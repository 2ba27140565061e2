"""Operations and bytes of a detect step, from the configuration's layer
shapes (the reference's ``layers``).

Ops: 2 per multiply-add of every conv, over the taps that fall inside the
image (padding taps are not work), the convention of XLA's and the
program's ``count_flops``. Bytes: each conv layer's input, weights, int32
bias and output, each counted once (a pooled layer writes its pooled
output; a residual block's 3x3 also reads the block's input): the same
work whatever kernel runs it. Decode, top-k and NMS are not counted."""

from __future__ import annotations

import numpy as np


def _taps(n_in: int, k: int, stride: int, pad: int) -> int:
    n_out = (n_in + 2 * pad - k) // stride + 1
    o = np.arange(n_out)[:, None] * stride - pad + np.arange(k)[None, :]
    return int(((o >= 0) & (o < n_in)).sum())


def layer_costs(layers, batch: int):
    """[(name, ops, bytes)] of one batch of square images."""
    out = []
    for name, k, c_in, c_out, stride, h, pool, residual in layers:
        pad = k // 2
        ho = (h + 2 * pad - k) // stride + 1
        ops = 2 * batch * c_in * c_out * _taps(h, k, stride, pad) ** 2
        hw_out = (ho // 2) ** 2 if pool else ho ** 2
        nbytes = (batch * h * h * c_in + k * k * c_in * c_out + 4 * c_out
                  + batch * hw_out * c_out)
        if residual:
            nbytes += batch * ho * ho * c_out
        out.append((name, ops, nbytes))
    return out


def roofline_s(costs, peak_ops: float, peak_bw: float) -> float:
    """The least time the layers can take one after another: each layer
    at the larger of its ops over the peak rate and its bytes over the
    peak bandwidth."""
    return sum(max(ops / peak_ops, nb / peak_bw) for _, ops, nb in costs)
