"""BatchNorm folding (counterpart of ``yolo_tpu/quant/bn_fold.py``):

    W' = W * gamma / sqrt(var + eps)                (per output channel)
    b' = beta - gamma * mean / sqrt(var + eps)      (+ gamma/std * b if the
                                                     conv had a bias)

in float32, as the JAX package writes it. 1/sqrt is IEEE here; XLA's CPU
backend lowers the JAX package's to an approximate reciprocal square root
refined by two Newton steps, so a folded weight can differ from its JAX
twin by an ulp (never more, in every comparison made so far).
"""

from __future__ import annotations

import copy

import numpy as np
import torch
from torch import nn

from yolo_tpu_torch.ops.blocks import Conv

_BN_EPS = 1e-5


def _fold(w, b, gamma, beta, mean, var, out_axis: int):
    """Folded (w, b) as float32 tensors; ``out_axis``: w's output-channel
    axis (-1 for HWIO, 0 for OIHW)."""
    std_inv = torch.ones_like(var) / torch.sqrt(var.to(torch.float32)
                                                + _BN_EPS)
    scale = gamma * std_inv
    shape = [1] * w.ndim
    shape[out_axis] = -1
    w_f = w.to(torch.float32) * scale.reshape(shape)
    b_f = beta - gamma * mean * std_inv
    if b is not None:
        b_f = b_f + scale * b.to(torch.float32)
    return w_f, b_f


def _fold_tree(params):
    if isinstance(params, dict):
        if "w" in params and "bn" in params:
            as_np = not isinstance(params["w"], torch.Tensor)
            t = {k: torch.as_tensor(np.asarray(v) if as_np else v)
                 for k, v in (("w", params["w"]), ("b", params.get("b")),
                              *params["bn"].items()) if v is not None}
            w, b = _fold(t["w"], t.get("b"), t["gamma"], t["beta"],
                         t["mean"], t["var"], -1)
            out = {k: v for k, v in params.items()
                   if k not in ("bn", "w", "b")}
            out["w"], out["b"] = ((w.numpy(), b.numpy()) if as_np
                                  else (w, b))
            return out
        return {k: _fold_tree(v) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(_fold_tree(v) for v in params)
    return params


def fold_batch_norm(params):
    """Fold every conv+BN.

    ``params`` is either a model (an ``nn.Module`` of ``blocks.Conv``
    layers): a copy of it comes back with every BN folded into its conv's
    weight and a new bias (the BN-fused form), on the same device; or a
    parameter tree in the JAX package's layout (dicts and lists, each conv
    {'w': HWIO[, 'b'], 'bn': {'gamma', 'beta', 'mean', 'var'}}) of numpy
    arrays or tensors, every such dict rewritten to {'w', 'b'}."""
    if not isinstance(params, nn.Module):
        return _fold_tree(params)
    fused = copy.deepcopy(params)
    with torch.no_grad():
        for m in fused.modules():
            if not isinstance(m, Conv) or m.bn is None:
                continue
            conv, bn = m.conv, m.bn
            w, b = _fold(conv.weight, conv.bias, bn.weight, bn.bias,
                         bn.running_mean, bn.running_var, 0)
            conv.weight.copy_(w)
            conv.bias = nn.Parameter(b)
            m.bn = None
    return fused
