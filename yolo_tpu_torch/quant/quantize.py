"""Power-of-two weight quantization on the host (counterpart of
``quantize_pow2_np`` in ``yolo_tpu/quant/quantize.py``; numpy only)."""

from __future__ import annotations

import numpy as np


def quantize_pow2_np(t, bitwidth: int = 8, channel_axis: int = None):
    """(levels, log2(scale) int) of ``t`` on the pow2 grid, in float32 so
    the exponent matches the JAX package's exactly even at pow2 boundaries.

    ``channel_axis``: per-channel scales — returns (levels, int32 exponent
    array [C]) instead of (levels, int). All-zero channels get exponent 0
    (their levels are 0 either way)."""
    t = np.asarray(t, np.float32)
    if channel_axis is not None:
        ax = channel_axis % t.ndim
        red = tuple(i for i in range(t.ndim) if i != ax)
        max_abs = np.max(np.abs(t), axis=red, keepdims=True)
        scale = (np.float32(2.0 ** (bitwidth - 1) - 1)
                 / np.where(max_abs > 0, max_abs, np.float32(1)))
        s_exp = np.floor(np.log2(scale.astype(np.float32))).astype(
            np.int32)
        s_exp = np.where(max_abs > 0, s_exp, 0).astype(np.int32)
        levels = np.round(t * np.exp2(s_exp.astype(np.float32)))
        return levels, s_exp.reshape(-1)
    max_abs = np.max(np.abs(t)) if t.size else np.float32(0)
    if max_abs <= 0:
        return np.zeros_like(t), 0
    scale = np.float32(2.0 ** (bitwidth - 1) - 1) / max_abs
    s_exp = int(np.floor(np.log2(scale)))
    return np.round(t * np.float32(2.0 ** s_exp)), s_exp
