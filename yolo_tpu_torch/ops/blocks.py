"""Model building blocks (counterpart of ``yolo_tpu/ops/blocks.py``; this
slice needs ``flatten_grid`` and the align-corners 2x upsample)."""

import numpy as np
import torch


def flatten_grid(pred: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] -> [B, H*W, C]."""
    b, h, w, c = pred.shape
    return pred.reshape(b, h * w, c)


def _align_corners_weights(n_in: int, n_out: int):
    """Interpolation (lo index, hi index, frac) for align_corners=True."""
    if n_in == 1:
        src = np.zeros(n_out)
    else:
        src = np.arange(n_out) * (n_in - 1) / (n_out - 1)
    lo = np.floor(src).astype(np.int32)
    hi = np.minimum(lo + 1, n_in - 1)
    frac = (src - lo).astype(np.float32)
    return lo, hi, frac


def _upsample2x_matrix(n: int) -> np.ndarray:
    """[2n, n] align-corners interpolation matrix (two nonzeros/row)."""
    lo, hi, frac = _align_corners_weights(n, 2 * n)
    u = np.zeros((2 * n, n), np.float32)
    u[np.arange(2 * n), lo] += 1.0 - frac
    u[np.arange(2 * n), hi] += frac
    return u


def upsample2x_align_corners(x: torch.Tensor) -> torch.Tensor:
    """2x bilinear upsample of float32 NHWC with align_corners=True: two
    separable passes (H, then W) with the [2n, n] interpolation matrices,
    as the JAX package computes it.

    Each output is u0*a + u1*b (the matrices have two nonzeros a row) taken
    as a gather, an elementwise product and one add, all in float32, so
    it rounds as the JAX package's CPU einsum does: the extra terms of its
    dense matmul are exact zeros."""
    for axis in (1, 2):
        n = x.shape[axis]
        lo, hi, frac = _align_corners_weights(n, 2 * n)
        u = _upsample2x_matrix(n)
        rows = np.arange(2 * n)
        w_lo = torch.as_tensor(u[rows, lo], device=x.device)
        w_hi = torch.as_tensor(np.where(hi != lo, u[rows, hi], 0.0)
                               .astype(np.float32), device=x.device)
        shape = [1, 1, 1, 1]
        shape[axis] = 2 * n
        a = torch.index_select(x, axis, torch.as_tensor(lo, device=x.device)
                               .long())
        b = torch.index_select(x, axis, torch.as_tensor(hi, device=x.device)
                               .long())
        x = a * w_lo.reshape(shape) + b * w_hi.reshape(shape)
    return x
