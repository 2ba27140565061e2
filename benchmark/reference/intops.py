"""Plain integer semantics of the INT8 engines, in int64 torch ops.

The fixed-point contract of one conv layer (power-of-two scales, the
reference FPGA engine's):

  acc   = sum of int8 products, exact           # scale 2^(sa_in + sw)
  acc   = shift(acc, sa_in + sw - retune)       # -> scale 2^retune
  acc  += shift(b_q, sb - retune)
  acc   = clamp(acc, int16)
  act   = leaky: negatives shifted by 3 (slope 0.125), or at another
          slope the Q16 rational round(slope * 65536) / 65536
  out8  = clamp(shift(act, retune - sa_out), int8)

``shift(v, s)`` multiplies by 2^-s, rounding half away from zero; a
negative ``s`` shifts left. A conv over a concat of parts at different
scales sums each part's raw products with those of equal shift, then
shifts each group. Products are summed exactly: ``F.conv2d`` in float64
(every partial sum lies far below 2^53).

This module imports nothing of the program under test.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

INT8_MIN, INT8_MAX = -128, 127
INT16_MIN, INT16_MAX = -(2 ** 15), 2 ** 15 - 1


def shift(v: torch.Tensor, s: int) -> torch.Tensor:
    """v * 2^-s on int64, rounded half away from zero; s <= 0 exact."""
    s = int(s)
    if s <= 0:
        return v * (1 << -s)
    if s >= 32:  # |v| < 2^31 <= 2^(s - 1): rounds to 0
        return torch.zeros_like(v)
    return (v + (1 << (s - 1)) - (v < 0).to(v.dtype)) >> s


def conv_sum(x: torch.Tensor, w: torch.Tensor, stride: int,
             padding: int) -> torch.Tensor:
    """Exact int64 sums of a conv: x int [B, H, W, C_in] (NHWC), w int
    [k, k, C_in, C_out] (HWIO) -> [B, Ho, Wo, C_out]."""
    y = F.conv2d(x.permute(0, 3, 1, 2).to(torch.float64),
                 w.permute(3, 2, 0, 1).to(torch.float64),
                 stride=stride, padding=padding)
    return torch.round(y).to(torch.int64).permute(0, 2, 3, 1)


def leaky(v: torch.Tensor, slope) -> torch.Tensor:
    """slope: False (none), True (0.125, the shift by 3) or a float."""
    if slope is False:
        return v
    if slope is True or slope == 0.125:
        return torch.where(v >= 0, v, shift(v, 3))
    num = int(round(float(slope) * 65536))
    return torch.where(v >= 0, v, shift(v * num, 16))


def conv_requant(parts, w, b, *, sw: int, sb: int, retune: int,
                 sa_out: int, stride: int = 1, padding: int = 0,
                 slope=True) -> torch.Tensor:
    """One conv layer. ``parts``: [(int8 NHWC tensor, its scale)], the
    concat's parts in channel order; ``w`` int8 HWIO over their channels,
    ``b`` its int8-valued bias -> int8 NHWC at 2^sa_out."""
    groups: dict = {}
    c0 = 0
    for x, sa in parts:
        c = x.shape[-1]
        p = conv_sum(x, w[:, :, c0:c0 + c], stride, padding)
        c0 += c
        k = int(sw) + int(sa) - int(retune)
        groups[k] = p if k not in groups else groups[k] + p
    if c0 != w.shape[2]:
        raise ValueError(f"parts hold {c0} channels, the weights {w.shape[2]}")
    acc = sum(shift(p, k) for k, p in groups.items())
    acc = acc + shift(b.to(torch.int64), int(sb) - int(retune))
    acc = leaky(torch.clamp(acc, INT16_MIN, INT16_MAX), slope)
    out = torch.clamp(shift(acc, int(retune) - int(sa_out)), INT8_MIN,
                      INT8_MAX)
    return out.to(torch.int8)


def maxpool2(x: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 max pool of NHWC."""
    b, h, w, c = x.shape
    return x.reshape(b, h // 2, 2, w // 2, 2, c).amax(dim=(2, 4))


def add_requant(a: torch.Tensor, sa_a: int, r: torch.Tensor, sa_r: int,
                sa_out: int) -> torch.Tensor:
    """Residual add: both to the finer scale (exact), sum, to 2^sa_out."""
    s = max(sa_a, sa_r)
    v = (a.to(torch.int64) << (s - sa_a)) + (r.to(torch.int64) << (s - sa_r))
    return torch.clamp(shift(v, s - sa_out), INT8_MIN, INT8_MAX).to(
        torch.int8)


def _taps(n: int, device):
    """Rows of a 2x bilinear align-corners upsample of n rows: each output
    row r reads rows lo and lo + 1 (clipped) with weights (d - t, t) / d,
    d = 2n - 1, from r (n - 1) = lo d + t."""
    d = 2 * n - 1
    r = torch.arange(2 * n, device=device, dtype=torch.int64) * (n - 1)
    lo = r // d
    t = r - lo * d
    hi = torch.clamp(lo + 1, max=n - 1)
    return lo, hi, t, d


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """2x bilinear (align_corners=True) upsample of int8 NHWC, rounded to
    the nearest integer at the same scale. Computed exactly: the value is
    a rational with the odd denominator (2n - 1)(2m - 1), never a tie."""
    b, h, w, c = x.shape
    lo_h, hi_h, t_h, d_h = _taps(h, x.device)
    lo_w, hi_w, t_w, d_w = _taps(w, x.device)
    v = x.to(torch.int64)
    rows = (v[:, lo_h] * (d_h - t_h).view(1, -1, 1, 1)
            + v[:, hi_h] * t_h.view(1, -1, 1, 1))
    num = (rows[:, :, lo_w] * (d_w - t_w).view(1, 1, -1, 1)
           + rows[:, :, hi_w] * t_w.view(1, 1, -1, 1))
    den = d_h * d_w
    out = torch.div(2 * num + den, 2 * den, rounding_mode="floor")
    return torch.clamp(out, INT8_MIN, INT8_MAX).to(torch.int8)


def quantize_images(images: torch.Tensor, sa_in: int) -> torch.Tensor:
    """Float images -> int8 at 2^sa_in (round half to even)."""
    return torch.clamp(torch.round(images * (2.0 ** sa_in)), INT8_MIN,
                       INT8_MAX).to(torch.int8)


def s2d_layout(x: torch.Tensor) -> torch.Tensor:
    """int8 NHWC [B, H, W, C] -> the padded space-to-depth serving layout
    [B, H/2 + 3, W/2 + 3, 4C]: padded by 3, each 2x2 block packed on C in
    (row, column, channel) order."""
    b, h, w, c = x.shape
    xp = F.pad(x, (0, 0, 3, 3, 3, 3))
    hb, wb = (h + 6) // 2, (w + 6) // 2
    return xp.reshape(b, hb, 2, wb, 2, c).permute(0, 1, 3, 2, 4, 5).reshape(
        b, hb, wb, 4 * c)
