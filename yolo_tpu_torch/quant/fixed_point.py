"""Integer INT8 inference engine (counterpart of
``yolo_tpu/quant/fixed_point.py``).

Fixed-point model per conv layer, exactly the JAX package's contract:

  acc32 = conv(a_q, w_q)                       # int32, scale 2^(sa_in+sw)
  acc16 = shift(acc32, sa_in + sw - retune)    # -> scale 2^retune
  acc16 += shift(b_q, sb - retune)
  [int16 saturation]
  act   = leaky: negative values >> 3          # slope 0.125 = 2^-3
  pool  = 2x2 max pool (if the layer has one)
  out8  = shift(acc16_act, retune - sa_out)    # -> scale 2^sa_out
  [int8 saturation]

``rounding='nearest'`` is round-half-away-from-zero, ``'floor'`` the
arithmetic shift. On a CUDA tensor every conv layer of ``int8_forward``
runs in a hand-written kernel (``yolo_tpu_torch.kernels.int8_conv``); on
a CPU tensor the same wrappers run their exact plain versions.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch

from yolo_tpu_torch.models.slim_yolo_v2 import CONV_LAYERS
from yolo_tpu_torch.quant.qsim import QUANT_LAYER_NAMES, TRACKER_NAMES

INT16_MIN, INT16_MAX = -(2 ** 15), 2 ** 15 - 1
INT8_MIN, INT8_MAX = -128, 127


@dataclass
class Int8Model:
    """Quantized slim_yolo_v2: int8 HWIO weights, int32 (int8-valued)
    biases and the per-layer shift exponents."""
    w_q: Dict[str, torch.Tensor]    # int8 HWIO
    b_q: Dict[str, torch.Tensor]    # int32 (int8-valued)
    sw: Dict[str, int]
    sb: Dict[str, int]
    sa: Dict[str, int]              # tracker name -> exponent (11 entries)
    retune: Dict[str, int]

    def to(self, device) -> "Int8Model":
        """The same model with its tensors on ``device``."""
        return Int8Model(
            w_q={k: v.to(device) for k, v in self.w_q.items()},
            b_q={k: v.to(device) for k, v in self.b_q.items()},
            sw=dict(self.sw), sb=dict(self.sb), sa=dict(self.sa),
            retune=dict(self.retune))


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; raises if it names CUDA and there is
    none (an entry point never falls back to the CPU on its own)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels")
    return dev


# ---------------------------------------------------------------------------
# Shared integer helpers (int32 tensors; wrap like XLA's int32).
# ---------------------------------------------------------------------------


def _shift_arr(v: torch.Tensor, s, rounding: str) -> torch.Tensor:
    """Per-channel variant of _shift: ``s`` is an int array broadcastable
    to v. Negative entries left-shift (exact); shifts >= 31 collapse to
    the degenerate 0 / -1."""
    s = torch.as_tensor(np.asarray(s, np.int32), device=v.device)
    left = torch.bitwise_left_shift(v, torch.clamp(-s, min=0))
    sp = torch.clamp(s, 0, 31)
    if rounding == "floor":
        right = torch.bitwise_right_shift(v, sp)
    else:
        off = torch.bitwise_left_shift(torch.ones_like(v),
                                       torch.clamp(sp - 1, min=0))
        right = torch.bitwise_right_shift(v + off - (v < 0).to(v.dtype), sp)
        right = torch.where(s >= 31, torch.zeros_like(v), right)
    return torch.where(s <= 0, left, right)


def _shift(v: torch.Tensor, s, rounding: str) -> torch.Tensor:
    """Multiply by 2^-s in integer arithmetic. s may be negative (left
    shift, exact) or an int array (per-channel scales, _shift_arr)."""
    if not isinstance(s, (int, np.integer)):
        return _shift_arr(v, s, rounding)
    s = int(s)
    if s == 0:
        return v
    if s < 0:
        return v * (1 << (-s))
    if s >= 32:
        # |v| < 2^31 <= 2^(s-1): the rounded result is exactly 0
        # (floor: 0 or -1 by sign); 1 << (s-1) would overflow int32.
        if rounding == "floor":
            return torch.bitwise_right_shift(v, 31)
        return torch.zeros_like(v)
    if rounding == "floor":
        return torch.bitwise_right_shift(v, s)
    offset = 1 << (s - 1)
    return torch.bitwise_right_shift(v + offset - (v < 0).to(v.dtype), s)


def _leaky_int(v: torch.Tensor, rounding: str) -> torch.Tensor:
    """LeakyReLU(0.125) as an arithmetic shift on negatives."""
    return torch.where(v >= 0, v, _shift(v, 3, rounding))


def _leaky_int_slope(v: torch.Tensor, slope: float,
                     rounding: str) -> torch.Tensor:
    """Integer LeakyReLU at an arbitrary slope: 0.125 is the pure shift,
    other slopes the Q16 rational round(slope*65536)/65536."""
    if slope == 0.125:
        return _leaky_int(v, rounding)
    num = int(round(slope * 65536))
    neg = _shift(v.to(torch.int64) * num, 16, rounding)
    return torch.where(v >= 0, v, neg.to(v.dtype))


def _requant(acc: torch.Tensor, bias_rt: torch.Tensor, *, acc_shift: int,
             out_shift: int, leaky, rounding: str) -> torch.Tensor:
    """The requant chain on an int32 accumulator whose bias is already at
    the retune scale -> int8. ``leaky``: False, True (0.125) or a float
    slope."""
    acc = _shift(acc, acc_shift, rounding) + bias_rt
    acc = torch.clamp(acc, INT16_MIN, INT16_MAX)
    if leaky:
        acc = _leaky_int_slope(acc, 0.125 if leaky is True else float(leaky),
                               rounding)
    out = _shift(acc, out_shift, rounding)
    return torch.clamp(out, INT8_MIN, INT8_MAX).to(torch.int8)


def _maxpool_int(x: torch.Tensor) -> torch.Tensor:
    """2x2/2 max pool of an NHWC integer tensor."""
    b, h, w, c = x.shape
    return x.reshape(b, h // 2, 2, w // 2, 2, c).amax(dim=(2, 4))


# ---------------------------------------------------------------------------
# Input layout.
# ---------------------------------------------------------------------------


def quantize_input(x: torch.Tensor, sa_in: int) -> torch.Tensor:
    """float (normalized) image -> int8 at scale 2^sa_in (round half to
    even, as jnp.round)."""
    return torch.clamp(torch.round(x * (2.0 ** sa_in)), INT8_MIN, INT8_MAX
                       ).to(torch.int8)


def _s2d_phase_weights(w_q: np.ndarray, c_in: int, c_out: int) -> np.ndarray:
    """[3,3,C_in,C_out] conv weights -> [2,2,4*C_in,4*C_out] block-conv
    weights over the space-to-depth input, one output group per pool
    phase (zeros where the 3x3 support doesn't reach)."""
    w4 = np.zeros((2, 2, 4 * c_in, 4 * c_out), w_q.dtype)
    for a in range(2):          # pool phase row (y row = 2u+a)
        for bph in range(2):    # pool phase col
            for j in range(3):  # 3x3 tap
                for k in range(3):
                    m_, n_ = a + j, bph + k   # position in the 4x4 window
                    r_, py = divmod(m_, 2)    # block offset / pixel-in-block
                    s_, px = divmod(n_, 2)
                    ci = (py * 2 + px) * c_in
                    co = (a * 2 + bph) * c_out
                    w4[r_, s_, ci:ci + c_in, co:co + c_out] = w_q[j, k]
    return w4


def check_serving_input(images: torch.Tensor, cfg,
                        input_s2d: bool = False) -> None:
    """Shape/dtype validation for the serving detect fn: a clear
    ValueError instead of a broadcast error deep in decode."""
    h, w = cfg.input_size
    if images.ndim != 4:
        raise ValueError(
            f"detect expects a batched [B, H, W, C] input; got shape "
            f"{tuple(images.shape)}")
    if input_s2d and images.dtype == torch.int8:
        want = (h // 2 + 3, w // 2 + 3, 12)
        if tuple(images.shape[1:]) != want:
            raise ValueError(
                f"int8 s2d input for input_size {h}x{w} must be "
                f"[B, {want[0]}, {want[1]}, {want[2]}] (the padded "
                f"space-to-depth layout from s2d_input_np); got "
                f"{tuple(images.shape)}. For plain NHWC input rebuild "
                f"the detect fn without input_s2d.")
        return
    if tuple(images.shape[1:]) != (h, w, 3):
        raise ValueError(
            f"images are {tuple(images.shape[1:])} but this detect fn "
            f"was built for input_size {h}x{w} (expected [B, {h}, {w}, "
            f"3]); rebuild with cfg.with_input_size(...) or resize the "
            f"batch")


def s2d_input(x_q: torch.Tensor) -> torch.Tensor:
    """[B,H,W,C] int8 -> padded space-to-depth [B,H/2+3,W/2+3,4*C].

    Pad 3 so the pool-window base row 2u-1 lands on an even (block)
    offset; channel order inside a block is (py, px, c)."""
    b, h, w, c_in = x_q.shape
    xp = torch.nn.functional.pad(x_q, (0, 0, 3, 3, 3, 3))
    hb, wb = (h + 6) // 2, (w + 6) // 2
    return xp.reshape(b, hb, 2, wb, 2, c_in).permute(
        0, 1, 3, 2, 4, 5).reshape(b, hb, wb, 4 * c_in)


def s2d_input_np(x_q: np.ndarray) -> np.ndarray:
    """Numpy twin of s2d_input (host-side layout for serving input)."""
    b, h, w, c_in = x_q.shape
    xp = np.pad(x_q, ((0, 0), (3, 3), (3, 3), (0, 0)))
    hb, wb = (h + 6) // 2, (w + 6) // 2
    return np.ascontiguousarray(
        xp.reshape(b, hb, 2, wb, 2, c_in).transpose(0, 1, 3, 2, 4, 5)
        .reshape(b, hb, wb, 4 * c_in))


# ---------------------------------------------------------------------------
# The integer graph.
# ---------------------------------------------------------------------------


def _leaky_flag(leaky) -> bool:
    if leaky is True or leaky is False:
        return leaky
    raise ValueError(
        f"leaky={leaky!r}: the int8 conv kernels implement the 0.125 "
        f"shift only (True / False); float slopes are not ported yet")


def int8_conv_pool_s2d_core(x2: torch.Tensor, w_q, b_q, *, c_in: int,
                            sw: int, sb: int, sa_in: int, sa_out: int,
                            retune: int, leaky: bool = True,
                            rounding: str = "nearest") -> torch.Tensor:
    """conv3x3 + requant + 2x2 pool on an already space-to-depth input
    [B,H/2+3,W/2+3,4*C_in] -> [B,H/2,W/2,C_out] int8."""
    from yolo_tpu_torch.kernels.int8_conv import int8_conv3x3_pool_s2d

    return int8_conv3x3_pool_s2d(
        x2, w_q, b_q, c_in=c_in, sw=sw, sb=sb, sa_in=sa_in, sa_out=sa_out,
        retune=retune, leaky=_leaky_flag(leaky), rounding=rounding)


# ---------------------------------------------------------------------------
# Generic integer ops (the building blocks of the yolo_v3 engine).
# ---------------------------------------------------------------------------


def int_conv_requant(x, w_q, b_q, *, sw, sb, sa_in, sa_out, retune,
                     padding: int = 0, stride: int = 1, leaky=True,
                     rounding: str = "nearest", residual=None,
                     sa_res: int = None) -> torch.Tensor:
    """Integer conv + fixed-point requant, generalized (the JAX package's
    ``int_conv_requant``): ``x`` is int8 at 2^sa_in or a list of (int8,
    sa) concat parts, ``leaky`` False | True (0.125) | a float slope, and
    ``residual`` an optional (r_q, sa_r) skip tensor added with
    ``int_add_requant`` to scale 2^sa_res. The conv runs in
    ``int8_conv_requant`` (a CUDA kernel on a CUDA tensor)."""
    from yolo_tpu_torch.kernels.int8_conv import int8_conv_requant

    out = int8_conv_requant(x, w_q, b_q, sw=sw, sb=sb, sa_in=sa_in,
                            sa_out=sa_out, retune=retune, padding=padding,
                            stride=stride, leaky=leaky, rounding=rounding)
    if residual is not None:
        r_q, sa_r = residual
        out = int_add_requant(out, sa_out, r_q, sa_r, sa_res, rounding)
    return out


def int_add_requant(a: torch.Tensor, sa_a: int, b: torch.Tensor, sa_b: int,
                    sa_out: int, rounding: str = "nearest") -> torch.Tensor:
    """Residual add of two int8 tensors with different scales: both shift
    (exactly, left) to the finer common scale, sum in int32, requantize to
    2^sa_out with int8 saturation."""
    s = max(sa_a, sa_b)
    va = torch.bitwise_left_shift(a.to(torch.int32), s - sa_a)
    vb = torch.bitwise_left_shift(b.to(torch.int32), s - sa_b)
    out = _shift(va + vb, s - sa_out, rounding)
    return torch.clamp(out, INT8_MIN, INT8_MAX).to(torch.int8)


def int_upsample2x_ac(x_q: torch.Tensor,
                      rounding: str = "nearest") -> torch.Tensor:
    """2x bilinear (align_corners=True) upsample of an int8 tensor, in
    float32, rounded back to the SAME scale exponent (``floor`` or
    ``nearest``: half to even, as jnp.round; 2n - 1 is odd, so no value is
    ever a tie)."""
    from yolo_tpu_torch.ops import blocks

    up = blocks.upsample2x_align_corners(x_q.to(torch.float32))
    r = torch.round(up) if rounding == "nearest" else torch.floor(up)
    return torch.clamp(r, INT8_MIN, INT8_MAX).to(torch.int8)


def int8_forward(m: Int8Model, x_q: torch.Tensor,
                 rounding: str = "nearest",
                 input_s2d: bool = False) -> torch.Tensor:
    """int8 input [B, H, W, 3] (or, with ``input_s2d``, the padded s2d
    layout [B, H/2+3, W/2+3, 12]) -> float head [B, H/16, W/16, C].

    Layer routing: conv1 on s2d input runs the s2d conv+pool form
    (int8_conv3x3_pool_s2d); every other pool layer runs
    int8_conv3x3_im2col(pool=True); the rest int8_conv3x3_requant.
    """
    from yolo_tpu_torch.kernels import int8_conv as K

    if any(np.ndim(s) for s in m.sw.values()):
        raise ValueError(
            "per-channel weight scales are not supported by the int8 conv "
            "kernels yet (their epilogue takes one sw per layer)")
    out = x_q
    names = list(TRACKER_NAMES)
    pools = {name: pool for name, _, _, pool in CONV_LAYERS}
    for i, name in enumerate(QUANT_LAYER_NAMES):
        kw = dict(sw=int(m.sw[name]), sb=int(m.sb[name]),
                  sa_in=int(m.sa[names[i]]), sa_out=int(m.sa[names[i + 1]]),
                  retune=int(m.retune[name]), leaky=(name != "pred"),
                  rounding=rounding)
        if input_s2d and i == 0:
            out = int8_conv_pool_s2d_core(out, m.w_q[name], m.b_q[name],
                                          c_in=3, **kw)
        elif pools.get(name):
            out = K.int8_conv3x3_im2col(out, m.w_q[name], m.b_q[name],
                                        pool=True, **kw)
        else:
            out = K.int8_conv3x3_requant(out, m.w_q[name], m.b_q[name],
                                         **kw)
    # dequantize the head to float for decode
    return out.to(torch.float32) * (2.0 ** -m.sa["pred"])
