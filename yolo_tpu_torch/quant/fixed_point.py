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
from typing import Dict, Optional

import numpy as np
import torch

from yolo_tpu_torch.models.slim_yolo_v2 import CONV_LAYERS
from yolo_tpu_torch.quant.qsim import QUANT_LAYER_NAMES, TRACKER_NAMES

INT16_MIN, INT16_MAX = -(2 ** 15), 2 ** 15 - 1
INT8_MIN, INT8_MAX = -128, 127
# the layers with a 2x2 max pool (K2 or K3); int8_forward runs every other
# layer in int8_conv3x3_requant (K1)
POOLED = frozenset(name for name, _, _, pool in CONV_LAYERS if pool)


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
    # {layer name: its weights packed K-major for the wgmma conv3x3
    # kernel}, made once by ``pack_conv3x3``
    packed: Optional[Dict[str, torch.Tensor]] = None
    # conv1's weights phase-packed for K2's wgmma kernel on the s2d layout
    # (``pack_pool_s2d_weights``), made once by ``pack_conv3x3``
    s2d_packed: Optional[torch.Tensor] = None
    # conv1's weights phase-packed for the NHWC form of K2's wgmma kernel
    # on NHWC input (``pack_pool_nhwc_weights``), made once by
    # ``pack_conv3x3``
    nhwc_packed: Optional[torch.Tensor] = None
    # {rounding: {layer name: its per-column accumulator shift table}}
    # (``acc_shift_table``), which the kernels read for a per-channel sw
    # and when counting overflows, made once by ``pack_conv3x3``
    shift_tables: Optional[Dict[str, Dict[str, torch.Tensor]]] = None

    def to(self, device) -> "Int8Model":
        """The same model with its tensors, packed ones and shift tables
        included, on ``device``."""
        def moved(d):
            return None if d is None else {k: v.to(device)
                                           for k, v in d.items()}

        return Int8Model(
            w_q=moved(self.w_q), b_q=moved(self.b_q),
            sw=dict(self.sw), sb=dict(self.sb), sa=dict(self.sa),
            retune=dict(self.retune), packed=moved(self.packed),
            s2d_packed=None if self.s2d_packed is None else
            self.s2d_packed.to(device),
            nhwc_packed=None if self.nhwc_packed is None else
            self.nhwc_packed.to(device),
            shift_tables=None if self.shift_tables is None else
            {r: moved(t) for r, t in self.shift_tables.items()})

    @property
    def per_channel(self) -> bool:
        """Whether any layer's sw is per-channel."""
        return any(np.ndim(s) for s in self.sw.values())

    def layer_shifts(self, i: int, name: str) -> dict:
        """Layer ``name``'s (the ``i``-th) sw, sb, sa_in, sa_out, retune:
        ints, sw a per-channel int32 array where it is one."""
        sw = self.sw[name]
        return dict(sw=np.asarray(sw, np.int32) if np.ndim(sw) else int(sw),
                    sb=int(self.sb[name]),
                    sa_in=int(self.sa[TRACKER_NAMES[i]]),
                    sa_out=int(self.sa[TRACKER_NAMES[i + 1]]),
                    retune=int(self.retune[name]))

    def pack_conv3x3(self) -> None:
        """Pack once the weights of every layer that ``int8_forward`` runs
        on the wgmma conv3x3 kernel (``int8_conv3x3_requant`` layers that
        ``conv3x3_wgmma_route`` takes, pooled ``int8_conv3x3_im2col``
        layers that ``conv3x3_pool_wgmma_route`` takes) into ``packed``,
        conv1's for K2's wgmma kernel on the s2d input
        (``pool_s2d_wgmma_route``, a scalar sw only) into ``s2d_packed``
        and for its NHWC form on NHWC input (``pool_nhwc_wgmma_route``, a
        scalar or a per-channel sw) into ``nhwc_packed``, and every
        layer's per-column shift table, for both roundings, into
        ``shift_tables``, so the forward never packs."""
        from yolo_tpu_torch.kernels.int8_conv import (
            acc_shift_table, conv3x3_pool_wgmma_route, conv3x3_wgmma_route,
            pack_conv3x3_weights, pack_pool_nhwc_weights,
            pack_pool_s2d_weights, pool_nhwc_wgmma_route,
            pool_s2d_wgmma_route)

        def routed(name):
            _, _, c_in, c_out = self.w_q[name].shape
            sw = self.sw[name]
            if name in POOLED:
                return conv3x3_pool_wgmma_route(c_in, sw, c_out=c_out)
            return conv3x3_wgmma_route(3, 1, 1, 1, c_in, sw, c_out=c_out)

        self.packed = {name: pack_conv3x3_weights(self.w_q[name])
                       for name in QUANT_LAYER_NAMES if routed(name)}
        w1 = self.w_q[QUANT_LAYER_NAMES[0]]
        c_in, c_out, sw1 = w1.shape[2], w1.shape[3], self.sw[
            QUANT_LAYER_NAMES[0]]
        self.s2d_packed = (pack_pool_s2d_weights(w1) if pool_s2d_wgmma_route(
            c_in, c_out, sw1) else None)
        self.nhwc_packed = (pack_pool_nhwc_weights(w1)
                            if pool_nhwc_wgmma_route(c_in, c_out, sw1)
                            else None)
        dev = w1.device
        self.shift_tables = {}
        for rounding in ("nearest", "floor"):
            tables = self.shift_tables[rounding] = {}
            for i, name in enumerate(QUANT_LAYER_NAMES):
                p = self.layer_shifts(i, name)
                tables[name] = acc_shift_table(
                    p["sw"], p["sa_in"], p["retune"], rounding,
                    self.w_q[name].shape[-1], dev)


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; raises if it names CUDA and there is
    none (an entry point never falls back to the CPU on its own)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels")
    return dev


def quantize_model(params_fused, tracker_states, retune: Dict[str, int],
                   bitwidth: int = 8, weight_bitwidth: int = None,
                   per_channel: bool = False, device=None) -> Int8Model:
    """BN-fused float slim params (a ``SlimYOLOv2`` in the fused form, or
    the JAX package's tree of it) + calibrated trackers + retune table ->
    the integer model, with int8 HWIO weights, on ``device``: by default
    the model's own, and for a tree the card (through ``resolve_device``,
    which raises where there is none).

    The weights quantize on the host in numpy float32, as the JAX package
    quantizes them: at ``weight_bitwidth or bitwidth`` bits (a narrower
    width's levels are a subset of int8), per tensor or (``per_channel``)
    per output channel, sw then an int32 [C_out] array; biases at
    ``bitwidth``."""
    from yolo_tpu_torch.quant.convert import (
        int8_model_from_numpy, module_to_params, quantize_slim_weights)
    from yolo_tpu_torch.quant.qsim import activation_scale_exponents

    if isinstance(params_fused, torch.nn.Module):
        if device is None:
            device = next(params_fused.parameters()).device
        params_fused = module_to_params(params_fused)
    w_q, b_q, sw, sb = quantize_slim_weights(
        params_fused, per_channel=per_channel, bitwidth=bitwidth,
        weight_bitwidth=weight_bitwidth)
    return int8_model_from_numpy(w_q, b_q, sw, sb,
                                 activation_scale_exponents(tracker_states),
                                 dict(retune),
                                 device="cuda" if device is None else device)


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


def _requant(acc: torch.Tensor, bias_rt: torch.Tensor, *, acc_shift,
             out_shift: int, leaky, rounding: str,
             overflow: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The requant chain on an int32 accumulator whose bias is already at
    the retune scale -> int8. ``acc_shift``: an int or a per-channel
    array; ``leaky``: False, True (0.125) or a float slope; ``overflow``:
    an int32 counter to which the values that hit the int16 clamp are
    added (``int8_forward_diagnostics``)."""
    acc = _shift(acc, acc_shift, rounding) + bias_rt
    if overflow is not None:
        overflow += ((acc > INT16_MAX) | (acc < INT16_MIN)).sum().to(
            overflow.dtype)
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


def int8_conv_pool_s2d_core(x2: torch.Tensor, w_q, b_q, *, c_in: int,
                            sw: int, sb: int, sa_in: int, sa_out: int,
                            retune: int, leaky=True,
                            rounding: str = "nearest",
                            packed=None) -> torch.Tensor:
    """conv3x3 + requant + 2x2 pool on an already space-to-depth input
    [B,H/2+3,W/2+3,4*C_in] -> [B,H/2,W/2,C_out] int8 (``packed``: the
    weights from ``pack_pool_s2d_weights``, for K2's wgmma kernel;
    ``leaky``: False, True (0.125) or a float slope, the darknet entry's
    0.1 on K2's wgmma kernel)."""
    from yolo_tpu_torch.kernels.int8_conv import int8_conv3x3_pool_s2d

    return int8_conv3x3_pool_s2d(
        x2, w_q, b_q, c_in=c_in, sw=sw, sb=sb, sa_in=sa_in, sa_out=sa_out,
        retune=retune, leaky=leaky, rounding=rounding,
        packed=packed)


# ---------------------------------------------------------------------------
# Generic integer ops (the building blocks of the yolo_v3 engine).
# ---------------------------------------------------------------------------


def int_conv_requant(x, w_q, b_q, *, sw, sb, sa_in, sa_out, retune,
                     padding: int = 0, stride: int = 1, leaky=True,
                     rounding: str = "nearest", residual=None,
                     sa_res: int = None, packed=None,
                     shifts=None) -> torch.Tensor:
    """Integer conv + fixed-point requant, generalized (the JAX package's
    ``int_conv_requant``): ``x`` is int8 at 2^sa_in or a list of (int8,
    sa) concat parts, ``sw`` an int or a per-channel int32 [C_out] array,
    ``leaky`` False | True (0.125) | a float slope, and ``residual`` an
    optional (r_q, sa_r) skip tensor added with ``int_add_requant`` to
    scale 2^sa_res. The conv runs in ``int8_conv_requant`` (a CUDA kernel
    on a CUDA tensor; ``packed``: the weights packed for its route,
    ``shifts``: a per-channel sw's shift tables, ``conv_shift_tables``)."""
    from yolo_tpu_torch.kernels.int8_conv import int8_conv_requant

    out = int8_conv_requant(x, w_q, b_q, sw=sw, sb=sb, sa_in=sa_in,
                            sa_out=sa_out, retune=retune, padding=padding,
                            stride=stride, leaky=leaky, rounding=rounding,
                            packed=packed, shifts=shifts)
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


# ---------------------------------------------------------------------------
# Space-to-depth execution forms (yolo_v3's stride-2 structure) and the SPP
# pools.
#
# The JAX package runs these as 2x2 block convs over phase-packed layouts:
# bit-exact re-executions of the plain convs that put small-C_in convs on
# the TPU's MXU. The port runs the plain convs they re-execute, on every
# device: on the card their kernels (the stride-2 form of the wgmma conv3x3
# already splits even and odd columns in shared memory), on a CPU tensor
# their exact plain versions. The same products summed exactly and the same
# requant chain give the same integers.
# ---------------------------------------------------------------------------


def _no_route(what: str, x: torch.Tensor):
    return ValueError(f"{what}: no CUDA kernel route takes these shapes "
                      f"({tuple(x.shape)}); the port never runs it on the "
                      f"CPU for a CUDA tensor")


def int8_conv_stride2_s2d(x_q, w_q, b_q, *, sw, sb, sa_in, sa_out, retune,
                          leaky=True, rounding: str = "nearest",
                          packed=None, shifts=None) -> torch.Tensor:
    """3x3 stride-2 pad-1 int8 conv: ``int_conv_requant(stride=2,
    padding=1)``, which the JAX package's block-conv form re-executes.

    On a CUDA tensor that is the stride-2 form of the wgmma conv3x3 kernel
    (``conv3x3_s2_wgmma_route``, C_in % 32 == 0; ``packed`` and ``shifts``
    as ``int_conv_requant`` takes them); other shapes raise."""
    from yolo_tpu_torch.kernels.int8_conv import (
        conv3x3_s2_wgmma_route, int8_conv_requant, route)

    b, h, w, c = x_q.shape
    if h % 2 or w % 2:
        raise ValueError("stride-2 s2d conv requires even H, W")
    if route(x_q) == "cuda" and not conv3x3_s2_wgmma_route(
            3, 2, 1, 1, c, sw, c_out=b_q.shape[0]):
        raise _no_route("int8_conv_stride2_s2d", x_q)
    return int8_conv_requant(
        x_q, w_q, b_q, sw=sw, sb=sb, sa_in=sa_in, sa_out=sa_out,
        retune=retune, padding=1, stride=2, leaky=leaky, rounding=rounding,
        packed=packed, shifts=shifts)


def s2d_entry_from_input(x2: torch.Tensor) -> torch.Tensor:
    """Serving s2d layout [B,H/2+3,W/2+3,4C] (``s2d_input`` / native
    layout='s2d') -> the odd-aligned entry-pair layout [B,H/2+1,W/2+1,4C]
    that ``int8_entry_pair_s2d`` takes with ``pre_s2d``: the input padded
    by 1, each 2x2 block packed on C in (py, px, c) order.

    Serving block k holds original rows (2k-3, 2k-2) (pad 3), the
    odd-aligned block m rows (2m-1, 2m) (pad 1): the same content at
    k = m+1, and the pad-3 zeros cover the pad-1 zeros, so the slice
    [1:-1] converts losslessly (a view: no copy)."""
    return x2[:, 1:-1, 1:-1, :]


def nhwc_from_entry_blocks(x2: torch.Tensor) -> torch.Tensor:
    """The odd-aligned block layout [B, H/2+1, W/2+1, 4C] back to the NHWC
    image [B, H, W, C] it holds: an exact index permutation, one copy.

    Block m holds rows (2m-1, 2m) at phase py = 0, 1, so image row
    r = 2k + q sits in block k + q at phase 1 - q (columns alike). That is
    one strided view of ``x2`` (strides of k and q: a block's and a block's
    less a phase's; offset: phase (1, 1) of block 0), made contiguous."""
    b, hb, wb, c4 = x2.shape
    c = c4 // 4
    if x2.stride(-1) != 1:
        x2 = x2.contiguous()
    s_b, s_m, s_n, _ = x2.stride()
    h, w = 2 * (hb - 1), 2 * (wb - 1)
    view = x2.as_strided((b, h // 2, 2, w // 2, 2, c),
                         (s_b, s_m, s_m - 2 * c, s_n, s_n - c, 1),
                         x2.storage_offset() + 3 * c)
    return view.contiguous().view(b, h, w, c)


def int8_entry_pair_s2d(x_q, w1, b1, p1: dict, w2, b2, p2: dict,
                        rounding: str = "nearest", pre_s2d: bool = False,
                        leaky=(True, True), packed=(None, None),
                        shifts=(None, None)) -> torch.Tensor:
    """The darknet entry, conv1 (3x3 s1 p1 leaky) then conv2 (3x3 s2 p1
    leaky): the sequential ``int_conv_requant`` pair, which the JAX
    package's fused block-conv form re-executes. ``p1``/``p2`` carry each
    conv's requant parameters (sw, sb, sa_in, sa_out, retune).

    The two give the same integers: conv1's phase-packed intermediate there
    holds exactly the requantized values of conv1's output here, and the
    zero block pad conv2 reads there is conv2's zero padding here.

    On a CUDA tensor conv1 runs on the entry conv kernel
    (``entry_conv3x3_route``, C_in <= 3), conv2 on the stride-2 form of the
    wgmma conv3x3 (``conv3x3_s2_wgmma_route``), each with its ``packed``
    weights and ``shifts`` tables; other shapes raise.

    ``pre_s2d``: ``x_q`` is the odd-aligned block layout
    [B, H/2+1, W/2+1, 4*C] (``s2d_entry_from_input`` of the serving
    layout), which ``nhwc_from_entry_blocks`` first turns back into NHWC
    (an exact permutation, one copy)."""
    from yolo_tpu_torch.kernels.int8_conv import (
        conv3x3_s2_wgmma_route, entry_conv3x3_route, int8_conv_requant,
        route)

    x = nhwc_from_entry_blocks(x_q) if pre_s2d else x_q
    if x.shape[1] % 2 or x.shape[2] % 2:
        raise ValueError("entry pair requires even H, W")
    c_in, c_mid, c_out = x.shape[-1], b1.shape[0], b2.shape[0]
    if route(x) == "cuda" and not (
            entry_conv3x3_route(3, 1, 1, 1, c_in, c_mid, p1["sw"])
            and conv3x3_s2_wgmma_route(3, 2, 1, 1, c_mid, p2["sw"],
                                       c_out=c_out)):
        raise _no_route("int8_entry_pair_s2d", x)
    y = int8_conv_requant(x, w1, b1, padding=1, stride=1, leaky=leaky[0],
                          rounding=rounding, packed=packed[0],
                          shifts=shifts[0], **p1)
    return int8_conv_requant(y, w2, b2, padding=1, stride=2, leaky=leaky[1],
                             rounding=rounding, packed=packed[1],
                             shifts=shifts[1], **p2)


def int_maxpool(x_q: torch.Tensor, window: int = 2, stride: int = 2,
                padding: int = 0) -> torch.Tensor:
    """int8 max pool, NHWC; padding uses INT8_MIN (torch -inf semantics).
    No Pallas kernel in the JAX package (XLA's reduce_window): here two
    int8 max reductions over unfolded windows, rows then columns (the max
    over a window is the max over its rows' maxima), on any device."""
    if padding:
        x_q = torch.nn.functional.pad(
            x_q, (0, 0, padding, padding, padding, padding), value=INT8_MIN)
    rows = x_q.unfold(1, window, stride).amax(-1)
    return rows.unfold(2, window, stride).amax(-1)


def int_spp(x_q: torch.Tensor) -> torch.Tensor:
    """int8 SPP: concat [x, mp5, mp9, mp13] on C (reference
    utils/modules.py:59-72). Max pools preserve the scale, so the concat is
    single-scale. mp9 runs as mp5 of mp5 and mp13 as mp5 of mp9: at stride
    1 with INT8_MIN padding a 5-window of 5-window maxima is the max over
    the 9-window they cover (clipped to the image alike), so the values are
    the three pools' own."""
    mp5 = int_maxpool(x_q, 5, 1, 2)
    mp9 = int_maxpool(mp5, 5, 1, 2)
    return torch.cat([x_q, mp5, mp9, int_maxpool(mp9, 5, 1, 2)], dim=-1)


def int_zero_pad_maxpool_s1(x_q: torch.Tensor) -> torch.Tensor:
    """ZeroPad2d((0,1,0,1)) + MaxPool2d(2, stride=1) on int8 NHWC (the
    darknet_light tail pool, reference backbone/darknet.py:232-235):
    zero padding, not INT8_MIN, exactly as the reference pads, then the
    int8 reductions of ``int_maxpool``."""
    return int_maxpool(torch.nn.functional.pad(x_q, (0, 0, 0, 1, 0, 1)),
                       2, 1)


def _forward(m: Int8Model, x_q: torch.Tensor, rounding: str,
             input_s2d: bool, counts: Optional[torch.Tensor] = None):
    """``int8_forward``'s walk; with ``counts`` (int32 [10]) each layer's
    kernel adds its overflow count to its entry."""
    from yolo_tpu_torch.kernels import int8_conv as K

    if input_s2d and m.per_channel:
        raise ValueError(
            "per-channel weight scales run on the plain NHWC conv path only "
            "(the s2d form phase-packs C_out, as in the JAX package); "
            "rebuild the detect fn without input_s2d")
    tables = (m.shift_tables or {}).get(rounding, {})
    out = x_q
    for i, name in enumerate(QUANT_LAYER_NAMES):
        kw = dict(m.layer_shifts(i, name), leaky=(name != "pred"),
                  rounding=rounding)
        if input_s2d and i == 0:
            out = int8_conv_pool_s2d_core(out, m.w_q[name], m.b_q[name],
                                          c_in=3, packed=m.s2d_packed, **kw)
            continue
        if counts is not None:
            kw["overflow"] = counts[i:i + 1]
        if counts is not None or np.ndim(kw["sw"]):
            kw["shifts"] = tables.get(name)
        if name in POOLED:
            fn, kw["pool"] = K.int8_conv3x3_im2col, True
        else:
            fn = K.int8_conv3x3_requant
        packed = m.nhwc_packed if i == 0 else (m.packed or {}).get(name)
        out = fn(out, m.w_q[name], m.b_q[name], packed=packed, **kw)
    # dequantize the head to float for decode
    return out.to(torch.float32) * (2.0 ** -m.sa["pred"])


def int8_forward(m: Int8Model, x_q: torch.Tensor,
                 rounding: str = "nearest",
                 input_s2d: bool = False) -> torch.Tensor:
    """int8 input [B, H, W, 3] (or, with ``input_s2d``, the padded s2d
    layout [B, H/2+3, W/2+3, 12]) -> float head [B, H/16, W/16, C].

    Layer routing: conv1 on s2d input runs the s2d conv+pool form
    (int8_conv3x3_pool_s2d, with ``m.s2d_packed``), on NHWC input
    int8_conv3x3_im2col(pool=True) with ``m.nhwc_packed``; every other
    pool layer runs int8_conv3x3_im2col(pool=True); the rest
    int8_conv3x3_requant; both with the weights of ``m.packed``; each
    packed form where ``pack_conv3x3`` made it. A per-channel sw (an int32
    [C_out] array, ``fixed_point.quantize_model(per_channel=True)`` of
    the JAX package) runs on NHWC input only, as in the JAX package
    (ValueError with ``input_s2d``), its layers on the per-column shift
    tables of ``m.shift_tables``.
    """
    return _forward(m, x_q, rounding, input_s2d)


def int8_forward_diagnostics(m: Int8Model, x_q: torch.Tensor,
                             rounding: str = "nearest"):
    """int8 NHWC input [B, H, W, 3] -> (head, {layer: int32 count}): the
    forward of ``int8_forward`` on the same routes, each layer counting the
    accumulator values that hit the int16 clamp this batch, as the JAX
    package's ``int8_forward_diagnostics`` counts them: every conv output
    after the accumulator shift and the bias, before the clamp and before
    any pool. Any nonzero count means the retune table is too aggressive
    for this input. On a CUDA tensor the counting kernels add to one int32
    counter per layer on the card (the counts are 0-d int32 tensors
    there); the CPU route counts in the plain versions."""
    counts = torch.zeros(len(QUANT_LAYER_NAMES), dtype=torch.int32,
                         device=x_q.device)
    head = _forward(m, x_q, rounding, input_s2d=False, counts=counts)
    return head, dict(zip(QUANT_LAYER_NAMES, counts))
