"""Fused int8 conv + fixed-point requant: CUDA kernels and their plain
PyTorch versions (counterpart of ``yolo_tpu/kernels/int8_conv.py``).

Wrappers with the JAX package's signatures (minus ``interpret`` and the
TPU tiling arguments), plus the space-to-depth input form conv1 uses:

- ``int8_conv3x3_requant``      replaces ``_conv_kernel`` (K1);
- ``int8_conv3x3_pool_requant`` replaces ``_pool_matmul_kernel`` (K2),
  and so does ``int8_conv3x3_pool_s2d`` (its s2d-input form);
- ``int8_conv3x3_im2col``       replaces ``_im2col_kernel`` (K3);
- ``int8_res_block``            replaces ``_res_block_kernel`` (K4);
- ``int8_conv_requant``         replaces no Pallas kernel: it is the card's
  counterpart of XLA's integer conv in ``fixed_point.int_conv_requant``
  (k 1 or 3, stride, padding, a two-part concat input, a leaky slope).

Every stride-1 3x3 conv of one input part with C_in % 32 == 0
(``conv3x3_wgmma_route``: all of K1's main-path layers and the
yolo_v3 head's nine 3x3s) launches the wgmma conv of
``csrc/int8_conv3x3_wgmma.cu``, every such conv over two parts of C_in %
32 == 0 (tiny_yolo_v3's conv_set_1, yolo_v2's convsets_2.0) its two-part
form (weights from ``pack_conv3x3_parts_weights``; both forms over
halo slabs of 128 channels, their slab walk, where C_in >= 1,024 in whole
slabs: yolo_v2's convsets_1.x and convsets_2.0, tiny's conv_set_2),
every such conv at
stride 2 (``conv3x3_s2_wgmma_route``: darknet53's five downsampling
convs) that kernel's stride-2 form, and every K3 conv with its pool and
C_in % 32 == 0 or C_in == 16 (``conv3x3_pool_wgmma_route``: slim's
conv2, conv3_2 and conv4_2, tiny_yolo_v3's conv_2) its pooled form;
those three read their weights K-major, packed once per model by
``pack_conv3x3_weights``. ``int8_conv3x3_requant`` and
``int8_conv3x3_im2col`` also take a per-channel sw (an int32 [C_out]
array) and an overflow counter: the stride-1 and pooled forms and the
mma.sync conv then read a per-column shift table (``acc_shift_table``,
made once per model by ``fixed_point.Int8Model.pack_conv3x3``), the
counting ones add to the counter; so does the NHWC form of K2's kernel
below. ``int8_conv_requant`` takes a per-channel sw on every route named
below (the per-column forms of the stride-1 (one or two parts),
stride-2, entry and 1x1 kernels, on the tables of ``conv_shift_tables``,
made once per model by ``int8_yolo_v3.Int8YoloV3.pack_conv3x3s`` and
``int8_models._Int8Named.pack``); so does ``int8_res_block``
(K4's per-column form, on a table per conv made once per model by
``Int8YoloV3.pack_res_blocks``); its mma.sync conv and K2 on the s2d
layout refuse one on a CUDA tensor. The
thin-input convs run on the row-streaming wgmma kernels of
``csrc/int8_entry_conv.cu``: K2 on the s2d layout with C_in <= 4 and
C_out <= 32 (``pool_s2d_wgmma_route``: slim's conv1; weights from
``pack_pool_s2d_weights``), the same kernel's NHWC form on every pooled
conv of C_in <= 4 and C_out <= 32 on NHWC input (``pool_nhwc_wgmma_route``:
slim's conv1 there, with a scalar or a per-channel sw and the overflow
counter; weights from ``pack_pool_nhwc_weights``) and every stride-1 3x3
of one part with C_in <= 3 and C_out <= 64 (``entry_conv3x3_route``:
yolo_v3's entry conv; weights from ``pack_entry_conv_weights``). Every
1x1 of stride 1, pad 0, one or two parts of C_in % 16 == 0
(``conv1x1_wgmma_route``: yolo_v3's nine 1x1s, two concat 1x1s and three
preds) runs as a GEMM on the wgmma kernel of
``csrc/int8_conv1x1_wgmma.cu``, its weights resident in shared memory
(packed K-major once per model by ``pack_conv1x1_weights``). The other
K1, K2 and K3 shapes and the other ``int8_conv_requant`` shapes launch the
tensor-core implicit GEMM of ``csrc/int8_conv.cuh`` (mma.sync; built by
``csrc/int8_conv.cu`` and ``csrc/int8_conv_general.cu``), K4 the fused
block of ``csrc/int8_res_block.cu``. The wgmma kernels are fed by a TMA ring
(``csrc/int8_wgmma.cuh``) and share their epilogue and tile planner
(``csrc/int8_wgmma_conv.cuh``). Each file's header note says what bounds
them. A wrapper given a CUDA tensor launches the kernel, adds one to its
count in ``launch_counts()`` (and in ``launch_counts_by_entry()``, under
the C entry launched, and ``launch_counts_by_input()``, under the shape
of its input) once the launch has succeeded, and raises if it
fails or if the kernel does not take its arguments; given a CPU tensor
it runs the plain version, which is exact integer arithmetic: float64
per-tap matmuls (exact while |acc| < 2^53; yolo_v3 reaches 1.5e8) and the
int32 requant chain of ``fixed_point``.
"""

from __future__ import annotations

import collections
import ctypes
import functools

import numpy as np
import torch

from yolo_tpu_torch.kernels import (  # noqa: F401  (re-exported)
    KERNEL_NAMES, launch, launch_counts, launch_counts_by_entry,
    launch_counts_by_input, reset_launch_counts, route)
from yolo_tpu_torch.quant import fixed_point as fp
from yolo_tpu_torch.utils import profiling


def _bias_at_retune(b_q: torch.Tensor, sb: int, retune: int,
                    rounding: str) -> torch.Tensor:
    """Bias shifted to the retune scale, exactly, as int32 [C_out]."""
    return fp._shift(b_q.to(torch.int32), sb - retune, rounding).contiguous()


def _check_scalar_shifts(**shifts):
    for k, v in shifts.items():
        if np.ndim(v):
            raise ValueError(
                f"{k} must be a scalar: this kernel's epilogue takes one "
                f"shift per layer (a per-channel sw runs in "
                f"int8_conv3x3_requant, int8_conv3x3_im2col, "
                f"int8_res_block and on int8_conv_requant's wgmma routes)")


def _sw_ok(sw, c_out) -> bool:
    """A scalar sw, or a per-channel one: 1-D, ``c_out`` long."""
    return np.ndim(sw) == 0 or (np.ndim(sw) == 1 and c_out is not None
                                and len(sw) == c_out)


def _check_sw(sw, c_out):
    if not _sw_ok(sw, c_out):
        raise ValueError(f"sw must be a scalar or a per-channel int array "
                         f"of length C_out = {c_out}, got shape "
                         f"{np.shape(sw)}")


# ---------------------------------------------------------------------------
# Per-column accumulator shift tables and overflow counters.
# ---------------------------------------------------------------------------


# the shift-table entry whose shift gives 0 (nearest) or v >> 31 (floor),
# and -SHIFT_CODE_MAX the one whose left shift gives 0
SHIFT_CODE_MAX = 32
TABLE_ALIGN = 128  # tables are padded as the biases are, to whole tiles
# the wgmma 1x1 kernel's tables and biases: whole tiles of up to 256 columns
CONV1X1_ALIGN = 256


def acc_shift_codes(sw, sa_in, retune, rounding, c_out) -> np.ndarray:
    """Each output column's accumulator shift sw + sa_in - retune as the
    entry the kernels' shift reads (``_shift`` of that entry, the scalar
    semantics of ``fixed_point._shift``): int32 [C_out], in [-32, 32].

    A per-channel ``sw`` follows ``fixed_point._shift_arr``: there a
    shift of 31 or more gives 0 under nearest (the scalar ``_shift``
    gives (v + 2^30 - (v < 0)) >> 31 at 31), so such columns get entry
    32; left shifts of 32 or more give 0 (entry -32). A scalar ``sw``
    keeps ``_shift``'s semantics in every column."""
    _check_rounding(rounding)
    s = np.asarray(sw, np.int64) + int(sa_in) - int(retune)
    if s.ndim and rounding == "nearest":
        s = np.where(s >= 31, SHIFT_CODE_MAX, s)
    s = np.clip(s, -SHIFT_CODE_MAX, SHIFT_CODE_MAX)
    return np.broadcast_to(s, (c_out,)).astype(np.int32)


def short_columns(codes) -> bool:
    """Whether every entry lies in [0, 31], where the kernels' short shift
    form (no left shift, no mask) gives the entry's shift."""
    codes = np.asarray(codes)
    return bool(((codes >= 0) & (codes <= 31)).all())


def acc_shift_table(sw, sa_in, retune, rounding, c_out, device,
                    align=TABLE_ALIGN) -> torch.Tensor:
    """The per-column shift table the conv kernels read where ``sw`` is
    per-channel or overflows are counted: ``acc_shift_codes`` as int32
    [C_out rounded up to ``align``] on ``device``, 0 past C_out (a zero
    accumulator stays 0). Made once per model and layer by
    ``Int8Model.pack_conv3x3`` and ``Int8YoloV3.pack_conv3x3s``; a wrapper
    given none makes one per call."""
    table = np.zeros(-(-c_out // align) * align, np.int32)
    table[:c_out] = acc_shift_codes(sw, sa_in, retune, rounding, c_out)
    _PACKS["shift_table"] += 1
    return torch.as_tensor(table).to(device)


def shift_table_count() -> int:
    """Calls of ``acc_shift_table`` since the last reset."""
    return _PACKS["shift_table"]


def reset_shift_table_count() -> None:
    _PACKS["shift_table"] = 0


def conv_shift_tables(sw, sas, retune, rounding, c_out, device,
                      align=TABLE_ALIGN):
    """The per-column shift tables of a general conv with a per-channel
    ``sw`` whose input parts have the scales ``sas``: one
    ``acc_shift_table`` per distinct input scale, in the order the parts
    first take it (``fixed_point.int_conv_requant`` groups the parts'
    partials by input scale and shifts each group by sw[c] + sa -
    retune). What ``int8_conv_requant`` takes as ``shifts``."""
    return tuple(acc_shift_table(sw, sa, retune, rounding, c_out, device,
                                 align)
                 for sa in dict.fromkeys(int(sa) for sa in sas))


def _table_for(shifts, sw, sa_in, retune, rounding, c_out, dev,
               align=TABLE_ALIGN):
    """``shifts`` checked, or a table made for this call where None."""
    if shifts is None:
        return acc_shift_table(sw, sa_in, retune, rounding, c_out, dev,
                               align)
    need = -(-c_out // align) * align
    if (shifts.dtype != torch.int32 or shifts.device != dev
            or shifts.ndim != 1 or shifts.shape[0] < need
            or not shifts.is_contiguous()):
        raise ValueError(f"the shift table must be a contiguous int32 "
                         f"[>= {need}] tensor on {dev}, got {shifts.dtype} "
                         f"{list(shifts.shape)} on {shifts.device}")
    return shifts


def _check_counter(overflow, dev):
    if (overflow.dtype != torch.int32 or overflow.device != dev
            or overflow.numel() != 1):
        raise ValueError(f"the overflow counter must be one int32 on {dev},"
                         f" got {overflow.dtype} {list(overflow.shape)} on "
                         f"{overflow.device}")


# ---------------------------------------------------------------------------
# Plain versions (exact integer arithmetic, any device).
# ---------------------------------------------------------------------------


def _conv_acc(xp: torch.Tensor, w_q: torch.Tensor,
              stride: int = 1) -> torch.Tensor:
    """int32 accumulator of a k x k valid conv over an already padded
    [B, Hp, Wp, C_in] int8 input and HWIO weights -> [B, Ho, Wo, C_out]."""
    k = w_q.shape[0]
    ho = (xp.shape[1] - k) // stride + 1
    wo = (xp.shape[2] - k) // stride + 1
    xf = xp.to(torch.float64)
    wf = w_q.to(torch.float64)
    acc = None
    for dy in range(k):
        for dx in range(k):
            tap = xf[:, dy:dy + stride * (ho - 1) + 1:stride,
                     dx:dx + stride * (wo - 1) + 1:stride, :]
            p = torch.matmul(tap, wf[dy, dx])
            acc = p if acc is None else acc + p
    return acc.to(torch.int32)


def _plain_conv_requant(xp, w_q, b_q, *, sw, sb, sa_in, sa_out, retune,
                        leaky, pool, rounding, overflow=None):
    acc = _conv_acc(xp, w_q)
    out = fp._requant(acc, _bias_at_retune(b_q, sb, retune, rounding),
                      acc_shift=sa_in + np.asarray(sw) - retune
                      if np.ndim(sw) else sa_in + sw - retune,
                      out_shift=retune - sa_out, leaky=leaky,
                      rounding=rounding, overflow=overflow)
    return fp._maxpool_int(out) if pool else out


def _pad1(x_q: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.pad(x_q, (0, 0, 1, 1, 1, 1))


def int8_conv3x3_requant_plain(x_q, w_q, b_q, *, sw, sb, sa_in, sa_out,
                               retune, leaky=True, rounding="nearest",
                               overflow=None):
    """``sw``: an int or a per-channel int32 [C_out] array (``fixed_point.
    _shift_arr``); ``overflow``: an int32 counter to which the values
    outside int16 after the accumulator shift and the bias are added."""
    return _plain_conv_requant(_pad1(x_q), w_q, b_q, sw=sw, sb=sb,
                               sa_in=sa_in, sa_out=sa_out, retune=retune,
                               leaky=leaky, pool=False, rounding=rounding,
                               overflow=overflow)


def int8_conv3x3_im2col_plain(x_q, w_q, b_q, *, sw, sb, sa_in, sa_out,
                              retune, leaky=True, pool=False,
                              rounding="nearest", overflow=None):
    """As ``int8_conv3x3_requant_plain``, ``leaky`` also a float slope in
    [0, 1] (the Q16 rational of ``fixed_point._leaky_int_slope``: the
    darknet 0.1 of tiny_yolo_v3's conv_2); with ``pool`` the 2x2/2 max
    pool of the requantized conv (the chain is monotone, so it equals the
    pool of the accumulator that the kernels take) and the counter counts
    every conv output before the pool."""
    _slope_num(leaky)
    return _plain_conv_requant(_pad1(x_q), w_q, b_q, sw=sw, sb=sb,
                               sa_in=sa_in, sa_out=sa_out, retune=retune,
                               leaky=leaky, pool=pool, rounding=rounding,
                               overflow=overflow)


def int8_conv3x3_pool_requant_plain(x_q, w_q, b_q, *, sw, sb, sa_in,
                                    sa_out, retune, leaky=True,
                                    rounding="nearest", assembly="stride2"):
    kw = dict(sw=sw, sb=sb, sa_in=sa_in, sa_out=sa_out, retune=retune,
              leaky=leaky, rounding=rounding)
    if assembly == "s2d":
        return int8_conv3x3_pool_s2d_plain(fp.s2d_input(x_q), w_q, b_q,
                                           c_in=x_q.shape[-1], **kw)
    if assembly != "stride2":
        raise ValueError(f"unknown assembly {assembly!r}")
    return _plain_conv_requant(_pad1(x_q), w_q, b_q, pool=True, **kw)


def _s2d_phase_weights(w_q: torch.Tensor, c_in: int, c_out: int):
    """``fixed_point._s2d_phase_weights`` in torch ops (so an exported
    program computes it from its weights): [3, 3, C_in, C_out] -> [2, 2,
    4 C_in, 4 C_out] block-conv weights over the s2d input, one output
    group per pool phase."""
    w4 = w_q.new_zeros((2, 2, 4 * c_in, 4 * c_out))
    for a in range(2):
        for bph in range(2):
            for j in range(3):
                for k in range(3):
                    r_, py = divmod(a + j, 2)
                    s_, px = divmod(bph + k, 2)
                    ci = (py * 2 + px) * c_in
                    co = (a * 2 + bph) * c_out
                    w4[r_, s_, ci:ci + c_in, co:co + c_out] = w_q[j, k]
    return w4


def int8_conv3x3_pool_s2d_plain(x2, w_q, b_q, *, c_in, sw, sb, sa_in,
                                sa_out, retune, leaky=True,
                                rounding="nearest"):
    """The JAX package's ``int8_conv_pool_s2d_core`` in torch: a 2x2 block
    conv with phase-packed weights over the s2d layout, requant, then
    the max over the four phase groups."""
    b, hb, wb, _ = x2.shape
    ho, wo = hb - 3, wb - 3
    c_out = w_q.shape[-1]
    w4 = _s2d_phase_weights(w_q.to(torch.float64), c_in, c_out)
    xf = x2.to(torch.float64)
    acc = None
    for r in range(2):
        for s in range(2):
            p = torch.matmul(xf[:, r:r + hb - 1, s:s + wb - 1, :], w4[r, s])
            acc = p if acc is None else acc + p
    acc = acc.to(torch.int32)                  # [B, hb-1, wb-1, 4*C_out]
    bias4 = _bias_at_retune(b_q, sb, retune, rounding).repeat(4)
    o8 = fp._requant(acc, bias4,
                     acc_shift=sw + sa_in - retune,
                     out_shift=retune - sa_out, leaky=leaky,
                     rounding=rounding)
    # pooled (u, v) lives at block-conv output (u+1, v+1)
    o8 = o8[:, 1:1 + ho, 1:1 + wo, :]
    z = o8[..., :c_out]
    for p in range(1, 4):
        z = torch.maximum(z, o8[..., p * c_out:(p + 1) * c_out])
    return z.contiguous()


# ---------------------------------------------------------------------------
# CUDA launch.
# ---------------------------------------------------------------------------


def _check_rounding(rounding):
    if rounding not in ("nearest", "floor"):
        raise ValueError(f"unknown rounding {rounding!r}")


def _slope_num(leaky) -> int:
    """The kernels' LeakyReLU as the Q16 numerator round(slope * 65536), as
    ``fixed_point._leaky_int_slope``: 8192 for True (0.125; exactly the
    arithmetic shift of ``fixed_point._leaky_int``), 65536 (slope 1, the
    identity) for False or 0, else a float slope in (0, 1]."""
    if isinstance(leaky, (bool, np.bool_)):
        return 8192 if leaky else 65536
    if not isinstance(leaky, (int, float, np.integer, np.floating)):
        raise ValueError(f"leaky must be False, True or a float slope, got "
                         f"{leaky!r}")
    slope = float(leaky)
    if not 0 <= slope <= 1:
        raise ValueError(f"leaky slope must lie in [0, 1], got {slope}")
    return int(round(slope * 65536)) if slope else 65536


def _check_leaky_flag(leaky):
    """K1-K3 take the 0.125 shift or no activation."""
    if leaky is not True and leaky is not False:
        raise ValueError(f"leaky must be True or False, got {leaky!r}")


def _check_operand(name, t, dev, dtype, shape):
    if t.dtype != dtype or t.device != dev or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must be {dtype} {list(shape)} on {dev}, got "
                         f"{t.dtype} {list(t.shape)} on {t.device}")


# the labels of a launch's address checks (``launch``'s ``align``): the
# output, a per-column shift table (8-byte pairs), an overflow counter
OUT, TABLE, COUNTER = ("the output allocation", "the shift table",
                       "the overflow counter")


def _launch(kernel, x, w_q, b_q, *, h, w, c_in, pool, s2d, sw, sb, sa_in,
            sa_out, retune, leaky, rounding, shifts=None,
            overflow=None) -> torch.Tensor:
    """Check the operands and launch the conv3x3 kernel on the current
    stream, counting the launch under ``kernel``; returns the int8 output.
    A per-channel ``sw`` or an ``overflow`` counter (int32, which the
    kernel adds to) runs the epilogue on a per-column shift table
    (``shifts``, made for this call where None), but not on the s2d
    layout. Raises on anything the kernel does not take and on a failed
    launch."""
    _check_rounding(rounding)
    _check_leaky_flag(leaky)
    _check_scalar_shifts(sb=sb, sa_in=sa_in, sa_out=sa_out, retune=retune)
    dev = x.device
    if x.dtype != torch.int8 or not x.is_contiguous():
        raise ValueError("x must be a contiguous int8 tensor")
    c_out = w_q.shape[-1]
    _check_sw(sw, c_out)
    cols = bool(np.ndim(sw)) or overflow is not None
    if s2d and cols:
        raise ValueError("the s2d-layout kernel phase-packs C_out: it takes "
                         "neither a per-channel sw nor an overflow counter")
    if overflow is not None:
        _check_counter(overflow, dev)
    _check_operand("w_q", w_q, dev, torch.int8, (3, 3, c_in, c_out))
    if tuple(b_q.shape) != (c_out,) or b_q.device != dev:
        raise ValueError(f"b_q must be [{c_out}] on {dev}")
    if (pool or s2d) and (h % 2 or w % 2):
        raise ValueError("pooled conv requires even H, W")
    w_c = w_q.contiguous()
    bsz = x.shape[0]
    if bsz * h * w >= 2 ** 31:
        raise ValueError("B * H * W must stay below 2^31; split the batch")
    ho, wo = (h // 2, w // 2) if pool else (h, w)
    out = torch.empty((bsz, ho, wo, c_out), dtype=torch.int8, device=dev)
    if out.numel() == 0:
        return out
    bias_rt = _bias_at_retune(b_q, sb, retune, rounding)
    table = (_table_for(shifts, sw, sa_in, retune, rounding, c_out, dev)
             if cols else None)
    launch(kernel, "yolo_int8_conv3x3_requant",
           x, w_c, bias_rt, out, table, overflow,
           bsz, h, w, c_in, c_out, 0 if cols else sa_in + sw - retune,
           retune - sa_out, int(leaky), int(rounding == "nearest"),
           int(pool), int(s2d), writes=(out, overflow),
           # 4-byte loads on the s2d layout, 16-byte loads when C_in % 16
           # == 0
           align=[("x", x, 4 if s2d else 16 if c_in % 16 == 0 else 1),
                  ("w_q", w_c, 4), (OUT, out, 16), (TABLE, table, 8),
                  (COUNTER, overflow, 4)])
    return out


# ---------------------------------------------------------------------------
# Public wrappers.
#
# Inside ``utils.profiling.count_flops`` each reports its logical conv once
# (``profiling.reported``), on every route: 2 FLOPs per multiply-add over
# the taps inside the image, and its input, weight, bias and output bytes.
# ---------------------------------------------------------------------------


def _conv_cost(x, b_q, out, c_in, k=3, stride=1, padding=1, hw=None):
    """(flops, bytes) of a k x k conv of ``x`` [B, H, W, .] (its pixels,
    or ``hw``) from ``c_in`` to ``len(b_q)`` channels that wrote ``out``."""
    c_out = b_q.shape[0]
    b, h, w = x.shape[:3]
    return (profiling.conv_flops(b, hw or (h, w), c_in, c_out, k, stride,
                                 padding),
            profiling.nbytes(x, b_q, out) + k * k * c_in * c_out)


def _cost_3x3(out, x_q, b_q, **_):
    return _conv_cost(x_q, b_q, out, x_q.shape[-1])


def _cost_pool_s2d(out, x2, b_q, c_in, **_):
    hb, wb = x2.shape[1:3]
    return _conv_cost(x2, b_q, out, c_in, hw=(2 * (hb - 3), 2 * (wb - 3)))


def _cost_general(out, x, w_q, b_q, sa_in, padding, stride, packed, **_):
    parts = _parts(x, sa_in)
    c_in = sum(xq.shape[-1] for xq, _ in parts)
    flops, nb = _conv_cost(parts[0][0], b_q, out, c_in,
                           _kernel_size(w_q, packed, c_in), stride, padding)
    return flops, nb + profiling.nbytes(*(xq for xq, _ in parts[1:]))


def _cost_res_block(out, x_q, b1_q, b2_q, **_):
    f1, n1 = _conv_cost(x_q, b1_q, None, x_q.shape[-1], 1, 1, 0)
    f2, n2 = _conv_cost(x_q, b2_q, out, b1_q.shape[0])
    return f1 + f2, n1 + n2 - profiling.nbytes(x_q)


@profiling.reported(_cost_3x3)
def int8_conv3x3_requant(x_q, w_q, b_q, *, sw, sb, sa_in, sa_out, retune,
                         leaky=True, rounding="nearest", packed=None,
                         shifts=None, overflow=None):
    """Fused int8 conv3x3(stride 1, pad 1) + requant: int8 [B,H,W,C_in]
    at scale 2^sa_in -> int8 [B,H,W,C_out] at scale 2^sa_out.

    ``sw``: an int, or a per-channel int32 [C_out] array (``fixed_point.
    _shift_arr``). ``packed``: the weights from ``pack_conv3x3_weights``
    (then ``w_q`` may be None). On a CUDA tensor with C_in % 32 == 0 the
    wgmma kernel reads that form; given only the HWIO weights it packs
    them for this call. ``shifts``: the per-column table of
    ``acc_shift_table`` that the kernels read for a per-channel ``sw`` or
    when counting (made for this call where None). ``overflow``: an int32
    counter on the input's device to which the values outside int16 after
    the accumulator shift and the bias are added (``int8_forward_
    diagnostics``). The CPU route reads the HWIO weights where given."""
    kw = dict(sw=sw, sb=sb, sa_in=sa_in, sa_out=sa_out, retune=retune,
              leaky=leaky, rounding=rounding)
    if route(x_q) == "plain":
        return int8_conv3x3_requant_plain(
            x_q, _hwio(w_q, packed, x_q.shape[-1]), b_q, overflow=overflow,
            **kw)
    b, h, w, c_in = x_q.shape
    if conv3x3_wgmma_route(3, 1, 1, 1, c_in, sw, c_out=b_q.shape[0]):
        _check_leaky_flag(leaky)
        return _launch_conv3x3_wgmma("int8_conv3x3_requant", x_q, w_q, b_q,
                                     packed, shifts=shifts,
                                     overflow=overflow, **kw)
    return _launch("int8_conv3x3_requant", x_q, _hwio(w_q, packed, c_in),
                   b_q, h=h, w=w, c_in=c_in, pool=False, s2d=False,
                   shifts=shifts, overflow=overflow, **kw)


@profiling.reported(_cost_3x3)
def int8_conv3x3_im2col(x_q, w_q, b_q, *, sw, sb, sa_in, sa_out, retune,
                        leaky=True, pool=False, rounding="nearest",
                        packed=None, shifts=None, overflow=None):
    """Fused int8 conv3x3(s1, p1) + requant [+ 2x2/2 max pool, taken on the
    int32 accumulator before requant: exact, the chain is monotone].

    ``packed``: the weights from ``pack_conv3x3_weights``, or for a pooled
    conv of C_in <= 4 from ``pack_pool_nhwc_weights`` (then ``w_q`` may be
    None). On a CUDA tensor a pooled conv that ``conv3x3_pool_wgmma_route``
    takes runs the wgmma conv3x3 kernel's pooled form, which reads the
    first form, and one that ``pool_nhwc_wgmma_route`` takes (slim's conv1
    on NHWC input) the NHWC form of K2's wgmma kernel, which reads the
    second (each packed for this call where only the HWIO weights are
    given). ``sw``, ``shifts`` and ``overflow`` as in
    ``int8_conv3x3_requant``; with ``pool`` the counter counts every conv
    output before the pool. ``leaky``: True (0.125), False, or on the CPU
    and the wgmma pooled form a float slope (the Q16 rational; the
    darknet 0.1). The CPU route reads the HWIO weights where given."""
    kw = dict(sw=sw, sb=sb, sa_in=sa_in, sa_out=sa_out, retune=retune,
              leaky=leaky, rounding=rounding)
    c_in, c_out = x_q.shape[-1], b_q.shape[0]
    if route(x_q) == "plain":
        return int8_conv3x3_im2col_plain(
            x_q, _hwio(w_q, packed, c_in, c_out), b_q, pool=pool,
            overflow=overflow, **kw)
    if pool and conv3x3_pool_wgmma_route(c_in, sw, c_out=c_out):
        return _launch_conv3x3_wgmma("int8_conv3x3_im2col", x_q, w_q, b_q,
                                     packed, form="pool", shifts=shifts,
                                     overflow=overflow, **kw)
    if pool and pool_nhwc_wgmma_route(c_in, c_out, sw):
        _check_leaky_flag(leaky)
        return _launch_pool_nhwc_wgmma("int8_conv3x3_im2col", x_q, w_q, b_q,
                                       packed, shifts=shifts,
                                       overflow=overflow, **kw)
    b, h, w, _ = x_q.shape
    return _launch("int8_conv3x3_im2col", x_q,
                   _hwio(w_q, packed, c_in, c_out), b_q, h=h, w=w,
                   c_in=c_in, pool=pool, s2d=False, shifts=shifts,
                   overflow=overflow, **kw)


@profiling.reported(_cost_3x3)
def int8_conv3x3_pool_requant(x_q, w_q, b_q, *, sw, sb, sa_in, sa_out,
                              retune, leaky=True, rounding="nearest",
                              assembly="stride2"):
    """Fused int8 conv3x3(s1, p1) + 2x2/2 max pool + requant at pooled
    resolution: int8 [B,H,W,C_in] -> int8 [B,H/2,W/2,C_out].

    ``assembly='stride2'`` reads the NHWC input directly (on a CUDA tensor
    a conv that ``pool_nhwc_wgmma_route`` takes runs the NHWC form of K2's
    wgmma kernel, its weights packed for this call); ``'s2d'`` first lays
    it out as padded space-to-depth (``fixed_point.s2d_input``) and runs
    the s2d-input form, ``int8_conv3x3_pool_s2d``."""
    kw = dict(sw=sw, sb=sb, sa_in=sa_in, sa_out=sa_out, retune=retune,
              leaky=leaky, rounding=rounding)
    if assembly not in ("stride2", "s2d"):
        raise ValueError(f"unknown assembly {assembly!r}")
    if route(x_q) == "plain":
        return int8_conv3x3_pool_requant_plain(x_q, w_q, b_q,
                                               assembly=assembly, **kw)
    b, h, w, c_in = x_q.shape
    if assembly == "s2d":
        if h % 2 or w % 2:
            raise ValueError("pooled conv requires even H, W")
        return int8_conv3x3_pool_s2d(fp.s2d_input(x_q).contiguous(), w_q,
                                     b_q, c_in=c_in, **kw)
    if pool_nhwc_wgmma_route(c_in, b_q.shape[0], sw):
        _check_leaky_flag(leaky)
        return _launch_pool_nhwc_wgmma("int8_conv3x3_pool_requant", x_q,
                                       w_q, b_q, None, **kw)
    return _launch("int8_conv3x3_pool_requant", x_q, w_q, b_q, h=h, w=w,
                   c_in=c_in, pool=True, s2d=False, **kw)


@profiling.reported(_cost_pool_s2d)
def int8_conv3x3_pool_s2d(x2, w_q, b_q, *, c_in, sw, sb, sa_in, sa_out,
                          retune, leaky=True, rounding="nearest",
                          packed=None):
    """conv3x3 + requant + 2x2 pool reading the padded space-to-depth
    layout [B, H/2+3, W/2+3, 4*C_in] (``fixed_point.s2d_input_np``) ->
    int8 [B, H/2, W/2, C_out]. Counts as a launch of
    ``int8_conv3x3_pool_requant`` (K2).

    ``packed``: the weights from ``pack_pool_s2d_weights`` (then ``w_q``
    may be None; C_out is ``b_q``'s length). On a CUDA tensor a conv that
    ``pool_s2d_wgmma_route`` takes (slim's conv1; the darknet entry convs
    of tiny_yolo_v3 and yolo_v2) runs the wgmma kernel of
    ``csrc/int8_entry_conv.cu``, which reads that form (packed for this
    call where only the HWIO weights are given) and any ``leaky`` slope;
    other shapes run the mma.sync pool_s2d kernel of ``csrc/int8_conv.cu``
    (True or False only). The CPU route reads the HWIO weights where
    given."""
    kw = dict(sw=sw, sb=sb, sa_in=sa_in, sa_out=sa_out, retune=retune,
              leaky=leaky, rounding=rounding)
    _slope_num(leaky)  # every route: False, True or a slope in [0, 1]
    if x2.ndim != 4 or x2.shape[-1] != 4 * c_in:
        raise ValueError(f"s2d input must be [B, H/2+3, W/2+3, {4 * c_in}], "
                         f"got {tuple(x2.shape)}")
    # the phase-packed form has 4 * C_out columns (as in the JAX package,
    # which runs per-channel sw only on its plain conv path)
    _check_scalar_shifts(sw=sw)
    c_out = b_q.shape[0]
    if route(x2) == "plain":
        return int8_conv3x3_pool_s2d_plain(
            x2, _s2d_hwio(w_q, packed, c_in, c_out), b_q, c_in=c_in, **kw)
    if pool_s2d_wgmma_route(c_in, c_out, sw):
        return _launch_pool_s2d_wgmma(x2, w_q, b_q, packed, c_in=c_in, **kw)
    b, hb, wb, _ = x2.shape
    return _launch("int8_conv3x3_pool_requant", x2,
                   _s2d_hwio(w_q, packed, c_in, c_out), b_q,
                   h=2 * (hb - 3), w=2 * (wb - 3), c_in=c_in, pool=True,
                   s2d=True, **kw)


# ---------------------------------------------------------------------------
# The general conv (int_conv_requant) and the fused residual block (K4).
# ---------------------------------------------------------------------------


def _parts(x, sa_in):
    """A conv input as a list of (int8 tensor, sa) parts."""
    return list(x) if isinstance(x, (list, tuple)) else [(x, sa_in)]


def int8_conv_requant_plain(x, w_q, b_q, *, sw, sb, sa_in, sa_out, retune,
                            padding=0, stride=1, leaky=True,
                            rounding="nearest", packed=None):
    """``fixed_point.int_conv_requant`` of the JAX package, without the
    residual: each part's raw int32 partial is summed with the partials of
    equal shift, each group shifted to the retune scale, then the requant
    chain. ``sw`` may be per-channel (an int32 [C_out] array). The HWIO
    weights are used where given, else those of ``packed`` (any packed
    form ``int8_conv_requant`` takes, a two-part 3x3's included)."""
    _check_rounding(rounding)
    _slope_num(leaky)
    parts = _parts(x, sa_in)
    if w_q is None:
        w_q = _hwio_parts(packed, [xq.shape[-1] for xq, _ in parts])
    sw_pc = np.ndim(sw) > 0
    raw: dict = {}
    c_ofs = 0
    for xq, sa in parts:
        c = xq.shape[-1]
        xp = torch.nn.functional.pad(
            xq, (0, 0, padding, padding, padding, padding))
        p = _conv_acc(xp, w_q[:, :, c_ofs:c_ofs + c], stride)
        c_ofs += c
        k = int(sa) if sw_pc else int(sw) + int(sa) - retune
        raw[k] = p if k not in raw else raw[k] + p
    acc = None
    for k, p in raw.items():
        p = fp._shift(p, (np.asarray(sw) + k - retune) if sw_pc else k,
                      rounding)
        acc = p if acc is None else acc + p
    return fp._requant(acc, _bias_at_retune(b_q, sb, retune, rounding),
                       acc_shift=0, out_shift=retune - sa_out, leaky=leaky,
                       rounding=rounding)


def _check_parts(parts, *, sb, sa_out, retune, leaky, rounding):
    """Check a general conv's epilogue arguments but sw and its (int8
    tensor, sa) input parts, one or two contiguous int8 [B, H, W, C]
    tensors on one device; returns the slope's Q16 numerator and the
    parts' channels."""
    _check_rounding(rounding)
    num = _slope_num(leaky)
    _check_scalar_shifts(sb=sb, sa_out=sa_out, retune=retune,
                         **{f"sa_in{i}": sa for i, (_, sa) in
                            enumerate(parts)})
    if len(parts) > 2:
        raise ValueError(f"the conv kernels take one or two input parts, got "
                         f"{len(parts)}")
    x0 = parts[0][0]
    for i, (xq, _) in enumerate(parts):
        if (xq.dtype != torch.int8 or xq.device != x0.device or xq.ndim != 4
                or xq.shape[:3] != x0.shape[:3] or not xq.is_contiguous()):
            raise ValueError(f"input part {i} must be a contiguous int8 "
                             f"[{', '.join(map(str, x0.shape[:3]))}, C] "
                             f"tensor on {x0.device}")
    return num, [xq.shape[-1] for xq, _ in parts]


def _launch_conv_requant(parts, w_q, b_q, *, sw, sb, sa_out, retune,
                         padding, stride, leaky, rounding) -> torch.Tensor:
    _check_scalar_shifts(sw=sw)
    num, cins = _check_parts(parts, sb=sb, sa_out=sa_out, retune=retune,
                             leaky=leaky, rounding=rounding)
    x0 = parts[0][0]
    dev = x0.device
    bsz, h, w = x0.shape[:3]
    k, c_out = w_q.shape[0], w_q.shape[-1]
    if k not in (1, 3):
        raise ValueError(f"the conv kernel takes 1x1 or 3x3 weights, got "
                         f"{list(w_q.shape)}")
    _check_operand("w_q", w_q, dev, torch.int8, (k, k, sum(cins), c_out))
    _check_operand("b_q", b_q, dev, b_q.dtype, (c_out,))
    if stride < 1 or padding < 0:
        raise ValueError(f"bad stride {stride} or padding {padding}")
    if (len(parts) == 2 or k == 1) and any(c % 16 for c in cins):
        raise ValueError(f"the kernel takes a two-part input or a 1x1 conv "
                         f"only with C_in % 16 == 0, got {cins}")
    w_parts, ofs = [], 0
    for c in cins:
        w_parts.append(w_q[:, :, ofs:ofs + c].contiguous())
        ofs += c
    ho = (h + 2 * padding - k) // stride + 1
    wo = (w + 2 * padding - k) // stride + 1
    if ho < 1 or wo < 1:
        raise ValueError(f"no output pixels for a {h}x{w} input")
    if bsz * ho * wo >= 2 ** 31:
        raise ValueError("B * Ho * Wo must stay below 2^31; split the batch")
    out = torch.empty((bsz, ho, wo, c_out), dtype=torch.int8, device=dev)
    if out.numel() == 0:
        return out
    bias_rt = _bias_at_retune(b_q, sb, retune, rounding)
    shifts = [sw + sa - retune for _, sa in parts]
    two = len(parts) == 2
    launch("int8_conv_requant", "yolo_int8_conv_requant",
           x0, w_parts[0], parts[1][0] if two else None,
           w_parts[1] if two else None, bias_rt, out, bsz, h, w, cins[0],
           cins[1] if two else 0, c_out, k, stride, padding, len(parts),
           shifts[0], shifts[-1], retune - sa_out, num,
           int(rounding == "nearest"), writes=(out,),
           align=[*((f"input part {i}", xq, 16 if c % 16 == 0 else 1)
                    for i, ((xq, _), c) in enumerate(zip(parts, cins))),
                  *(("w_q", wp, 4) for wp in w_parts), (OUT, out, 16)])
    return out


@profiling.reported(_cost_general)
def int8_conv_requant(x, w_q, b_q, *, sw, sb, sa_in, sa_out, retune,
                      padding=0, stride=1, leaky=True, rounding="nearest",
                      packed=None, shifts=None):
    """Integer conv (k 1 or 3 HWIO weights, any stride and padding) +
    fixed-point requant: int8 NHWC at scale 2^sa_in -> int8 at 2^sa_out.

    ``x`` is an int8 tensor, or a list of (int8 tensor, sa) parts whose
    channel concat is the conv input (``sa_in`` is then unused); ``leaky``
    is False, True (0.125) or a float slope (Q16 rational). ``sw`` is an
    int or a per-channel int32 [C_out] array (``fixed_point._shift_arr``);
    the kernels take one or two parts, and a per-channel ``sw`` on the
    four wgmma routes below (their per-column forms), not on the mma.sync
    conv. ``packed``: a 3x3's weights from ``pack_conv3x3_weights`` (then
    ``w_q`` may be None), which the wgmma kernel reads on the one-part
    shapes of ``conv3x3_wgmma_route`` and its stride-2 form on those of
    ``conv3x3_s2_wgmma_route``, or for two parts from
    ``pack_conv3x3_parts_weights``, which its two-part form reads on the
    two-part shapes of ``conv3x3_wgmma_route``, or from
    ``pack_entry_conv_weights``, which
    the entry conv kernel reads on the shapes of ``entry_conv3x3_route``
    (C_in <= 3), or a 1x1's from ``pack_conv1x1_weights``, which the wgmma
    1x1 kernel reads on the shapes of ``conv1x1_wgmma_route`` (one or two
    parts). ``shifts``: with a per-channel ``sw``, the tables of
    ``conv_shift_tables`` for the parts' scales (a 1x1's with
    ``align=CONV1X1_ALIGN``), made for this call where None. There is no
    fallback: a routed conv launches its kernel or raises; the mma.sync
    conv takes the shapes no route takes."""
    parts = _parts(x, sa_in)
    kw = dict(sw=sw, sb=sb, sa_out=sa_out, retune=retune, padding=padding,
              stride=stride, leaky=leaky, rounding=rounding)
    cins = [xq.shape[-1] for xq, _ in parts]
    if route(parts[0][0]) == "plain":
        return int8_conv_requant_plain(parts, w_q, b_q, sa_in=None,
                                       packed=packed, **kw)
    k = _kernel_size(w_q, packed, sum(cins))
    c_out = b_q.shape[0]
    if conv1x1_wgmma_route(k, stride, padding, len(parts), cins, sw,
                           c_out=c_out):
        return _launch_conv1x1_wgmma(parts, w_q, b_q, packed, sw=sw, sb=sb,
                                     sa_out=sa_out, retune=retune,
                                     leaky=leaky, rounding=rounding,
                                     shifts=shifts)
    shape = (k, stride, padding, len(parts), cins[0], sw)
    if len(parts) == 2 and conv3x3_wgmma_route(*shape, c_out=c_out,
                                               cins=cins):
        return _launch_conv3x3_parts_wgmma(
            parts, w_q, b_q, packed, sw=sw, sb=sb, sa_out=sa_out,
            retune=retune, leaky=leaky, rounding=rounding, shifts=shifts)
    table = None if shifts is None else _one_table(shifts)
    if entry_conv3x3_route(*shape[:5], c_out, sw):
        (x0, sa0), = parts
        return _launch_entry_conv3x3(
            x0, w_q, b_q, packed, sw=sw, sb=sb, sa_in=sa0, sa_out=sa_out,
            retune=retune, leaky=leaky, rounding=rounding, shifts=table)
    for taken, form in ((conv3x3_wgmma_route, "conv"),
                        (conv3x3_s2_wgmma_route, "s2")):
        if taken(*shape, c_out=c_out):
            (x0, sa0), = parts
            return _launch_conv3x3_wgmma(
                "int8_conv_requant", x0, w_q, b_q, packed, sw=sw, sb=sb,
                sa_in=sa0, sa_out=sa_out, retune=retune, leaky=leaky,
                rounding=rounding, form=form, shifts=table)
    return _launch_conv_requant(
        parts, w_q if w_q is not None else _hwio_parts(packed, cins), b_q,
        **kw)


def _one_table(shifts):
    """The one table of a one-part conv's ``shifts``."""
    if len(shifts) != 1:
        raise ValueError(f"a one-part conv takes one shift table, got "
                         f"{len(shifts)}")
    return shifts[0]


# ---------------------------------------------------------------------------
# The wgmma conv3x3 (pad 1): K1, K3 and the general conv's 3x3s.
# ---------------------------------------------------------------------------


# the wgmma conv3x3 kernel's C entries, by form: the conv, its pooled form
# and its stride-2 form, each also with a per-column shift table (cols),
# the first two also counting the values that hit the int16 clamp (count)
WGMMA_ENTRY = "yolo_int8_conv3x3_wgmma"
POOL_WGMMA_ENTRY = "yolo_int8_conv3x3_pool_wgmma"
S2_WGMMA_ENTRY = "yolo_int8_conv3x3_s2_wgmma"
COLS_WGMMA_ENTRY = "yolo_int8_conv3x3_cols_wgmma"
POOL_COLS_WGMMA_ENTRY = "yolo_int8_conv3x3_pool_cols_wgmma"
S2_COLS_WGMMA_ENTRY = "yolo_int8_conv3x3_s2_cols_wgmma"
COUNT_WGMMA_ENTRY = "yolo_int8_conv3x3_count_wgmma"
POOL_COUNT_WGMMA_ENTRY = "yolo_int8_conv3x3_pool_count_wgmma"
_ENTRY_OF = {"conv": WGMMA_ENTRY, "pool": POOL_WGMMA_ENTRY,
             "s2": S2_WGMMA_ENTRY}
_COLS_ENTRY_OF = {"conv": COLS_WGMMA_ENTRY, "pool": POOL_COLS_WGMMA_ENTRY,
                  "s2": S2_COLS_WGMMA_ENTRY}
_COUNT_ENTRY_OF = {"conv": COUNT_WGMMA_ENTRY, "pool": POOL_COUNT_WGMMA_ENTRY}
# its two-part form's (a 3x3 over a two-part concat), scalar and per column
PARTS_WGMMA_ENTRY = "yolo_int8_conv3x3_parts_wgmma"
PARTS_COLS_WGMMA_ENTRY = "yolo_int8_conv3x3_parts_cols_wgmma"
# the tag of a launch of those entries (scalar and per column) that took
# their slab walk (halo slabs of 128 channels, where C_in >= 1,024 in whole
# slabs: yolo_v2's convsets_1.x and convsets_2.0, tiny's conv_set_2): they
# choose it themselves, as the layout the wrapper reads reports it, and
# the launch is counted under the entry's name + this
SLAB_WALK = ".slab"
# the mma.sync conv3x3's C entry (K1 at C_in % 32 != 0, K3 at C_in = 3:
# slim's conv1 on NHWC input)
MMA_SYNC_ENTRY = "yolo_int8_conv3x3_requant"


def conv3x3_wgmma_route(k, stride, padding, nparts, c_in, sw, c_out=None,
                        cins=None) -> bool:
    """True where a conv on a CUDA tensor runs on the wgmma conv3x3 kernel
    (``csrc/int8_conv3x3_wgmma.cu``): a 3x3, stride 1, pad 1, one input
    part of C_in % 32 == 0 channels, or two (``cins``: each part's
    channels, each % 32 == 0; its two-part form), a scalar ``sw`` or a
    per-channel one of ``c_out`` entries. ``int8_conv3x3_requant`` sends
    such one-part convs there and every other to the mma.sync conv
    kernel, and so does ``int8_conv_requant`` with the two-part ones too
    (tiny_yolo_v3's conv_set_1, yolo_v2's convsets_2.0). There is no
    fallback: a routed conv launches the kernel or raises."""
    if cins is None:
        cins = (c_in,) if nparts == 1 else ()
    return (k == 3 and stride == 1 and padding == 1 and nparts in (1, 2)
            and len(cins) == nparts and cins[0] == c_in
            and all(c > 0 and c % 32 == 0 for c in cins)
            and _sw_ok(sw, c_out))


def conv3x3_s2_wgmma_route(k, stride, padding, nparts, c_in, sw,
                           c_out=None) -> bool:
    """True where ``int8_conv_requant`` on a CUDA tensor runs the wgmma
    conv3x3 kernel's stride-2 form (``csrc/int8_conv3x3_wgmma.cu``): a
    3x3, stride 2, pad 1, one input part of C_in % 32 == 0 channels, a
    scalar ``sw`` or a per-channel one of ``c_out`` entries (its
    per-column form; yolo_v3's five downsampling convs); any H and W, odd
    ones included. Every other stride-2 conv runs the mma.sync conv
    kernel."""
    return (k == 3 and stride == 2 and padding == 1 and nparts == 1
            and c_in > 0 and c_in % 32 == 0 and _sw_ok(sw, c_out))


def conv3x3_pool_wgmma_route(c_in, sw, c_out=None) -> bool:
    """True where ``int8_conv3x3_im2col(pool=True)`` on a CUDA tensor runs
    the wgmma conv3x3 kernel's pooled form (``csrc/int8_conv3x3_wgmma.cu``):
    C_in % 32 == 0, or C_in == 16 (zero-extended to 32 channels in the
    kernel's halo tile and in the packed weights: slim's conv2), and a
    scalar ``sw`` or a per-channel one of ``c_out`` entries; H and W even,
    as every pooled conv. Every other pooled conv runs the mma.sync conv
    kernel."""
    return ((c_in == 16 or (c_in > 0 and c_in % 32 == 0))
            and _sw_ok(sw, c_out))


def _pack3x3(w_q: torch.Tensor, pad32: bool = False) -> torch.Tensor:
    if w_q.ndim != 4 or tuple(w_q.shape[:2]) != (3, 3):
        raise ValueError(f"3x3 weights must be HWIO [3, 3, C_in, C_out], "
                         f"got {list(w_q.shape)}")
    c_in, c_out = w_q.shape[2], w_q.shape[3]
    if pad32 and c_in % 32:
        w_q = torch.nn.functional.pad(w_q, (0, 0, 0, -c_in % 32))
        c_in = w_q.shape[2]
    return w_q.permute(3, 0, 1, 2).reshape(c_out, 9 * c_in).contiguous()


def pack_conv3x3_weights(w_q: torch.Tensor) -> torch.Tensor:
    """A 3x3 conv's HWIO weights [3, 3, C_in, C_out] in the K-major form
    the wgmma kernels read, made once per model: [C_out, 9 * C_k] in
    (dy, dx, c) order (OHWI), C_k = C_in rounded up to 32 with zero weights
    past C_in (the kernels' 32-deep K steps), contiguous, on the weights'
    device."""
    wp = _pack3x3(w_q, pad32=True)
    _PACKS["conv3x3"] += 1
    return wp


def unpack_conv3x3_weights(wp: torch.Tensor, c_in=None) -> torch.Tensor:
    """The inverse of ``pack_conv3x3_weights``: an HWIO [3, 3, C_in,
    C_out] view of the packed weights, the zero channels past ``c_in``
    (where given) left out."""
    c_out, k9 = wp.shape
    w = wp.reshape(c_out, 3, 3, k9 // 9).permute(1, 2, 3, 0)
    return w if c_in is None else w[:, :, :c_in]


def pack_conv3x3_parts_weights(w_q: torch.Tensor, cins) -> torch.Tensor:
    """A 3x3 conv's HWIO weights [3, 3, C_in0 + C_in1, C_out] over a
    two-part concat input (``cins`` = (C_in0, C_in1), each % 32 == 0) in
    the K-major form the wgmma kernel's two-part form reads, made once per
    model: [C_out, 9 * C_in0 + 9 * C_in1], part 0's (dy, dx, c) block and
    then part 1's (each part's taps in turn, so that each part's partial
    is a K range of its own), contiguous, on the weights' device."""
    cins = tuple(int(c) for c in cins)
    if (len(cins) != 2 or any(c <= 0 or c % 32 for c in cins)
            or w_q.ndim != 4 or tuple(w_q.shape[:2]) != (3, 3)
            or w_q.shape[2] != sum(cins)):
        raise ValueError(f"two-part 3x3 weights must be HWIO [3, 3, C_in0 + "
                         f"C_in1, C_out] with each C_in % 32 == 0, got "
                         f"{list(w_q.shape)} for parts {list(cins)}")
    wp = torch.cat([_pack3x3(w_q[:, :, :cins[0]]),
                    _pack3x3(w_q[:, :, cins[0]:])], dim=1).contiguous()
    _PACKS["conv3x3_parts"] += 1
    return wp


def unpack_conv3x3_parts_weights(wp: torch.Tensor, cins) -> torch.Tensor:
    """The inverse of ``pack_conv3x3_parts_weights``: HWIO [3, 3, C_in0 +
    C_in1, C_out]."""
    k0 = 9 * int(cins[0])
    return torch.cat([unpack_conv3x3_weights(wp[:, :k0]),
                      unpack_conv3x3_weights(wp[:, k0:])], dim=2)


def conv3x3_parts_pack_count() -> int:
    """Calls of ``pack_conv3x3_parts_weights`` since the last reset."""
    return _PACKS["conv3x3_parts"]


def reset_conv3x3_parts_pack_count() -> None:
    _PACKS["conv3x3_parts"] = 0


def _hwio_parts(packed, cins):
    """The HWIO weights of a general conv over parts of ``cins`` channels
    from its packed form: a two-part 3x3's from
    ``pack_conv3x3_parts_weights``, else any form ``_hwio`` reads."""
    if len(cins) == 2 and packed.shape[1] == 9 * sum(cins):
        return unpack_conv3x3_parts_weights(packed, cins)
    return _hwio(None, packed, sum(cins))


def _hwio(w_q, packed, c_in, c_out=None):
    """The HWIO weights where given, else those of ``packed`` (its first
    ``c_in`` input channels): a 1x1's [C_out, C_in] form
    (``pack_conv1x1_weights``), the entry conv's [C_out, 32] form (C_in <=
    3), the pooled NHWC form [4 * CP, 64] (C_in <= 4) of
    ``pack_pool_nhwc_weights`` (its first ``c_out`` columns), or the
    [C_out, 9 * C_k] form (9 * C_k >= 288) of ``pack_conv3x3_weights``."""
    if w_q is not None:
        return w_q
    if packed.shape[1] == c_in:
        return unpack_conv1x1_weights(packed)
    if packed.shape[1] == ENTRY_K:
        return unpack_entry_conv_weights(packed, c_in)
    if packed.shape[1] == POOL_K and c_in <= 4:
        return unpack_pool_nhwc_weights(packed, c_in, c_out)
    return unpack_conv3x3_weights(packed, c_in)


def _kernel_size(w_q, packed, c_in) -> int:
    """k of a conv given its HWIO weights, or only its packed ones: a 1x1's
    packed form has one column per input channel (``_hwio``)."""
    if w_q is not None:
        return w_q.shape[0]
    return 1 if packed.shape[1] == c_in else 3


def conv3x3_pack_count() -> int:
    """Calls of ``pack_conv3x3_weights`` since the last reset."""
    return _PACKS["conv3x3"]


def reset_conv3x3_pack_count() -> None:
    _PACKS["conv3x3"] = 0


# the wgmma conv3x3 kernel's launch layout, as
# yolo_int8_conv3x3_wgmma_info reports it (halo_channels: C_in rounded up
# to 32, or the slab of them a stride-2 or slab-walk halo tile holds at a
# time; groups: blocks per tile, each with a share of the weight tiles)
Conv3x3Layout = collections.namedtuple("Conv3x3Layout", (
    "tile_h", "tile_w", "smem_bytes", "blocks_per_sm", "bn",
    "consumer_warpgroups", "ring_stages", "tile_pixels", "mma_rows",
    "halo_channels", "groups"))


def _layout(form, h, w, c_in, c_out, batch=1) -> Conv3x3Layout:
    from yolo_tpu_torch.kernels import build

    lib = build.load()
    entry = _ENTRY_OF[form] + "_info"
    info = (ctypes.c_int * len(Conv3x3Layout._fields))()
    # (the stride-1 conv's layout is a batch's: its slab walk's groups)
    dims = (batch, h, w, c_in, c_out) if form == "conv" else (h, w, c_in,
                                                              c_out)
    rc = getattr(lib, entry)(*dims, info)
    if rc == _CUDA_ERROR_INVALID_VALUE:
        need = ("H and W even and C_in % 32 == 0 or C_in == 16"
                if form == "pool" else "C_in % 32 == 0")
        what = {"conv": "", "pool": "pooled ", "s2": "stride-2 "}[form]
        raise ValueError(f"the conv3x3 wgmma kernel takes no {h}x{w} "
                         f"{what}conv of C_in {c_in} -> C_out {c_out}: it "
                         f"needs {need}, and a tile that fits in shared "
                         f"memory")
    if rc:
        raise RuntimeError(f"{entry} failed: "
                           f"{lib.yolo_int8_error_string(rc).decode()}")
    return Conv3x3Layout(*info)


@functools.lru_cache(maxsize=None)
def conv3x3_wgmma_layout(h, w, c_in, c_out, batch=1) -> Conv3x3Layout:
    """The wgmma conv3x3 kernel's launch layout for a ``batch`` x H x W x
    C_in -> C_out conv, as its CUDA source picks it (``plan`` in
    ``csrc/int8_conv3x3_wgmma.cu``): tile, shared memory, blocks per SM,
    weight-tile columns, consumer warpgroups, ring stages, a full tile's
    pixels beside the rows its 64-row wgmma steps run, the halo tile's
    channels and blocks per tile: where its slab walk takes the conv
    (C_in >= 1,024, C_in % 128 == 0; not its counting form)
    ``halo_channels`` a slab of 128 and ``groups`` by ``batch``, else all
    C_in and 1. Needs the built kernels. Raises ValueError where the
    kernel takes no such conv (C_in % 32 != 0, or no tile fits in shared
    memory)."""
    return _layout("conv", h, w, c_in, c_out, batch)


@functools.lru_cache(maxsize=None)
def conv3x3_pool_wgmma_layout(h, w, c_in, c_out) -> Conv3x3Layout:
    """The same for the kernel's pooled form (conv3x3 + 2x2/2 max pool),
    whose tiles are even: its 64-row wgmma steps hold the four pixels of
    16 pooled pixels each. Raises ValueError where the form takes no such
    conv (H or W odd, C_in neither 16 nor a multiple of 32, or no tile
    fits in shared memory)."""
    return _layout("pool", h, w, c_in, c_out)


@functools.lru_cache(maxsize=None)
def conv3x3_s2_wgmma_layout(h, w, c_in, c_out) -> Conv3x3Layout:
    """The same for the kernel's stride-2 form (conv3x3, stride 2, pad 1,
    of an H x W input), whose tile is in output pixels and whose halo tile
    may hold a slab of C_in (``halo_channels``; ``plan_tile_s2`` in
    ``csrc/int8_wgmma_conv.cuh``). Raises ValueError where the form takes
    no such conv (C_in % 32 != 0, or no tile fits in shared memory)."""
    return _layout("s2", h, w, c_in, c_out)


_LAYOUT_OF = {"pool": conv3x3_pool_wgmma_layout,
              "s2": conv3x3_s2_wgmma_layout}


def _launch_conv3x3_wgmma(name, x, w_q, b_q, packed, *, sw, sb, sa_in,
                          sa_out, retune, leaky, rounding, form="conv",
                          shifts=None, overflow=None) -> torch.Tensor:
    """Check the operands and launch the wgmma conv3x3 kernel in ``form``
    ("conv", "pool": its pooled form, "s2": its stride-2 form) on the
    current stream, counting the launch under ``name``; packs ``w_q`` for
    this call where ``packed`` is None. Every form also takes a
    per-channel ``sw`` (its per-column instantiations), the conv and
    pooled forms an ``overflow`` counter (their counting ones), both on a
    per-column shift table (``shifts``, made for this call where None).
    The conv's entries take their slab walk where ``conv3x3_wgmma_layout``
    reports one, except when counting (the launch counted with
    ``SLAB_WALK``). Raises on anything the form does not take and on a
    failed launch."""
    _check_rounding(rounding)
    num = _slope_num(leaky)
    _check_scalar_shifts(sb=sb, sa_in=sa_in, sa_out=sa_out, retune=retune)
    if form == "s2" and overflow is not None:
        raise ValueError("the stride-2 form counts no overflow")
    dev = x.device
    if x.dtype != torch.int8 or x.ndim != 4 or not x.is_contiguous():
        raise ValueError("x must be a contiguous int8 [B, H, W, C] tensor")
    bsz, h, w, c_in = x.shape
    if form == "pool":
        if not conv3x3_pool_wgmma_route(c_in, 0):
            raise ValueError(f"the pooled conv3x3 wgmma kernel needs C_in % "
                             f"32 == 0 or C_in == 16, got {c_in}")
        if h % 2 or w % 2:
            raise ValueError("pooled conv requires even H, W")
    elif c_in % 32:
        raise ValueError(f"the conv3x3 wgmma kernel needs C_in % 32 == 0, "
                         f"got {c_in}")
    if packed is None:
        packed = pack_conv3x3_weights(w_q)
    c_out = packed.shape[0]
    _check_operand("packed weights", packed, dev, torch.int8,
                   (c_out, 9 * (-(-c_in // 32) * 32)))
    if not packed.is_contiguous():
        raise ValueError("the packed weights must be contiguous")
    _check_operand("b_q", b_q, dev, b_q.dtype, (c_out,))
    if bsz * h * w >= 2 ** 31:
        raise ValueError("B * H * W must stay below 2^31; split the batch")
    _check_sw(sw, c_out)
    if overflow is not None:
        _check_counter(overflow, dev)
    ho, wo = {"conv": (h, w), "pool": (h // 2, w // 2),
              "s2": ((h + 1) // 2, (w + 1) // 2)}[form]
    out = torch.empty((bsz, ho, wo, c_out), dtype=torch.int8, device=dev)
    if out.numel() == 0:
        return out
    # raises where no tile fits
    lay = (conv3x3_wgmma_layout(h, w, c_in, c_out, bsz) if form == "conv"
           else _LAYOUT_OF[form](h, w, c_in, c_out))
    slab = form == "conv" and overflow is None and lay.halo_channels < c_in
    # the kernel reads bias (and shift) pairs of whole 32-, 64- or
    # 128-column tiles
    bias_rt = torch.zeros(-(-c_out // 128) * 128, dtype=torch.int32,
                          device=dev)
    bias_rt[:c_out] = _bias_at_retune(b_q, sb, retune, rounding)
    _launch_shift_form(
        name, (_ENTRY_OF[form], _COLS_ENTRY_OF.get(form),
               _COUNT_ENTRY_OF.get(form)), x, packed, bias_rt, out,
        (bsz, h, w, c_in, c_out), sw=sw, sa_in=sa_in, sa_out=sa_out,
        retune=retune, rounding=rounding, num=num, shifts=shifts,
        overflow=overflow, tag=SLAB_WALK if slab else "")
    return out


def _launch_shift_form(name, entries, x, packed, bias_rt, out, dims, *, sw,
                       sa_in, sa_out, retune, rounding, num, shifts,
                       overflow, tag="") -> None:
    """Launch one of a kernel's three C entries, ``entries`` = (scalar,
    per-column, counting; None where it has no such form), all with the
    conv3x3 kernels' interface, on
    ``dims`` = (B, H, W, C_in, C_out), counting the launch under
    ``name``: the scalar one for a scalar ``sw`` without a counter, the
    counting one with ``overflow``, else the per-column one, those two on a
    shift table (``shifts``, made for this call where None); ``tag``: as
    ``launch``'s. Every address is 16-byte aligned, the table's 8-byte,
    the counter's 4."""
    dev, c_out = x.device, dims[-1]
    nearest = int(rounding == "nearest")
    scalar, cols, count = entries

    def go(entry, *args):
        launch(name, entry, x, packed, bias_rt, *args, writes=(out, overflow),
               align=[("x", x, 16), ("packed weights", packed, 16),
                      (OUT, out, 16), (TABLE, table, 8),
                      (COUNTER, overflow, 4)], tag=tag)

    table = None
    if overflow is None and not np.ndim(sw):
        go(scalar, out, *dims, sa_in + sw - retune, retune - sa_out, num,
           nearest)
        return
    table = _table_for(shifts, sw, sa_in, retune, rounding, c_out, dev)
    if overflow is not None:
        go(count, table, out, overflow, *dims, retune - sa_out, num, nearest)
        return
    codes = acc_shift_codes(sw, sa_in, retune, rounding, c_out)
    go(cols, table, out, *dims, int(short_columns(codes)), retune - sa_out,
       num, nearest)


# the two-part form's launch layout, as
# yolo_int8_conv3x3_parts_wgmma_info reports it: the one-part fields (the
# halo tile's channels both parts'), and whether the parts take two
# accumulator shifts (split: the 64-column tile, two accumulators)
Conv3x3PartsLayout = collections.namedtuple(
    "Conv3x3PartsLayout", Conv3x3Layout._fields + ("split",))


@functools.lru_cache(maxsize=None)
def conv3x3_parts_wgmma_layout(h, w, cin0, cin1, c_out, split,
                               batch=1) -> Conv3x3PartsLayout:
    """The launch layout of the wgmma conv3x3 kernel's two-part form (both
    shift forms') for a ``batch`` x H x W x (C_in0 + C_in1) -> C_out conv
    whose parts take two accumulator shifts (``split``) or one, as its
    CUDA source picks it (``plan`` in ``csrc/int8_conv3x3_wgmma.cu``):
    where its slab walk takes the conv (C_in0 + C_in1 >= 1,024, each
    part's C_in % 128 == 0) ``halo_channels`` a slab of 128 and ``groups``
    by ``batch``, else both parts' channels and 1. Needs the built
    kernels. Raises ValueError where the form takes no such conv (a part's
    C_in % 32 != 0, or no tile fits in shared memory)."""
    from yolo_tpu_torch.kernels import build

    lib = build.load()
    info = (ctypes.c_int * len(Conv3x3PartsLayout._fields))()
    rc = lib.yolo_int8_conv3x3_parts_wgmma_info(batch, h, w, cin0, cin1,
                                                c_out, int(split), info)
    if rc == _CUDA_ERROR_INVALID_VALUE:
        raise ValueError(f"the conv3x3 wgmma kernel's two-part form takes no "
                         f"{h}x{w} conv of C_in {cin0} + {cin1} -> C_out "
                         f"{c_out}: each part needs C_in % 32 == 0, and a "
                         f"tile that fits in shared memory")
    if rc:
        raise RuntimeError(f"yolo_int8_conv3x3_parts_wgmma_info failed: "
                           f"{lib.yolo_int8_error_string(rc).decode()}")
    return Conv3x3PartsLayout(*info)


def _launch_conv3x3_parts_wgmma(parts, w_q, b_q, packed, *, sw, sb, sa_out,
                                retune, leaky, rounding,
                                shifts=None) -> torch.Tensor:
    """Check the operands and launch the wgmma conv3x3 kernel's two-part
    form (pad 1) on the current stream, counting the launch under
    ``int8_conv_requant``; ``parts``: the two (int8 tensor, sa) parts of
    the input; packs ``w_q`` for this call where ``packed`` is None. The
    parts' raw partials sum before one shift where they take one, else
    each is shifted on its own (split). A per-channel ``sw`` runs its
    per-column form on the tables of ``conv_shift_tables`` (``shifts``,
    made for this call where None): one where the parts' scales agree, one
    per part where they differ. The form's entries take their slab walk
    where ``conv3x3_parts_wgmma_layout`` reports one (the launch counted
    with ``SLAB_WALK``). Raises on anything the form does not take and on
    a failed launch."""
    num, cins = _check_parts(parts, sb=sb, sa_out=sa_out, retune=retune,
                             leaky=leaky, rounding=rounding)
    x0 = parts[0][0]
    dev = x0.device
    bsz, h, w = x0.shape[:3]
    if packed is None:
        packed = pack_conv3x3_parts_weights(w_q, cins)
    c_out = packed.shape[0]
    if not conv3x3_wgmma_route(3, 1, 1, len(parts), cins[0], sw,
                               c_out=c_out, cins=cins) or len(parts) != 2:
        raise ValueError(f"the two-part conv3x3 wgmma form takes two parts "
                         f"of C_in % 32 == 0 and a scalar sw or one of "
                         f"C_out = {c_out} entries, got {cins}, sw of shape "
                         f"{np.shape(sw)}")
    _check_operand("packed weights", packed, dev, torch.int8,
                   (c_out, 9 * sum(cins)))
    if not packed.is_contiguous():
        raise ValueError("the packed weights must be contiguous")
    _check_operand("b_q", b_q, dev, b_q.dtype, (c_out,))
    if bsz * h * w >= 2 ** 31:
        raise ValueError("B * H * W must stay below 2^31; split the batch")
    out = torch.empty((bsz, h, w, c_out), dtype=torch.int8, device=dev)
    if out.numel() == 0:
        return out
    sas = [sa for _, sa in parts]
    cols = bool(np.ndim(sw))
    # the parts' accumulator shifts sw + sa - retune differ where their
    # input scales do (int_conv_requant's groups)
    split = sas[0] != sas[1]
    # raises where no tile fits
    lay = conv3x3_parts_wgmma_layout(h, w, cins[0], cins[1], c_out, split,
                                     bsz)
    tag = SLAB_WALK if lay.halo_channels < sum(cins) else ""
    # the kernel reads bias (and shift) pairs of whole 64- or 128-column
    # tiles
    bias_rt = torch.zeros(-(-c_out // TABLE_ALIGN) * TABLE_ALIGN,
                          dtype=torch.int32, device=dev)
    bias_rt[:c_out] = _bias_at_retune(b_q, sb, retune, rounding)
    ptrs = (x0, parts[1][0], packed, bias_rt)
    dims = (bsz, h, w, cins[0], cins[1], c_out)
    tail = (retune - sa_out, num, int(rounding == "nearest"))
    align = [*((f"input part {i}", xq, 16) for i, (xq, _) in enumerate(parts)),
             ("packed weights", packed, 16), (OUT, out, 16)]
    if not cols:
        launch("int8_conv_requant", PARTS_WGMMA_ENTRY, *ptrs, out, *dims,
               sw + sas[0] - retune, sw + sas[1] - retune, *tail,
               writes=(out,), align=align, tag=tag)
        return out
    groups = list(dict.fromkeys(sas))
    if shifts is None:
        shifts = conv_shift_tables(sw, sas, retune, rounding, c_out, dev)
    if len(shifts) != len(groups):
        raise ValueError(f"parts of {len(groups)} input scales take "
                         f"{len(groups)} shift tables, got {len(shifts)}")
    tables = [_table_for(t, sw, sa, retune, rounding, c_out, dev)
              for t, sa in zip(shifts, groups)]
    short = all(short_columns(acc_shift_codes(sw, sa, retune, rounding,
                                              c_out)) for sa in groups)
    launch("int8_conv_requant", PARTS_COLS_WGMMA_ENTRY, *ptrs, tables[0],
           tables[-1], out, *dims, int(split), int(short), *tail,
           writes=(out,), align=[*align, *((TABLE, t, 8) for t in tables)],
           tag=tag)
    return out


def pack_res_block_weights(w1_q: torch.Tensor, w2_q: torch.Tensor):
    """K4's weights in the K-major form its kernel reads, made once per
    model: w1 [C, Cmid] (or [1, 1, C, Cmid]) -> [Cmid, C]; w2 HWIO
    [3, 3, Cmid, C] -> [C, 9 * Cmid] in (dy, dx, c) order (OHWI).
    Returns (w1p, w2p), contiguous, on the weights' device."""
    c, cmid = w1_q.shape[-2], w1_q.shape[-1]
    if tuple(w2_q.shape) != (3, 3, cmid, c):
        raise ValueError(f"w2_q must be [3, 3, {cmid}, {c}], got "
                         f"{list(w2_q.shape)}")
    _PACKS["res_block"] += 1
    return w1_q.reshape(c, cmid).t().contiguous(), _pack3x3(w2_q)


def unpack_res_block_weights(packed):
    """The inverse of ``pack_res_block_weights``: (w1 [C, Cmid], w2 HWIO
    [3, 3, Cmid, C]) views of the packed pair."""
    w1p, w2p = packed
    return w1p.t(), unpack_conv3x3_weights(w2p)


# packings made since the last reset (serving packs once per model)
_PACKS = {"res_block": 0, "conv3x3": 0, "conv3x3_parts": 0,
          "entry_conv": 0, "pool_s2d": 0, "pool_nhwc": 0, "conv1x1": 0,
          "shift_table": 0}


def res_block_pack_count() -> int:
    """Calls of ``pack_res_block_weights`` since the last reset."""
    return _PACKS["res_block"]


def reset_res_block_pack_count() -> None:
    _PACKS["res_block"] = 0


def int8_res_block_plain(x_q, w1_q, b1_q, p1, w2_q, b2_q, p2, *,
                         sa_res=None, leaky=True, rounding="nearest",
                         packed=None):
    """The chain K4 fuses: 1x1 conv + requant, 3x3 conv (pad 1) + requant,
    and with ``sa_res`` the residual add with ``x_q``, requantized to
    2^sa_res (``fixed_point.int_add_requant``). The HWIO weights are used
    where given, else those of ``packed`` (from
    ``pack_res_block_weights``)."""
    if w1_q is None or w2_q is None:
        w1_q, w2_q = unpack_res_block_weights(packed)
    w1 = w1_q.reshape(1, 1, *w1_q.shape[-2:])
    y1 = int8_conv_requant_plain(x_q, w1, b1_q, padding=0, leaky=leaky,
                                 rounding=rounding, **p1)
    out = int8_conv_requant_plain(y1, w2_q, b2_q, padding=1, leaky=leaky,
                                  rounding=rounding, **p2)
    if sa_res is not None:
        out = fp.int_add_requant(out, p2["sa_out"], x_q, p1["sa_in"], sa_res,
                                 rounding)
    return out


_CUDA_ERROR_INVALID_VALUE = 1  # cudaErrorInvalidValue
# K4's launch layout at a stage, as yolo_int8_res_block_info reports it
ResBlockLayout = collections.namedtuple("ResBlockLayout", (
    "tile_h", "tile_w", "halo_rows_per_box", "smem_bytes", "blocks_per_sm",
    "bn1", "bn2", "consumer_warpgroups", "ring_stages"))


@functools.lru_cache(maxsize=None)
def res_block_layout(h, w, c, cmid) -> ResBlockLayout:
    """The K4 kernel's launch layout at an H x W x C stage with C_mid mid
    channels, as its CUDA source picks it (``plan`` in
    ``csrc/int8_res_block.cu``). Needs the built kernels. Raises ValueError
    where no tile fits in shared memory."""
    from yolo_tpu_torch.kernels import build

    lib = build.load()
    info = (ctypes.c_int * len(ResBlockLayout._fields))()
    rc = lib.yolo_int8_res_block_info(h, w, c, cmid, info)
    if rc == _CUDA_ERROR_INVALID_VALUE:
        raise ValueError(f"C_mid = {cmid} is too wide for the residual block "
                         f"kernel's shared memory")
    if rc:
        raise RuntimeError(f"yolo_int8_res_block_info failed: "
                           f"{lib.yolo_int8_error_string(rc).decode()}")
    return ResBlockLayout(*info)


def res_block_row_shares(th, tw, r1):
    """Share of the 64-row wgmma steps run that carry pixels, in the 1x1
    GEMM (halo pixels, ``r1`` halo rows per TMA box) and the 3x3 GEMM (tile
    pixels; a warpgroup whose 64 rows lie past the tile runs none), for a
    full th x tw tile: (share_1x1, share_3x3)."""
    hh, hw = th + 2, tw + 2
    rows1 = sum(-(-min(r1, hh - c) * hw // 64) * 64
                for c in range(0, hh, r1))
    p2 = th * tw
    return hh * hw / rows1, p2 / (-(-p2 // 64) * 64)


# K4's per-column form (a per-channel sw)
RES_BLOCK_COLS_ENTRY = "yolo_int8_res_block_cols_wgmma"


def _launch_res_block(x_q, packed, b1_q, p1, b2_q, p2, *, sa_res, leaky,
                      rounding, shifts=None) -> torch.Tensor:
    """Check the operands and launch K4 on the current stream: its scalar
    form, or where either conv's sw is per-channel its per-column form on
    the two convs' shift tables (``shifts`` = (conv1's, conv2's), each
    made for this call where None). Raises on anything the kernel does not
    take and on a failed launch."""
    _check_rounding(rounding)
    num = _slope_num(leaky)
    _check_scalar_shifts(**{f"{k}1": v for k, v in p1.items() if k != "sw"},
                         **{f"{k}2": v for k, v in p2.items() if k != "sw"},
                         sa_res=sa_res or 0)
    dev = x_q.device
    if x_q.dtype != torch.int8 or x_q.ndim != 4 or not x_q.is_contiguous():
        raise ValueError("x_q must be a contiguous int8 [B, H, W, C] tensor")
    bsz, h, w, c = x_q.shape
    w1p, w2p = packed
    cmid = w1p.shape[0]
    if c % 64 or cmid % 32:
        raise ValueError(f"the residual block kernel needs C % 64 == 0 and "
                         f"C_mid % 32 == 0, got C {c}, C_mid {cmid}")
    if h and w:
        res_block_layout(h, w, c, cmid)  # raises where no tile fits
    _check_operand("packed w1", w1p, dev, torch.int8, (cmid, c))
    _check_operand("packed w2", w2p, dev, torch.int8, (c, 9 * cmid))
    _check_operand("b1_q", b1_q, dev, b1_q.dtype, (cmid,))
    _check_operand("b2_q", b2_q, dev, b2_q.dtype, (c,))
    _check_sw(p1["sw"], cmid)
    _check_sw(p2["sw"], c)
    if not (w1p.is_contiguous() and w2p.is_contiguous()):
        raise ValueError("the packed weights must be contiguous")
    if bsz * h * w >= 2 ** 31:
        raise ValueError("B * H * W must stay below 2^31; split the batch")
    sh = (0, 0, 0)
    if sa_res is not None:
        s = max(p2["sa_out"], p1["sa_in"])
        sh = (s - p2["sa_out"], s - p1["sa_in"], s - sa_res)
        if max(sh[:2]) > 24:
            raise ValueError(f"residual alignment shifts {sh[:2]} exceed 24 "
                             f"bits")
    out = torch.empty_like(x_q)
    if out.numel() == 0:
        return out
    align = [("x_q", x_q, 16), ("packed w1", w1p, 16),
             ("packed w2", w2p, 16), (OUT, out, 16)]
    b1_rt = _bias_at_retune(b1_q, p1["sb"], p1["retune"], rounding)
    b2_rt = _bias_at_retune(b2_q, p2["sb"], p2["retune"], rounding)
    outs = (p1["retune"] - p1["sa_out"], p2["retune"] - p2["sa_out"])
    tail = (num, int(rounding == "nearest"), int(sa_res is not None), *sh)
    if not (np.ndim(p1["sw"]) or np.ndim(p2["sw"])):
        launch("int8_res_block", "yolo_int8_res_block", x_q, w1p, b1_rt,
               w2p, b2_rt, out, bsz, h, w, c, cmid,
               p1["sa_in"] + p1["sw"] - p1["retune"], outs[0],
               p2["sa_in"] + p2["sw"] - p2["retune"], outs[1], *tail,
               writes=(out,), align=align)
        return out
    if shifts is None:
        shifts = (None, None)
    if len(shifts) != 2:
        raise ValueError(f"the residual block takes two shift tables "
                         f"(conv1's, conv2's), got {len(shifts)}")
    tables = [_table_for(t, p["sw"], p["sa_in"], p["retune"], rounding, n,
                         dev)
              for t, p, n in zip(shifts, (p1, p2), (cmid, c))]
    short = all(short_columns(acc_shift_codes(p["sw"], p["sa_in"],
                                              p["retune"], rounding, n))
                for p, n in ((p1, cmid), (p2, c)))
    launch("int8_res_block", RES_BLOCK_COLS_ENTRY, x_q, w1p, b1_rt,
           tables[0], w2p, b2_rt, tables[1], out, bsz, h, w, c, cmid, *outs,
           int(short), *tail, writes=(out,),
           align=[*align, *((TABLE, t, 8) for t in tables)])
    return out


@profiling.reported(_cost_res_block)
def int8_res_block(x_q, w1_q, b1_q, p1, w2_q, b2_q, p2, *, sa_res=None,
                   leaky=True, rounding="nearest", packed=None, shifts=None):
    """Fused darknet residual block: int8 [B,H,W,C] -> 1x1 conv + requant
    (C -> Cmid) -> 3x3 conv (s1, p1) + requant (Cmid -> C) -> [residual
    add + requant to 2^sa_res] -> int8 [B,H,W,C], the mid activation kept
    on chip. ``p1``/``p2`` carry sw, sb, sa_in, sa_out, retune; each sw an
    int or a per-channel int32 array (conv1's of length Cmid, conv2's of
    length C; ``fixed_point._shift_arr``); ``w1_q`` is [C, Cmid] or [1, 1,
    C, Cmid]; ``leaky`` is False, True (0.125) or a float slope (the
    darknet53 backbone's 0.1), for both convs.

    ``packed``: the weights from ``pack_res_block_weights`` (then ``w1_q``
    and ``w2_q`` may be None). The kernel reads that form; given only the
    HWIO weights, the wrapper packs them for this call. ``shifts``: with a
    per-channel sw on CUDA, the two convs' ``acc_shift_table``s (conv1's,
    conv2's), made for this call where None; the plain version reads the
    sw itself."""
    if p2["sa_in"] != p1["sa_out"]:
        raise ValueError("conv2's sa_in must be conv1's sa_out")
    kw = dict(sa_res=sa_res, leaky=leaky, rounding=rounding)
    if route(x_q) == "plain":
        return int8_res_block_plain(x_q, w1_q, b1_q, p1, w2_q, b2_q, p2,
                                    packed=packed, **kw)
    if packed is None:
        packed = pack_res_block_weights(w1_q, w2_q)
    return _launch_res_block(x_q, packed, b1_q, p1, b2_q, p2, shifts=shifts,
                             **kw)


# ---------------------------------------------------------------------------
# The thin-input entry convs (csrc/int8_entry_conv.cu): yolo_v3's C_in = 3
# entry conv and K2 on the s2d layout (slim's conv1), row-streaming wgmma.
# ---------------------------------------------------------------------------


ENTRY_CONV_ENTRY = "yolo_int8_entry_conv3x3_wgmma"
# its per-column form (a per-channel sw)
ENTRY_CONV_COLS_ENTRY = "yolo_int8_entry_conv3x3_cols_wgmma"
POOL_S2D_WGMMA_ENTRY = "yolo_int8_pool_s2d_wgmma"
ENTRY_K = 32  # the entry conv's one K step: 9 * C_in <= 27 bytes, padded
# K2's two K steps (both input forms): 16 * C_in <= 64 bytes, padded
POOL_K = 64


def entry_conv3x3_route(k, stride, padding, nparts, c_in, c_out, sw) -> bool:
    """True where ``int8_conv_requant`` on a CUDA tensor runs the entry
    conv kernel (``csrc/int8_entry_conv.cu``): a 3x3, stride 1, pad 1, one
    input part of 1 <= C_in <= 3 channels (9 * C_in <= 32: one K step),
    C_out <= 64 and a scalar ``sw`` or a per-channel one of C_out entries
    (its per-column form; yolo_v3's entry conv, 3 -> 32). There is no
    fallback: a routed conv launches that kernel or raises."""
    return (k == 3 and stride == 1 and padding == 1 and nparts == 1
            and 1 <= c_in <= 3 and 1 <= c_out <= 64 and _sw_ok(sw, c_out))


def pool_s2d_wgmma_route(c_in, c_out, sw) -> bool:
    """True where ``int8_conv3x3_pool_s2d`` on a CUDA tensor runs K2's
    wgmma kernel (``csrc/int8_entry_conv.cu``): C_in <= 4 (K = 16 * C_in
    <= 64), C_out <= 32 (4 phases of up to 32 columns) and a scalar ``sw``
    (slim's conv1, 3 -> 16). Other shapes run the mma.sync pool_s2d
    kernel of ``csrc/int8_conv.cu``."""
    return 1 <= c_in <= 4 and 1 <= c_out <= 32 and np.ndim(sw) == 0


def pack_entry_conv_weights(w_q: torch.Tensor) -> torch.Tensor:
    """The entry conv's HWIO weights [3, 3, C_in, C_out] (C_in <= 3) in the
    K-major form its kernel reads, made once per model: [C_out, 32] in
    (dy, dx, c) order, zero past 9 * C_in, contiguous, on the weights'
    device."""
    if w_q.ndim != 4 or tuple(w_q.shape[:2]) != (3, 3) or w_q.shape[2] > 3:
        raise ValueError(f"entry conv weights must be HWIO [3, 3, C_in <= 3, "
                         f"C_out], got {list(w_q.shape)}")
    wp = _pack3x3(w_q)
    wp = torch.nn.functional.pad(wp, (0, ENTRY_K - wp.shape[1])).contiguous()
    _PACKS["entry_conv"] += 1
    return wp


def unpack_entry_conv_weights(wp: torch.Tensor, c_in: int) -> torch.Tensor:
    """The inverse of ``pack_entry_conv_weights``: HWIO [3, 3, C_in,
    C_out]."""
    return unpack_conv3x3_weights(wp[:, :9 * c_in], c_in)


def _s2d_phases(c_out: int) -> int:
    """Columns of one pool phase in K2's packed weights: C_out rounded up
    to 16 or 32."""
    return 16 if c_out <= 16 else 32


def _pack_phases(w_q: torch.Tensor, column, what: str) -> torch.Tensor:
    """HWIO weights [3, 3, C_in, C_out] (C_in <= 4, C_out <= 32) as K2's
    phase-packed block-conv weights, K-major: [4 * CP, 64], row p * CP +
    co for pool phase p = 2a + b and output channel co (CP = 16 where
    C_out <= 16, else 32; zero rows past C_out), tap (j, k) of phase (a,
    b) at columns ``column(a + j, b + k, C_in)`` .. + C_in of the pooled
    pixel's 4x4 window (zero past 16 * C_in). Contiguous, on the weights'
    device; counted under ``what``."""
    if w_q.ndim != 4 or tuple(w_q.shape[:2]) != (3, 3):
        raise ValueError(f"3x3 weights must be HWIO [3, 3, C_in, C_out], "
                         f"got {list(w_q.shape)}")
    c_in, c_out = w_q.shape[2], w_q.shape[3]
    if c_in > 4 or c_out > 32:
        raise ValueError(f"K2's wgmma weights take C_in <= 4 and C_out <= "
                         f"32, got {c_in} -> {c_out}")
    cp = _s2d_phases(c_out)
    wp = torch.zeros((4, cp, POOL_K), dtype=torch.int8, device=w_q.device)
    for a in range(2):              # pool phase row
        for bph in range(2):        # pool phase column
            for j in range(3):      # 3x3 tap
                for k in range(3):
                    k0 = column(a + j, bph + k, c_in)
                    wp[a * 2 + bph, :c_out, k0:k0 + c_in] = w_q[j, k].t()
    _PACKS[what] += 1
    return wp.reshape(4 * cp, POOL_K).contiguous()


def _unpack_phases(wp: torch.Tensor, c_in: int, c_out: int,
                   column) -> torch.Tensor:
    """The inverse of ``_pack_phases``: HWIO [3, 3, C_in, C_out], read from
    pool phase 0, whose window holds all nine taps."""
    w = torch.empty((3, 3, c_in, c_out), dtype=wp.dtype, device=wp.device)
    for j in range(3):
        for k in range(3):
            k0 = column(j, k, c_in)
            w[j, k] = wp[:c_out, k0:k0 + c_in].t()
    return w


def _s2d_column(m: int, n: int, c: int) -> int:
    """Column of 4x4-window pixel (m, n) in K2's s2d K order (r, s, py, px,
    c): m = 2r + py, n = 2s + px."""
    return (m // 2) * 8 * c + (n // 2) * 4 * c + ((m % 2) * 2 + n % 2) * c


def pack_pool_s2d_weights(w_q: torch.Tensor) -> torch.Tensor:
    """K2's HWIO weights [3, 3, C_in, C_out] (C_in <= 4, C_out <= 32) as the
    phase-packed block-conv weights its wgmma kernel reads, made once per
    model (``_pack_phases``): column k = r * 8C + s * 4C + (py * 2 + px) *
    C + c of the s2d 4x4 window, ``fixed_point._s2d_phase_weights`` of the
    JAX package transposed K-major."""
    return _pack_phases(w_q, _s2d_column, "pool_s2d")


def unpack_pool_s2d_weights(wp: torch.Tensor, c_in: int,
                            c_out: int) -> torch.Tensor:
    """The inverse of ``pack_pool_s2d_weights``: HWIO [3, 3, C_in,
    C_out]."""
    return _unpack_phases(wp, c_in, c_out, _s2d_column)


def _s2d_hwio(w_q, packed, c_in, c_out):
    """K2's HWIO weights where given, else those of ``packed``."""
    return (w_q if w_q is not None
            else unpack_pool_s2d_weights(packed, c_in, c_out))


def entry_conv_pack_count() -> int:
    """Calls of ``pack_entry_conv_weights`` since the last reset."""
    return _PACKS["entry_conv"]


def reset_entry_conv_pack_count() -> None:
    _PACKS["entry_conv"] = 0


def pool_s2d_pack_count() -> int:
    """Calls of ``pack_pool_s2d_weights`` since the last reset."""
    return _PACKS["pool_s2d"]


def reset_pool_s2d_pack_count() -> None:
    _PACKS["pool_s2d"] = 0


# the launch layout of either kernel of csrc/int8_entry_conv.cu, as its
# _info entry reports it: tile (whole rows of the output, or of the pooled
# output), shared memory, blocks per SM, columns of the wgmma (BN), its
# warpgroups, and the shared input and output row pitches
RowTileLayout = collections.namedtuple("RowTileLayout", (
    "tile_h", "tile_w", "smem_bytes", "blocks_per_sm", "bn", "warpgroups",
    "in_pitch", "out_pitch"))


def _row_layout(entry, what, h, w, c_in, c_out) -> RowTileLayout:
    from yolo_tpu_torch.kernels import build

    lib = build.load()
    info = (ctypes.c_int * len(RowTileLayout._fields))()
    rc = getattr(lib, entry + "_info")(h, w, c_in, c_out, info)
    if rc == _CUDA_ERROR_INVALID_VALUE:
        raise ValueError(f"the {what} kernel takes no {h}x{w} conv of C_in "
                         f"{c_in} -> C_out {c_out}")
    if rc:
        raise RuntimeError(f"{entry}_info failed: "
                           f"{lib.yolo_int8_error_string(rc).decode()}")
    return RowTileLayout(*info)


@functools.lru_cache(maxsize=None)
def entry_conv3x3_layout(h, w, c_in, c_out) -> RowTileLayout:
    """The entry conv kernel's launch layout for an H x W x C_in -> C_out
    conv, as its CUDA source picks it (``plan_rows`` in
    ``csrc/int8_entry_conv.cu``). Needs the built kernels. Raises
    ValueError where the kernel takes no such conv (C_in > 3, C_out > 64)."""
    return _row_layout(ENTRY_CONV_ENTRY, "entry conv", h, w, c_in, c_out)


@functools.lru_cache(maxsize=None)
def pool_s2d_wgmma_layout(h, w, c_in, c_out) -> RowTileLayout:
    """The same for K2's wgmma kernel on the s2d layout of an H x W image
    (its tile in pooled pixels). Raises ValueError where it takes no such
    conv (H or W odd, C_in > 4, C_out > 32)."""
    return _row_layout(POOL_S2D_WGMMA_ENTRY, "pooled s2d wgmma", h, w, c_in,
                       c_out)


def _check_input(x):
    if x.dtype != torch.int8 or x.ndim != 4 or not x.is_contiguous():
        raise ValueError("x must be a contiguous int8 [B, H, W, C] tensor")


def _launch_entry_conv3x3(x, w_q, b_q, packed, *, sw, sb, sa_in, sa_out,
                          retune, leaky, rounding,
                          shifts=None) -> torch.Tensor:
    """Check the operands and launch the entry conv kernel on the current
    stream, counting the launch under ``int8_conv_requant``; packs ``w_q``
    for this call where ``packed`` is None. A per-channel ``sw`` runs its
    per-column form on a shift table (``shifts``, made for this call where
    None). Raises on anything the kernel does not take and on a failed
    launch."""
    _check_rounding(rounding)
    num = _slope_num(leaky)
    _check_scalar_shifts(sb=sb, sa_in=sa_in, sa_out=sa_out, retune=retune)
    _check_input(x)
    dev = x.device
    bsz, h, w, c_in = x.shape
    if packed is None:
        packed = pack_entry_conv_weights(w_q)
    c_out = packed.shape[0]
    if not entry_conv3x3_route(3, 1, 1, 1, c_in, c_out, sw):
        raise ValueError(f"the entry conv kernel needs 1 <= C_in <= 3, "
                         f"C_out <= 64 and a scalar sw or one of C_out "
                         f"entries, got {c_in} -> {c_out}, sw of shape "
                         f"{np.shape(sw)}")
    _check_operand("packed weights", packed, dev, torch.int8,
                   (c_out, ENTRY_K))
    if not packed.is_contiguous():
        raise ValueError("the packed weights must be contiguous")
    _check_operand("b_q", b_q, dev, b_q.dtype, (c_out,))
    if bsz * h * w >= 2 ** 31:
        raise ValueError("B * H * W must stay below 2^31; split the batch")
    out = torch.empty((bsz, h, w, c_out), dtype=torch.int8, device=dev)
    if out.numel() == 0:
        return out
    entry_conv3x3_layout(h, w, c_in, c_out)  # raises where no tile fits
    bias_rt = torch.zeros(64, dtype=torch.int32, device=dev)
    bias_rt[:c_out] = _bias_at_retune(b_q, sb, retune, rounding)
    _launch_shift_form("int8_conv_requant",
                       (ENTRY_CONV_ENTRY, ENTRY_CONV_COLS_ENTRY, None), x,
                       packed, bias_rt, out, (bsz, h, w, c_in, c_out), sw=sw,
                       sa_in=sa_in, sa_out=sa_out, retune=retune,
                       rounding=rounding, num=num, shifts=shifts,
                       overflow=None)
    return out


def _launch_pool_s2d_wgmma(x2, w_q, b_q, packed, *, c_in, sw, sb, sa_in,
                           sa_out, retune, leaky, rounding) -> torch.Tensor:
    """Check the operands and launch K2's wgmma kernel on the s2d layout
    on the current stream, counting the launch under
    ``int8_conv3x3_pool_requant``; packs ``w_q`` for this call where
    ``packed`` is None. Raises on anything the kernel does not take and on
    a failed launch."""
    _check_rounding(rounding)
    num = _slope_num(leaky)
    _check_scalar_shifts(sw=sw, sb=sb, sa_in=sa_in, sa_out=sa_out,
                         retune=retune)
    _check_input(x2)
    dev = x2.device
    bsz, hb, wb, c4 = x2.shape
    c_out = b_q.shape[0]
    if c4 != 4 * c_in or hb < 4 or wb < 4:
        raise ValueError(f"s2d input must be [B, H/2+3, W/2+3, {4 * c_in}], "
                         f"got {tuple(x2.shape)}")
    if not pool_s2d_wgmma_route(c_in, c_out, sw):
        raise ValueError(f"K2's wgmma kernel needs C_in <= 4 and C_out <= "
                         f"32, got {c_in} -> {c_out}")
    if packed is None:
        packed = pack_pool_s2d_weights(w_q)
    _check_operand("packed weights", packed, dev, torch.int8,
                   (4 * _s2d_phases(c_out), POOL_K))
    if not packed.is_contiguous():
        raise ValueError("the packed weights must be contiguous")
    _check_operand("b_q", b_q, dev, b_q.dtype, (c_out,))
    h, w = 2 * (hb - 3), 2 * (wb - 3)
    if bsz * hb * wb >= 2 ** 31:
        raise ValueError("B * (H/2+3) * (W/2+3) must stay below 2^31; split "
                         "the batch")
    out = torch.empty((bsz, h // 2, w // 2, c_out), dtype=torch.int8,
                      device=dev)
    if out.numel() == 0:
        return out
    pool_s2d_wgmma_layout(h, w, c_in, c_out)  # raises where no tile fits
    bias_rt = torch.zeros(32, dtype=torch.int32, device=dev)
    bias_rt[:c_out] = _bias_at_retune(b_q, sb, retune, rounding)
    launch("int8_conv3x3_pool_requant", POOL_S2D_WGMMA_ENTRY, x2, packed,
           bias_rt, out, bsz, h, w, c_in, c_out, sa_in + sw - retune,
           retune - sa_out, num, int(rounding == "nearest"), writes=(out,),
           align=[("x", x2, 16), ("packed weights", packed, 16),
                  (OUT, out, 16)])
    return out


# ---------------------------------------------------------------------------
# The NHWC form of K2's wgmma kernel (csrc/int8_entry_conv.cu): conv3x3 + 2x2
# pool of C_in <= 4 on NHWC input (slim's conv1 there), K3's counterpart.
# ---------------------------------------------------------------------------


# its C entries: one shift per layer, a per-column shift table (a
# per-channel sw), and the table with an overflow count
POOL_NHWC_WGMMA_ENTRY = "yolo_int8_pool_nhwc_wgmma"
POOL_NHWC_COLS_ENTRY = "yolo_int8_pool_nhwc_cols_wgmma"
POOL_NHWC_COUNT_ENTRY = "yolo_int8_pool_nhwc_count_wgmma"
_POOL_NHWC_ENTRIES = (POOL_NHWC_WGMMA_ENTRY, POOL_NHWC_COLS_ENTRY,
                      POOL_NHWC_COUNT_ENTRY)


def pool_nhwc_wgmma_route(c_in, c_out, sw) -> bool:
    """True where a pooled conv3x3 on a CUDA NHWC tensor
    (``int8_conv3x3_im2col(pool=True)``, ``int8_conv3x3_pool_requant(
    assembly='stride2')``) runs the NHWC form of K2's wgmma kernel
    (``csrc/int8_entry_conv.cu``): 1 <= C_in <= 4 (K = 16 * C_in <= 64),
    1 <= C_out <= 32, and a scalar ``sw`` or a per-channel one of C_out
    entries (slim's conv1 on NHWC input, 3 -> 16). There is no fallback: a
    routed conv launches that kernel or raises."""
    return 1 <= c_in <= 4 and 1 <= c_out <= 32 and _sw_ok(sw, c_out)


def _nhwc_column(m: int, n: int, c: int) -> int:
    """Column of 4x4-window pixel (m, n) in the NHWC form's K order (dy, dx,
    c): the window's rows are NHWC runs of 4C bytes."""
    return m * 4 * c + n * c


def pack_pool_nhwc_weights(w_q: torch.Tensor) -> torch.Tensor:
    """The HWIO weights [3, 3, C_in, C_out] (C_in <= 4, C_out <= 32) of a
    pooled conv in the phase-packed form the NHWC form of K2's wgmma kernel
    reads, made once per model (``_pack_phases``): column k = dy * 4C + dx
    * C + c of the pooled pixel's 4x4 NHWC input window (tap (j, k) of
    phase (a, b) at dy = a + j, dx = b + k)."""
    return _pack_phases(w_q, _nhwc_column, "pool_nhwc")


def unpack_pool_nhwc_weights(wp: torch.Tensor, c_in: int,
                             c_out: int) -> torch.Tensor:
    """The inverse of ``pack_pool_nhwc_weights``: HWIO [3, 3, C_in,
    C_out]."""
    return _unpack_phases(wp, c_in, c_out, _nhwc_column)


def pool_nhwc_pack_count() -> int:
    """Calls of ``pack_pool_nhwc_weights`` since the last reset."""
    return _PACKS["pool_nhwc"]


def reset_pool_nhwc_pack_count() -> None:
    _PACKS["pool_nhwc"] = 0


@functools.lru_cache(maxsize=None)
def pool_nhwc_wgmma_layout(h, w, c_in, c_out) -> RowTileLayout:
    """The launch layout of the NHWC form of K2's wgmma kernel (every shift
    form's) for an H x W x C_in -> C_out pooled conv, its tile in pooled
    pixels (``plan_rows`` in ``csrc/int8_entry_conv.cu``; the shared input
    rows are 2 * tile_h + 2 NHWC rows). Needs the built kernels. Raises
    ValueError where it takes no such conv (H or W odd, C_in > 4, C_out >
    32)."""
    return _row_layout(POOL_NHWC_WGMMA_ENTRY, "pooled NHWC wgmma", h, w,
                       c_in, c_out)


def _launch_pool_nhwc_wgmma(name, x, w_q, b_q, packed, *, sw, sb, sa_in,
                            sa_out, retune, leaky, rounding, shifts=None,
                            overflow=None) -> torch.Tensor:
    """Check the operands and launch the NHWC form of K2's wgmma kernel on
    the current stream, counting the launch under ``name``; packs ``w_q``
    for this call where ``packed`` is None. A per-channel ``sw`` runs its
    per-column form and an ``overflow`` counter its counting form, on a
    per-column shift table (``shifts``, made for this call where None).
    Raises on anything the kernel does not take and on a failed launch."""
    _check_rounding(rounding)
    num = _slope_num(leaky)
    _check_scalar_shifts(sb=sb, sa_in=sa_in, sa_out=sa_out, retune=retune)
    _check_input(x)
    dev = x.device
    bsz, h, w, c_in = x.shape
    c_out = b_q.shape[0]
    if not pool_nhwc_wgmma_route(c_in, c_out, sw):
        raise ValueError(f"the pooled NHWC wgmma kernel needs C_in <= 4, "
                         f"C_out <= 32 and a scalar sw or one of C_out "
                         f"entries, got {c_in} -> {c_out}, sw of shape "
                         f"{np.shape(sw)}")
    if h % 2 or w % 2:
        raise ValueError("pooled conv requires even H, W")
    if packed is None:
        packed = pack_pool_nhwc_weights(w_q)
    _check_operand("packed weights", packed, dev, torch.int8,
                   (4 * _s2d_phases(c_out), POOL_K))
    if not packed.is_contiguous():
        raise ValueError("the packed weights must be contiguous")
    _check_operand("b_q", b_q, dev, b_q.dtype, (c_out,))
    if bsz * h * w >= 2 ** 31:
        raise ValueError("B * H * W must stay below 2^31; split the batch")
    if overflow is not None:
        _check_counter(overflow, dev)
    out = torch.empty((bsz, h // 2, w // 2, c_out), dtype=torch.int8,
                      device=dev)
    if out.numel() == 0:
        return out
    pool_nhwc_wgmma_layout(h, w, c_in, c_out)  # raises where no tile fits
    # the kernel reads bias (and shift) pairs of 4 phases' 16 or 32 columns
    bias_rt = torch.zeros(32, dtype=torch.int32, device=dev)
    bias_rt[:c_out] = _bias_at_retune(b_q, sb, retune, rounding)
    _launch_shift_form(name, _POOL_NHWC_ENTRIES, x, packed, bias_rt, out,
                       (bsz, h, w, c_in, c_out), sw=sw, sa_in=sa_in,
                       sa_out=sa_out, retune=retune, rounding=rounding,
                       num=num, shifts=shifts, overflow=overflow)
    return out


# ---------------------------------------------------------------------------
# The wgmma 1x1 conv (csrc/int8_conv1x1_wgmma.cu): yolo_v3's fourteen 1x1s,
# two-part concat inputs and preds included, as one GEMM.
# ---------------------------------------------------------------------------


CONV1X1_ENTRY = "yolo_int8_conv1x1_wgmma"
# its per-column form (a per-channel sw: a shift table per group of parts)
CONV1X1_COLS_ENTRY = "yolo_int8_conv1x1_cols_wgmma"
# the kernel keeps all of K of its column tile in shared memory: the
# parts' channels, each rounded up to 128, at most 4096 in all
CONV1X1_MAX_K = 4096


def conv1x1_wgmma_route(k, stride, padding, nparts, cins, sw,
                        c_out=None) -> bool:
    """True where ``int8_conv_requant`` on a CUDA tensor runs the wgmma 1x1
    kernel (``csrc/int8_conv1x1_wgmma.cu``): a 1x1, stride 1, pad 0, one or
    two input parts (``cins``: each part's channels) of C_in % 16 == 0,
    at most ``CONV1X1_MAX_K`` channels in all once each part is rounded
    up to 128, and a scalar ``sw`` or a per-channel one of ``c_out``
    entries (its per-column form; yolo_v3's nine 1x1s, two concat 1x1s
    and three preds). Every other conv, the padded 1x1 included, keeps its
    route. There is no fallback: a routed conv launches the kernel or
    raises."""
    return (k == 1 and stride == 1 and padding == 0 and nparts in (1, 2)
            and len(cins) == nparts
            and all(c > 0 and c % 16 == 0 for c in cins)
            and sum(-(-c // 128) * 128 for c in cins) <= CONV1X1_MAX_K
            and _sw_ok(sw, c_out))


def pack_conv1x1_weights(w_q: torch.Tensor) -> torch.Tensor:
    """A 1x1 conv's HWIO weights [1, 1, C_in, C_out] (C_in: all parts of a
    concat input) in the K-major form its wgmma kernel reads, made once per
    model: [C_out, C_in], contiguous, on the weights' device."""
    if w_q.ndim != 4 or tuple(w_q.shape[:2]) != (1, 1):
        raise ValueError(f"1x1 weights must be HWIO [1, 1, C_in, C_out], "
                         f"got {list(w_q.shape)}")
    _PACKS["conv1x1"] += 1
    return w_q[0, 0].t().contiguous()


def unpack_conv1x1_weights(wp: torch.Tensor) -> torch.Tensor:
    """The inverse of ``pack_conv1x1_weights``: an HWIO [1, 1, C_in, C_out]
    view of the packed weights."""
    return wp.t()[None, None]


def conv1x1_pack_count() -> int:
    """Calls of ``pack_conv1x1_weights`` since the last reset."""
    return _PACKS["conv1x1"]


def reset_conv1x1_pack_count() -> None:
    _PACKS["conv1x1"] = 0


# the wgmma 1x1 kernel's launch layout, as yolo_int8_conv1x1_wgmma_info
# reports it: rows and columns (BN) of a tile, ring stages, resident
# blocks per SM, shared memory, blocks launched (each walking its M tiles),
# column tiles, and the bytes of a block's resident weights
Conv1x1Layout = collections.namedtuple("Conv1x1Layout", (
    "tile_m", "bn", "ring_stages", "blocks_per_sm", "smem_bytes", "grid",
    "n_tiles", "weight_bytes"))


@functools.lru_cache(maxsize=None)
def conv1x1_wgmma_layout(m, cin0, cin1, c_out, split) -> Conv1x1Layout:
    """The wgmma 1x1 kernel's launch layout (both shift forms') for an
    M x (cin0 + cin1) -> C_out GEMM (cin1 0: one part) whose two parts
    take different accumulator shifts (``split``) or not, as its CUDA
    source picks it (``plan`` in ``csrc/int8_conv1x1_wgmma.cu``). Needs
    the built kernels. Raises ValueError where the kernel takes no such
    conv."""
    from yolo_tpu_torch.kernels import build

    lib = build.load()
    info = (ctypes.c_int * len(Conv1x1Layout._fields))()
    rc = lib.yolo_int8_conv1x1_wgmma_info(m, cin0, cin1, c_out, int(split),
                                          info)
    if rc == _CUDA_ERROR_INVALID_VALUE:
        raise ValueError(f"the 1x1 wgmma kernel takes no {m}-row conv of "
                         f"C_in {cin0} + {cin1} -> C_out {c_out}: each part "
                         f"needs C_in % 16 == 0, at most {CONV1X1_MAX_K} "
                         f"channels in all")
    if rc:
        raise RuntimeError(f"yolo_int8_conv1x1_wgmma_info failed: "
                           f"{lib.yolo_int8_error_string(rc).decode()}")
    return Conv1x1Layout(*info)


def _launch_conv1x1_wgmma(parts, w_q, b_q, packed, *, sw, sb, sa_out,
                          retune, leaky, rounding,
                          shifts=None) -> torch.Tensor:
    """Check the operands and launch the wgmma 1x1 kernel on the current
    stream, counting the launch under ``int8_conv_requant``; ``parts``: the
    (int8 tensor, sa) parts of the input; packs ``w_q`` for this call where
    ``packed`` is None. A per-channel ``sw`` runs its per-column form on
    the tables of ``conv_shift_tables`` (``shifts``, made for this call
    where None): one where the parts' scales agree, one per part (split)
    where they differ. Raises on anything the kernel does not take and on
    a failed launch."""
    num, cins = _check_parts(parts, sb=sb, sa_out=sa_out, retune=retune,
                             leaky=leaky, rounding=rounding)
    x0 = parts[0][0]
    dev = x0.device
    bsz, h, w = x0.shape[:3]
    if packed is None:
        packed = pack_conv1x1_weights(w_q)
    c_out = packed.shape[0]
    if not conv1x1_wgmma_route(1, 1, 0, len(parts), cins, sw, c_out=c_out):
        raise ValueError(f"the 1x1 wgmma kernel takes one or two parts of "
                         f"C_in % 16 == 0, at most {CONV1X1_MAX_K} channels "
                         f"in all, and a scalar sw or one of C_out = "
                         f"{c_out} entries, got {cins}, sw of shape "
                         f"{np.shape(sw)}")
    _check_operand("packed weights", packed, dev, torch.int8,
                   (c_out, sum(cins)))
    if not packed.is_contiguous():
        raise ValueError("the packed weights must be contiguous")
    _check_operand("b_q", b_q, dev, b_q.dtype, (c_out,))
    m = bsz * h * w
    if m >= 2 ** 31:
        raise ValueError("B * H * W must stay below 2^31; split the batch")
    out = torch.empty((bsz, h, w, c_out), dtype=torch.int8, device=dev)
    if out.numel() == 0:
        return out
    sas = [sa for _, sa in parts]
    two, cols = len(parts) == 2, bool(np.ndim(sw))
    # the parts' accumulator shifts differ: per-channel, where their input
    # scales do (int_conv_requant's groups)
    split = (sas[0] != sas[-1] if cols
             else sw + sas[0] - retune != sw + sas[-1] - retune)
    # raises where no tile fits
    conv1x1_wgmma_layout(m, cins[0], cins[1] if two else 0, c_out, split)
    # the kernel reads bias (and shift) pairs of whole 32- to 256-column
    # tiles
    bias_rt = torch.zeros(-(-c_out // CONV1X1_ALIGN) * CONV1X1_ALIGN,
                          dtype=torch.int32, device=dev)
    bias_rt[:c_out] = _bias_at_retune(b_q, sb, retune, rounding)
    x1 = parts[1][0] if two else None
    tail = (retune - sa_out, num, int(rounding == "nearest"))
    align = [*((f"input part {i}", xq, 16) for i, (xq, _) in enumerate(parts)),
             ("packed weights", packed, 16), (OUT, out, 16)]
    if not cols:
        launch("int8_conv_requant", CONV1X1_ENTRY, x0, x1, packed, bias_rt,
               out, m, cins[0], cins[1] if two else 0, c_out,
               sw + sas[0] - retune, sw + sas[-1] - retune, *tail,
               writes=(out,), align=align)
        return out
    groups = list(dict.fromkeys(sas))
    if shifts is None:
        shifts = conv_shift_tables(sw, sas, retune, rounding, c_out, dev,
                                   CONV1X1_ALIGN)
    if len(shifts) != len(groups):
        raise ValueError(f"parts of {len(groups)} input scales take "
                         f"{len(groups)} shift tables, got {len(shifts)}")
    tables = [_table_for(t, sw, sa, retune, rounding, c_out, dev,
                         CONV1X1_ALIGN) for t, sa in zip(shifts, groups)]
    short = all(short_columns(acc_shift_codes(sw, sa, retune, rounding,
                                              c_out)) for sa in groups)
    launch("int8_conv_requant", CONV1X1_COLS_ENTRY, x0, x1, packed, bias_rt,
           tables[0], tables[-1], out, m, cins[0], cins[1] if two else 0,
           c_out, int(split), int(short), *tail, writes=(out,),
           align=[*align, *((TABLE, t, 8) for t in tables)])
    return out
