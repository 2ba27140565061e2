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

K1-K3 and ``int8_conv_requant`` launch the tensor-core implicit GEMM of
``csrc/int8_conv.cuh`` (built by ``csrc/int8_conv.cu`` and
``csrc/int8_conv_general.cu``), K4 the fused block of
``csrc/int8_res_block.cu`` (each file's header note says what bounds
them). A wrapper given a CUDA tensor launches the kernel, adds one to its
count in ``launch_counts()`` once the launch has succeeded, and raises if
it fails or if the kernel does not take its arguments; given a CPU tensor
it runs the plain version, which is exact integer arithmetic: float64
per-tap matmuls (exact while |acc| < 2^53; yolo_v3 reaches 1.5e8) and the
int32 requant chain of ``fixed_point``.
"""

from __future__ import annotations

import numpy as np
import torch

from yolo_tpu_torch.kernels import (  # noqa: F401  (re-exported)
    KERNEL_NAMES, launch, launch_counts, reset_launch_counts, route)
from yolo_tpu_torch.quant import fixed_point as fp


def _bias_at_retune(b_q: torch.Tensor, sb: int, retune: int,
                    rounding: str) -> torch.Tensor:
    """Bias shifted to the retune scale, exactly, as int32 [C_out]."""
    return fp._shift(b_q.to(torch.int32), sb - retune, rounding).contiguous()


def _check_scalar_shifts(**shifts):
    for k, v in shifts.items():
        if np.ndim(v):
            raise ValueError(
                f"{k} must be a scalar: the kernels' epilogue takes one "
                f"shift per layer (per-channel sw is not ported yet)")


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
                        leaky, pool, rounding):
    acc = _conv_acc(xp, w_q)
    out = fp._requant(acc, _bias_at_retune(b_q, sb, retune, rounding),
                      acc_shift=sa_in + sw - retune,
                      out_shift=retune - sa_out, leaky=leaky,
                      rounding=rounding)
    return fp._maxpool_int(out) if pool else out


def _pad1(x_q: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.pad(x_q, (0, 0, 1, 1, 1, 1))


def int8_conv3x3_requant_plain(x_q, w_q, b_q, *, sw, sb, sa_in, sa_out,
                               retune, leaky=True, rounding="nearest"):
    return _plain_conv_requant(_pad1(x_q), w_q, b_q, sw=sw, sb=sb,
                               sa_in=sa_in, sa_out=sa_out, retune=retune,
                               leaky=leaky, pool=False, rounding=rounding)


def int8_conv3x3_im2col_plain(x_q, w_q, b_q, *, sw, sb, sa_in, sa_out,
                              retune, leaky=True, pool=False,
                              rounding="nearest"):
    return _plain_conv_requant(_pad1(x_q), w_q, b_q, sw=sw, sb=sb,
                               sa_in=sa_in, sa_out=sa_out, retune=retune,
                               leaky=leaky, pool=pool, rounding=rounding)


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


def int8_conv3x3_pool_s2d_plain(x2, w_q, b_q, *, c_in, sw, sb, sa_in,
                                sa_out, retune, leaky=True,
                                rounding="nearest"):
    """The JAX package's ``int8_conv_pool_s2d_core`` in torch: a 2x2 block
    conv with phase-packed weights over the s2d layout, requant, then
    the max over the four phase groups."""
    b, hb, wb, _ = x2.shape
    ho, wo = hb - 3, wb - 3
    c_out = w_q.shape[-1]
    w4 = torch.as_tensor(
        fp._s2d_phase_weights(w_q.cpu().numpy(), c_in, c_out),
        device=x2.device).to(torch.float64)
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


def _check_operand(name, t, dev, dtype, shape):
    if t.dtype != dtype or t.device != dev or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must be {dtype} {list(shape)} on {dev}, got "
                         f"{t.dtype} {list(t.shape)} on {t.device}")


def _aligned(name, t, align):
    if t.data_ptr() % align:
        raise ValueError(f"{name} must be {align}-byte aligned")


def _launch(kernel, x, w_q, b_q, *, h, w, c_in, pool, s2d, sw, sb, sa_in,
            sa_out, retune, leaky, rounding) -> torch.Tensor:
    """Check the operands and launch the conv3x3 kernel on the current
    stream, counting the launch under ``kernel``; returns the int8 output.
    Raises on anything the kernel does not take and on a failed launch."""
    _check_rounding(rounding)
    if leaky is not True and leaky is not False:
        raise ValueError(f"leaky must be True or False, got {leaky!r}")
    _check_scalar_shifts(sw=sw, sb=sb, sa_in=sa_in, sa_out=sa_out,
                         retune=retune)
    dev = x.device
    if x.dtype != torch.int8 or not x.is_contiguous():
        raise ValueError("x must be a contiguous int8 tensor")
    c_out = w_q.shape[-1]
    _check_operand("w_q", w_q, dev, torch.int8, (3, 3, c_in, c_out))
    if tuple(b_q.shape) != (c_out,) or b_q.device != dev:
        raise ValueError(f"b_q must be [{c_out}] on {dev}")
    if (pool or s2d) and (h % 2 or w % 2):
        raise ValueError("pooled conv requires even H, W")
    w_c = w_q.contiguous()
    # 4-byte loads on the s2d layout, 16-byte loads when C_in % 16 == 0
    _aligned("x", x, 4 if s2d else 16 if c_in % 16 == 0 else 1)
    _aligned("w_q", w_c, 4)
    bsz = x.shape[0]
    if bsz * h * w >= 2 ** 31:
        raise ValueError("B * H * W must stay below 2^31; split the batch")
    ho, wo = (h // 2, w // 2) if pool else (h, w)
    out = torch.empty((bsz, ho, wo, c_out), dtype=torch.int8, device=dev)
    if out.numel() == 0:
        return out
    _aligned("the output allocation", out, 16)
    bias_rt = _bias_at_retune(b_q, sb, retune, rounding)
    launch(kernel, "yolo_int8_conv3x3_requant", dev,
           x.data_ptr(), w_c.data_ptr(), bias_rt.data_ptr(), out.data_ptr(),
           bsz, h, w, c_in, c_out, sa_in + sw - retune, retune - sa_out,
           int(leaky), int(rounding == "nearest"), int(pool), int(s2d))
    return out


# ---------------------------------------------------------------------------
# Public wrappers.
# ---------------------------------------------------------------------------


def int8_conv3x3_requant(x_q, w_q, b_q, *, sw, sb, sa_in, sa_out, retune,
                         leaky=True, rounding="nearest"):
    """Fused int8 conv3x3(stride 1, pad 1) + requant: int8 [B,H,W,C_in]
    at scale 2^sa_in -> int8 [B,H,W,C_out] at scale 2^sa_out."""
    kw = dict(sw=sw, sb=sb, sa_in=sa_in, sa_out=sa_out, retune=retune,
              leaky=leaky, rounding=rounding)
    if route(x_q) == "plain":
        return int8_conv3x3_requant_plain(x_q, w_q, b_q, **kw)
    b, h, w, c_in = x_q.shape
    return _launch("int8_conv3x3_requant", x_q, w_q, b_q, h=h, w=w,
                   c_in=c_in, pool=False, s2d=False, **kw)


def int8_conv3x3_im2col(x_q, w_q, b_q, *, sw, sb, sa_in, sa_out, retune,
                        leaky=True, pool=False, rounding="nearest"):
    """Fused int8 conv3x3(s1, p1) + requant [+ 2x2/2 max pool, taken on the
    int32 accumulator before requant: exact, the chain is monotone]."""
    kw = dict(sw=sw, sb=sb, sa_in=sa_in, sa_out=sa_out, retune=retune,
              leaky=leaky, rounding=rounding)
    if route(x_q) == "plain":
        return int8_conv3x3_im2col_plain(x_q, w_q, b_q, pool=pool, **kw)
    b, h, w, c_in = x_q.shape
    return _launch("int8_conv3x3_im2col", x_q, w_q, b_q, h=h, w=w,
                   c_in=c_in, pool=pool, s2d=False, **kw)


def int8_conv3x3_pool_requant(x_q, w_q, b_q, *, sw, sb, sa_in, sa_out,
                              retune, leaky=True, rounding="nearest",
                              assembly="stride2"):
    """Fused int8 conv3x3(s1, p1) + 2x2/2 max pool + requant at pooled
    resolution: int8 [B,H,W,C_in] -> int8 [B,H/2,W/2,C_out].

    ``assembly='stride2'`` reads the NHWC input directly; ``'s2d'`` first
    lays it out as padded space-to-depth (``fixed_point.s2d_input``) and
    runs the s2d-input form, ``int8_conv3x3_pool_s2d``."""
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
    return _launch("int8_conv3x3_pool_requant", x_q, w_q, b_q, h=h, w=w,
                   c_in=c_in, pool=True, s2d=False, **kw)


def int8_conv3x3_pool_s2d(x2, w_q, b_q, *, c_in, sw, sb, sa_in, sa_out,
                          retune, leaky=True, rounding="nearest"):
    """conv3x3 + requant + 2x2 pool reading the padded space-to-depth
    layout [B, H/2+3, W/2+3, 4*C_in] (``fixed_point.s2d_input_np``) ->
    int8 [B, H/2, W/2, C_out]. Counts as a launch of
    ``int8_conv3x3_pool_requant`` (K2)."""
    kw = dict(sw=sw, sb=sb, sa_in=sa_in, sa_out=sa_out, retune=retune,
              leaky=leaky, rounding=rounding)
    if x2.ndim != 4 or x2.shape[-1] != 4 * c_in:
        raise ValueError(f"s2d input must be [B, H/2+3, W/2+3, {4 * c_in}], "
                         f"got {tuple(x2.shape)}")
    if route(x2) == "plain":
        return int8_conv3x3_pool_s2d_plain(x2, w_q, b_q, c_in=c_in, **kw)
    b, hb, wb, _ = x2.shape
    return _launch("int8_conv3x3_pool_requant", x2, w_q, b_q,
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
                            rounding="nearest"):
    """``fixed_point.int_conv_requant`` of the JAX package, without the
    residual: each part's raw int32 partial is summed with the partials of
    equal shift, each group shifted to the retune scale, then the requant
    chain. ``sw`` may be per-channel (an int32 [C_out] array)."""
    _check_rounding(rounding)
    _slope_num(leaky)
    sw_pc = np.ndim(sw) > 0
    raw: dict = {}
    c_ofs = 0
    for xq, sa in _parts(x, sa_in):
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


def _launch_conv_requant(parts, w_q, b_q, *, sw, sb, sa_out, retune,
                         padding, stride, leaky, rounding) -> torch.Tensor:
    _check_rounding(rounding)
    num = _slope_num(leaky)
    _check_scalar_shifts(sw=sw, sb=sb, sa_out=sa_out, retune=retune,
                         **{f"sa_in{i}": sa for i, (_, sa) in
                            enumerate(parts)})
    if len(parts) > 2:
        raise ValueError(f"the conv kernel takes one or two input parts, got "
                         f"{len(parts)}")
    x0 = parts[0][0]
    dev = x0.device
    bsz, h, w = x0.shape[:3]
    for i, (xq, _) in enumerate(parts):
        if (xq.dtype != torch.int8 or xq.device != dev or xq.ndim != 4
                or tuple(xq.shape[:3]) != (bsz, h, w)
                or not xq.is_contiguous()):
            raise ValueError(f"input part {i} must be a contiguous int8 "
                             f"[{bsz}, {h}, {w}, C] tensor on {dev}")
    cins = [xq.shape[-1] for xq, _ in parts]
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
    for i, ((xq, _), c) in enumerate(zip(parts, cins)):
        _aligned(f"input part {i}", xq, 16 if c % 16 == 0 else 1)
    w_parts, ofs = [], 0
    for c in cins:
        w_parts.append(w_q[:, :, ofs:ofs + c].contiguous())
        _aligned("w_q", w_parts[-1], 4)
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
    _aligned("the output allocation", out, 16)
    bias_rt = _bias_at_retune(b_q, sb, retune, rounding)
    shifts = [sw + sa - retune for _, sa in parts]
    two = len(parts) == 2
    launch("int8_conv_requant", "yolo_int8_conv_requant", dev,
           x0.data_ptr(), w_parts[0].data_ptr(),
           parts[1][0].data_ptr() if two else 0,
           w_parts[1].data_ptr() if two else 0,
           bias_rt.data_ptr(), out.data_ptr(), bsz, h, w, cins[0],
           cins[1] if two else 0, c_out, k, stride, padding, len(parts),
           shifts[0], shifts[-1], retune - sa_out, num,
           int(rounding == "nearest"))
    return out


def int8_conv_requant(x, w_q, b_q, *, sw, sb, sa_in, sa_out, retune,
                      padding=0, stride=1, leaky=True, rounding="nearest"):
    """Integer conv (k 1 or 3 HWIO weights, any stride and padding) +
    fixed-point requant: int8 NHWC at scale 2^sa_in -> int8 at 2^sa_out.

    ``x`` is an int8 tensor, or a list of (int8 tensor, sa) parts whose
    channel concat is the conv input (``sa_in`` is then unused); ``leaky``
    is False, True (0.125) or a float slope (Q16 rational). The kernel
    takes one or two parts and a scalar ``sw``; the plain version also a
    per-channel one."""
    parts = _parts(x, sa_in)
    kw = dict(sw=sw, sb=sb, sa_out=sa_out, retune=retune, padding=padding,
              stride=stride, leaky=leaky, rounding=rounding)
    if route(parts[0][0]) == "plain":
        return int8_conv_requant_plain(parts, w_q, b_q, sa_in=None, **kw)
    return _launch_conv_requant(parts, w_q, b_q, **kw)


def int8_res_block_plain(x_q, w1_q, b1_q, p1, w2_q, b2_q, p2, *,
                         sa_res=None, leaky=True, rounding="nearest"):
    """The chain K4 fuses: 1x1 conv + requant, 3x3 conv (pad 1) + requant,
    and with ``sa_res`` the residual add with ``x_q``, requantized to
    2^sa_res (``fixed_point.int_add_requant``)."""
    w1 = w1_q.reshape(1, 1, *w1_q.shape[-2:])
    y1 = int8_conv_requant_plain(x_q, w1, b1_q, padding=0, leaky=leaky,
                                 rounding=rounding, **p1)
    out = int8_conv_requant_plain(y1, w2_q, b2_q, padding=1, leaky=leaky,
                                  rounding=rounding, **p2)
    if sa_res is not None:
        out = fp.int_add_requant(out, p2["sa_out"], x_q, p1["sa_in"], sa_res,
                                 rounding)
    return out


# the largest dynamic shared memory a block may take (H100: 227 KB)
_MAX_SMEM = 232448


def _res_block_tile(h, w, cmid):
    """Output tile (th, tw) of the K4 kernel: up to 16 x 16 pixels, whose
    y1 with its halo and the two 15 KB GEMM stages fit in shared memory
    (C_mid <= 512 at every size)."""
    th, tw = min(16, h), min(16, w)
    if (th + 2) * (tw + 2) * cmid + 16 + 2 * (128 + 64) * 20 * 4 > _MAX_SMEM:
        raise ValueError(f"C_mid = {cmid} is too wide for the residual block "
                         f"kernel's shared memory")
    return th, tw


def _launch_res_block(x_q, w1, b1_q, p1, w2_q, b2_q, p2, *, sa_res, leaky,
                      rounding) -> torch.Tensor:
    _check_rounding(rounding)
    num = _slope_num(leaky)
    _check_scalar_shifts(**{f"{k}1": v for k, v in p1.items()},
                         **{f"{k}2": v for k, v in p2.items()},
                         sa_res=sa_res or 0)
    dev = x_q.device
    if x_q.dtype != torch.int8 or x_q.ndim != 4 or not x_q.is_contiguous():
        raise ValueError("x_q must be a contiguous int8 [B, H, W, C] tensor")
    bsz, h, w, c = x_q.shape
    cmid = w1.shape[-1]
    if c % 64 or cmid % 32:
        raise ValueError(f"the residual block kernel needs C % 64 == 0 and "
                         f"C_mid % 32 == 0, got C {c}, C_mid {cmid}")
    _check_operand("w1_q", w1, dev, torch.int8, (c, cmid))
    _check_operand("w2_q", w2_q, dev, torch.int8, (3, 3, cmid, c))
    _check_operand("b1_q", b1_q, dev, b1_q.dtype, (cmid,))
    _check_operand("b2_q", b2_q, dev, b2_q.dtype, (c,))
    w1, w2 = w1.contiguous(), w2_q.contiguous()
    _aligned("x_q", x_q, 16)
    _aligned("w1_q", w1, 4)
    _aligned("w2_q", w2, 4)
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
    _aligned("the output allocation", out, 16)
    b1_rt = _bias_at_retune(b1_q, p1["sb"], p1["retune"], rounding)
    b2_rt = _bias_at_retune(b2_q, p2["sb"], p2["retune"], rounding)
    th, tw = _res_block_tile(h, w, cmid)
    launch("int8_res_block", "yolo_int8_res_block", dev,
           x_q.data_ptr(), w1.data_ptr(), b1_rt.data_ptr(), w2.data_ptr(),
           b2_rt.data_ptr(), out.data_ptr(), bsz, h, w, c, cmid, th, tw,
           p1["sa_in"] + p1["sw"] - p1["retune"], p1["retune"] - p1["sa_out"],
           p2["sa_in"] + p2["sw"] - p2["retune"], p2["retune"] - p2["sa_out"],
           num, int(rounding == "nearest"), int(sa_res is not None),
           *sh)
    return out


def int8_res_block(x_q, w1_q, b1_q, p1, w2_q, b2_q, p2, *, sa_res=None,
                   leaky=True, rounding="nearest"):
    """Fused darknet residual block: int8 [B,H,W,C] -> 1x1 conv + requant
    (C -> Cmid) -> 3x3 conv (s1, p1) + requant (Cmid -> C) -> [residual
    add + requant to 2^sa_res] -> int8 [B,H,W,C], the mid activation kept
    on chip. ``p1``/``p2`` carry sw, sb, sa_in, sa_out, retune; ``w1_q`` is
    [C, Cmid] or [1, 1, C, Cmid]; ``leaky`` is False, True (0.125) or a
    float slope (the darknet53 backbone's 0.1), for both convs."""
    if p2["sa_in"] != p1["sa_out"]:
        raise ValueError("conv2's sa_in must be conv1's sa_out")
    w1 = w1_q.reshape(w1_q.shape[-2], w1_q.shape[-1])
    kw = dict(sa_res=sa_res, leaky=leaky, rounding=rounding)
    if route(x_q) == "plain":
        return int8_res_block_plain(x_q, w1, b1_q, p1, w2_q, b2_q, p2, **kw)
    return _launch_res_block(x_q, w1, b1_q, p1, w2_q, b2_q, p2, **kw)
