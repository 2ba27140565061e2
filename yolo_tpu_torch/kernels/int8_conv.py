"""Fused int8 conv3x3 + fixed-point requant: CUDA kernels and their plain
PyTorch versions (counterpart of ``yolo_tpu/kernels/int8_conv.py``).

Three wrappers with the JAX package's signatures (minus ``interpret`` and
the TPU tiling arguments), plus the space-to-depth input form conv1 uses:

- ``int8_conv3x3_requant``      replaces ``_conv_kernel`` (K1);
- ``int8_conv3x3_pool_requant`` replaces ``_pool_matmul_kernel`` (K2),
  and so does ``int8_conv3x3_pool_s2d`` (its s2d-input form);
- ``int8_conv3x3_im2col``       replaces ``_im2col_kernel`` (K3).

They launch the tensor-core implicit GEMMs of ``csrc/int8_conv.cu`` (its
header note says what bounds them): a conv kernel, with a fused 2x2 pool
for K3 and K2's ``'stride2'`` assembly, and the pooled-window kernel on the
s2d layout for ``int8_conv3x3_pool_s2d``. A wrapper
given a CUDA tensor launches the kernel, adds one to its count in
``launch_counts()`` once the launch has succeeded, and raises if it fails; given a CPU tensor it runs the
plain version, which is exact integer arithmetic: float64 per-tap
matmuls (exact while |acc| < 2^53; slim reaches 3.7e7) and the int32
requant chain of ``fixed_point``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from yolo_tpu_torch.quant import fixed_point as fp

KERNEL_NAMES = ("int8_conv3x3_requant", "int8_conv3x3_pool_requant",
                "int8_conv3x3_im2col")
# kernel launches since the last reset, by wrapper name
_LAUNCHES = dict.fromkeys(KERNEL_NAMES, 0)


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


def _conv3x3_acc(xp: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """int32 accumulator of a 3x3 valid conv over an already padded
    [B, H+2, W+2, C_in] int8 input and HWIO weights -> [B, H, W, C_out]."""
    h, w = xp.shape[1] - 2, xp.shape[2] - 2
    xf = xp.to(torch.float64)
    wf = w_q.to(torch.float64)
    acc = None
    for dy in range(3):
        for dx in range(3):
            p = torch.matmul(xf[:, dy:dy + h, dx:dx + w, :], wf[dy, dx])
            acc = p if acc is None else acc + p
    return acc.to(torch.int32)


def _plain_conv_requant(xp, w_q, b_q, *, sw, sb, sa_in, sa_out, retune,
                        leaky, pool, rounding):
    acc = _conv3x3_acc(xp, w_q)
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


def _launch(kernel, x, w_q, b_q, *, h, w, c_in, pool, s2d, sw, sb, sa_in,
            sa_out, retune, leaky, rounding) -> torch.Tensor:
    """Check the operands and launch the kernel on the current stream,
    counting the launch under ``kernel``; returns the int8 output. Raises
    on anything the kernel does not take and on a failed launch."""
    from yolo_tpu_torch.kernels import build

    if rounding not in ("nearest", "floor"):
        raise ValueError(f"unknown rounding {rounding!r}")
    if leaky is not True and leaky is not False:
        raise ValueError(f"leaky must be True or False, got {leaky!r}")
    _check_scalar_shifts(sw=sw, sb=sb, sa_in=sa_in, sa_out=sa_out,
                         retune=retune)
    dev = x.device
    if x.dtype != torch.int8 or not x.is_contiguous():
        raise ValueError("x must be a contiguous int8 tensor")
    c_out = w_q.shape[-1]
    if (w_q.dtype != torch.int8 or w_q.device != dev
            or tuple(w_q.shape) != (3, 3, c_in, c_out)):
        raise ValueError(f"w_q must be int8 [3, 3, {c_in}, C_out] HWIO on "
                         f"{dev}, got {w_q.dtype} {tuple(w_q.shape)} on "
                         f"{w_q.device}")
    if tuple(b_q.shape) != (c_out,) or b_q.device != dev:
        raise ValueError(f"b_q must be [{c_out}] on {dev}")
    if (pool or s2d) and (h % 2 or w % 2):
        raise ValueError("pooled conv requires even H, W")
    w_c = w_q.contiguous()
    # 4-byte loads on the s2d layout, 16-byte loads when C_in % 16 == 0
    align = 4 if s2d else 16 if c_in % 16 == 0 else 1
    if x.data_ptr() % align or w_c.data_ptr() % 4:
        raise ValueError(f"x must be {align}-byte and w_q 4-byte aligned")
    bsz = x.shape[0]
    if bsz * h * w >= 2 ** 31:
        raise ValueError("B * H * W must stay below 2^31; split the batch")
    ho, wo = (h // 2, w // 2) if pool else (h, w)
    out = torch.empty((bsz, ho, wo, c_out), dtype=torch.int8, device=dev)
    if out.numel() == 0:
        return out
    if out.data_ptr() % 16:
        raise ValueError("the output allocation is not 16-byte aligned")
    bias_rt = _bias_at_retune(b_q, sb, retune, rounding)
    lib = build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.yolo_int8_conv3x3_requant(
            x.data_ptr(), w_c.data_ptr(), bias_rt.data_ptr(), out.data_ptr(),
            bsz, h, w, c_in, c_out, sa_in + sw - retune, retune - sa_out,
            int(leaky), int(rounding == "nearest"), int(pool), int(s2d),
            ctypes.c_void_p(stream))
    if rc != 0:
        msg = lib.yolo_int8_error_string(rc).decode()
        raise RuntimeError(f"int8 conv kernel launch failed: {msg}")
    _LAUNCHES[kernel] += 1
    return out


def _route(x: torch.Tensor) -> str:
    if x.device.type == "cpu":
        return "plain"
    if x.device.type == "cuda":
        return "cuda"
    raise ValueError(f"no int8 conv for device {x.device}")


# ---------------------------------------------------------------------------
# Public wrappers.
# ---------------------------------------------------------------------------


def int8_conv3x3_requant(x_q, w_q, b_q, *, sw, sb, sa_in, sa_out, retune,
                         leaky=True, rounding="nearest"):
    """Fused int8 conv3x3(stride 1, pad 1) + requant: int8 [B,H,W,C_in]
    at scale 2^sa_in -> int8 [B,H,W,C_out] at scale 2^sa_out."""
    kw = dict(sw=sw, sb=sb, sa_in=sa_in, sa_out=sa_out, retune=retune,
              leaky=leaky, rounding=rounding)
    if _route(x_q) == "plain":
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
    if _route(x_q) == "plain":
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
    if _route(x_q) == "plain":
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
    if _route(x2) == "plain":
        return int8_conv3x3_pool_s2d_plain(x2, w_q, b_q, c_in=c_in, **kw)
    b, hb, wb, _ = x2.shape
    return _launch("int8_conv3x3_pool_requant", x2, w_q, b_q,
                   h=2 * (hb - 3), w=2 * (wb - 3), c_in=c_in, pool=True,
                   s2d=True, **kw)


def launch_counts() -> dict:
    """{kernel name: launches since the last reset}."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for name in KERNEL_NAMES:
        _LAUNCHES[name] = 0
