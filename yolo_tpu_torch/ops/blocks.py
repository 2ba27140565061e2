"""Model building blocks (counterpart of ``yolo_tpu/ops/blocks.py``).

The float blocks run on NCHW activations with OIHW weights (``nn.Conv2d``'s
layout); the models of ``yolo_tpu_torch.models`` take and return NHWC, as
the JAX package's do. Each conv runs in true float32: TF32 is off for its
duration (``fp32_precision``), as the JAX package runs its float convs at
precision 'highest'.

The quantization tap (``quantization_context``) fires where the JAX
package's does, in the same call order: after each conv block's
activation, with a ``pre`` hook on the pre-activation value; on each
residual sum; and before (``pre``) and after each prediction head.

BN runs from the running stats unless a ``train_context`` is active
(the JAX package's ``train=True``): then from the batch's statistics,
with the running stats updated in place (not inside ``frozen_stats``: a
recomputed forward leaves them alone). A ``branch_context`` records a
forward's leaky signs, pool argmaxes and STE fake-quant clip masks and
levels, or imposes recorded ones.
Inside a ``fast_pool_context`` the conv + pool pairs with few input
channels run at pooled resolution (``conv_block_pool_s2d``).
"""

from __future__ import annotations

import contextlib
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# LeakyReLU slope of every model-level conv block (0.125 = 2^-3, a shift
# on the FPGA) and of the darknet backbones (torch's default 0.1).
MODEL_LEAKY_SLOPE = 0.125
BACKBONE_LEAKY_SLOPE = 0.1

_BN_EPS = 1e-5
_BN_MOMENTUM = 0.1


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


def upsample2x_align_corners(x: torch.Tensor, axes=(1, 2)) -> torch.Tensor:
    """2x bilinear upsample of float32 with align_corners=True over the
    spatial ``axes`` ((1, 2) for NHWC, (2, 3) for NCHW): two separable
    passes (H, then W) with the [2n, n] interpolation matrices, as the JAX
    package computes it.

    Each output is u0*a + u1*b (the matrices have two nonzeros a row) taken
    as a gather, an elementwise product and one add, all in float32, so
    it rounds as the JAX package's CPU einsum does: the extra terms of its
    dense matmul are exact zeros."""
    for axis in axes:
        n = x.shape[axis]
        lo, hi, w_lo, w_hi = _upsample2x_taps(n, str(x.device))
        shape = [1] * x.ndim
        shape[axis] = 2 * n
        a = torch.index_select(x, axis, lo)
        b = torch.index_select(x, axis, hi)
        x = (a * w_lo.to(x.dtype).reshape(shape)
             + b * w_hi.to(x.dtype).reshape(shape))
    return x


@functools.lru_cache(maxsize=64)
def _upsample2x_taps(n: int, device: str):
    """The [2n] gather indices and weights of ``upsample2x_align_corners``
    on ``device``, made once per size, so that a serving call (or a CUDA
    graph's capture) copies nothing from the host; shared, never
    written."""
    lo, hi, _ = _align_corners_weights(n, 2 * n)
    u = _upsample2x_matrix(n)
    rows = np.arange(2 * n)
    w_hi = np.where(hi != lo, u[rows, hi], 0.0).astype(np.float32)
    return (torch.as_tensor(lo, device=device).long(),
            torch.as_tensor(hi, device=device).long(),
            torch.as_tensor(u[rows, lo], device=device),
            torch.as_tensor(w_hi, device=device))


# ---------------------------------------------------------------------------
# Float forward ops (NCHW activations, OIHW weights).
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def fp32_precision():
    """TF32 off for cuDNN convs and CUDA matmuls inside the block, the
    previous settings restored after it: TF32 keeps a 10-bit mantissa and
    would move every activation maximum the calibration reads."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    old = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32 = matmul.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = old


def leaky_relu(x: torch.Tensor, slope: float = MODEL_LEAKY_SLOPE):
    if _BRANCHES is not None:
        return torch.where(_BRANCHES.leaky(x), x, x * slope)
    return torch.where(x >= 0, x, x * slope)


class _Conv2dFP32(torch.autograd.Function):
    """F.conv2d whose backward (the input and weight gradients, cuDNN's
    dgrad and wgrad on the card) also runs with TF32 off, as the JAX
    package's 'highest' precision covers the backward too: autograd runs
    a backward outside any context the forward was called in, and cuDNN
    allows TF32 by default."""

    @staticmethod
    def forward(ctx, x, w, stride, padding):
        ctx.save_for_backward(x, w)
        ctx.stride, ctx.padding = stride, padding
        with fp32_precision():
            return F.conv2d(x, w, None, stride=stride, padding=padding)

    @staticmethod
    def backward(ctx, grad):
        x, w = ctx.saved_tensors
        gx = gw = None
        with fp32_precision():
            if ctx.needs_input_grad[0]:
                gx = torch.nn.grad.conv2d_input(x.shape, w, grad,
                                                ctx.stride, ctx.padding)
            if ctx.needs_input_grad[1]:
                gw = torch.nn.grad.conv2d_weight(x, w.shape, grad,
                                                 ctx.stride, ctx.padding)
        return gx, gw, None, None


def conv2d(x: torch.Tensor, w: torch.Tensor, b=None, stride: int = 1,
           padding: int = 0) -> torch.Tensor:
    """Plain 2D conv, NCHW x OIHW -> NCHW, in true float32 (its backward
    too)."""
    out = _Conv2dFP32.apply(x, w, stride, padding)
    if b is not None:
        out = out + b.reshape(1, -1, 1, 1)
    return out


def batch_norm_inference(x: torch.Tensor, bn: nn.BatchNorm2d):
    """Inference-mode BN on NCHW from the running stats: the JAX package's
    algebra, with 1/sqrt in IEEE float32 (XLA's CPU backend lowers its
    rsqrt to an approximation and two Newton steps, which can differ by an
    ulp)."""
    var = bn.running_var.to(torch.float32)
    inv = torch.ones_like(var) / torch.sqrt(var + _BN_EPS)
    scale = (bn.weight * inv).to(x.dtype)  # a bf16 model stays bf16
    offset = (bn.bias - bn.weight * bn.running_mean * inv).to(x.dtype)
    return x * scale.reshape(1, -1, 1, 1) + offset.reshape(1, -1, 1, 1)


def batch_norm_train(x: torch.Tensor, bn: nn.BatchNorm2d) -> torch.Tensor:
    """Train-mode BN on NCHW over (N, H, W), in float32 (float64 input in
    float64): normalize with the batch's biased variance (1/sqrt in IEEE
    arithmetic), and move ``bn``'s running stats in place (no autograd)
    as torch's BatchNorm2d does: an EMA with momentum 0.1 on the new
    value, the variance unbiased by n / max(n - 1, 1). The JAX package's
    algebra; torch's own train-mode BN refuses n = 1, where this divides
    by 1. Inside ``frozen_stats`` the running stats stay."""
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    var, mean = torch.var_mean(xf, dim=(0, 2, 3), correction=0)
    n = x.shape[0] * x.shape[2] * x.shape[3]
    inv = torch.ones_like(var) / torch.sqrt(var + _BN_EPS)
    y = ((xf - mean.reshape(1, -1, 1, 1)) * inv.reshape(1, -1, 1, 1)
         * bn.weight.reshape(1, -1, 1, 1) + bn.bias.reshape(1, -1, 1, 1))
    if not _STATS_FROZEN:
        with torch.no_grad():
            unbiased_var = var * (n / max(n - 1, 1))
            bn.running_mean.copy_((1 - _BN_MOMENTUM) * bn.running_mean
                                  + _BN_MOMENTUM * mean)
            bn.running_var.copy_((1 - _BN_MOMENTUM) * bn.running_var
                                 + _BN_MOMENTUM * unbiased_var)
    return y.to(x.dtype)


def max_pool(x: torch.Tensor, window: int = 2, stride: int = 2,
             padding: int = 0) -> torch.Tensor:
    """Max pool, NCHW (floor mode, -inf padding)."""
    if _BRANCHES is not None:
        return _BRANCHES.pool(x, window, stride, padding)
    return F.max_pool2d(x, window, stride, padding)


def spp(x: torch.Tensor) -> torch.Tensor:
    """Spatial pyramid pooling, NCHW: concat [x, mp5(x), mp9(x), mp13(x)]
    on C (stride 1, -inf padding; reference utils/modules.py:59-72)."""
    return torch.cat([x, max_pool(x, 5, 1, 2), max_pool(x, 9, 1, 4),
                      max_pool(x, 13, 1, 6)], dim=1)


def zero_pad_maxpool_s1(x: torch.Tensor) -> torch.Tensor:
    """ZeroPad2d((0, 1, 0, 1)) + MaxPool2d(2, stride=1), NCHW: the
    tiny-yolov3 backbone's last pool (reference backbone/darknet.py:
    232-235). It pads with zero, not -inf, as the reference does: a
    negative activation on the bottom row or right column meets a 0."""
    return max_pool(F.pad(x, (0, 1, 0, 1)), 2, 1)


def reorg(x: torch.Tensor, stride: int = 2, nchw: bool = False):
    """Space-to-depth passthrough layer (reference utils/modules.py:43-57):
    [B, H, W, C] -> [B, H/s, W/s, s*s*C] (NHWC; with ``nchw`` the same on
    [B, C, H, W]). The output's channel blocks are ordered by the (row,
    col) position inside each s x s window, the original channels
    contiguous inside each block: NCHW ``[B, s*s, C, H/s, W/s]``
    flattened."""
    s = stride
    if nchw:
        b, c, h, w = x.shape
        x = x.reshape(b, c, h // s, s, w // s, s)
        # -> [B, s(row), s(col), C, H/s, W/s]
        return x.permute(0, 3, 5, 1, 2, 4).reshape(b, s * s * c, h // s,
                                                   w // s)
    b, h, w, c = x.shape
    x = x.reshape(b, h // s, s, w // s, s, c)
    # -> [B, H/s, W/s, s(row), s(col), C]
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h // s, w // s, s * s * c)


# Active quantization tap (see quantization_context), read at call time.
_QUANT_TAP = None


class quantization_context:
    """``with quantization_context(tap): model(x)`` — ``tap`` is called
    with each conv block's activation and each residual sum (in call
    order) and returns the (fake-quantized) value; its optional ``pre``
    sees each conv's pre-activation value."""

    def __init__(self, tap):
        self.tap = tap

    def __enter__(self):
        global _QUANT_TAP
        self._prev = _QUANT_TAP
        _QUANT_TAP = self.tap
        return self.tap

    def __exit__(self, *exc):
        global _QUANT_TAP
        _QUANT_TAP = self._prev
        return False


# Whether BN runs in train mode (see train_context), read at call time.
_TRAIN = False


class train_context:
    """``with train_context(): model(x)`` — every BN of the forward runs in
    train mode (``batch_norm_train``: batch statistics, the running stats
    updated in place), as the JAX package's ``forward(..., train=True)``.
    Outside it BN runs from the running stats whatever the modules'
    ``training`` flags (an ``nn.Module`` starts in training mode, so
    keying on the flag would move every serving and calibration
    forward)."""

    def __enter__(self):
        global _TRAIN
        self._prev = _TRAIN
        _TRAIN = True
        return self

    def __exit__(self, *exc):
        global _TRAIN
        _TRAIN = self._prev
        return False


# Whether train-mode BN leaves the running stats alone (see frozen_stats),
# read at call time.
_STATS_FROZEN = False


@contextlib.contextmanager
def frozen_stats():
    """Train-mode BN inside the block normalizes with the batch's
    statistics but moves no running stat: the recompute of a
    rematerialized forward (``torch.utils.checkpoint``) runs the forward
    a second time, and its EMA would land twice (``jax.checkpoint`` is
    functional and cannot)."""
    global _STATS_FROZEN
    prev, _STATS_FROZEN = _STATS_FROZEN, True
    try:
        yield
    finally:
        _STATS_FROZEN = prev


# The active branch_context, read at call time.
_BRANCHES = None


class branch_context:
    """``with branch_context() as b: model(x)`` records the forward's
    discrete choices in ``b.choices`` (their kinds in ``b.kinds``), in
    call order: each ``leaky_relu``'s sign mask, each ``max_pool``'s
    argmax, and at each STE fake-quant tap
    (``quant.qat.tracker_quantize_ste``) its clip mask and its rounded
    levels. ``with branch_context(choices) as b: ...`` makes the same
    forward, on any device, take those choices in place of its own (the
    pool as a gather at the given argmax, the tap's levels as given, its
    gradient passing where the given mask says inside the rails), and
    lists in ``b.flips`` one ("leaky", "pool", "clip" or "round",
    elements where its own choice differs, the largest margin over them,
    the layer's largest |x|) a choice: the margin is |x| at a leaky, the
    window's own maximum less the element taken at a pool, the distance
    to the nearer rail at a clip, and at a rounding the distance of the
    clipped value to the tie between its own level and the one taken.

    Two devices' float32 forwards round differently. Where a value lies
    within that rounding of a leaky's zero, or of a pool window's
    runner-up (flat image regions give exact ties), they branch apart,
    and their gradients part by far more than rounding. A tight
    comparison of one device's gradients with another's takes one
    device's branches on both and holds the flips' margins to
    rounding."""

    def __init__(self, choices=None):
        self.imposed = choices
        self.choices, self.kinds, self.flips = [], [], []

    def __enter__(self):
        global _BRANCHES
        self._prev, _BRANCHES = _BRANCHES, self
        return self

    def __exit__(self, *exc):
        global _BRANCHES
        _BRANCHES = self._prev
        return False

    def _take(self, kind, own, margin_of, v):
        self.kinds.append(kind)
        if self.imposed is None:
            self.choices.append(own)
            return own
        taken = self.imposed[len(self.choices)].to(own.device)
        if taken.shape != own.shape:
            raise ValueError(f"choice {len(self.choices)}: imposed "
                             f"{tuple(taken.shape)}, the forward's "
                             f"{tuple(own.shape)}")
        self.choices.append(taken)
        differ = taken != own
        n = int(differ.sum())
        self.flips.append((kind, n, float(margin_of(taken)[differ].max())
                           if n else 0.0, float(v.abs().max())))
        return taken

    def leaky(self, x):
        """The sign mask a leaky_relu of ``x`` takes."""
        v = x.detach()
        return self._take("leaky", v >= 0, lambda taken: v.abs(), v)

    def quant(self, x, clipped, levels, lo, hi, scale):
        """The clip mask and levels of an STE fake-quant of ``x``
        (``clipped`` = ``x`` clamped to [``lo``, ``hi``], ``levels`` =
        round(``scale`` * ``clipped``)) -> (the clipped value, its
        gradient path cut where the mask taken says clipped and opened
        where it says inside, and the levels taken)."""
        v = x.detach()
        own = (v >= lo) & (v <= hi)
        inside = self._take(
            "clip", own,
            lambda taken: torch.minimum((v - lo).abs(), (v - hi).abs()), v)
        if inside is not own:
            clipped = torch.where(inside == own, clipped,
                                  torch.where(inside, x, clipped.detach()))
        c = clipped.detach()
        taken = self._take(
            "round", levels.detach(),
            lambda t: ((scale * c - t).abs() - 0.5).abs() / scale, v)
        return clipped, taken

    def pool(self, x, window, stride, padding):
        out, own = F.max_pool2d(x, window, stride, padding,
                                return_indices=True)

        def at(idx):  # x at each window's index idx (flat over H x W)
            return x.flatten(2).gather(2, idx.flatten(2)).view_as(out)

        v = x.detach()
        idx = self._take("pool", own,
                         lambda taken: out.detach() - at(taken).detach(), v)
        if idx is own:
            return out
        # in out's memory layout (channels-last after a CPU conv), which
        # the next conv's summation order follows
        return torch.empty_like(out).copy_(at(idx))


def _pre(y):
    if _QUANT_TAP is not None and hasattr(_QUANT_TAP, "pre"):
        _QUANT_TAP.pre(y)


def _tap(y):
    return y if _QUANT_TAP is None else _QUANT_TAP(y)


def residual_add(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y + x, with a quantization tap on the sum (the integer path
    requantizes the sum of two differently scaled tensors to one scale)."""
    return _tap(y + x)


# ---------------------------------------------------------------------------
# Conv modules and their initialisation.
# ---------------------------------------------------------------------------


class Conv(nn.Module):
    """A conv with a bias (``batch_norm=False``, the BN-fused form) or
    followed by an inference BN (``batch_norm=True``, its conv unbiased).
    Its parameters are those of ``nn.Conv2d`` (OIHW) and
    ``nn.BatchNorm2d``; BN runs from the running stats whatever the
    module's training flag, from the batch's inside a ``train_context``.
    Built on ``device`` (raises where it names CUDA and there is
    none)."""

    def __init__(self, ksize: int, c_in: int, c_out: int, stride: int = 1,
                 padding: int = 0, batch_norm: bool = False,
                 device="cuda"):
        from yolo_tpu_torch.quant.fixed_point import resolve_device

        super().__init__()
        device = resolve_device(device)
        self.stride, self.padding = stride, padding
        self.conv = nn.Conv2d(c_in, c_out, ksize, stride, padding,
                              bias=not batch_norm, device=device)
        self.bn = nn.BatchNorm2d(c_out, device=device) if batch_norm \
            else None

    def linear(self, x: torch.Tensor) -> torch.Tensor:
        """The conv and, where there is one, the BN (train mode inside a
        ``train_context``)."""
        y = conv2d(x, self.conv.weight, self.conv.bias, self.stride,
                   self.padding)
        if self.bn is None:
            return y
        if _TRAIN:
            return batch_norm_train(y, self.bn)
        return batch_norm_inference(y, self.bn)


class ConvBlock(Conv):
    """Conv(+BN) + LeakyReLU(``slope``) (the JAX package's inference
    ``conv_block``); the tap's ``pre`` sees the pre-activation value, the
    tap the activation."""

    def __init__(self, ksize: int, c_in: int, c_out: int, stride: int = 1,
                 padding: int = 0, slope: float = MODEL_LEAKY_SLOPE,
                 batch_norm: bool = False, device="cuda"):
        super().__init__(ksize, c_in, c_out, stride, padding, batch_norm,
                         device)
        self.slope = slope

    def forward(self, x):
        y = self.linear(x)
        _pre(y)
        return _tap(leaky_relu(y, self.slope))


class PredConv(Conv):
    """Prediction-head conv: biased, no activation; tapped before
    (``pre``) and after."""

    def __init__(self, ksize: int, c_in: int, c_out: int, padding: int = 0,
                 device="cuda"):
        super().__init__(ksize, c_in, c_out, 1, padding, False, device)

    def forward(self, x):
        y = self.linear(x)
        _pre(y)
        return _tap(y)


def s2d_pool_weights(w: torch.Tensor) -> torch.Tensor:
    """OIHW 3x3 weights [C_out, C, 3, 3] -> the 2x2 block conv's weights
    over the space-to-depth input, [4 C_out, 4 C, 2, 2]: output channels
    phase-major (pool phase (a, b) at (2a + b) C_out), input channels in
    the s2d order (py, px, c); zeros where the 3x3 support does not
    reach. Pads, reshapes and a concat, so gradients flow back to ``w``
    (the JAX package's ``s2d_pool_weights`` in OIHW)."""
    c_out, c_in = w.shape[0], w.shape[1]
    phases = []
    for a in range(2):          # pool phase row
        for b in range(2):      # pool phase col
            wp = F.pad(w, (b, 1 - b, a, 1 - a))  # [C_out, C, 4, 4]
            # (kh, kw) = (2 bh + py, 2 bw + px) -> [C_out, py, px, C, bh, bw]
            wp = wp.reshape(c_out, c_in, 2, 2, 2, 2).permute(0, 3, 5, 1, 2,
                                                             4)
            phases.append(wp.reshape(c_out, 4 * c_in, 2, 2))
    return torch.cat(phases, dim=0)


def conv_block_pool_s2d(block: ConvBlock, x: torch.Tensor) -> torch.Tensor:
    """``block`` (3x3, stride 1, pad 1) + BN + leaky + a 2x2/2 max pool
    on NCHW ``x`` (even H, W), computed at pooled resolution: the padded
    input in space-to-depth, one 2x2 block conv with a contraction of 16
    C_in and 4 C_out phase-packed outputs, BN per phase (in train mode
    over all four phases: the plain path's statistics), the activation,
    then the max over the four phase groups (``torch.amax``: a tie shares
    the gradient, as the JAX package's ``jnp.max``). The same values as
    ``block`` then ``max_pool`` up to the float summation order (the JAX
    package's ``conv_block_pool_s2d``)."""
    b, c, h, w = x.shape
    c_out = block.conv.weight.shape[0]
    ho, wo = h // 2, w // 2
    hb, wb = (h + 6) // 2, (w + 6) // 2
    x2 = F.pad(x, (3, 3, 3, 3)).reshape(b, c, hb, 2, wb, 2).permute(
        0, 3, 5, 1, 2, 4).reshape(b, 4 * c, hb, wb)
    y = conv2d(x2, s2d_pool_weights(block.conv.weight).to(x2.dtype))
    # pooled (u, v) lies at block-conv output (u + 1, v + 1)
    y = y[:, :, 1:1 + ho, 1:1 + wo]
    if block.conv.bias is not None:
        y = y + block.conv.bias.repeat(4).reshape(1, -1, 1, 1)
    if block.bn is not None:
        # per channel over the four phases: the plain path's statistics
        y4 = y.reshape(b * 4, c_out, ho, wo)
        y = (batch_norm_train(y4, block.bn) if _TRAIN else
             batch_norm_inference(y4, block.bn)).reshape(b, 4 * c_out, ho,
                                                          wo)
    _pre(y)
    y = _tap(leaky_relu(y, block.slope))
    # the pool: the max over the phase groups (the activation and the
    # taps are monotone and per channel, so they commute with it)
    return torch.amax(y.reshape(b, 4, c_out, ho, wo), dim=1)


# C_in threshold of the s2d pooled form (see fast_pool_context), read at
# call time; 0: off.
_FAST_POOL_CIN_MAX = 0


class fast_pool_context:
    """``with fast_pool_context(cin_max=32): model(x)`` — each conv + pool
    pair (``conv_block_pool``) with C_in <= ``cin_max`` and an even input
    runs in the pooled-resolution s2d form (``conv_block_pool_s2d``): the
    same math in another summation order. Independent of
    ``train_context``."""

    def __init__(self, cin_max: int = 32):
        self.cin_max = cin_max

    def __enter__(self):
        global _FAST_POOL_CIN_MAX
        self._prev = _FAST_POOL_CIN_MAX
        _FAST_POOL_CIN_MAX = self.cin_max
        return self

    def __exit__(self, *exc):
        global _FAST_POOL_CIN_MAX
        _FAST_POOL_CIN_MAX = self._prev
        return False


def conv_block_pool(block: ConvBlock, x: torch.Tensor) -> torch.Tensor:
    """``block`` (3x3, stride 1, pad 1) then a 2x2/2 max pool: the plain
    trace, or inside a ``fast_pool_context`` that admits ``block``'s C_in
    (and for an even input) ``conv_block_pool_s2d`` (the JAX package's
    ``conv_block_pool``)."""
    c_in = block.conv.weight.shape[1]
    if (0 < c_in <= _FAST_POOL_CIN_MAX and x.shape[2] % 2 == 0
            and x.shape[3] % 2 == 0):
        return conv_block_pool_s2d(block, x)
    return max_pool(block(x), 2, 2)


def init_conv(conv: nn.Conv2d, generator: torch.Generator) -> None:
    """Fill ``conv`` as torch's nn.Conv2d defaults do (weights
    kaiming_uniform(a=sqrt(5)), bias uniform(+-1/sqrt(fan_in))), drawn
    from ``generator`` (weights, then bias)."""
    c_out, c_in, k, _ = conv.weight.shape
    fan_in = c_in * k * k
    bound = math.sqrt(2.0 / (1 + 5.0)) * math.sqrt(3.0 / fan_in)
    with torch.no_grad():
        w = torch.empty(conv.weight.shape, dtype=torch.float32)
        conv.weight.copy_(w.uniform_(-bound, bound, generator=generator))
        if conv.bias is not None:
            b_bound = 1.0 / math.sqrt(fan_in)
            b = torch.empty(conv.bias.shape, dtype=torch.float32)
            conv.bias.copy_(b.uniform_(-b_bound, b_bound,
                                       generator=generator))


def init_conv_block(block: Conv, generator: torch.Generator) -> None:
    """``init_conv`` on the block's conv; its BN, if any, the identity
    (gamma 1, beta 0, mean 0, var 1)."""
    init_conv(block.conv, generator)
    if block.bn is not None:
        with torch.no_grad():
            block.bn.weight.fill_(1.0)
            block.bn.bias.zero_()
            block.bn.running_mean.zero_()
            block.bn.running_var.fill_(1.0)


def init_model(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """``init_conv_block`` on every conv of ``model``, in module order."""
    for m in model.modules():
        if isinstance(m, Conv):
            init_conv_block(m, generator)
    return model
