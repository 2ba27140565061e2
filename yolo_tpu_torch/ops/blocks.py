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

Not ported here: train-mode BN and the s2d pooled-conv form
(``conv_block_pool_s2d``, ``fast_pool_context``).
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
    return torch.where(x >= 0, x, x * slope)


def conv2d(x: torch.Tensor, w: torch.Tensor, b=None, stride: int = 1,
           padding: int = 0) -> torch.Tensor:
    """Plain 2D conv, NCHW x OIHW -> NCHW, in true float32."""
    with fp32_precision():
        out = F.conv2d(x, w, None, stride=stride, padding=padding)
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


def max_pool(x: torch.Tensor, window: int = 2, stride: int = 2,
             padding: int = 0) -> torch.Tensor:
    """Max pool, NCHW (floor mode, -inf padding)."""
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
    module's training flag. Built on ``device`` (raises where it names
    CUDA and there is none)."""

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
        """The conv and, where there is one, the BN."""
        y = conv2d(x, self.conv.weight, self.conv.bias, self.stride,
                   self.padding)
        return y if self.bn is None else batch_norm_inference(y, self.bn)


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


def conv_block_pool(block: ConvBlock, x: torch.Tensor) -> torch.Tensor:
    """``block`` (3x3, stride 1, pad 1) then a 2x2/2 max pool (the plain
    form of the JAX package's ``conv_block_pool``)."""
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
