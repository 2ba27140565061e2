"""SlimYOLOv2, the 9-conv FPGA deployment network (counterpart of
``yolo_tpu/models/slim_yolo_v2.py``).

9 Conv+BN+LeakyReLU(0.125) 3x3 blocks (16-32-64-64-128-128-256-256-256)
with 4 interleaved 2x2 max pools (stride 16) and a biased 3x3 prediction
conv to A*(1+4+C) channels. Two parameter forms share the module:
``batch_norm=True``, the float training form, and ``batch_norm=False``,
the BN-fused form with conv biases that ``quant.bn_fold`` produces from
it and the quantizer reads.
"""

from __future__ import annotations

import torch
from torch import nn

from yolo_tpu_torch.ops import blocks

STRIDES = (16,)

# (layer_name, c_in, c_out, followed_by_2x2_maxpool) — the 10-layer
# schedule the INT8 engine iterates (pred follows conv7).
CONV_LAYERS = (
    ("conv1", 3, 16, True),
    ("conv2", 16, 32, True),
    ("conv3_1", 32, 64, False),
    ("conv3_2", 64, 64, True),
    ("conv4_1", 64, 128, False),
    ("conv4_2", 128, 128, True),
    ("conv5", 128, 256, False),
    ("conv6", 256, 256, False),
    ("conv7", 256, 256, False),
)


def layer_names(include_pred: bool = True):
    names = [name for name, _, _, _ in CONV_LAYERS]
    return names + ["pred"] if include_pred else names


class SlimYOLOv2(nn.Module):
    """``pred_out`` = anchors_per_scale * (1 + 4 + num_classes). Children
    are named as the JAX package's parameter tree is keyed (``conv1`` ..
    ``conv7``, ``pred``). Built on ``device`` (raises where it names CUDA
    and there is none). Random initialisation (torch's nn.Conv2d bounds,
    BN identity) only from an explicit ``generator``; without one the
    parameters are left as constructed, to be loaded."""

    STRIDES = STRIDES

    def __init__(self, pred_out: int, batch_norm: bool = True,
                 device="cuda", generator: torch.Generator = None):
        from yolo_tpu_torch.quant.fixed_point import resolve_device

        super().__init__()
        device = resolve_device(device)
        for name, c_in, c_out, _ in CONV_LAYERS:
            self.add_module(name, blocks.ConvBlock(
                3, c_in, c_out, 1, 1, blocks.MODEL_LEAKY_SLOPE, batch_norm,
                device))
        self.pred = blocks.PredConv(3, 256, pred_out, 1, device)
        if generator is not None:
            blocks.init_model(self, generator)

    def forward(self, x: torch.Tensor):
        """NHWC images [B, H, W, 3] -> [head [B, H/16, W/16, pred_out]]."""
        out = x.permute(0, 3, 1, 2)
        for name, _, _, pool in CONV_LAYERS:
            block = getattr(self, name)
            out = blocks.conv_block_pool(block, out) if pool else block(out)
        return [self.pred(out).permute(0, 2, 3, 1)]
