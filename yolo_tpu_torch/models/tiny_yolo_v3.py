"""tiny-YOLOv3: darknet_light backbone + 2-scale FPN head (counterpart of
``yolo_tpu/models/tiny_yolo_v3.py``; reference models/tiny_yolo_v3.py:
9-39,181-199).

conv_set_2 (C5 1024 -> 256, 3x3), upsample(conv_1x1_2) concatenated
after C4, conv_set_1 (384 -> 256, 3x3) -> pred_1 (stride 16);
extra_conv_2 -> pred_2 (stride 32). The convs run in the JAX package's
call order (pred_2 before pred_1), which the generic calibration's taps
follow. Head outputs run fine-to-coarse, in ``STRIDES`` order."""

from __future__ import annotations

import torch
from torch import nn

from yolo_tpu_torch.models.darknet import DarknetLight, cb, conv_seq
from yolo_tpu_torch.ops import blocks

STRIDES = (16, 32)

_CONV_SET_2 = cb(3, 1024, 256, 1, 1)
_CONV_1X1_2 = cb(1, 256, 128)
_EXTRA_2 = cb(3, 256, 512, 1, 1)
_CONV_SET_1 = cb(3, 384, 256, 1, 1)


class TinyYOLOv3(nn.Module):
    """``pred_out`` = anchors_per_scale * (1 + 4 + num_classes). Children
    named as the JAX package's tree (``backbone``, ``conv_set_2`` ..
    ``pred_1``); ``batch_norm`` as ``YOLOv3`` takes it. Built on
    ``device`` (raises where it names CUDA and there is none). Random
    initialisation only from an explicit ``generator``."""

    STRIDES = STRIDES

    def __init__(self, pred_out: int, batch_norm: bool = True,
                 device="cuda", generator: torch.Generator = None):
        from yolo_tpu_torch.quant.fixed_point import resolve_device

        super().__init__()
        device = resolve_device(device)
        head = blocks.MODEL_LEAKY_SLOPE
        self.backbone = DarknetLight(batch_norm, device)
        for name, spec in (("conv_set_2", _CONV_SET_2),
                           ("conv_1x1_2", _CONV_1X1_2),
                           ("extra_conv_2", _EXTRA_2),
                           ("conv_set_1", _CONV_SET_1)):
            self.add_module(name, conv_seq([spec], head, batch_norm,
                                           device)[0])
        self.pred_2 = blocks.PredConv(1, 512, pred_out, 0, device)
        self.pred_1 = blocks.PredConv(1, 256, pred_out, 0, device)
        if generator is not None:
            blocks.init_model(self, generator)

    def forward(self, x: torch.Tensor):
        """NHWC images [B, H, W, 3] -> [pred_1, pred_2] NHWC (strides 16,
        32)."""
        c4, c5 = self.backbone(x.permute(0, 3, 1, 2))
        c5h = self.conv_set_2(c5)
        up = blocks.upsample2x_align_corners(self.conv_1x1_2(c5h), (2, 3))
        c4h = self.conv_set_1(torch.cat([c4, up], dim=1))
        pred_2 = self.pred_2(self.extra_conv_2(c5h))
        pred_1 = self.pred_1(c4h)
        return [p.permute(0, 2, 3, 1) for p in (pred_1, pred_2)]
