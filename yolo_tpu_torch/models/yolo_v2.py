"""YOLOv2: darknet19 backbone + passthrough (reorg) head (counterpart of
``yolo_tpu/models/yolo_v2.py``; reference models/yolo_v2.py:9-40,165-178).

darknet19 -> two 3x3 1024 convs on C6; a 1x1 route conv (512 -> 64) on
C5, ``reorg``-ed (stride 2) and concatenated in front of the head's
output; a 3x3 1280 -> 1024 conv; a 1x1 prediction conv. Stride 32."""

from __future__ import annotations

import torch
from torch import nn

from yolo_tpu_torch.models.darknet import Darknet19, cb, conv_seq, run_seq
from yolo_tpu_torch.ops import blocks

STRIDES = (32,)

CONVSETS_1 = [cb(3, 1024, 1024, 1, 1), cb(3, 1024, 1024, 1, 1)]
ROUTE = cb(1, 512, 64)
CONVSETS_2 = [cb(3, 1280, 1024, 1, 1)]


class YOLOv2(nn.Module):
    """``pred_out`` = anchors_per_scale * (1 + 4 + num_classes). Children
    named as the JAX package's tree (``backbone``, ``convsets_1``,
    ``route_layer``, ``convsets_2``, ``pred``); ``batch_norm`` as
    ``YOLOv3`` takes it. Built on ``device`` (raises where it names CUDA
    and there is none). Random initialisation only from an explicit
    ``generator``."""

    STRIDES = STRIDES

    def __init__(self, pred_out: int, batch_norm: bool = True,
                 device="cuda", generator: torch.Generator = None):
        from yolo_tpu_torch.quant.fixed_point import resolve_device

        super().__init__()
        device = resolve_device(device)
        head = blocks.MODEL_LEAKY_SLOPE
        self.backbone = Darknet19(batch_norm, device)
        self.convsets_1 = conv_seq(CONVSETS_1, head, batch_norm, device)
        self.route_layer = conv_seq([ROUTE], head, batch_norm, device)[0]
        self.convsets_2 = conv_seq(CONVSETS_2, head, batch_norm, device)
        self.pred = blocks.PredConv(1, 1024, pred_out, 0, device)
        if generator is not None:
            blocks.init_model(self, generator)

    def forward(self, x: torch.Tensor):
        """NHWC images [B, H, W, 3] -> [pred] NHWC (stride 32)."""
        _, c5, c6 = self.backbone(x.permute(0, 3, 1, 2))
        fp2 = run_seq(self.convsets_1, c6)
        fp1 = blocks.reorg(self.route_layer(c5), 2, nchw=True)
        head = run_seq(self.convsets_2, torch.cat([fp1, fp2], dim=1))
        return [self.pred(head).permute(0, 2, 3, 1)]
