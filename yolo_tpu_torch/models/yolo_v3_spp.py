"""YOLOv3-SPP (counterpart of ``yolo_tpu/models/yolo_v3_spp.py``): YOLOv3
with an SPP block in the coarse-scale head. Identical to yolo_v3 except
that conv_set_3 starts with SPP (4x channel concat) followed by a
4096 -> 512 1x1 conv (reference models/yolo_v3_spp.py:28-37)."""

from __future__ import annotations

import torch

from yolo_tpu_torch.models.darknet import cb
from yolo_tpu_torch.models.yolo_v3 import STRIDES, YOLOv3  # noqa: F401

CONV_SET_3_SPP = [cb(1, 4096, 512), cb(3, 512, 1024, 1, 1),
                  cb(1, 1024, 512), cb(3, 512, 1024, 1, 1),
                  cb(1, 1024, 512)]


class YOLOv3SPP(YOLOv3):
    """``YOLOv3`` with ``blocks.spp`` on C5 and ``CONV_SET_3_SPP``; the
    same children, so the JAX package's yolo_v3_spp tree loads into it."""

    def __init__(self, pred_out: int, batch_norm: bool = True,
                 device="cuda", generator: torch.Generator = None):
        super().__init__(pred_out, batch_norm, device, generator,
                         conv_set_3=CONV_SET_3_SPP, use_spp=True)
