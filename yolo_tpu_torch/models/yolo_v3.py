"""YOLOv3 head schedule (counterpart of ``yolo_tpu/models/yolo_v3.py``; the
float model is not ported yet). Head outputs run fine-to-coarse, in
``STRIDES`` order."""

from __future__ import annotations

from yolo_tpu_torch.models.darknet import cb

STRIDES = (8, 16, 32)

CONV_SET_3 = [cb(1, 1024, 512), cb(3, 512, 1024, 1, 1), cb(1, 1024, 512),
              cb(3, 512, 1024, 1, 1), cb(1, 1024, 512)]
CONV_SET_2 = [cb(1, 768, 256), cb(3, 256, 512, 1, 1), cb(1, 512, 256),
              cb(3, 256, 512, 1, 1), cb(1, 512, 256)]
CONV_SET_1 = [cb(1, 384, 128), cb(3, 128, 256, 1, 1), cb(1, 256, 128),
              cb(3, 128, 256, 1, 1), cb(1, 256, 128)]
_CONV_1X1_3 = cb(1, 512, 256)
_CONV_1X1_2 = cb(1, 256, 128)
_EXTRA_3 = cb(3, 512, 1024, 1, 1)
_EXTRA_2 = cb(3, 256, 512, 1, 1)
_EXTRA_1 = cb(3, 128, 256, 1, 1)
