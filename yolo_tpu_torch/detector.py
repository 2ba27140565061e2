"""Detector pieces (counterpart of ``yolo_tpu/detector.py``; this slice
needs only ``decode_all_boxes``)."""

from __future__ import annotations

from typing import List

import torch

from yolo_tpu_torch.config import DetectorConfig
from yolo_tpu_torch.ops import decode


def decode_all_boxes(txts: List[torch.Tensor], cfg: DetectorConfig):
    """Per-scale anchor decode, concatenated: -> [B, N, 4] corner boxes in
    input pixels."""
    boxes = []
    a = cfg.anchors_per_scale
    for i, (txt, stride) in enumerate(zip(txts, cfg.strides)):
        anchors = cfg.anchor_size[i * a:(i + 1) * a]
        grid_xy, anchor_wh = decode.make_grid(cfg.input_size, stride,
                                              anchors, txt.device)
        boxes.append(decode.decode_boxes(txt, grid_xy, anchor_wh, stride,
                                         cfg.anchor_units))
    return torch.cat(boxes, dim=1)
