"""Detector pieces (counterpart of ``yolo_tpu/detector.py``): the tail of
``predict`` that turns per-scale head outputs into boxes and class
probabilities. The float models are not ported yet, so the functions take
the heads themselves rather than a model and its parameters."""

from __future__ import annotations

from typing import List, Sequence

import torch

from yolo_tpu_torch.config import DetectorConfig
from yolo_tpu_torch.ops import blocks, decode


def head_outputs(outs: Sequence[torch.Tensor], cfg: DetectorConfig):
    """Split per-scale heads [B, Hs, Ws, A*(1+C+4)] -> (conf [B, N, 1],
    cls [B, N, C], txts list of [B, HWs, A, 4]), N = sum_s HWs * A,
    concatenated in STRIDES order."""
    confs, clss, txts = [], [], []
    a, c = cfg.anchors_per_scale, cfg.num_classes
    for pred in outs:
        conf_s, cls_s, txt_s = decode.split_predictions(
            blocks.flatten_grid(pred), a, c)
        confs.append(conf_s)
        clss.append(cls_s)
        txts.append(txt_s)
    return torch.cat(confs, dim=1), torch.cat(clss, dim=1), txts


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


def predict(outs: Sequence[torch.Tensor], cfg: DetectorConfig):
    """Per-scale float heads -> (boxes_norm [B, N, 4] in [0, 1],
    class_probs [B, N, C]): sigmoid objectness, box decode over the input
    size clamped to [0, 1], softmax class probs scaled by objectness."""
    conf, cls, txts = head_outputs(outs, cfg)
    h, w = cfg.input_size
    boxes = decode_all_boxes(txts, cfg)
    boxes = torch.stack([boxes[..., 0] / w, boxes[..., 1] / h,
                         boxes[..., 2] / w, boxes[..., 3] / h], dim=-1)
    boxes = torch.clamp(boxes, 0.0, 1.0)
    probs = torch.softmax(cls, dim=-1) * torch.sigmoid(conf)
    return boxes, probs
