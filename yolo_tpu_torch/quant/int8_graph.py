"""Whole-pipeline INT8 detection: quantize -> int8 backbone -> decode ->
NMS (counterpart of ``yolo_tpu/quant/int8_graph.py``: ``int8_predict``
and ``make_int8_detect_fn``, without mesh or spatial sharding)."""

from __future__ import annotations

import torch

from yolo_tpu_torch.config import DetectorConfig
from yolo_tpu_torch.detector import predict
from yolo_tpu_torch.ops import nms
from yolo_tpu_torch.quant import fixed_point as fp


def int8_predict(m: fp.Int8Model, images: torch.Tensor, cfg: DetectorConfig,
                 rounding: str = "nearest", input_s2d: bool = False):
    """images -> (boxes_norm [B, N, 4], class_probs [B, N, C]).

    ``images`` is float32 (quantized here) or already int8 at scale
    2^sa_in; with ``input_s2d`` int8 input is the padded space-to-depth
    layout and float input is laid out so on the device."""
    if images.dtype == torch.int8:
        x_q = images
    else:
        x_q = fp.quantize_input(images, m.sa["in"])
        if input_s2d:
            x_q = fp.s2d_input(x_q)
    head = fp.int8_forward(m, x_q.contiguous(), rounding,
                           input_s2d=input_s2d)
    return predict([head], cfg)


def make_int8_detect_fn(m: fp.Int8Model, cfg: DetectorConfig,
                        rounding: str = "nearest", input_s2d: bool = False,
                        device="cuda"):
    """End-to-end int8 detector on ``device``:
    images [B, H, W, 3] float32 or int8 (or, with ``input_s2d``, int8
    [B, H/2+3, W/2+3, 12]) -> (boxes, scores, classes, valid).

    The model's tensors move to ``device`` once, here; the images are
    moved there per call if they are elsewhere. Raises if ``device`` is
    CUDA and there is none."""
    dev = fp.resolve_device(device)
    m_dev = m.to(dev)

    def detect(images):
        images = torch.as_tensor(images).to(dev)
        fp.check_serving_input(images, cfg, input_s2d)
        boxes, probs = int8_predict(m_dev, images, cfg, rounding, input_s2d)
        return nms.batched_postprocess(
            boxes, probs, cfg.conf_thresh, cfg.nms_thresh,
            cfg.pre_nms_top_k, cfg.top_k)

    return detect
