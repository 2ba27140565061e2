"""Typed detector configuration (counterpart of ``yolo_tpu/config.py``).

A numpy-free copy of the anchor tables, constants, ``DetectorConfig`` and
``get_config``: importing ``yolo_tpu.config`` would import jax.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple

TRAIN_CFG = {
    "lr_epoch": (150, 200),
    "max_epoch": 260,
}

# Single-level anchors (units: grid cells at the model stride).
ANCHOR_SIZE = (
    (1.19, 1.98), (2.79, 4.59), (4.53, 8.92), (8.06, 5.29), (10.32, 10.65),
)
# slim_yolo_v2 on the face-mask dataset (the FPGA deployment target).
ANCHOR_SIZE_MASK = (
    (0.27894, 0.49337), (0.8669, 1.37835), (1.82727, 2.8404),
    (3.4131, 5.05744), (5.8903, 7.6757),
)
ANCHOR_SIZE_COCO = (
    (0.53, 0.79), (1.71, 2.36), (2.89, 6.44), (6.33, 3.79), (9.03, 9.74),
)

# Multi-level anchors (units: input pixels). yolo_v3 / yolo_v3_spp.
MULTI_ANCHOR_SIZE = (
    (32.64, 47.68), (50.24, 108.16), (126.72, 96.32),
    (78.4, 201.92), (178.24, 178.56), (129.6, 294.72),
    (331.84, 194.56), (227.84, 325.76), (365.44, 358.72),
)
MULTI_ANCHOR_SIZE_COCO = (
    (12.48, 19.2), (31.36, 46.4), (46.4, 113.92),
    (97.28, 55.04), (133.12, 127.36), (79.04, 224.0),
    (301.12, 150.4), (172.16, 285.76), (348.16, 341.12),
)

# tiny_yolo_v3 (2 scales x 3 anchors).
TINY_MULTI_ANCHOR_SIZE = (
    (34.01, 61.79), (86.94, 109.68), (93.49, 227.46),
    (246.38, 163.33), (178.68, 306.55), (344.89, 337.14),
)
TINY_MULTI_ANCHOR_SIZE_COCO = (
    (15.09, 23.25), (46.36, 61.47), (68.41, 161.84),
    (168.88, 93.59), (154.96, 257.45), (334.74, 302.47),
)

IGNORE_THRESH = 0.5

# ImageNet normalization stats in BGR channel order.
BGR_MEAN = (0.406, 0.456, 0.485)
BGR_STD = (0.225, 0.224, 0.229)


@dataclass(frozen=True)
class DetectorConfig:
    """Static configuration for one detector instance."""

    name: str
    num_classes: int = 20
    # (height, width)
    input_size: Tuple[int, int] = (416, 416)
    # ((w, h), ...) anchor table; anchors_per_scale of them per stride.
    anchor_size: Tuple[Tuple[float, float], ...] = ANCHOR_SIZE
    # One stride per detection scale, fine-to-coarse for v3-family.
    strides: Tuple[int, ...] = (32,)
    conf_thresh: float = 0.01
    nms_thresh: float = 0.5
    hr: bool = False
    # 'grid' (v2 family) or 'pixel' (v3 family).
    anchor_units: str = "grid"
    # Static detection budget of the fixed-shape postprocess.
    top_k: int = 100
    pre_nms_top_k: int = 512

    @property
    def num_scales(self) -> int:
        return len(self.strides)

    @property
    def anchors_per_scale(self) -> int:
        return len(self.anchor_size) // len(self.strides)

    @property
    def num_anchors(self) -> int:
        return len(self.anchor_size)

    def grid_sizes(self) -> Tuple[Tuple[int, int], ...]:
        """(hs, ws) of each detection scale at the current input size."""
        h, w = self.input_size
        return tuple(
            (int(round(h / s)), int(round(w / s))) for s in self.strides
        )

    def with_input_size(self, input_size) -> "DetectorConfig":
        return dataclasses.replace(self, input_size=tuple(input_size))


_MODEL_DEFAULTS = {
    # name: (strides, default anchors for voc, mask, coco)
    "slim_yolo_v2": ((16,), ANCHOR_SIZE, ANCHOR_SIZE_MASK, ANCHOR_SIZE_COCO),
    "slim_yolo_v2_q_bf": (
        (16,), ANCHOR_SIZE, ANCHOR_SIZE_MASK, ANCHOR_SIZE_COCO),
    "yolo_v2": ((32,), ANCHOR_SIZE, ANCHOR_SIZE_MASK, ANCHOR_SIZE_COCO),
    "yolo_v3": (
        (8, 16, 32), MULTI_ANCHOR_SIZE, MULTI_ANCHOR_SIZE,
        MULTI_ANCHOR_SIZE_COCO),
    "yolo_v3_spp": (
        (8, 16, 32), MULTI_ANCHOR_SIZE, MULTI_ANCHOR_SIZE,
        MULTI_ANCHOR_SIZE_COCO),
    "tiny_yolo_v3": (
        (16, 32), TINY_MULTI_ANCHOR_SIZE, TINY_MULTI_ANCHOR_SIZE,
        TINY_MULTI_ANCHOR_SIZE_COCO),
}

_DATASET_NUM_CLASSES = {"voc": 20, "mask": 2, "coco": 80}


def get_config(
    model: str,
    dataset: str = "voc",
    input_size=None,
    conf_thresh: float = 0.01,
    nms_thresh: float = 0.5,
    hr: bool = False,
    **overrides,
) -> DetectorConfig:
    """Build a DetectorConfig from (model, dataset) names."""
    if model not in _MODEL_DEFAULTS:
        raise ValueError(
            f"unknown model {model!r}; choose from {sorted(_MODEL_DEFAULTS)}")
    if dataset not in _DATASET_NUM_CLASSES:
        raise ValueError(f"unknown dataset {dataset!r}")
    strides, voc_anchors, mask_anchors, coco_anchors = _MODEL_DEFAULTS[model]
    anchors = {
        "voc": voc_anchors, "mask": mask_anchors, "coco": coco_anchors,
    }[dataset]
    if input_size is None:
        if model.startswith("slim"):
            input_size = (240, 320)
        else:
            input_size = (640, 640) if hr else (416, 416)
    anchor_units = "pixel" if "v3" in model else "grid"
    return DetectorConfig(
        name=model,
        num_classes=_DATASET_NUM_CLASSES[dataset],
        input_size=tuple(input_size),
        anchor_size=tuple(tuple(a) for a in anchors),
        strides=strides,
        conf_thresh=conf_thresh,
        nms_thresh=nms_thresh,
        hr=hr,
        anchor_units=anchor_units,
        **overrides,
    )
