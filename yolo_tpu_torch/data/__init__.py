"""Datasets, host-side image transforms and batch loading (counterpart of
``yolo_tpu/data``): the synthetic, VOC-format and COCO datasets, the eval
transform and the train-time ``SSDAugmentation``, ``BatchLoader`` and
``detection_collate``, and the committed golden fixtures (the ``.npz``
files beside this module)."""

from yolo_tpu_torch.data.transforms import (  # noqa: F401
    BaseTransform,
    SSDAugmentation,
    base_transform,
)
from yolo_tpu_torch.data.voc import (  # noqa: F401
    VOC_CLASSES,
    VOC_CLASSES_MASK,
    VOCDetection,
)
from yolo_tpu_torch.data.synthetic import SyntheticDetection  # noqa: F401
from yolo_tpu_torch.data.loader import BatchLoader, detection_collate  # noqa: F401
