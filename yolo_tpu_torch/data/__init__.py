"""Datasets and host-side image transforms (counterpart of
``yolo_tpu/data``): the synthetic, VOC-format and COCO datasets, the eval
transforms, and the committed golden fixtures (the ``.npz`` files beside
this module). The train-time augmentation and the batch loader belong
with training."""

from yolo_tpu_torch.data.transforms import (  # noqa: F401
    BaseTransform,
    base_transform,
)
from yolo_tpu_torch.data.voc import (  # noqa: F401
    VOC_CLASSES,
    VOC_CLASSES_MASK,
    VOCDetection,
)
from yolo_tpu_torch.data.synthetic import SyntheticDetection  # noqa: F401
