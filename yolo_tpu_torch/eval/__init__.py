"""mAP evaluation (counterpart of ``yolo_tpu/eval``): VOC AP@0.5 and the
COCO bbox protocol over the port's batched detect fns."""

from yolo_tpu_torch.eval.voc_eval import (  # noqa: F401
    VOCEvaluator,
    voc_ap,
    voc_eval_class,
)
