"""Training (counterpart of ``yolo_tpu/train``): target assignment, the
YOLO loss and the trainer's loss function; the optimizer, the LR schedule
and the training loop are still to be ported (ROADMAP.md Queue 1 item
2)."""

from yolo_tpu_torch.train.targets import gt_creator, multi_gt_creator  # noqa: F401
from yolo_tpu_torch.train.loss import iou_score, yolo_loss  # noqa: F401
