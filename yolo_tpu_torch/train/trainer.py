"""The trainer's configuration and loss function (counterpart of
``TrainConfig`` and ``loss_fn`` in ``yolo_tpu/train/trainer.py``).

One training batch: uint8 or normalized NHWC images on the model's
device, the training forward (``detector.train_outputs``: BN in train
mode, its running stats updated in place), then ``yolo_loss`` in
float32; ``total.backward()`` gives the gradients autograd puts on the
parameters. The optimizer (SGD with coupled weight decay), the LR
schedule, multi-scale training and the training loop are still to be
ported (ROADMAP.md Queue 1 item 2).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from yolo_tpu_torch import detector as det
from yolo_tpu_torch.config import TRAIN_CFG, DetectorConfig
from yolo_tpu_torch.train.loss import yolo_loss


@dataclass(frozen=True)
class TrainConfig:
    base_lr: float = 1e-3
    momentum: float = 0.9
    weight_decay: float = 5e-4
    wp_epoch: int = 2              # warmup epochs (reference train.py:47)
    max_epoch: int = TRAIN_CFG["max_epoch"]
    lr_epoch: Tuple[int, ...] = TRAIN_CFG["lr_epoch"]
    cos: bool = False
    obj_loss_f: str = "mse"
    # recompute the forward during the backward instead of keeping its
    # activations
    remat: bool = False
    # mixed precision: the convs in this dtype, the parameters,
    # gradients and the loss in float32
    compute_dtype: Optional[str] = None
    # conv + pool pairs with C_in <= this in the pooled-resolution s2d
    # form (same math, another summation order); 0: the plain trace
    fast_pool_cin: int = 0


def _check_ported(tc: TrainConfig) -> None:
    """Raise on the options whose forms are not ported yet: they would
    otherwise change nothing, silently."""
    unported = [f"{name}={value!r}" for name, value, default in (
        ("compute_dtype", tc.compute_dtype, None),
        ("remat", tc.remat, False),
        ("fast_pool_cin", tc.fast_pool_cin, 0)) if value != default]
    if unported:
        raise NotImplementedError(
            f"TrainConfig({', '.join(unported)}): bf16 compute, remat and "
            f"the s2d pooled form come with the trainer proper (ROADMAP.md "
            f"Queue 1 item 2); this loss runs the float32 path only")


def loss_fn(model, cfg: DetectorConfig, tc: TrainConfig,
            images: torch.Tensor, gt_tensor):
    """One batch's loss on ``model`` (a float model with BN, on the
    images' device): ``images`` NHWC, uint8 RGB (normalized here by
    ``detector.normalize_u8``) or normalized float32; ``gt_tensor`` [B,
    N, 11] from ``train.targets.build_targets``. Returns (total,
    {'conf_loss', 'cls_loss', 'txtytwth_loss'}), float32 scalars that
    carry autograd; the BN running stats are updated in place.
    Non-default ``compute_dtype``, ``remat`` and ``fast_pool_cin``
    raise ``NotImplementedError``."""
    _check_ported(tc)
    if images.dtype == torch.uint8:
        images = det.normalize_u8(images)
    conf, cls, txt, boxes_norm = det.train_outputs(model, images, cfg)
    conf_l, cls_l, box_l, total = yolo_loss(
        conf, cls, txt, boxes_norm, gt_tensor, cfg.num_classes,
        obj_loss_f=tc.obj_loss_f)
    return total, {"conf_loss": conf_l, "cls_loss": cls_l,
                   "txtytwth_loss": box_l}
