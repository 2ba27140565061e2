"""The YOLO loss on torch tensors, in float32, float64 predictions in
float64 (counterpart of ``yolo_tpu/train/loss.py``; reference
tools.py:392-435).

Components (all "sum over anchors, mean over batch"):
- objectness: masked MSE (pos weight 5.0, neg weight 1.0) on
  sigmoid(conf) against the IoU of the decoded box with its GT box, or
  BCE (``obj_loss_f='bce'``); slots whose objectness label is -1 (the
  ignored anchors) take no part.
- class: softmax cross-entropy on positive slots.
- box: BCE-with-logits on (tx, ty), MSE on (tw, th), both scaled by the
  per-box size weight (2 - area fraction).
"""

from __future__ import annotations

import torch


def iou_score(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """Elementwise IoU of corner boxes [..., 4]
    (reference tools.iou_score, tools.py:377-389)."""
    tl = torch.maximum(boxes_a[..., :2], boxes_b[..., :2])
    br = torch.minimum(boxes_a[..., 2:], boxes_b[..., 2:])
    area_a = torch.prod(boxes_a[..., 2:] - boxes_a[..., :2], dim=-1)
    area_b = torch.prod(boxes_b[..., 2:] - boxes_b[..., :2], dim=-1)
    en = torch.all(tl < br, dim=-1).to(boxes_a.dtype)
    area_i = torch.prod(br - tl, dim=-1) * en
    # the epsilon guards the all-zero (no GT) slots
    return area_i / (area_a + area_b - area_i + 1e-20)


def _bce_with_logits(x, z):
    # stable: max(x, 0) - x*z + log(1 + exp(-|x|)); torch.maximum splits
    # the gradient at a tie as jnp.maximum does
    return torch.maximum(x, torch.zeros_like(x)) - x * z + torch.log1p(
        torch.exp(-torch.abs(x)))


def _bce_prob(p, z):
    eps = 1e-14
    return -(z * torch.log(p + eps) + (1.0 - z) * torch.log(1.0 - p + eps))


def yolo_loss(conf_pred, cls_pred, txtytwth_pred, boxes_norm_pred, gt_tensor,
              num_classes: int, obj_loss_f: str = "mse"):
    """(conf_loss, cls_loss, txtytwth_loss, total_loss), float32 scalars
    (float64 for float64 predictions).

    Args:
      conf_pred: [B, N, 1] objectness logits.
      cls_pred: [B, N, C] class logits.
      txtytwth_pred: [B, N, 4] raw box offsets.
      boxes_norm_pred: [B, N, 4] decoded corner boxes normalized to
        [0, 1], the IoU objectness target's input (detached here, as the
        reference builds that target in its forward,
        models/slim_yolo_v2.py:601-616).
      gt_tensor: [B, N, 11] from ``train.targets`` (numpy or a tensor),
        taken to the loss's type on the predictions' device.
    """
    if obj_loss_f not in ("mse", "bce"):
        raise ValueError(f"unknown obj_loss_f {obj_loss_f!r}")
    dtype = torch.promote_types(conf_pred.dtype, torch.float32)
    conf_pred, cls_pred, txtytwth_pred, boxes_norm_pred = (
        t.to(dtype) for t in (conf_pred, cls_pred, txtytwth_pred,
                              boxes_norm_pred))
    gt = torch.as_tensor(gt_tensor).to(device=conf_pred.device, dtype=dtype)
    gt_obj = gt[:, :, 0]
    gt_cls = gt[:, :, 1].to(torch.int64)
    gt_txtytwth = gt[:, :, 2:6]
    gt_weight = gt[:, :, 6]
    gt_boxes = gt[:, :, 7:11]

    # conf target = IoU(decoded pred box, gt box); zero where no gt box
    gt_conf = iou_score(boxes_norm_pred, gt_boxes).detach()

    pred_conf = torch.sigmoid(conf_pred[:, :, 0])
    pos_id = (gt_obj == 1.0).to(dtype)
    neg_id = (gt_obj == 0.0).to(dtype)

    if obj_loss_f == "mse":
        # yolov2-style (reference tools.MSELoss + weights 5 / 1)
        pos_loss = torch.mean(torch.sum(pos_id * (pred_conf - gt_conf) ** 2,
                                        dim=1))
        neg_loss = torch.mean(torch.sum(neg_id * pred_conf ** 2, dim=1))
        conf_loss = 5.0 * pos_loss + 1.0 * neg_loss
    else:
        pos_loss = torch.mean(torch.sum(
            pos_id * _bce_prob(pred_conf, gt_conf), dim=1))
        neg_loss = torch.mean(torch.sum(
            neg_id * _bce_prob(pred_conf, torch.zeros_like(pred_conf)),
            dim=1))
        conf_loss = pos_loss + neg_loss

    gt_mask = (gt_weight > 0.0).to(dtype)

    # class loss: CE on positives
    log_probs = torch.log_softmax(cls_pred, dim=-1)
    ce = -torch.gather(log_probs, -1, gt_cls[..., None])[..., 0]
    cls_loss = torch.mean(torch.sum(ce * gt_mask, dim=1))

    # box loss
    txty_l = torch.sum(_bce_with_logits(txtytwth_pred[:, :, :2],
                                        gt_txtytwth[:, :, :2]), dim=2)
    twth_l = torch.sum((txtytwth_pred[:, :, 2:] - gt_txtytwth[:, :, 2:]) ** 2,
                       dim=2)
    txty_loss = torch.mean(torch.sum(txty_l * gt_weight * gt_mask, dim=1))
    twth_loss = torch.mean(torch.sum(twth_l * gt_weight * gt_mask, dim=1))
    txtytwth_loss = txty_loss + twth_loss

    total_loss = conf_loss + cls_loss + txtytwth_loss
    return conf_loss, cls_loss, txtytwth_loss, total_loss
