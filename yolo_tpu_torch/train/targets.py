"""Ground-truth target assignment on the host, in numpy (a copy of
``yolo_tpu/train/targets.py``; the port imports nothing of that package).

Semantics parity with the reference target builders
(tools.py:132-374): best-anchor assignment with an IoU ignore threshold —
the single best anchor per GT becomes the positive; other anchors above
the ignore threshold are marked ignored (objectness/weight = -1).

GT tensor layout per anchor slot (11 columns, reference tools.py:230):
  [objectness, class, tx, ty, tw, th, box_scale_weight,
   xmin, ymin, xmax, ymax]   (corner coords normalized to [0, 1])

The anchor-IoU computation is vectorized; the per-GT placement is a small
host loop exactly because last-write-wins collision behavior must match
the reference.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from yolo_tpu_torch.config import IGNORE_THRESH

GT_WIDTH = 11  # 1 obj + 1 cls + 4 txtytwth + 1 weight + 4 xyxy


def anchor_iou_wh(anchor_wh: np.ndarray, box_wh: np.ndarray) -> np.ndarray:
    """IoU between zero-centered anchors [A, 2] and one zero-centered gt
    box [2] — the shape-matching IoU of reference tools.compute_iou
    (tools.py:72-110) specialized to centered boxes."""
    inter = (np.minimum(anchor_wh[:, 0], box_wh[0]) *
             np.minimum(anchor_wh[:, 1], box_wh[1]))
    union = (anchor_wh[:, 0] * anchor_wh[:, 1] +
             box_wh[0] * box_wh[1] - inter + 1e-20)
    return inter / union


def gt_creator(input_size: Sequence[int], stride: int,
               label_lists: List[np.ndarray],
               anchor_size: Sequence[Tuple[float, float]]) -> np.ndarray:
    """Single-scale target tensor [B, hs*ws*A, 11]
    (reference tools.gt_creator, tools.py:202-253).

    Anchors are in grid-cell units (stride-scaled), as the reference's
    single-level anchor tables are (data/config.py:10-14).
    """
    batch_size = len(label_lists)
    h, w = input_size[0], input_size[1]
    ws, hs = int(round(w / stride)), int(round(h / stride))
    anchors = np.asarray(anchor_size, np.float64)
    num_anchors = len(anchors)

    gt = np.zeros((batch_size, hs, ws, num_anchors, GT_WIDTH))
    for b, labels in enumerate(label_lists):
        for gt_label in np.asarray(labels).reshape(-1, 5):
            xmin, ymin, xmax, ymax, gt_class = gt_label
            c_x = (xmax + xmin) / 2 * w
            c_y = (ymax + ymin) / 2 * h
            box_w = (xmax - xmin) * w
            box_h = (ymax - ymin) * h
            if box_w < 1.0 or box_h < 1.0:
                continue  # dirty data (reference tools.py:140-142)
            box_ws, box_hs = box_w / stride, box_h / stride
            grid_x = int(c_x / stride)
            grid_y = int(c_y / stride)

            iou = anchor_iou_wh(anchors, np.array([box_ws, box_hs]))
            above = iou > IGNORE_THRESH
            best = int(np.argmax(iou))

            def place_positive(index):
                p_w, p_h = anchors[index]
                tx = c_x / stride - grid_x
                ty = c_y / stride - grid_y
                tw = np.log(box_ws / p_w)
                th = np.log(box_hs / p_h)
                weight = 2.0 - (box_w / w) * (box_h / h)
                if grid_y < hs and grid_x < ws:
                    gt[b, grid_y, grid_x, index, 0] = 1.0
                    gt[b, grid_y, grid_x, index, 1] = int(gt_class)
                    gt[b, grid_y, grid_x, index, 2:6] = [tx, ty, tw, th]
                    gt[b, grid_y, grid_x, index, 6] = weight
                    gt[b, grid_y, grid_x, index, 7:] = [xmin, ymin, xmax, ymax]

            if not above.any():
                place_positive(best)
            else:
                for index in np.where(above)[0]:
                    if index == best:
                        place_positive(index)
                    else:
                        # ignored anchor (reference tools.py:195-197)
                        gt[b, grid_y, grid_x, index, 0] = -1.0
                        gt[b, grid_y, grid_x, index, 6] = -1.0

    return gt.reshape(batch_size, hs * ws * num_anchors, GT_WIDTH)


def multi_gt_creator(input_size: Sequence[int], strides: Sequence[int],
                     label_lists: List[np.ndarray],
                     anchor_size: Sequence[Tuple[float, float]]) -> np.ndarray:
    """Multi-scale (FPN) target tensor, scales concatenated in ``strides``
    order: [B, sum_s (h/s)*(w/s)*A, 11]
    (reference tools.multi_gt_creator, tools.py:256-374).

    Anchors here are in *input pixels* (data/config.py:18-31); each GT box
    is matched against the flat anchor table, and the winning anchor's
    scale index selects the stride.
    """
    batch_size = len(label_lists)
    h, w = input_size
    num_scale = len(strides)
    anchors = np.asarray(anchor_size, np.float64)
    apc = len(anchors) // num_scale  # anchors per scale

    gts = [np.zeros((batch_size, h // s, w // s, apc, GT_WIDTH))
           for s in strides]

    for b, labels in enumerate(label_lists):
        for gt_label in np.asarray(labels).reshape(-1, 5):
            xmin, ymin, xmax, ymax, gt_class = gt_label
            c_x = (xmax + xmin) / 2 * w
            c_y = (ymax + ymin) / 2 * h
            box_w = (xmax - xmin) * w
            box_h = (ymax - ymin) * h
            if box_w < 1.0 or box_h < 1.0:
                continue

            iou = anchor_iou_wh(anchors, np.array([box_w, box_h]))
            above = iou > IGNORE_THRESH
            best = int(np.argmax(iou))

            def place(index, positive):
                s_idx, ab_idx = index // apc, index % apc
                s = strides[s_idx]
                grid_x = int(c_x / s)
                grid_y = int(c_y / s)
                t = gts[s_idx]
                if positive:
                    p_w, p_h = anchors[index]
                    tx = c_x / s - grid_x
                    ty = c_y / s - grid_y
                    tw = np.log(box_w / p_w)
                    th = np.log(box_h / p_h)
                    weight = 2.0 - (box_w / w) * (box_h / h)
                    if grid_y < t.shape[1] and grid_x < t.shape[2]:
                        t[b, grid_y, grid_x, ab_idx, 0] = 1.0
                        t[b, grid_y, grid_x, ab_idx, 1] = int(gt_class)
                        t[b, grid_y, grid_x, ab_idx, 2:6] = [tx, ty, tw, th]
                        t[b, grid_y, grid_x, ab_idx, 6] = weight
                        t[b, grid_y, grid_x, ab_idx, 7:] = [
                            xmin, ymin, xmax, ymax]
                else:
                    t[b, grid_y, grid_x, ab_idx, 0] = -1.0
                    t[b, grid_y, grid_x, ab_idx, 6] = -1.0

            if not above.any():
                place(best, positive=True)
            else:
                for index in np.where(above)[0]:
                    place(int(index), positive=(index == best))

    return np.concatenate(
        [t.reshape(batch_size, -1, GT_WIDTH) for t in gts], axis=1)


def build_targets(cfg, label_lists) -> np.ndarray:
    """Dispatch on the number of scales, like the reference training loop
    (train.py:303-315)."""
    if cfg.num_scales == 1:
        return gt_creator(cfg.input_size, cfg.strides[0], label_lists,
                          cfg.anchor_size)
    return multi_gt_creator(cfg.input_size, cfg.strides, label_lists,
                            cfg.anchor_size)
