"""Anchor-box k-means (counterpart of ``yolo_tpu/cli/kmeans.py``, the
reference's generate_ab_kmeans.py): IoU-distance k-means with kmeans++
seeding over every ground-truth box size of the evaluation dataset,
scaled to the model input. Host numpy only; no model runs.

    python -m yolo_tpu_torch.cli.kmeans -d synthetic -na 5
"""

from __future__ import annotations

import argparse

import numpy as np

from yolo_tpu_torch.cli.common import add_common_args, build_cfg, build_dataset


def wh_iou(boxes: np.ndarray, centers: np.ndarray) -> np.ndarray:
    """IoU of zero-centered (w, h) boxes [N, 2] against centers [K, 2]."""
    inter = (np.minimum(boxes[:, None, 0], centers[None, :, 0]) *
             np.minimum(boxes[:, None, 1], centers[None, :, 1]))
    union = (boxes[:, 0] * boxes[:, 1])[:, None] + \
        (centers[:, 0] * centers[:, 1])[None, :] - inter
    return inter / np.maximum(union, 1e-12)


def kmeans_pp_init(boxes: np.ndarray, k: int, rng) -> np.ndarray:
    """kmeans++ seeding with 1-IoU distance
    (reference generate_ab_kmeans.py:50-84)."""
    centers = [boxes[rng.integers(len(boxes))]]
    for _ in range(1, k):
        d = 1.0 - wh_iou(boxes, np.asarray(centers)).max(axis=1)
        probs = d / d.sum()
        centers.append(boxes[rng.choice(len(boxes), p=probs)])
    return np.asarray(centers)


def anchor_kmeans(boxes: np.ndarray, k: int, max_iters: int = 1000,
                  seed: int = 0):
    """(anchors [K, 2] sorted by area, mean best-IoU)."""
    rng = np.random.default_rng(seed)
    centers = kmeans_pp_init(boxes, k, rng)
    assign = None
    for _ in range(max_iters):
        iou = wh_iou(boxes, centers)
        new_assign = iou.argmax(axis=1)
        if assign is not None and np.array_equal(assign, new_assign):
            break
        assign = new_assign
        for j in range(k):
            members = boxes[assign == j]
            if len(members):
                centers[j] = members.mean(axis=0)
    avg_iou = float(wh_iou(boxes, centers).max(axis=1).mean())
    order = np.argsort(centers[:, 0] * centers[:, 1])
    return centers[order], avg_iou


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="yolo_tpu_torch anchor "
                                                 "k-means")
    add_common_args(parser)
    parser.add_argument("-na", "--num_anchorbox", type=int, default=5)
    parser.add_argument("--scale_to_grid", action="store_true",
                        default=False,
                        help="report anchors in grid-cell units "
                             "(divide by the model stride)")
    return parser.parse_args(argv)


def main(args=None):
    args = args or parse_args()
    cfg = build_cfg(args)
    dataset = build_dataset(args, cfg, train=False)
    h, w = cfg.input_size
    sizes = []
    for i in range(len(dataset)):
        _, target, _, _ = dataset.pull_item(i)
        t = np.asarray(target).reshape(-1, 5)
        ws = (t[:, 2] - t[:, 0]) * w
        hs = (t[:, 3] - t[:, 1]) * h
        sizes.extend(np.stack([ws, hs], axis=1))
    boxes = np.asarray(sizes)
    boxes = boxes[(boxes > 1).all(axis=1)]
    anchors, avg_iou = anchor_kmeans(boxes, args.num_anchorbox)
    if args.scale_to_grid:
        anchors = anchors / cfg.strides[-1]
    print(f"avg IoU: {avg_iou:.4f}")
    print("anchors:", [[round(float(a), 5) for a in row]
                       for row in anchors])
    return anchors, avg_iou


if __name__ == "__main__":
    main()
