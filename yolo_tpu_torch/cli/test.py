"""Visual test entry point (counterpart of ``yolo_tpu/cli/test.py``): run
detection over a dataset, draw the boxes, write jpgs.

    python -m yolo_tpu_torch.cli.test -v slim_yolo_v2 -d synthetic --num_images 8

Drawing and writing need cv2. ``-q`` runs the version's INT8 engine
(calibrated as ``cli.eval`` calibrates it), else the float Detector's
single-image path; on ``--device cuda`` (the default; it raises without
a card) or ``--device cpu``.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from yolo_tpu_torch.cli.common import add_common_args, build_cfg, build_dataset

try:
    import cv2
except ImportError:  # vis and test raise when they need it
    cv2 = None


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="yolo_tpu_torch visual "
                                                 "test")
    add_common_args(parser)
    parser.add_argument("--trained_model", default=None)
    parser.add_argument("--visual_threshold", type=float, default=0.3)
    parser.add_argument("--num_images", type=int, default=16)
    parser.add_argument("--output", default="output/")
    parser.add_argument("-q", "--quantize", action="store_true",
                        default=False)
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default; raises without a card) "
                             "or cpu")
    return parser.parse_args(argv)


def _need_cv2():
    if cv2 is None:
        raise ImportError("drawing and writing detections needs cv2 "
                          "(opencv-python), which does not import here")


def vis(img, boxes, scores, cls_inds, class_names, thresh, scale):
    """``img`` with the detections of score >= ``thresh`` drawn (boxes
    normalized, times ``scale``), one seeded color a class."""
    _need_cv2()
    img = img.copy()
    rng = np.random.default_rng(5)
    colors = [tuple(int(c) for c in rng.integers(0, 255, 3))
              for _ in class_names]
    for box, score, cls in zip(boxes, scores, cls_inds):
        if score < thresh:
            continue
        x1, y1, x2, y2 = (box * scale).astype(int)
        cls = int(cls)
        cv2.rectangle(img, (x1, y1), (x2, y2), colors[cls], 2)
        label = f"{class_names[cls]}: {score:.2f}"
        cv2.putText(img, label, (x1, max(y1 - 5, 0)),
                    cv2.FONT_HERSHEY_SIMPLEX, 0.5, colors[cls], 1)
    return img


def test(args=None):
    _need_cv2()
    from yolo_tpu_torch.cli.common import load_params
    from yolo_tpu_torch.cli.eval import calibration_batches
    from yolo_tpu_torch.data.voc import VOC_CLASSES, VOC_CLASSES_MASK
    from yolo_tpu_torch.detector import Detector
    from yolo_tpu_torch.eval.voc_eval import host_outputs
    from yolo_tpu_torch.quant.dispatch import (build_int8_detector,
                                               init_float_model)

    args = args or parse_args()
    cfg = build_cfg(args)
    model = load_params(args, init_float_model(args.version, cfg,
                                               device=args.device))
    dataset = build_dataset(args, cfg, train=False)
    os.makedirs(args.output, exist_ok=True)
    if args.dataset == "synthetic":
        class_names = [f"class{i}" for i in range(cfg.num_classes)]
    else:
        class_names = (VOC_CLASSES_MASK if args.dataset == "mask"
                       else VOC_CLASSES)

    if args.quantize:
        _, int8_detect = build_int8_detector(
            args.version, model, cfg, calibration_batches(dataset),
            device=args.device)

        def detect_one(im):
            boxes, scores, classes, valid = host_outputs(
                int8_detect(np.asarray(im, np.float32)[None]))
            keep = valid[0]
            return boxes[0][keep], scores[0][keep], classes[0][keep]
    else:
        det = Detector(cfg, model=model, device=args.device)
        detect_one = det.detect_single_numpy

    n = min(args.num_images, len(dataset))
    for i in range(n):
        im, _, h, w = dataset.pull_item(i)
        raw, _ = dataset.pull_image(i)
        t0 = time.time()
        boxes, scores, cls_inds = detect_one(im)
        print(f"im {i}: detection time {time.time() - t0:.3f}s, "
              f"{len(scores)} boxes")
        out = vis(raw, boxes, scores, cls_inds, class_names,
                  args.visual_threshold, np.array([w, h, w, h]))
        cv2.imwrite(os.path.join(args.output, f"{i}.jpg"), out)
    print(f"wrote {n} images to {args.output}")


if __name__ == "__main__":
    test()
