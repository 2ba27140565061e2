"""Demo entry point (counterpart of ``yolo_tpu/cli/demo.py``): detection
with drawn boxes over a directory of images, a video or a camera.

    python -m yolo_tpu_torch.cli.demo --mode image --path_to_img imgs/

The float Detector's single-image path on ``--device cuda`` (the
default; it raises without a card) or ``--device cpu``. Reading, drawing
and writing frames need cv2.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from yolo_tpu_torch.cli.common import add_common_args, build_cfg
from yolo_tpu_torch.cli.test import _need_cv2, vis

try:
    import cv2
except ImportError:  # detect raises when it needs it
    cv2 = None


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="yolo_tpu_torch demo")
    add_common_args(parser)
    parser.add_argument("--mode", default="image",
                        help="image, video or camera")
    parser.add_argument("--path_to_img", default="data/demo/images/")
    parser.add_argument("--path_to_vid", default="data/demo/video/video.mp4")
    parser.add_argument("--path_to_save", default="det_results/")
    parser.add_argument("--trained_model", default=None)
    parser.add_argument("--visual_threshold", type=float, default=0.3)
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default; raises without a card) "
                             "or cpu")
    return parser.parse_args(argv)


def _detect_frame(det, transform, frame, class_names, thresh):
    x, _, _ = transform(frame)
    h, w = frame.shape[:2]
    t0 = time.time()
    boxes, scores, cls_inds = det.detect_single_numpy(x)
    dt = time.time() - t0
    out = vis(frame, boxes, scores, cls_inds, class_names, thresh,
              np.array([w, h, w, h]))
    return out, dt


def detect(args=None):
    _need_cv2()
    from yolo_tpu_torch.cli.common import load_params
    from yolo_tpu_torch.data.transforms import BaseTransform
    from yolo_tpu_torch.data.voc import VOC_CLASSES_MASK
    from yolo_tpu_torch.detector import Detector
    from yolo_tpu_torch.quant.dispatch import init_float_model

    args = args or parse_args()
    cfg = build_cfg(args)
    det = Detector(cfg, model=load_params(args, init_float_model(
        args.version, cfg, device=args.device)), device=args.device)
    transform = BaseTransform(cfg.input_size)
    class_names = [f"class{i}" for i in range(cfg.num_classes)]
    if cfg.num_classes == 2:
        class_names = VOC_CLASSES_MASK
    os.makedirs(args.path_to_save, exist_ok=True)

    if args.mode == "image":
        files = sorted(os.listdir(args.path_to_img))
        for i, name in enumerate(files):
            frame = cv2.imread(os.path.join(args.path_to_img, name))
            if frame is None:  # not an image file
                continue
            out, dt = _detect_frame(det, transform, frame, class_names,
                                    args.visual_threshold)
            print(f"{name}: {dt:.3f}s")
            cv2.imwrite(os.path.join(args.path_to_save, f"{i}.jpg"), out)
    elif args.mode in ("video", "camera"):
        src = args.path_to_vid if args.mode == "video" else 0
        cap = cv2.VideoCapture(src)
        writer = None
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            out, dt = _detect_frame(det, transform, frame, class_names,
                                    args.visual_threshold)
            if args.mode == "video":
                if writer is None:
                    fourcc = cv2.VideoWriter_fourcc(*"XVID")
                    writer = cv2.VideoWriter(
                        os.path.join(args.path_to_save, "det.avi"), fourcc,
                        30.0, (out.shape[1], out.shape[0]))
                writer.write(out)
            else:
                cv2.imshow("detection", out)
                if cv2.waitKey(1) == ord("q"):
                    break
        cap.release()
        if writer is not None:
            writer.release()
    else:
        raise ValueError(f"unknown mode {args.mode!r}")


if __name__ == "__main__":
    detect()
