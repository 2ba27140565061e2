"""Streaming serving benchmark / demo: batched multi-stream detection on
the card (counterpart of ``yolo_tpu/cli/serve.py``): frames (synthetic,
video or camera) -> native preprocess -> one INT8 detect fn at a fixed
batch -> per-frame boxes.

    python -m yolo_tpu_torch.cli.serve -d synthetic --batch 64 --iters 20

Runs on ``--device cuda`` (the default; it raises without a card) or, for
a check on a machine without one, ``--device cpu`` (the kernels' plain
versions). Weights are random, from seeds. Not ported yet: ``--artifact``
(serving/export), ``--fp32`` (the float Detector) and ``--trained_model``
(the checkpoint reader); each exits with a message.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from yolo_tpu_torch.cli.common import add_common_args, build_cfg
from yolo_tpu_torch.serving import StreamingDetector

# flag -> the piece of the port it needs
_UNPORTED = {"artifact": "serving/export (a torch.export artifact format)",
             "fp32": "the float Detector (detector.Detector)",
             "trained_model": "the msgpack checkpoint reader"}


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="yolo_tpu_torch serving "
                                                 "bench")
    add_common_args(parser)
    parser.add_argument("--trained_model", default=None,
                        help="not ported yet")
    parser.add_argument("--artifact", default=None, help="not ported yet")
    parser.add_argument("--batch", type=int, default=64)
    parser.add_argument("--iters", type=int, default=20)
    parser.add_argument("--source", default="synthetic",
                        help="synthetic | video path | camera index")
    parser.add_argument("--fp32", action="store_true", default=False,
                        help="not ported yet")
    parser.add_argument("--input", default="auto",
                        choices=["auto", "s2d", "int8", "f32"],
                        help="host->device input mode: s2d (int8 in the "
                        "padded space-to-depth layout), int8 "
                        "(host-quantized NHWC), f32 (quantize on the "
                        "device). auto: int8 for yolo_v2 at batch >= 128, "
                        "else s2d (the JAX package's rule)")
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default; raises without a card) "
                             "or cpu")
    return parser.parse_args(argv)


def _frames(args, cfg, n):
    if args.source == "synthetic":
        rng = np.random.default_rng(0)
        return [rng.integers(0, 256, (480, 640, 3), dtype=np.uint8)
                for _ in range(n)]
    import cv2
    src = int(args.source) if args.source.isdigit() else args.source
    cap = cv2.VideoCapture(src)
    frames = []
    while len(frames) < n:
        ok, f = cap.read()
        if not ok:
            break
        frames.append(f)
    cap.release()
    return frames


def build(args):
    """The INT8 detector of ``args`` -> (StreamingDetector, int8 model):
    the version's float model from ``torch.Generator().manual_seed(0)``,
    calibrated on 4 batches of 8 uniform images from
    ``np.random.default_rng(0)`` (as the JAX CLI draws them), served by
    its family's detect fn (``quant.dispatch``)."""
    from yolo_tpu_torch.quant.dispatch import (
        build_int8_detector, init_float_model, input_scale_exponent)

    for flag, what in _UNPORTED.items():
        if getattr(args, flag):
            raise SystemExit(f"--{flag} is not ported yet: it needs {what}")
    cfg = build_cfg(args)
    if args.input == "auto":
        # the JAX CLI's per-family rule: yolo_v2's s2d entry lost at
        # batch >= 128 there
        args.input = ("int8" if args.version == "yolo_v2"
                      and args.batch >= 128 else "s2d")
    model = init_float_model(args.version, cfg, device=args.device,
                             generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    h, w = cfg.input_size
    calib = [rng.random((8, h, w, 3), dtype=np.float32) for _ in range(4)]
    s2d = args.input == "s2d"
    m, detect = build_int8_detector(args.version, model, cfg, calib,
                                    input_s2d=s2d, device=args.device)
    sa_in = (input_scale_exponent(m) if args.input in ("s2d", "int8")
             else None)
    sd = StreamingDetector(cfg, detect, batch_size=args.batch, sa_in=sa_in,
                           s2d=s2d, device=args.device)
    return sd, m


def main(argv=None):
    """Serve synthetic (or video / camera) frames and print end-to-end
    frames/sec -> {"fps": overlapped, "fps_sequential": sequential,
    "detector": the StreamingDetector}."""
    args = parse_args(argv)
    sd, _ = build(args)
    cfg = sd.cfg
    frames = _frames(args, cfg, args.batch)
    print(f"native preprocess: {sd._native is not None}; "
          f"host-side int8 quantize: {sd.sa_in is not None}; "
          f"s2d input layout: {sd.s2d}; device: {sd.device}")

    results = sd.detect_frames(frames[:4])
    for i, (boxes, scores, classes) in enumerate(results):
        print(f"frame {i}: {len(scores)} detections")

    fps_seq = sd.benchmark(frames, iters=args.iters, overlap=False)
    fps = sd.benchmark(frames, iters=args.iters, overlap=True)
    print(f"end-to-end throughput: {fps:.1f} frames/sec "
          f"(batch {args.batch}, {cfg.input_size[0]}x{cfg.input_size[1]},"
          f" INT8); prefetch overlap gain {fps / max(fps_seq, 1e-9):.2f}x "
          f"over sequential {fps_seq:.1f}")
    return {"fps": fps, "fps_sequential": fps_seq, "detector": sd}


if __name__ == "__main__":
    main()
