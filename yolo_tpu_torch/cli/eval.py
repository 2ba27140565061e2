"""mAP evaluation entry point (counterpart of ``yolo_tpu/cli/eval.py``).

    python -m yolo_tpu_torch.cli.eval -v slim_yolo_v2 -d synthetic -q

Scores the version's detector on the dataset with ``VOCEvaluator`` and
prints ``Mean AP``. With ``-q`` the INT8 engine of the version's family
(``quant.dispatch.build_int8_detector``, calibrated on the stack of the
dataset's first 16 images), else the float ``detector.Detector``. Runs on
``--device cuda`` (the default; it raises without a card) or ``--device
cpu`` (the kernels' plain versions). Weights come from
``--trained_model``, else random from a seed (``cli.common.load_params``).
"""

from __future__ import annotations

import argparse

import numpy as np

from yolo_tpu_torch.cli.common import (add_common_args, build_cfg,
                                       build_dataset, load_params)
from yolo_tpu_torch.eval.voc_eval import VOCEvaluator


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="yolo_tpu_torch evaluation")
    add_common_args(parser)
    parser.add_argument("--trained_model", default=None,
                        help="checkpoint (.msgpack, or a reference slim "
                             ".pth)")
    parser.add_argument("-q", "--quantize", action="store_true",
                        default=False,
                        help="evaluate the INT8-quantized model")
    parser.add_argument("--batch_size", type=int, default=32)
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default; raises without a card) "
                             "or cpu")
    return parser.parse_args(argv)


def calibration_batches(dataset):
    """The JAX CLI's calibration draw: one stack of the first 16
    transformed images."""
    return [np.stack([dataset.pull_item(i)[0]
                      for i in range(min(16, len(dataset)))])]


def build_detect(args, cfg, dataset):
    """``args``'s detector on ``args.device`` -> (the INT8 model and its
    detect fn with ``-q``, else the float ``Detector`` and its
    ``detect_fn()``)."""
    from yolo_tpu_torch.quant.dispatch import (build_int8_detector,
                                               init_float_model)

    model = load_params(args, init_float_model(args.version, cfg,
                                               device=args.device))
    if args.quantize:
        return build_int8_detector(args.version, model, cfg,
                                   calibration_batches(dataset),
                                   device=args.device)
    from yolo_tpu_torch.detector import Detector

    det = Detector(cfg, model=model, device=args.device)
    return det, det.detect_fn()


def evaluate(args=None):
    """-> the mAP."""
    args = args or parse_args()
    cfg = build_cfg(args)
    dataset = build_dataset(args, cfg, train=False)
    evaluator = VOCEvaluator(dataset, cfg.num_classes, cfg.input_size,
                             batch_size=args.batch_size, display=True)
    _, detect = build_detect(args, cfg, dataset)
    mean_ap = evaluator.evaluate(detect)
    print(f"Mean AP: {mean_ap:.4f}")
    return mean_ap


if __name__ == "__main__":
    evaluate()
