"""Shared CLI plumbing (counterpart of ``add_common_args`` and
``build_cfg`` in ``yolo_tpu/cli/common.py``, and of ``load_params`` in
``yolo_tpu/cli/eval.py``, here until the port's eval CLI exists; the
dataset builders wait for the port's data loaders)."""

from __future__ import annotations

import argparse

from yolo_tpu_torch.config import get_config


def add_common_args(parser: argparse.ArgumentParser):
    parser.add_argument("-v", "--version", default="slim_yolo_v2",
                        help="model version: slim_yolo_v2, slim_yolo_v2_q_bf,"
                             " yolo_v2, yolo_v3, yolo_v3_spp, tiny_yolo_v3")
    parser.add_argument("-d", "--dataset", default="mask",
                        help="voc, coco, mask or synthetic")
    parser.add_argument("-hr", "--high_resolution", action="store_true",
                        default=False, help="use hi-res backbone")
    parser.add_argument("--input_size", type=int, nargs=2, default=None,
                        metavar=("H", "W"), help="model input size")
    parser.add_argument("--conf_thresh", type=float, default=0.01)
    parser.add_argument("--nms_thresh", type=float, default=0.5)
    return parser


def build_cfg(args):
    kwargs = {}
    if args.input_size is not None:
        kwargs["input_size"] = tuple(args.input_size)
    dataset = "mask" if args.dataset == "synthetic" else args.dataset
    return get_config(args.version, dataset,
                      conf_thresh=args.conf_thresh,
                      nms_thresh=args.nms_thresh,
                      hr=args.high_resolution, **kwargs)


def load_params(args, model):
    """``model`` (a version's float ``nn.Module``) with ``--trained_model``'s
    weights: a ``.msgpack`` checkpoint of either package
    (``utils.checkpoint``), or for the slim family a reference ``.pth``
    (BN form, or fused for ``*_q_bf``). Without ``--trained_model``:
    random weights from ``torch.Generator().manual_seed(0)`` (the JAX CLI
    draws from ``PRNGKey(0)``, a stream torch cannot reproduce). Returns
    ``model``."""
    import torch

    from yolo_tpu_torch.ops import blocks
    from yolo_tpu_torch.quant.convert import load_params as copy_params
    from yolo_tpu_torch.utils import checkpoint

    if args.trained_model is None:
        with torch.no_grad():
            return blocks.init_model(model,
                                     torch.Generator().manual_seed(0))
    if args.trained_model.endswith(".pth"):
        if not args.version.startswith("slim_yolo_v2"):
            raise SystemExit(f"a reference .pth loads for the slim family "
                             f"only, not {args.version}; pass a .msgpack "
                             f"checkpoint")
        params, _ = checkpoint.load_torch_slim_yolo_v2(
            args.trained_model, fused=args.version.endswith("_q_bf"))
    else:
        params, _ = checkpoint.load_checkpoint(args.trained_model)
    return copy_params(model, params)
