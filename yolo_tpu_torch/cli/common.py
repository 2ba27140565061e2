"""Shared CLI plumbing (counterpart of ``yolo_tpu/cli/common.py``:
``add_common_args``, ``build_cfg`` and ``build_dataset``; and of
``load_params`` in ``yolo_tpu/cli/eval.py``, which every port CLI shares
from here)."""

from __future__ import annotations

import argparse

from yolo_tpu_torch.config import get_config


def add_common_args(parser: argparse.ArgumentParser):
    parser.add_argument("-v", "--version", default="slim_yolo_v2",
                        help="model version: slim_yolo_v2, slim_yolo_v2_q_bf,"
                             " yolo_v2, yolo_v3, yolo_v3_spp, tiny_yolo_v3")
    parser.add_argument("-d", "--dataset", default="mask",
                        help="voc, coco, mask or synthetic")
    parser.add_argument("--dataset_root", default="data/VOCdevkit",
                        help="dataset root directory")
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


def build_dataset(args, cfg, train: bool = True, seed: int = 0,
                  u8: bool = False):
    """The dataset of ``args.dataset`` at ``cfg.input_size`` (the JAX
    CLI's dispatch, reference train.py:108-157). Training
    (``SSDAugmentation`` seeded with ``seed``; ``u8`` keeps its images
    raw uint8, normalized on the card by ``detector.normalize_u8``):
    synthetic (128 images, seed 0), voc (VOC2007 and VOC2012 trainval),
    mask (its train split) or coco (train2017). Evaluation
    (``BaseTransform``): synthetic (32 images, seed 1), voc (VOC2007
    test), mask (its test split) or coco (val2017). Every set but
    synthetic lies under ``args.dataset_root``."""
    from yolo_tpu_torch.data.synthetic import SyntheticDetection
    from yolo_tpu_torch.data.transforms import BaseTransform, SSDAugmentation
    from yolo_tpu_torch.data.voc import VOC_CLASSES, VOCDetection

    size = cfg.input_size
    transform = (SSDAugmentation(size, seed=seed, normalize=not u8)
                 if train else BaseTransform(size))
    if args.dataset == "synthetic":
        return SyntheticDetection(size=size, num_classes=cfg.num_classes,
                                  transform=transform,
                                  length=128 if train else 32,
                                  seed=0 if train else 1)
    if args.dataset == "voc":
        sets = ((("2007", "trainval"), ("2012", "trainval")) if train
                else (("2007", "test"),))
        return VOCDetection(args.dataset_root, image_sets=sets,
                            classes=VOC_CLASSES, transform=transform)
    if args.dataset == "mask":
        return VOCDetection.mask(args.dataset_root,
                                 "train" if train else "test",
                                 transform=transform)
    if args.dataset == "coco":
        from yolo_tpu_torch.data.coco import COCODataset
        split = "train2017" if train else "val2017"
        return COCODataset(args.dataset_root,
                           json_file=f"instances_{split}.json",
                           name=split, transform=transform)
    raise ValueError(f"unknown dataset {args.dataset!r}")


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
