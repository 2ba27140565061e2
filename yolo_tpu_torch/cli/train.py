"""Training entry point (counterpart of ``yolo_tpu/cli/train.py``,
reference train.py).

    python -m yolo_tpu_torch.cli.train -v slim_yolo_v2 -d synthetic \
        --max_epoch 3 [--device cpu]

Trains the version's float model on ``--device cuda`` (the default; it
raises without a card) or ``--device cpu``: ``BatchLoader`` batches,
targets and the copy to the device one batch ahead of the step
(``prefetch_iter``), SGD steps (``train.trainer.make_train_step``),
optionally multi-scale (a new bucket every 10 iterations, resized on the
device), the VOC mAP every ``--eval_epoch`` epochs, and a checkpoint
every 10 epochs and at the last, with the optimizer state in the JAX
package's layout, so either package resumes the other's. Seeded weights
come from ``torch.Generator().manual_seed(0)`` (the JAX CLI draws from
``PRNGKey(0)``, a stream torch cannot reproduce).
"""

from __future__ import annotations

import argparse
import itertools
import os
import time

import numpy as np
import torch
import torch.nn.functional as F

from yolo_tpu_torch.cli.common import add_common_args, build_cfg, build_dataset


def _resize_batch(images, size):
    """Bilinear resize of an NHWC batch to a multi-scale bucket (the
    reference's F.interpolate, train.py:293), on the batch's device; the
    batch itself at its own size. uint8 batches are normalized first
    (``detector.normalize_u8``), as the reference interpolates the
    normalized tensor. Each axis separately, with align_corners=False and,
    where the axis shrinks, antialiasing, as the JAX package's
    ``jax.image.resize(..., 'bilinear')`` (a triangle kernel widened by
    the scale when it shrinks); -> float32 NHWC."""
    from yolo_tpu_torch.detector import normalize_u8

    images = torch.as_tensor(images)
    if tuple(images.shape[1:3]) == tuple(size):
        return images
    x = normalize_u8(images) if images.dtype == torch.uint8 else images
    x = x.permute(0, 3, 1, 2)
    for new in ((size[0], x.shape[3]), tuple(size)):
        if tuple(x.shape[2:]) != new:
            shrinks = new[0] < x.shape[2] or new[1] < x.shape[3]
            x = F.interpolate(x, size=new, mode="bilinear",
                              align_corners=False, antialias=shrinks)
    return x.permute(0, 2, 3, 1).contiguous()


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="yolo_tpu_torch training")
    add_common_args(parser)
    parser.add_argument("-b", "--batch_size", type=int, default=32)
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--wp_epoch", type=int, default=2)
    parser.add_argument("--start_epoch", type=int, default=0)
    parser.add_argument("--max_epoch", type=int, default=260)
    parser.add_argument("-r", "--resume", default=None,
                        help="checkpoint to resume from (either package's: "
                             "parameters, BN stats and momentum)")
    parser.add_argument("--pretrained_backbone", default=None,
                        help="reference ImageNet backbone .pth to "
                             "initialize from (darknet19/53/light, "
                             "matched to -v; reference train.py:174-213)")
    parser.add_argument("-ms", "--multi_scale", action="store_true",
                        default=False)
    parser.add_argument("--cos", action="store_true", default=False)
    parser.add_argument("--bf16", action="store_true", default=False,
                        help="bf16 mixed-precision compute (fp32 master "
                             "params/optimizer)")
    parser.add_argument("--fast_pool", type=int, default=0,
                        metavar="CIN_MAX",
                        help="run entry conv+pool pairs (C_in <= CIN_MAX) "
                             "at pooled resolution via space-to-depth: "
                             "same math, another summation order (try "
                             "32). 0 = the plain trace (default)")
    parser.add_argument("--eval_epoch", type=int, default=10)
    parser.add_argument("--save_folder", default="weights/")
    parser.add_argument("--num_workers", type=int, default=8)
    parser.add_argument("--f32_input", action="store_true", default=False,
                        help="host-normalized float32 batches instead of "
                             "the default raw-uint8 + on-device normalize "
                             "path (4x more host->device traffic)")
    parser.add_argument("--loader_workers", default="auto",
                        choices=["auto", "process", "thread"],
                        help="dataset worker pool kind (auto: threads "
                             "when the native augmentation backend is "
                             "available, else a forked process pool "
                             "like the reference DataLoader workers)")
    parser.add_argument("--mesh_data", type=int, default=None,
                        help="data-parallel mesh size (not ported yet)")
    parser.add_argument("--dcn", default=None, metavar="COORD,N,ID",
                        help="multi-host data parallelism (not ported yet)")
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default; raises without a card) "
                             "or cpu")
    parser.add_argument("--debug", action="store_true", default=False)
    return parser.parse_args(argv)


def load_pretrained_backbone(version: str, path: str):
    """The backbone tree of a reference ImageNet .pth for ``version``
    (reference train.py:174-213, backbone/darknet.py:258-328)."""
    from yolo_tpu_torch.utils import checkpoint as ckpt

    loaders = {
        "yolo_v2": ckpt.load_torch_darknet19,
        "yolo_v3": ckpt.load_torch_darknet53,
        "yolo_v3_spp": ckpt.load_torch_darknet53,
        "tiny_yolo_v3": ckpt.load_torch_darknet_light,
    }
    if version not in loaders:
        raise ValueError(
            f"{version} has no pretrained backbone (reference trains "
            f"slim_yolo_v2 from scratch, train.py:201-205)")
    return loaders[version](path)


def _to_device(a, dev: torch.device):
    """A host batch on ``dev``: from pinned memory without blocking on
    CUDA, so that the copy of batch n+1 queues behind step n."""
    t = torch.as_tensor(a)
    if dev.type != "cuda":
        return t
    return t.pin_memory().to(dev, non_blocking=True)


def train(args=None):
    """-> the trained model."""
    from yolo_tpu_torch.data.loader import BatchLoader, prefetch_iter
    from yolo_tpu_torch.detector import Detector
    from yolo_tpu_torch.eval.voc_eval import VOCEvaluator
    from yolo_tpu_torch.quant.convert import load_params, module_to_params
    from yolo_tpu_torch.quant.dispatch import init_float_model
    from yolo_tpu_torch.train.targets import build_targets
    from yolo_tpu_torch.train.trainer import (TrainConfig, lr_at,
                                              make_train_step,
                                              multi_scale_sizes)
    from yolo_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                 save_checkpoint)
    from yolo_tpu_torch.utils.device import resolve_device
    from yolo_tpu_torch.utils.profiling import MetricsLogger

    args = args or parse_args()
    if args.dcn or args.mesh_data is not None:
        raise NotImplementedError(
            "--mesh_data and --dcn (data-parallel training) come with "
            "parallel/, ROADMAP.md Queue 1 item 5")
    dev = resolve_device(args.device)
    cfg = build_cfg(args)

    save_dir = os.path.join(args.save_folder, args.dataset, args.version)
    os.makedirs(save_dir, exist_ok=True)

    dataset = build_dataset(args, cfg, train=True, u8=not args.f32_input)
    loader = BatchLoader(dataset, args.batch_size,
                         num_workers=args.num_workers,
                         workers=args.loader_workers)
    val_dataset = build_dataset(args, cfg, train=False)
    evaluator = VOCEvaluator(val_dataset, cfg.num_classes, cfg.input_size)

    model = init_float_model(args.version, cfg, dev,
                             generator=torch.Generator().manual_seed(0))
    resume_extra = None
    if args.resume:
        print(f"resuming from {args.resume}")
        params, resume_extra = load_checkpoint(args.resume)
        load_params(model, params)
    elif args.pretrained_backbone:
        load_params(model.backbone, load_pretrained_backbone(
            args.version, args.pretrained_backbone))
        print(f"loaded pretrained backbone {args.pretrained_backbone}")

    tc = TrainConfig(base_lr=args.lr, wp_epoch=args.wp_epoch,
                     max_epoch=args.max_epoch, cos=args.cos,
                     compute_dtype="bfloat16" if args.bf16 else None,
                     fast_pool_cin=args.fast_pool)
    opt, step = make_train_step(model, cfg, tc)
    opt_state = opt.init(model)
    if resume_extra and "opt_state" in resume_extra:
        # the momentum too (the reference loses it, train.py:357-361
        # saves the bare state_dict)
        opt_state.load_state_dict(resume_extra["opt_state"])

    # multi-scale training: a new bucket every 10 iterations (reference
    # train.py:287-294), drawn per epoch so that a resumed run replays
    # it; a step per bucket (the optimizer state is size-independent)
    ms_sizes = multi_scale_sizes() if args.multi_scale else None
    cur_cfg = cfg
    # exact resume: the shuffle order and the augmentation seeds are
    # pure functions of (loader seed, epoch)
    loader.set_epoch(args.start_epoch)
    steps_by_size = {cfg.input_size: step}

    def step_for(c):
        if c.input_size not in steps_by_size:
            steps_by_size[c.input_size] = make_train_step(model, c, tc)[1]
        return steps_by_size[c.input_size]

    metrics_log = MetricsLogger(
        os.path.join(save_dir, "metrics.jsonl"), echo=False)
    detector = None

    epoch_size = max(len(loader), 1)
    best_map = -1.0
    for epoch in range(args.start_epoch, args.max_epoch):
        t_epoch = time.time()
        ms_rng = np.random.default_rng((7, epoch))
        it_counter = itertools.count()

        def prepare(arg, epoch=epoch, ms_rng=ms_rng):
            """Per-iteration host work in the prefetch thread, strictly in
            order (the iteration count and the bucket are sequential
            state): targets, the copy to the device, the resize."""
            nonlocal cur_cfg
            it = next(it_counter)
            images, targets = arg
            if ms_sizes and it % 10 == 0:
                size = ms_sizes[int(ms_rng.integers(len(ms_sizes)))]
                cur_cfg = cfg.with_input_size(size)
            images = _to_device(images, dev)
            step_fn = step
            if ms_sizes:
                images = _resize_batch(images, cur_cfg.input_size)
                step_fn = step_for(cur_cfg)
            lr = lr_at(tc, epoch, it, epoch_size)
            gt = _to_device(build_targets(cur_cfg, targets), dev)
            return it, step_fn, lr, images, gt

        # the epoch generator itself: an early exit (--debug, an
        # exception) closes it, so the loader's workers shut down
        for it, step_fn, lr, images, gt in prefetch_iter(
                iter(loader), prepare, depth=2):
            metrics = step_fn(opt_state, images, gt, lr)
            if it % 10 == 0:
                m = {k: float(v) for k, v in metrics.items()}
                print(f"[Epoch {epoch}][Iter {it}/{epoch_size}]"
                      f"[lr {lr:.6f}] obj {m['conf_loss']:.2f} | "
                      f"cls {m['cls_loss']:.2f} | "
                      f"box {m['txtytwth_loss']:.2f} | "
                      f"total {m['total_loss']:.2f}")
                metrics_log.log(epoch * epoch_size + it, lr=lr, **m)
            if args.debug:
                break

        print(f"epoch {epoch} took {time.time() - t_epoch:.1f}s")

        if (epoch + 1) % args.eval_epoch == 0:
            if detector is None:
                # one detector: its captured graphs read the live weights
                detector = Detector(cfg, model=model, device=dev)
            mean_ap = evaluator.evaluate(detector.detect_fn())
            print(f"[Epoch {epoch}] mAP = {mean_ap:.4f}")
            metrics_log.log((epoch + 1) * epoch_size, mAP=mean_ap)
            best_map = max(best_map, mean_ap)
        if (epoch + 1) % 10 == 0 or epoch + 1 == args.max_epoch:
            path = os.path.join(
                save_dir, f"{args.version}_{epoch + 1}.msgpack")
            save_checkpoint(path, module_to_params(model), extra={
                "epoch": epoch + 1, "opt_state": opt_state.state_dict()})
            print(f"saved {path}")
        if args.debug:
            break
    metrics_log.close()
    return model


if __name__ == "__main__":
    train()
