"""Compression-pipeline entry point (counterpart of
``yolo_tpu/cli/quantize.py``): the reference's conv+bn2conv.py,
retune_bias_quantize.py (with and without -q) and
retune_bias_quantize_findbest.py as stages of one entry point, plus QAT.

    python -m yolo_tpu_torch.cli.quantize bnfold -d synthetic -r ckpt.msgpack
    python -m yolo_tpu_torch.cli.quantize retune -d synthetic -r fused.msgpack
    python -m yolo_tpu_torch.cli.quantize qat    -d synthetic -r fused.msgpack
    python -m yolo_tpu_torch.cli.quantize ptq    -d synthetic -r fused.msgpack
    python -m yolo_tpu_torch.cli.quantize findbest -d synthetic -r fused.msgpack
    python -m yolo_tpu_torch.cli.quantize export -d synthetic -r fused.msgpack \\
        --header weight.h [--artifact slim.pt2 --artifact_input s2d]

Every flag and default is the JAX CLI's, and ``--device`` (default cuda:
it raises without a card; ``--device cpu`` runs the kernels' plain
versions). Checkpoints are either package's (``.msgpack``), or a
reference slim ``.pth``. Without ``-r`` the weights are random from
``torch.Generator().manual_seed(0)`` (the JAX CLI draws from
``PRNGKey(0)``, a stream torch cannot reproduce). ``export --artifact``
writes the port's own artifact (``serving.export``), which
``cli.serve --artifact`` serves.
"""

from __future__ import annotations

import argparse
import contextlib

import numpy as np
import torch

from yolo_tpu_torch.cli.common import add_common_args, build_cfg, build_dataset


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="yolo_tpu_torch "
                                                 "compression")
    parser.add_argument("stage", choices=["bnfold", "retune", "qat",
                                          "ptq", "findbest", "export"])
    add_common_args(parser)
    parser.add_argument("-r", "--resume", required=False, default=None,
                        help="input checkpoint (.msgpack or .pth)")
    parser.add_argument("--out", default=None, help="output checkpoint")
    parser.add_argument("--header", default="weight.h",
                        help="C header path for export")
    parser.add_argument("--artifact", default=None,
                        help="export stage: also write a serialized "
                             "serving artifact (torch.export program "
                             "with weights baked in) to this path")
    parser.add_argument("--artifact_input", default="f32",
                        choices=["f32", "int8", "s2d"],
                        help="input mode the artifact is exported for "
                             "(s2d = the fastest serving layout; the "
                             "mode + quantization exponent are recorded "
                             "in the artifact header for cli.serve "
                             "--artifact)")
    parser.add_argument("--calib_images", type=int, default=1000)
    parser.add_argument("--head_clip", default="auto",
                        help="prediction-head range cap: a float, "
                             "'none', or 'auto' (sweep caps and pick by "
                             "detection agreement; quant/autoclip.py)")
    parser.add_argument("--act_percentile", default="none",
                        help="per-tracker activation clip: a percentile "
                             "float (e.g. 99.9), 'none' (reference "
                             "abs-max), or 'auto' (full config search: "
                             "cap sweep + percentile sweep, "
                             "quant.autoclip.select_quant_config)")
    parser.add_argument("--greedy", type=int, default=0,
                        help="with --act_percentile auto: greedy "
                             "per-tracker refinement rounds (each round "
                             "~n_trackers engine rebuilds)")
    parser.add_argument("--per_channel", action="store_true",
                        default=False,
                        help="per-output-channel weight scales (serving "
                             "opt-in; incompatible with the weight.h "
                             "shift-chain export)")
    parser.add_argument("--weight_bits", type=int, default=8,
                        choices=[4, 5, 6, 8],
                        help="weight bitwidth (sub-8-bit levels are a "
                             "subset of int8, so engines and exports "
                             "are unchanged; pair with --per_channel "
                             "below 6 bits — docs/PARITY.md)")
    parser.add_argument("--batch_size", type=int, default=32)
    parser.add_argument("--lr", type=float, default=None,
                        help="fine-tune LR (default: 1e-7 for retune, "
                             "1e-5 for qat)")
    parser.add_argument("--steps", type=int, default=100)
    parser.add_argument("--eval_every", type=int, default=0,
                        help="retune: eval every N steps and keep the "
                             "best checkpoint (0 = once per dataset "
                             "epoch, like the reference script)")
    parser.add_argument("--no_eval", action="store_true", default=False)
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default; raises without a card) "
                             "or cpu")
    return parser.parse_args(argv)


def _load(args, cfg, batch_norm: bool, dev):
    """The float model of ``-r`` in its tree's form (a ``.msgpack`` of
    either package, or a reference slim ``.pth``), on ``dev``; without
    ``-r`` one in the form ``batch_norm`` names, random from
    ``Generator().manual_seed(0)``."""
    from yolo_tpu_torch.quant.convert import _has_bn, load_params
    from yolo_tpu_torch.quant.dispatch import init_float_model
    from yolo_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                 load_torch_slim_yolo_v2)

    if args.resume is None:
        return init_float_model(args.version, cfg, dev,
                                generator=torch.Generator().manual_seed(0),
                                batch_norm=batch_norm)
    if args.resume.endswith(".pth"):
        params, _ = load_torch_slim_yolo_v2(
            args.resume, fused=args.version.endswith("_q_bf"))
    else:
        params, _ = load_checkpoint(args.resume)
    model = init_float_model(args.version, cfg, dev,
                             batch_norm=_has_bn(params))
    return load_params(model, params)


def _out_path(args, suffix: str) -> str:
    return args.out or (args.resume or "model").replace(
        ".msgpack", "") + suffix


def _calib_batches(args, cfg, dev):
    """Evaluation-transformed images in batches of ``--batch_size`` until
    more than ``--calib_images`` (the JAX CLI's batches), as float32
    tensors on ``dev``, copied there once."""
    dataset = build_dataset(args, cfg, train=False)
    batches, seen = [], 0
    for start in range(0, len(dataset), args.batch_size):
        idx = range(start, min(start + args.batch_size, len(dataset)))
        batch = np.stack([dataset.pull_item(i)[0] for i in idx]).astype(
            np.float32)
        batches.append(torch.from_numpy(batch).to(dev))
        seen += len(batch)
        if seen > args.calib_images:
            break
    return batches


def _maybe_eval(args, cfg, detect_fn, label):
    from yolo_tpu_torch.eval.voc_eval import VOCEvaluator

    if args.no_eval:
        return None
    dataset = build_dataset(args, cfg, train=False)
    ev = VOCEvaluator(dataset, cfg.num_classes, cfg.input_size,
                      batch_size=args.batch_size)
    mean_ap = ev.evaluate(detect_fn)
    print(f"[{label}] mAP = {mean_ap:.4f}")
    return mean_ap


def _train_batches(dataset, args, cfg):
    """Endless (images, targets) batches of ``--batch_size`` from the
    training ``dataset``."""
    from yolo_tpu_torch.data.loader import BatchLoader
    from yolo_tpu_torch.train.targets import build_targets

    loader = BatchLoader(dataset, args.batch_size)
    while True:
        for images, targets in loader:
            yield images, build_targets(cfg, targets)


def _head_clip(value, pick):
    """--head_clip as the pipelines take it: None, a float, or for 'auto'
    ``pick()``'s choice."""
    if value == "none":
        return None
    if value == "auto":
        cap, _ = pick()
        print(f"head_clip auto -> {cap}")
        return cap
    return float(value)


def _example_input(args, cfg, mode, dev):
    """A zero batch of the artifact's input: s2d int8 [B, H/2+3, W/2+3,
    12], int8 or float32 NHWC."""
    h, w = cfg.input_size
    if mode == "s2d":
        return torch.zeros((args.batch_size, h // 2 + 3, w // 2 + 3, 12),
                           dtype=torch.int8, device=dev)
    return torch.zeros((args.batch_size, h, w, 3), device=dev,
                       dtype=torch.int8 if mode == "int8" else torch.float32)


def _save_artifact(args, cfg, m, detect, dev):
    from yolo_tpu_torch.quant.dispatch import input_scale_exponent
    from yolo_tpu_torch.serving.export import save_artifact

    mode = args.artifact_input
    meta = {"version": args.version, "input": mode,
            "sa_in": (None if mode == "f32" else input_scale_exponent(m)),
            "batch": args.batch_size, "input_size": list(cfg.input_size)}
    save_artifact(detect, _example_input(args, cfg, mode, dev),
                  args.artifact, meta=meta)
    print(f"wrote {args.artifact} ({args.version}, batch "
          f"{args.batch_size}, input {mode}; serve via 'python -m "
          f"yolo_tpu_torch.cli.serve --artifact {args.artifact}')")
    return args.artifact


def _export_artifact_generic(args, cfg, dev):
    """The serving artifact of any family through the INT8 dispatch
    (weight.h stays slim-only); its header records the input contract."""
    from yolo_tpu_torch.quant.dispatch import build_int8_detector

    model = _load(args, cfg, True, dev)
    batches = _calib_batches(args, cfg, dev)
    head_clip = args.head_clip
    if head_clip == "none":
        head_clip = None
    elif head_clip != "auto":
        head_clip = float(head_clip)
    m, detect = build_int8_detector(
        args.version, model, cfg, batches, head_clip=head_clip,
        max_images=args.calib_images,
        input_s2d=(args.artifact_input == "s2d"),
        weight_bitwidth=(None if args.weight_bits == 8
                         else args.weight_bits),
        per_channel=args.per_channel, device=dev)
    return _save_artifact(args, cfg, m, detect, dev)


def main(args=None):
    """Run ``args.stage`` -> bnfold, retune, qat: the float model;
    findbest: the tables; ptq, export: the integer model (a generic
    export: the artifact's path)."""
    from yolo_tpu_torch.detector import Detector
    from yolo_tpu_torch.quant.convert import module_to_params
    from yolo_tpu_torch.utils.checkpoint import save_checkpoint
    from yolo_tpu_torch.utils.device import resolve_device

    args = args or parse_args()
    dev = resolve_device(args.device)
    cfg = build_cfg(args)

    if args.stage == "bnfold":
        from yolo_tpu_torch.quant.bn_fold import fold_batch_norm
        fused = fold_batch_norm(_load(args, cfg, True, dev))
        _maybe_eval(args, cfg, Detector(cfg, model=fused, batch_norm=False,
                                        device=dev).detect_fn(), "bnfold")
        out = _out_path(args, "_bnfuse.msgpack")
        save_checkpoint(out, module_to_params(fused))
        print(f"saved {out}")
        return fused

    model = _load(args, cfg, False, dev)
    det = Detector(cfg, model=model, batch_norm=False, device=dev)

    if args.stage == "retune":
        from yolo_tpu_torch.eval.voc_eval import VOCEvaluator
        from yolo_tpu_torch.quant.retune import retune_finetune

        lr = args.lr if args.lr is not None else 1e-7
        dataset = build_dataset(args, cfg, train=True)
        eval_fn, eval_every = None, 0
        if not args.no_eval:
            # per-"epoch" eval + best-checkpoint selection, as the
            # reference script (retune_bias_quantize.py:374-420); one
            # detector, whose captured graphs read the live weights
            val = build_dataset(args, cfg, train=False)
            ev = VOCEvaluator(val, cfg.num_classes, cfg.input_size,
                              batch_size=args.batch_size)
            eval_fn = lambda _m: ev.evaluate(det.detect_fn())  # noqa: E731
            eval_every = args.eval_every or max(
                1, len(dataset) // args.batch_size)
        with contextlib.closing(_train_batches(dataset, args,
                                               cfg)) as batches:
            model, _ = retune_finetune(det, batches, base_lr=lr,
                                       steps=args.steps, eval_fn=eval_fn,
                                       eval_every=eval_every)
        out = _out_path(args, "_retune.msgpack")
        save_checkpoint(out, module_to_params(model))
        print(f"saved {out}")
        return model

    if args.stage == "qat":
        # calibrate the tracker scales on the fake-quant model, then
        # train the float32 masters through it with STE (quant/qat.py:
        # the gradient step the reference's retune -q skips,
        # retune_bias_quantize.py:358-369)
        from yolo_tpu_torch.quant import generic
        from yolo_tpu_torch.quant.autoclip import select_head_clip
        from yolo_tpu_torch.quant.qat import qat_finetune

        calib = _calib_batches(args, cfg, dev)
        head_clip = _head_clip(args.head_clip, lambda: select_head_clip(
            args.version, model, cfg, calib, verbose=True, device=dev))
        wb = None if args.weight_bits == 8 else args.weight_bits
        params_q = generic.fake_quantize_all_convs(
            model, weight_bitwidth=wb, per_channel=args.per_channel)
        states = generic.calibrate_generic(
            params_q, cfg, calib, max_images=args.calib_images,
            head_clip=head_clip)
        lr = args.lr if args.lr is not None else 1e-5  # QAT default
        with contextlib.closing(_train_batches(
                build_dataset(args, cfg, train=True), args,
                cfg)) as batches:
            model, metrics = qat_finetune(det, states, batches, base_lr=lr,
                                          steps=args.steps,
                                          weight_bitwidth=wb,
                                          per_channel=args.per_channel)
        if metrics is not None:
            print("qat final loss:", float(metrics["total_loss"]))
        if not args.no_eval:
            # serve with the frozen states QAT trained against:
            # re-calibrating the tuned weights could move a pow2 exponent
            # off the trained grid
            _, _, detect_q = generic.quantize_detector(
                det, calib, fold_bn=False, max_images=args.calib_images,
                head_clip=head_clip, states=states, weight_bitwidth=wb,
                per_channel=args.per_channel)
            _maybe_eval(args, cfg, detect_q, "qat-int8sim")
        out = _out_path(args, "_qat.msgpack")
        save_checkpoint(out, module_to_params(model))
        print(f"saved {out}")
        return model

    if args.stage == "export" and args.version not in (
            "slim_yolo_v2", "slim_yolo_v2_q_bf"):
        # the family-generic artifact (weight.h is the reference C
        # engine's slim-only contract)
        if not args.artifact:
            raise SystemExit(
                f"export -v {args.version}: pass --artifact PATH (the "
                f"weight.h header export is slim-only)")
        return _export_artifact_generic(args, cfg, dev)

    # ptq / findbest / export share the calibration pipeline
    from yolo_tpu_torch.quant.autoclip import (select_head_clip,
                                               select_quant_config)
    from yolo_tpu_torch.quant.int8_graph import (make_int8_detect_fn,
                                                 quantize_pipeline)
    from yolo_tpu_torch.quant.retune import export_c_header, export_tables

    batches = _calib_batches(args, cfg, dev)
    states = None
    if args.act_percentile == "auto":
        # the full search: cap sweep + per-tracker percentile sweep (+
        # greedy refinement) by detection agreement
        best, _ = select_quant_config(args.version, model, cfg, batches,
                                      greedy_rounds=args.greedy,
                                      verbose=True, device=dev)
        print(f"config search -> head_clip {best['head_clip']}, "
              f"act_percentile {best['act_percentile']}, agreement "
              f"{best['score']:.4f}")
        states, head_clip, act_pct = best["states"], None, None
    else:
        act_pct = (None if args.act_percentile == "none"
                   else float(args.act_percentile))
        head_clip = _head_clip(args.head_clip, lambda: select_head_clip(
            args.version, model, cfg, batches, verbose=True, device=dev))
    m = quantize_pipeline(model, cfg, batches, fold_bn=False,
                          max_images=args.calib_images, head_clip=head_clip,
                          states=states, act_percentile=act_pct,
                          weight_bitwidth=(None if args.weight_bits == 8
                                           else args.weight_bits),
                          per_channel=args.per_channel)
    if args.per_channel:
        # a per-channel sw has no one-scale-per-layer table; the weight.h
        # contract stays per tensor
        if args.stage == "export":
            raise SystemExit(
                "--per_channel engines cannot export to weight.h (one "
                "scale_w per layer, c_embedding/yolo_forward.c:32); "
                "drop --per_channel for embedded export or use "
                "--artifact via a non-per-channel build")
        tables = {"scale_b": m.sb, "scale_a": m.sa, "retune": m.retune}
        print("scale_w: per-channel (int8 serving engine)")
    else:
        tables = export_tables(m)
        print("scale_w:", tables["scale_w"])
    print("scale_b:", tables["scale_b"])
    print("scale_a:", tables["scale_a"])
    print("retune :", tables["retune"])

    if args.stage == "findbest":
        return tables

    if args.stage == "export":
        export_c_header(m, args.header)
        print(f"wrote {args.header}")
        if args.artifact:
            _save_artifact(args, cfg, m, make_int8_detect_fn(
                m, cfg, input_s2d=(args.artifact_input == "s2d"),
                device=dev), dev)
        return m

    # ptq: evaluate the integer model, save its weights and tables
    _maybe_eval(args, cfg, make_int8_detect_fn(m, cfg, device=dev),
                "ptq-int8")
    out = _out_path(args, "_retune_quantize.msgpack")
    if args.per_channel:
        saved_tables = {name: {k: np.asarray(v) for k, v in t.items()}
                        for name, t in (("scale_w", m.sw), ("scale_b", m.sb),
                                        ("scale_a", m.sa),
                                        ("retune", m.retune))}
    else:
        saved_tables = {k: np.asarray(v) for k, v in tables.items()}
    save_checkpoint(out, {
        "w_q": {k: v.cpu().numpy() for k, v in m.w_q.items()},
        "b_q": {k: v.cpu().numpy() for k, v in m.b_q.items()},
        "tables": saved_tables})
    print(f"saved {out}")
    return m


if __name__ == "__main__":
    main()
