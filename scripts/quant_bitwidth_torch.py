"""Sub-8-bit weight quantization study of the PyTorch / CUDA port
(counterpart of ``scripts/quant_bitwidth.py``; the reference is
INT8-only, retune_bias_quantize.py:73-86 hardcodes num_bits=8).

Weights are quantized at 8/6/5/4 bits (pow2 per-tensor scales);
activations and bias stay int8, so the integer engines, export formats
and shift semantics are untouched: b-bit levels are a subset of int8,
only the per-layer sw exponents move. Each width gets its own
calibration and retune search on the b-bit weights and is served through
the integer engine with the autoclip head cap; mAP is reported with a
paired bootstrap 95% CI against the first width's engine.

``--per_channel`` also measures every width with per-output-channel pow2
weight scales (the serving opt-in whose requant is a per-column epilogue
shift). ``--qat_steps`` also fine-tunes each width against its exact
serving grid and scores the re-quantized engine.

Runs on ``--device`` (default ``cuda``, raising without a card;
``--device cpu`` runs the kernels' plain versions), the engines through
the card's INT8 kernels as serving runs them. The checkpoint is
``scripts/quant_parity_torch.py``'s (either package's loads).

On the card, on that script's deployment checkpoint:
    python3 scripts/quant_bitwidth_torch.py --size 416 --hard \\
        --per_channel --val 2048 \\
        --ckpt $TMPDIR/quant_parity_torch_slim_416_hard.msgpack
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from quant_parity_torch import (add_device_arg, calib_batches,  # noqa: E402
                                device_feed, int8_engine, qat_engine,
                                synthetic_sets, temp_path)
from yolo_tpu_torch.config import get_config  # noqa: E402
from yolo_tpu_torch.eval.voc_eval import (VOCEvaluator,  # noqa: E402
                                          bootstrap_delta_ci)
from yolo_tpu_torch.utils.device import resolve_device  # noqa: E402


def _plain(v):
    """A table entry as JSON takes it: an int, or a per-channel list."""
    if isinstance(v, torch.Tensor):
        v = v.cpu().numpy()
    return np.asarray(v).tolist() if np.ndim(v) else int(v)


def weight_variant(model, cfg, calib, cap, bits: int, per_channel: bool,
                   device):
    """slim's integer engine with ``bits``-bit weights (per tensor, or
    ``per_channel``) at head cap ``cap`` -> (its name, the Int8Model, the
    detect fn, max |w_q|); asserts that every weight fits ``bits``."""
    m, detect = int8_engine(model, cfg, calib, device, head_clip=cap,
                            weight_bitwidth=bits, per_channel=per_channel)
    name = f"w{bits}a8" + ("/pc" if per_channel else "")
    wmax = max(int(w.to(torch.int32).abs().max()) for w in m.w_q.values())
    assert wmax <= 2 ** (bits - 1) - 1, (bits, wmax)
    return name, m, detect, wmax


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--val", type=int, default=1024)
    ap.add_argument("--bits", type=int, nargs="+", default=[8, 6, 5, 4])
    ap.add_argument("--per_channel", action="store_true",
                    help="also measure per-output-channel weight scales "
                         "at every width (the serving opt-in)")
    ap.add_argument("--hard", action="store_true",
                    help="crowded/small-object synthetic regime (must "
                         "match the checkpoint's training regime)")
    ap.add_argument("--ckpt",
                    default=temp_path("quant_parity_torch_params.msgpack"))
    ap.add_argument("--n_boot", type=int, default=300)
    ap.add_argument("--qat_steps", type=int, default=0,
                    help="additionally QAT-fine-tune each width against "
                         "its exact serving grid (weight_bitwidth + "
                         "per_channel threaded into the STE forward) "
                         "and measure the re-quantized engine")
    ap.add_argument("--qat_lr", type=float, default=1e-6)
    ap.add_argument("--train_images", type=int, default=128,
                    help="QAT feed size (must match the checkpoint's "
                         "training set for the synthetic regime)")
    ap.add_argument("--out", default=None,
                    help="write the result table to this JSON path")
    add_device_arg(ap)
    args = ap.parse_args(argv)

    from yolo_tpu_torch.quant.autoclip import select_head_clip
    from yolo_tpu_torch.quant.convert import load_params
    from yolo_tpu_torch.quant.dispatch import init_float_model
    from yolo_tpu_torch.utils.checkpoint import load_checkpoint

    dev = resolve_device(args.device)
    size = args.size
    cfg = get_config("slim_yolo_v2", "mask", input_size=(size, size),
                     conf_thresh=0.01)
    if not os.path.exists(args.ckpt):
        raise SystemExit(
            f"{args.ckpt} not found — train one first via "
            f"scripts/quant_parity_torch.py (it caches its checkpoint "
            f"there)")
    train_ds, val_ds = synthetic_sets(size, args.hard, args.train_images,
                                      args.val)
    model = init_float_model("slim_yolo_v2", cfg, dev)
    load_params(model, load_checkpoint(args.ckpt)[0])
    evaluator = VOCEvaluator(val_ds, 2, (size, size), batch_size=64,
                             cache_device=True)
    calib = calib_batches(train_ds, dev, num_workers=0)

    cap, _ = select_head_clip("slim_yolo_v2", model, cfg, calib,
                              device=dev)
    print(f"autoclip head cap: {cap}")

    feed = None
    if args.qat_steps > 0:
        from yolo_tpu_torch.quant import qsim
        from yolo_tpu_torch.quant.bn_fold import fold_batch_norm

        feed = device_feed(cfg, train_ds, 16, dev)
        fused = fold_batch_norm(model)

    results, raw, tables = {}, {}, {}
    variants = [(bits, False) for bits in args.bits]
    if args.per_channel:
        variants += [(bits, True) for bits in args.bits]
    for bits, pc in variants:
        t0 = time.perf_counter()
        name, m, detect, wmax = weight_variant(model, cfg, calib, cap, bits,
                                               pc, dev)
        results[name] = evaluator.evaluate(detect)
        raw[name] = evaluator.raw
        tables[name] = {"sw": {k: _plain(v) for k, v in m.sw.items()},
                        "retune": {k: int(v) for k, v in m.retune.items()}}
        print(f"  [{name}] mAP = {results[name]:.4f} "
              f"(max |w_q| = {wmax}; {time.perf_counter() - t0:.1f}s)",
              flush=True)

        if args.qat_steps > 0:
            # QAT against the EXACT serving grid of this variant: weight
            # STE at (bits, per_channel), activation taps on the frozen
            # states calibrated at this width, then the integer engine
            # rebuilt from the tuned masters on the SAME states
            t0 = time.perf_counter()
            params_qw = qsim.fake_quantize_params(
                fused, weight_bitwidth=bits, per_channel=pc)
            st = qsim.calibrate(params_qw, cfg, calib, head_clip=cap)
            _, detect_q = qat_engine(fused, cfg, calib, dev, st, feed,
                                     args.qat_lr, args.qat_steps,
                                     weight_bitwidth=bits, per_channel=pc)
            qname = name + "+qat"
            results[qname] = evaluator.evaluate(detect_q)
            raw[qname] = evaluator.raw
            print(f"  [{qname}] mAP = {results[qname]:.4f} "
                  f"({args.qat_steps} steps; "
                  f"{time.perf_counter() - t0:.1f}s)", flush=True)

    base = f"w{args.bits[0]}a8"
    _, gts = raw[base]
    print(f"\n=== weight-bitwidth sweep (slim, {args.val} val images, "
          f"vs {base}, paired bootstrap 95% CI) ===")
    ci_rows = {}
    for name, v in results.items():
        if name == base:
            print(f"{name:>8}: {v:.4f}")
            continue
        d, lo, hi = bootstrap_delta_ci(raw[name][0], raw[base][0], gts,
                                       n_boot=args.n_boot)
        ci_rows[name] = (d * 100, lo * 100, hi * 100)
        print(f"{name:>10}: {v:.4f}  delta {d * 100:+.2f} pts  "
              f"[{lo * 100:+.2f}, {hi * 100:+.2f}]")
    # the per-channel and QAT recovery claims get their own paired
    # intervals
    pairs = [(f"w{bits}a8/pc", f"w{bits}a8",
              f"per-channel vs per-tensor @w{bits}")
             for bits in args.bits]
    pairs += [(n + "+qat", n, f"QAT vs PTQ @{n}")
              for n in list(results) if not n.endswith("+qat")]
    for a, b, label in pairs:
        if a in raw and b in raw:
            d, lo, hi = bootstrap_delta_ci(raw[a][0], raw[b][0], gts,
                                           n_boot=args.n_boot)
            ci_rows[f"{a}_vs_{b}"] = (d * 100, lo * 100, hi * 100)
            print(f"{label}: {d * 100:+.2f} "
                  f"pts  [{lo * 100:+.2f}, {hi * 100:+.2f}]")
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"map": results, "delta_ci_pts_vs_w8": ci_rows,
                       "head_clip": cap, "val_images": args.val,
                       "input_size": size, "hard": args.hard,
                       "sw_tables": tables}, f, indent=1)
        print(f"wrote {args.out}")
    return results


if __name__ == "__main__":
    main()
