"""mAP-delta quantization parity of the PyTorch / CUDA port for the v3
family and yolo_v2 (counterpart of ``scripts/quant_parity_v3.py``).

The harness of ``scripts/quant_parity_torch.py`` for tiny_yolo_v3,
yolo_v2, yolo_v3 and yolo_v3_spp: train on the synthetic set, then
measure mAP at

  FP32 -> fake-quant INT8 (PTQ sim) -> true-integer INT8 engine
  (+ the clip search and QAT vs PTQ, served on QAT's frozen states)

under the JAX script's stage names and in its order, each delta with a
PAIRED bootstrap 95% CI over the val split. Runs on ``--device`` (default
``cuda``, raising without a card; ``--device cpu`` runs the kernels'
plain versions), the integer engines through the card's INT8 kernels as
serving runs them. Weights from ``torch.Generator().manual_seed(0)``;
the checkpoint and the results JSON go under ``tempfile.gettempdir()``
as ``quant_parity_torch_<version>_<size>[_hard].msgpack`` and
``quant_parity_torch_<version>_<size>[_hard]_results.json``.

Deployment recipe, on the card:
    python3 scripts/quant_parity_v3_torch.py -v yolo_v3 --size 416 --hard \\
        --train_images 512 --val 2048 --epochs 150 --n_boot 1000
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from quant_parity_torch import (Stages, add_device_arg,  # noqa: E402
                                calib_batches, device_feed, first_with,
                                float_model, stage_table, synthetic_sets,
                                temp_path, write_results)
from yolo_tpu_torch.config import get_config  # noqa: E402
from yolo_tpu_torch.detector import Detector  # noqa: E402
from yolo_tpu_torch.eval.voc_eval import VOCEvaluator  # noqa: E402
from yolo_tpu_torch.utils.device import resolve_device  # noqa: E402


def build_integer(version, model, cfg, calib, head_clip=None,
                  fold_bn=True, states=None, device="cuda"):
    """(Int8 model, detect fn on ``device``) for any family, optionally on
    frozen tracker states (the QAT serving path)."""
    kw = dict(head_clip=head_clip, fold_bn=fold_bn, states=states)
    if version == "tiny_yolo_v3":
        from yolo_tpu_torch.quant.int8_models import (
            make_int8_tiny_detect_fn, quantize_pipeline_tiny)
        m = quantize_pipeline_tiny(model, cfg, calib, **kw)
        return m, make_int8_tiny_detect_fn(m, cfg, device=device)
    if version == "yolo_v2":
        from yolo_tpu_torch.quant.int8_models import (
            make_int8_yolo_v2_detect_fn, quantize_pipeline_yolo_v2)
        m = quantize_pipeline_yolo_v2(model, cfg, calib, **kw)
        return m, make_int8_yolo_v2_detect_fn(m, cfg, device=device)
    from yolo_tpu_torch.quant.int8_yolo_v3 import (
        make_int8_yolo_v3_detect_fn, quantize_pipeline_yolo_v3)
    m = quantize_pipeline_yolo_v3(model, cfg, calib,
                                  spp=version.endswith("_spp"), **kw)
    return m, make_int8_yolo_v3_detect_fn(m, cfg, device=device)


def main(version: str = "tiny_yolo_v3", epochs: int = 150, size: int = 64,
         batch: int = 16, val_images: int = 512, qat_steps: int = 300,
         qat_lr: float = 1e-6, skip_train: bool = False,
         n_boot: int = 300, hard: bool = False, train_images: int = 128,
         greedy: int = 0, lr: float = None, device: str = "cuda"):
    from yolo_tpu_torch.quant.autoclip import select_quant_config
    from yolo_tpu_torch.quant.generic import quantize_detector

    dev = resolve_device(device)
    suffix = f"{size}{'_hard' if hard else ''}"
    ckpt = temp_path(f"quant_parity_torch_{version}_{suffix}.msgpack")
    cfg = get_config(version, "mask", input_size=(size, size),
                     conf_thresh=0.01)
    train_ds, val_ds = synthetic_sets(size, hard, train_images, val_images)
    model, train_s = float_model(version, cfg, dev, ckpt, skip_train,
                                 train_ds, batch, epochs, lr)

    stages = Stages(VOCEvaluator(val_ds, 2, (size, size), batch_size=64,
                                 cache_device=True), train_s)
    det = Detector(cfg, model=model, device=dev)
    stages.run("fp32", det.detect_fn())
    calib = calib_batches(train_ds, dev)

    # the fake-quant float sim via the generic model-agnostic PTQ
    _, _, fq_detect = quantize_detector(det, calib)
    stages.run("int8_fakequant", fq_detect)

    # the true integer engine: plain, hand-picked head clip, autoclip
    stages.run("int8_integer",
               build_integer(version, model, cfg, calib, device=dev)[1])
    stages.run("int8_headclip",
               build_integer(version, model, cfg, calib, head_clip=16.0,
                             device=dev)[1])

    # the PTQ config search: head-cap sweep, per-tracker percentile
    # sweep, optional greedy refinement (tiny's sim loss lives in the
    # backbone tracker grids the head cap cannot reach)
    best_cfg, cfg_info = select_quant_config(version, model, cfg, calib,
                                             greedy_rounds=greedy,
                                             verbose=True, device=dev)
    stages.lap("autoclip search")
    auto_cap = best_cfg["head_clip"]
    stages.run(f"int8_autoclip[{auto_cap}]",
               build_integer(version, model, cfg, calib, head_clip=auto_cap,
                             device=dev)[1])
    stages.run(f"int8_ptclip[p={best_cfg['act_percentile']}]",
               build_integer(version, model, cfg, calib,
                             states=best_cfg["states"], device=dev)[1])

    # ---- QAT: fine-tune against the frozen grid, serve the integer
    # engine on the SAME frozen states, the searched per-tracker ones
    if qat_steps > 0:
        from yolo_tpu_torch.quant.bn_fold import fold_batch_norm
        from yolo_tpu_torch.quant.qat import qat_finetune

        states = best_cfg["states"]
        det_f = Detector(cfg, model=fold_batch_norm(model), batch_norm=False,
                         device=dev)
        feed = device_feed(cfg, train_ds, batch, dev)
        tuned, _ = qat_finetune(det_f, states, feed(), base_lr=qat_lr,
                                steps=qat_steps)
        stages.lap(f"qat: {qat_steps} steps")
        stages.run("int8_qat[ptclip]",
                   build_integer(version, tuned, cfg, calib, fold_bn=False,
                                 states=states, device=dev)[1])

    results = stages.results
    pairs = [("qat_vs_ptq_ptclip", "int8_qat[ptclip]",
              first_with(results, "int8_ptclip"),
              "QAT vs PTQ (ptclip states, paired)")]
    ci_rows, best_k = stage_table(
        stages, n_boot, pairs,
        f"\n=== {version} mAP by stage @{size}x{size} input, "
        f"{'hard' if hard else 'easy'} synthetic (vs fp32, paired "
        f"bootstrap 95% CI, {val_images} val images) ===")
    delta = (results["fp32"] - results[best_k]) * 100
    ci = ci_rows[best_k]
    print(f"\nbest int8 integer engine = {best_k}: delta {delta:.2f} mAP"
          f" points, 95% CI [{-ci[2]:.2f}, {-ci[1]:.2f}] "
          f"({'PASS' if delta < 0.5 else 'CHECK'} vs the <=0.5 target)")
    write_results(
        temp_path(f"quant_parity_torch_{version}_{suffix}_results.json"),
        stages, ci_rows, val_images, epochs, size, hard, train_images,
        best_cfg, cfg_info)
    return results


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("-v", "--version", default="tiny_yolo_v3",
                   choices=["tiny_yolo_v3", "yolo_v2", "yolo_v3",
                            "yolo_v3_spp"])
    p.add_argument("--epochs", type=int, default=150)
    p.add_argument("--size", type=int, default=64,
                   help="input size; acceptance runs use deployment "
                        "resolution (416), the 64 default is the fast "
                        "smoke configuration")
    p.add_argument("--val", type=int, default=512)
    p.add_argument("--train_images", type=int, default=128)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--hard", action="store_true", default=False,
                   help="crowded/small-object synthetic regime")
    p.add_argument("--qat_steps", type=int, default=300)
    p.add_argument("--qat_lr", type=float, default=1e-6,
                   help="QAT LR (1e-6 measured best on slim; 1e-5 "
                        "degrades, docs/PARITY.md)")
    p.add_argument("--lr", type=float, default=None,
                   help="training LR (default: 1e-3 up to 128^2, "
                        "2.5e-4 above — the summed-over-anchors loss "
                        "scales with grid area)")
    p.add_argument("--n_boot", type=int, default=300)
    p.add_argument("--greedy", type=int, default=0,
                   help="greedy per-tracker refinement rounds in the "
                        "PTQ config search (each round ~n_trackers "
                        "engine rebuilds)")
    p.add_argument("--skip_train", action="store_true")
    add_device_arg(p)
    args = p.parse_args()
    main(args.version, epochs=args.epochs, size=args.size,
         batch=args.batch, val_images=args.val, qat_steps=args.qat_steps,
         qat_lr=args.qat_lr, n_boot=args.n_boot,
         skip_train=args.skip_train, hard=args.hard,
         train_images=args.train_images, greedy=args.greedy,
         lr=args.lr, device=args.device)
