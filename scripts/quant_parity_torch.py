"""End-to-end quantization parity check of the PyTorch / CUDA port
(counterpart of ``scripts/quant_parity.py``, the BASELINE.md north star).

Trains slim_yolo_v2 on the synthetic detection set with the port's
trainer, then measures mAP at every compression stage, under the JAX
script's stage names and in its order:

  FP32 -> BN-fused -> fake-quant INT8 (PTQ sim) -> integer INT8 engine
  (+ the clip search, per-channel weight scales and QAT vs PTQ)

and reports each stage's delta against FP32 with a PAIRED bootstrap 95%
CI over the val split; the best integer engine must land less than 0.5
mAP points below this run's own FP32 (the reference's acceptance bar,
retune_bias_quantize.py:402).

Everything runs on ``--device`` (default ``cuda``; it raises without a
card, and ``--device cpu`` runs the kernels' plain versions): training on
cuDNN, the fake-quant sims, and the integer engines through the card's
INT8 kernels, each detect fn captured in a CUDA graph per input shape as
serving runs it. The weights are drawn from ``torch.Generator()
.manual_seed(0)`` (the JAX script draws from ``PRNGKey(0)``, a stream
torch cannot reproduce), so a run is compared with the JAX figures
statistically, not bit for bit. Checkpoints of either package load with
``--skip_train``. The checkpoint and the results JSON go under
``tempfile.gettempdir()`` as ``quant_parity_torch_slim_<size>[_hard]
.msgpack`` and ``quant_parity_torch_results_<size>[_hard].json``.

Deployment recipe, on the card:
    python3 scripts/quant_parity_torch.py --size 416 --hard \\
        --train_images 512 --val 2048 --epochs 150
On the CPU at smoke size:
    python3 scripts/quant_parity_torch.py --device cpu --size 64 \\
        --train_images 16 --val 16 --epochs 1 --qat_steps 2 --n_boot 20

``scripts/quant_parity_v3_torch.py`` and ``scripts/quant_bitwidth_torch.py``
import their shared pieces from here.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from yolo_tpu_torch.config import get_config  # noqa: E402
from yolo_tpu_torch.data import (BaseTransform, BatchLoader,  # noqa: E402
                                 SyntheticDetection)
from yolo_tpu_torch.detector import Detector  # noqa: E402
from yolo_tpu_torch.eval.voc_eval import (VOCEvaluator,  # noqa: E402
                                          bootstrap_delta_ci)
from yolo_tpu_torch.quant import qsim  # noqa: E402
from yolo_tpu_torch.quant.bn_fold import fold_batch_norm  # noqa: E402
from yolo_tpu_torch.quant.int8_graph import (  # noqa: E402
    make_int8_detect_fn, quantize_pipeline)
from yolo_tpu_torch.utils.device import resolve_device  # noqa: E402


# ---------------------------------------------------------------------------
# Pieces the three accuracy scripts share.
# ---------------------------------------------------------------------------


def temp_path(name: str) -> str:
    """``name`` under the system's temporary directory."""
    return os.path.join(tempfile.gettempdir(), name)


def synthetic_sets(size: int, hard: bool, train_images: int,
                   val_images: int):
    """(train, val) synthetic sets at ``size``², two classes, the plain
    eval transform (the classes are color-coded, so photometric
    augmentation would erase them; the hard regime bakes its own jitter
    into the generator); val from seed 99."""
    train_ds = SyntheticDetection((size, size), num_classes=2,
                                  length=train_images, hard=hard,
                                  transform=BaseTransform((size, size)))
    val_ds = SyntheticDetection((size, size), num_classes=2,
                                length=val_images, hard=hard,
                                transform=BaseTransform((size, size)),
                                seed=99)
    return train_ds, val_ds


def calib_batches(train_ds, device, n: int = 8, batch: int = 16,
                  num_workers: int = 4):
    """The first ``n`` unshuffled training batches of ``batch`` images,
    as float32 tensors on ``device``, copied there once: the config
    search scores dozens of engine builds on them."""
    loader = BatchLoader(train_ds, batch, shuffle=False,
                         num_workers=num_workers)
    return [torch.from_numpy(np.asarray(images, np.float32)).to(device)
            for images, _ in list(loader)[:n]]


def device_feed(cfg, train_ds, batch: int, device):
    """The QAT feed: every training sample and its target rows held on
    ``device`` once; ``feed(seed=1)`` then yields (images, targets) of
    ``batch`` indices drawn with replacement by
    ``numpy.default_rng(seed).integers``, moving only the indices."""
    from yolo_tpu_torch.train.targets import build_targets

    imgs, tgts = [], []
    for i in range(len(train_ds)):
        img, target, _, _ = train_ds.pull_item(i)
        imgs.append(np.asarray(img, np.float32))
        tgts.append(np.asarray(target).reshape(-1, 5))
    X = torch.from_numpy(np.stack(imgs)).to(device)
    G = torch.from_numpy(np.asarray(build_targets(cfg, tgts),
                                    np.float32)).to(device)

    def feed(seed: int = 1):
        rng = np.random.default_rng(seed)
        n = X.shape[0]
        while True:
            idx = torch.from_numpy(rng.integers(0, n, batch)).to(device)
            yield X[idx], G[idx]

    return feed


def float_model(version: str, cfg, device: torch.device, ckpt: str,
                skip_train: bool, train_ds, batch: int, epochs: int,
                lr=None):
    """The BN-form float model of ``version`` on ``device``: loaded from
    ``ckpt`` with ``skip_train`` where it exists (either package's
    checkpoint), else drawn from ``Generator().manual_seed(0)``, trained
    on ``train_ds`` held on the device (``train_device_resident``) and
    saved to ``ckpt``. -> (model, training seconds or None)."""
    from yolo_tpu_torch.quant.convert import load_params, module_to_params
    from yolo_tpu_torch.quant.dispatch import init_float_model
    from yolo_tpu_torch.train.trainer import (TrainConfig,
                                              train_device_resident)
    from yolo_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                 save_checkpoint)

    model = init_float_model(version, cfg, device,
                             generator=torch.Generator().manual_seed(0))
    if skip_train and os.path.exists(ckpt):
        load_params(model, load_checkpoint(ckpt)[0])
        print(f"loaded {ckpt}")
        return model, None
    if lr is None:
        # the conf loss sums over anchors, so its gradient scales with
        # the grid's area; 1e-3 is the stable 64² setting
        lr = 1e-3 if cfg.input_size[0] <= 128 else 2.5e-4
    tc = TrainConfig(base_lr=lr, wp_epoch=max(2, epochs // 30), cos=True,
                     max_epoch=epochs)
    t0 = time.perf_counter()
    train_device_resident(model, cfg, tc, train_ds, batch)
    if device.type == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    print(f"trained {epochs} epochs in {seconds:.1f}s", flush=True)
    save_checkpoint(ckpt, module_to_params(model))
    return model, seconds


class Stages:
    """Scores stages on one evaluator: ``run(name, detect)`` evaluates a
    detect fn and keeps its mAP, its raw detections (for the paired
    bootstrap) and the wall seconds since the last stage ended (its
    build included); ``train_seconds``, where the model was trained,
    heads the seconds."""

    def __init__(self, evaluator, train_seconds=None):
        self.evaluator = evaluator
        self.results, self.raw, self.seconds = {}, {}, {}
        if train_seconds is not None:
            self.seconds["train"] = train_seconds
        self.mark = time.perf_counter()

    def run(self, name: str, detect) -> float:
        self.results[name] = self.evaluator.evaluate(detect)
        self.raw[name] = self.evaluator.raw
        now = time.perf_counter()
        self.seconds[name] = now - self.mark
        self.mark = now
        print(f"  [{name}] mAP = {self.results[name]:.4f} "
              f"({self.seconds[name]:.1f}s)", flush=True)
        return self.results[name]

    def lap(self, what: str) -> float:
        """Seconds since the last stage or lap (a search, a fine-tune),
        printed and taken out of the next stage's."""
        now = time.perf_counter()
        s, self.mark = now - self.mark, now
        self.seconds[what] = s
        print(f"  {what}: {s:.1f}s", flush=True)
        return s


def stage_table(stages: Stages, n_boot: int, pairs, label: str):
    """Print ``label`` and the paired bootstrap table against fp32, then
    each (tag, a, b, text) of ``pairs`` whose stages ran as its own pair
    -> ({row: (delta, lo, hi)} in points, the best integer engine's
    name)."""
    results, raw = stages.results, stages.raw
    print(label)
    _, gts = raw["fp32"]
    ci_rows = {}
    for k, v in results.items():
        if k == "fp32":
            print(f"{k:>22}: {v:.4f}")
            continue
        d, lo, hi = bootstrap_delta_ci(raw[k][0], raw["fp32"][0], gts,
                                       n_boot=n_boot)
        ci_rows[k] = (d * 100, lo * 100, hi * 100)
        print(f"{k:>22}: {v:.4f}  delta {d * 100:+.2f} pts  "
              f"[{lo * 100:+.2f}, {hi * 100:+.2f}]")
    # a QAT-vs-PTQ claim gets its own paired interval (the fp32-relative
    # CIs cannot support it: that is a different pair)
    for tag, a, b, text in pairs:
        if a in results and b is not None:
            d, lo, hi = bootstrap_delta_ci(raw[a][0], raw[b][0], gts,
                                           n_boot=n_boot)
            ci_rows[tag] = (d * 100, lo * 100, hi * 100)
            print(f"\n{text}: {d * 100:+.2f} pts  [{lo * 100:+.2f}, "
                  f"{hi * 100:+.2f}]")
    best_k = max((k for k in results if k.startswith("int8_")
                  and "fakequant" not in k), key=lambda k: results[k])
    return ci_rows, best_k


def first_with(results, prefix: str):
    return next((k for k in results if k.startswith(prefix)), None)


def write_results(path: str, stages: Stages, ci_rows, val_images, epochs,
                  size, hard, train_images, best_cfg, cfg_info) -> None:
    """The JAX scripts' results JSON (their keys and nesting)."""
    with open(path, "w") as f:
        json.dump({"map": stages.results, "delta_ci_pts": ci_rows,
                   "val_images": val_images, "epochs": epochs,
                   "input_size": size, "hard": hard,
                   "train_images": train_images,
                   "ptq_search": {
                       "head_clip": best_cfg["head_clip"],
                       "act_percentile": best_cfg["act_percentile"],
                       "agreement": best_cfg["score"],
                       "cap_scores": {str(k): v for k, v in
                                      cfg_info["cap_scores"].items()},
                       "pct_scores": {str(k): v for k, v in
                                      cfg_info["pct_scores"].items()},
                       "greedy_flips": [
                           [r, str(k), s]
                           for r, k, s in cfg_info["greedy_flips"]]}},
                  f, indent=1)
    print(f"wrote {path}")
    print("seconds by stage:", json.dumps(
        {k: round(v, 3) for k, v in stages.seconds.items()}), flush=True)


# ---------------------------------------------------------------------------
# slim_yolo_v2's stages.
# ---------------------------------------------------------------------------


def float_stages(model, cfg, calib, device):
    """The float stages of ``model`` (BN form) in the JAX script's order,
    each (name, detect fn) built as it is reached: fp32, bn_fused, the
    fake-quant sim (``int8_fakequant``) and its two halves
    (``weights_only_q``, ``acts_only_q``). The sim's tracker states are
    calibrated on ``calib``."""
    yield "fp32", Detector(cfg, model=model, device=device).detect_fn()
    fused = fold_batch_norm(model)
    yield "bn_fused", Detector(cfg, model=fused, batch_norm=False,
                               device=device).detect_fn()
    params_q = qsim.fake_quantize_params(fused)
    states = qsim.calibrate(params_q, cfg, calib)
    yield "int8_fakequant", Detector(
        cfg, model=qsim.make_quant_module(params_q, states),
        batch_norm=False, device=device).detect_fn()
    # isolate weight-quant from activation-quant damage
    yield "weights_only_q", Detector(cfg, model=params_q, batch_norm=False,
                                     device=device).detect_fn()
    yield "acts_only_q", Detector(
        cfg, model=qsim.make_quant_module(fused, states),
        batch_norm=False, device=device).detect_fn()


def int8_engine(model, cfg, calib, device, **pipeline_kw):
    """``quantize_pipeline(model, cfg, calib, **pipeline_kw)`` served on
    ``device`` (NHWC float input, as the JAX script serves it) ->
    (Int8Model, detect fn)."""
    m = quantize_pipeline(model, cfg, calib, **pipeline_kw)
    return m, make_int8_detect_fn(m, cfg, device=device)


def qat_engine(fused, cfg, calib, device, st, feed, qat_lr, qat_steps,
               **weights_kw):
    """QAT of a copy of the BN-folded ``fused`` against the frozen tracker
    states ``st`` (a slim name dict) on ``feed(seed=1)``, then the integer
    engine rebuilt from the tuned masters on the same states ->
    (Int8Model, detect fn). ``weights_kw``: the weight grid
    (``weight_bitwidth``, ``per_channel``) of both."""
    from yolo_tpu_torch.quant.qat import qat_finetune, states_from_qsim

    det_q = Detector(cfg, model=copy.deepcopy(fused), batch_norm=False,
                     device=device)
    tuned, _ = qat_finetune(det_q, states_from_qsim(st), feed(),
                            base_lr=qat_lr, steps=qat_steps, **weights_kw)
    return int8_engine(tuned, cfg, calib, device, fold_bn=False, states=st,
                       **weights_kw)


def main(epochs: int = 150, size: int = 64, batch: int = 16,
         val_images: int = 512, qat_steps: int = 300,
         qat_lr: float = 1e-6,
         ckpt: str = None,
         skip_train: bool = False, n_boot: int = 300,
         hard: bool = False, train_images: int = 128,
         greedy: int = 0, lr: float = None, train_only: bool = False,
         device: str = "cuda"):
    from yolo_tpu_torch.quant.autoclip import select_quant_config

    dev = resolve_device(device)
    suffix = f"{size}{'_hard' if hard else ''}"
    if ckpt is None:
        ckpt = temp_path(f"quant_parity_torch_slim_{suffix}.msgpack")
    cfg = get_config("slim_yolo_v2", "mask", input_size=(size, size),
                     conf_thresh=0.01)
    train_ds, val_ds = synthetic_sets(size, hard, train_images, val_images)
    model, train_s = float_model("slim_yolo_v2", cfg, dev, ckpt,
                                 skip_train, train_ds, batch, epochs, lr)
    if train_only:
        # the deterministic checkpoint alone (e.g. for
        # quant_bitwidth_torch.py), without the stage evaluations
        print(f"train_only: checkpoint at {ckpt}")
        return {}

    stages = Stages(VOCEvaluator(val_ds, 2, (size, size), batch_size=64,
                                 cache_device=True), train_s)
    # PTQ calibration on training images, held on the device
    calib = calib_batches(train_ds, dev)
    for name, detect in float_stages(model, cfg, calib, dev):
        stages.run(name, detect)

    # the true integer engine; then with the head-clip tracker
    # (objectness logits saturate through the sigmoid, so capping their
    # tracked range buys the box / class channels ~8x finer resolution)
    stages.run("int8_integer", int8_engine(model, cfg, calib, dev)[1])
    stages.run("int8_headclip", int8_engine(model, cfg, calib, dev,
                                            head_clip=16.0)[1])

    # the label-free PTQ config search (quant/autoclip.py): head-cap
    # sweep, per-tracker percentile sweep, optional greedy refinement
    best_cfg, cfg_info = select_quant_config(
        "slim_yolo_v2", model, cfg, calib, greedy_rounds=greedy,
        verbose=True, device=dev)
    stages.lap("autoclip search")
    auto_cap = best_cfg["head_clip"]
    stages.run(f"int8_autoclip[{auto_cap}]",
               int8_engine(model, cfg, calib, dev, head_clip=auto_cap)[1])
    # the per-tracker clip (percentile p on every conv tracker plus any
    # greedy flips); p=None: the search kept abs-max + the head cap, and
    # the row ties int8_autoclip
    stages.run(f"int8_ptclip[p={best_cfg['act_percentile']}]",
               int8_engine(model, cfg, calib, dev,
                           states=best_cfg["states"])[1])
    # per-channel weight scales (the serving opt-in; weight.h stays per
    # tensor)
    stages.run("int8_perchan",
               int8_engine(model, cfg, calib, dev, head_clip=auto_cap,
                           per_channel=True)[1])

    # ---- QAT: train against the frozen int8 grid, serve on the SAME
    # frozen states. Three variants: no head clip (does training recover
    # the saturation collapse?), the autoclip states and the searched
    # per-tracker states (does QAT beat PTQ on them?)
    if qat_steps > 0:
        fused = fold_batch_norm(model)
        params_q = qsim.fake_quantize_params(fused)
        feed = device_feed(cfg, train_ds, batch, dev)
        for tag, st in [("noclip", qsim.calibrate(params_q, cfg, calib)),
                        ("autoclip", qsim.calibrate(params_q, cfg, calib,
                                                    head_clip=auto_cap)),
                        ("ptclip", best_cfg["states"])]:
            _, detect_qat = qat_engine(fused, cfg, calib, dev, st, feed,
                                       qat_lr, qat_steps)
            stages.lap(f"qat[{tag}]: {qat_steps} steps")
            stages.run(f"int8_qat[{tag}]", detect_qat)

    results = stages.results
    pairs = [(f"qat_vs_ptq_{tag}", f"int8_qat[{tag}]",
              first_with(results, prefix),
              f"QAT vs PTQ (both on {tag} states, paired)")
             for tag, prefix in (("autoclip", "int8_autoclip"),
                                 ("ptclip", "int8_ptclip"))]
    ci_rows, best_k = stage_table(
        stages, n_boot, pairs,
        f"\n=== mAP by stage @{size}x{size} input, "
        f"{'hard' if hard else 'easy'} synthetic (vs fp32, paired "
        f"bootstrap 95% CI, {val_images} val images, {n_boot} "
        "replicates) ===")
    delta = (results["fp32"] - results[best_k]) * 100
    ci = ci_rows[best_k]
    print(f"\nbest int8 integer engine = {best_k}: delta {delta:.2f} mAP "
          f"points, 95% CI [{-ci[2]:.2f}, {-ci[1]:.2f}] "
          f"({'PASS' if delta < 0.5 else 'CHECK'} vs the <=0.5 target; "
          f"CI half-width "
          f"{(ci[2] - ci[1]) / 2:.2f} pts vs the 0.5 bar)")
    write_results(temp_path(f"quant_parity_torch_results_{suffix}.json"),
                  stages, ci_rows, val_images, epochs, size, hard,
                  train_images, best_cfg, cfg_info)
    return results


def add_device_arg(p) -> None:
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; raises without a card) or "
                        "cpu (the kernels' plain versions)")


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--epochs", type=int, default=150)
    p.add_argument("--size", type=int, default=64)
    p.add_argument("--val", type=int, default=512)
    p.add_argument("--train_images", type=int, default=128)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--hard", action="store_true", default=False,
                   help="crowded/small-object synthetic regime "
                        "(data/synthetic.py hard=True)")
    p.add_argument("--qat_steps", type=int, default=300)
    p.add_argument("--qat_lr", type=float, default=1e-6)
    p.add_argument("--lr", type=float, default=None,
                   help="training LR (default: 1e-3 up to 128^2, "
                        "2.5e-4 above — the summed-over-anchors loss "
                        "scales with grid area)")
    p.add_argument("--n_boot", type=int, default=300)
    p.add_argument("--greedy", type=int, default=0,
                   help="greedy per-tracker refinement rounds in the "
                        "PTQ config search (each round ~n_trackers "
                        "engine rebuilds)")
    p.add_argument("--skip_train", action="store_true", default=False)
    p.add_argument("--train_only", action="store_true", default=False,
                   help="train + save the deterministic checkpoint and "
                        "exit (skip every quantization stage)")
    add_device_arg(p)
    a = p.parse_args()
    main(epochs=a.epochs, size=a.size, batch=a.batch, val_images=a.val,
         qat_steps=a.qat_steps, qat_lr=a.qat_lr, n_boot=a.n_boot,
         skip_train=a.skip_train, hard=a.hard,
         train_images=a.train_images, greedy=a.greedy, lr=a.lr,
         train_only=a.train_only, device=a.device)
