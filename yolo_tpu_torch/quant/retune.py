"""The retune fine-tune and the exponent-table export (counterpart of
``yolo_tpu/quant/retune.py``): ``retune_finetune``, the low-LR fine-tune
of the BN-fused model, and the per-layer scale_w / scale_b / scale_a /
retune tables and int8 weights that the reference C engine consumes."""

from __future__ import annotations

from typing import Dict

import numpy as np

from yolo_tpu_torch.quant.fixed_point import Int8Model
from yolo_tpu_torch.quant.qsim import QUANT_LAYER_NAMES, TRACKER_NAMES

# The header's first line: the JAX package's own, so that both packages
# write byte-identical headers for one model.
HEADER_LINE = "// generated by yolo_tpu.quant.retune.export_c_header"


def retune_finetune(det, batches_with_targets, base_lr: float = 1e-7,
                    steps: int = 100, eval_fn=None, eval_every: int = 0):
    """Low-LR fine-tune of the BN-fused model (reference
    retune_bias_quantize.py without -q, :374-420): ``det`` a
    ``detector.Detector`` around a ``batch_norm=False`` float model,
    trained in place by ``train.trainer.make_train_step`` (no warmup, LR
    ``base_lr``) on ``batches_with_targets`` (images [B, H, W, 3], gt
    [B, N, 11]), at most ``steps`` of them.

    With ``eval_fn`` (model -> mAP) and ``eval_every`` > 0 it evaluates
    every ``eval_every`` steps and at the end, and leaves the model in
    the best-scoring state seen (the final one included; the first of
    equal scores): the reference driver's per-epoch evaluation and
    best-checkpoint choice. Returns (the model, the last step's
    metrics)."""
    import torch

    from yolo_tpu_torch.train.trainer import TrainConfig, make_train_step

    model = det.model
    tc = TrainConfig(base_lr=base_lr, wp_epoch=0)
    opt, step = make_train_step(model, det.cfg, tc)
    opt_state = opt.init(model)
    last = None
    best_state, best_map = None, -1.0
    track = eval_fn is not None and eval_every > 0

    def consider(what):
        nonlocal best_state, best_map
        m = float(eval_fn(model))
        print(f"[retune] {what}: mAP = {m:.4f}")
        if m > best_map:
            best_map = m
            best_state = {k: v.detach().clone()
                          for k, v in model.state_dict().items()}

    for i, (images, gt) in enumerate(batches_with_targets):
        if i >= steps:
            break
        last = step(opt_state, images, gt, base_lr)
        if track and (i + 1) % eval_every == 0 and (i + 1) < steps:
            consider(f"step {i + 1}")
    if track:
        consider("final")
        print(f"[retune] best mAP = {best_map:.4f}")
        with torch.no_grad():
            model.load_state_dict(best_state)
    return model, last


def export_tables(m: Int8Model) -> Dict[str, list]:
    """The four exponent tables in C-engine layer order; ValueError for a
    model with per-channel weight scales (weight.h holds one scale_w per
    layer)."""
    if m.per_channel:
        raise ValueError(
            "per-channel weight scales cannot export to the shift-chain "
            "weight.h contract (one scale_w entry per layer, "
            "c_embedding/yolo_forward.c:32); rebuild the pipeline with "
            "per_channel=False for embedded deployment")
    return {
        "scale_w": [int(m.sw[n]) for n in QUANT_LAYER_NAMES],
        "scale_b": [int(m.sb[n]) for n in QUANT_LAYER_NAMES],
        "scale_a": [int(m.sa[n]) for n in TRACKER_NAMES],
        "retune": [int(m.retune[n]) for n in QUANT_LAYER_NAMES],
    }


def c_header(m: Int8Model) -> str:
    """The weight.h text: exponent tables, then each layer's int8 weights
    (OIHW order, the embedded engine's layout) and biases."""
    t = export_tables(m)
    lines = [HEADER_LINE, ""]
    for name in ("scale_w", "scale_b", "retune", "scale_a"):
        vals = ", ".join(str(v) for v in t[name])
        lines.append(f"const char {name}[{len(t[name])}] = {{{vals}}};")
    lines.append("")
    for i, layer in enumerate(QUANT_LAYER_NAMES):
        w = m.w_q[layer].cpu().numpy()  # HWIO
        oihw = np.transpose(w, (3, 2, 0, 1)).ravel()
        b = m.b_q[layer].cpu().numpy().astype(np.int8)
        lines.append(
            f"const signed char weight_{i}[{oihw.size}] = "
            f"{{{', '.join(str(int(v)) for v in oihw)}}};")
        lines.append(
            f"const signed char bias_{i}[{b.size}] = "
            f"{{{', '.join(str(int(v)) for v in b)}}};")
    return "\n".join(lines) + "\n"


def export_c_header(m: Int8Model, path: str) -> None:
    """Write ``c_header(m)`` to ``path``."""
    with open(path, "w") as f:
        f.write(c_header(m))
