"""Quantization analysis (counterpart of ``yolo_tpu/quant/analysis.py``):
per-layer weight quantization SNR, channel-range spread (the damage a
per-tensor scale does to small channels) and activation-scale
summaries, where the reference prints unique weight values
(weightsdistribute, retune_bias_quantize.py:121-127). Rows name each conv
by its path in the JAX package's parameter tree (``conv1``,
``backbone.conv_1[0]``), so that they compare one to one with that
package's."""

from __future__ import annotations

from typing import List

import numpy as np
import torch
from torch import nn

from yolo_tpu_torch.quant import quantize as q


def _snr_db(clean: np.ndarray, quant: np.ndarray) -> float:
    err = clean - quant
    p_sig = float(np.mean(clean ** 2))
    p_err = float(np.mean(err ** 2)) + 1e-20
    return 10.0 * np.log10(p_sig / p_err + 1e-20)


def weight_report(params, bitwidth: int = 8,
                  prefix: str = "") -> List[dict]:
    """Per-conv quantization stats of a float model (an ``nn.Module``,
    read through ``convert.module_to_params``) or of a JAX-layout tree
    (HWIO weights). channel_spread: the largest output channel's max|w|
    over the smallest's; a large spread means a per-tensor scale starves
    the small channels (the reference quantizes per tensor,
    retune_bias_quantize.py:73-86)."""
    if isinstance(params, nn.Module):
        from yolo_tpu_torch.quant.convert import module_to_params

        params = module_to_params(params)
    rows = []
    if isinstance(params, dict):
        if "w" in params:
            w = q.to_numpy_f32(params["w"])
            wt = torch.tensor(w)
            fq = q.fake_quantize(wt, bitwidth).numpy()
            ch_max = np.abs(w).reshape(-1, w.shape[-1]).max(axis=0)
            rows.append({
                "layer": prefix or "<conv>",
                "max_abs": float(np.abs(w).max()),
                "scale_exp": int(np.log2(float(q.pow2_scale(wt,
                                                            bitwidth)))),
                "snr_db": _snr_db(w, fq),
                "channel_spread": float(
                    ch_max.max() / max(ch_max.min(), 1e-12)),
            })
            return rows
        for k, v in params.items():
            rows.extend(weight_report(v, bitwidth,
                                      f"{prefix}.{k}" if prefix else k))
    elif isinstance(params, (list, tuple)):
        for i, v in enumerate(params):
            rows.extend(weight_report(v, bitwidth, f"{prefix}[{i}]"))
    return rows


def activation_report(tracker_states) -> List[dict]:
    """Summaries of calibrated activation trackers (a name dict or a
    call-ordered list of states)."""
    items = (tracker_states.items() if isinstance(tracker_states, dict)
             else enumerate(tracker_states))
    rows = []
    for name, st in items:
        scale = float(q.to_numpy_f32(st["scale"]))
        p2 = float(q.tracker_pow2(st)) if scale > 0 else 0.0
        rows.append({
            "tracker": str(name),
            "ema_scale": scale,
            "pow2_scale_exp": int(np.log2(p2)) if p2 > 0 else None,
            "implied_max": 127.0 / scale if scale > 0 else float("inf"),
        })
    return rows


def print_report(rows: List[dict], title: str = "") -> None:
    if title:
        print(f"=== {title} ===")
    if not rows:
        return
    keys = list(rows[0].keys())
    for r in rows:
        print("  ".join(f"{k}={r[k]:.3g}" if isinstance(r[k], float)
                        else f"{k}={r[k]}" for k in keys))
