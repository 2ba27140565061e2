"""Label-free search of the PTQ clip configuration (counterpart of
``yolo_tpu/quant/autoclip.py``).

The prediction head's tracked range is dominated by a few extreme conf
logits; capping it (head_clip) saturates those (harmless after the
sigmoid) for a finer grid on everything else. The best cap depends on the
model, and the reference hand-picks it (the findbest search's spirit,
retune_bias_quantize_findbest.py:115-148). ``select_head_clip`` sweeps
candidate caps and scores each INT8 engine by how well its detections
reproduce the float model's on the calibration batches
(``detection_agreement``: score-weighted best-IoU matching, the quantity
mAP measures, without labels). ``select_quant_config`` adds a
per-tracker percentile clip and greedy per-tracker refinement.

Candidate engines come from ``dispatch.build_int8_detector``: on the card
the kernels. Calibration batches that are tensors stay where they are,
so that the dozens of candidates scored on them do not copy them from
the host each time.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch

DEFAULT_CAPS: Tuple[Optional[float], ...] = (None, 8.0, 16.0, 32.0)
DEFAULT_PERCENTILES: Tuple[Optional[float], ...] = (
    None, 99.95, 99.8, 99.5, 99.0)


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def detection_agreement(float_out, int_out) -> float:
    """Score in [0, 1]: confidence-weighted best-IoU agreement of the
    int8 detections with the float detections (same class required).
    Each argument is a detect fn's (boxes, scores, classes, valid)."""
    fb, fs, fc, fv = (_np(a) for a in float_out)
    ib, is_, ic, iv = (_np(a) for a in int_out)
    total_w = 0.0
    total = 0.0
    for i in range(fb.shape[0]):
        fkeep = np.where(fv[i])[0]
        for k in fkeep:
            w = float(fs[i, k])
            total_w += w
            same = np.where(iv[i] & (ic[i] == fc[i, k]))[0]
            if same.size == 0:
                continue
            x1 = np.maximum(ib[i, same, 0], fb[i, k, 0])
            y1 = np.maximum(ib[i, same, 1], fb[i, k, 1])
            x2 = np.minimum(ib[i, same, 2], fb[i, k, 2])
            y2 = np.minimum(ib[i, same, 3], fb[i, k, 3])
            inter = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
            area_f = ((fb[i, k, 2] - fb[i, k, 0]) *
                      (fb[i, k, 3] - fb[i, k, 1]))
            area_i = ((ib[i, same, 2] - ib[i, same, 0]) *
                      (ib[i, same, 3] - ib[i, same, 1]))
            iou = inter / np.maximum(area_f + area_i - inter, 1e-9)
            # penalize score disagreement of the best spatial match
            j = int(np.argmax(iou))
            total += w * float(iou[j]) * (
                1.0 - min(1.0, abs(float(is_[i, same[j]]) - w)))
    if total_w == 0.0:
        return 1.0  # no float detections: nothing to disagree about
    return total / total_w


def _as_f32_batches(batches):
    """Host batches as float32 numpy; tensors (on the card, say) pass
    through untouched."""
    return [b if isinstance(b, torch.Tensor) else np.asarray(b, np.float32)
            for b in batches]


def _float_reference(version: str, model, cfg, calib_batches, device):
    """The float model's detections on the calibration batches (the
    agreement's target)."""
    from yolo_tpu_torch.detector import Detector
    from yolo_tpu_torch.quant.dispatch import has_batch_norm

    det = Detector(cfg, model=model, batch_norm=has_batch_norm(version),
                   device=device)
    return [det.detect(b) for b in calib_batches]


def _agreement(detect, float_outs, calib_batches) -> float:
    return float(np.mean([
        detection_agreement(fo, detect(b))
        for fo, b in zip(float_outs, calib_batches)]))


def select_head_clip(version: str, model, cfg,
                     calib_batches: Iterable,
                     caps: Sequence[Optional[float]] = DEFAULT_CAPS,
                     verbose: bool = False, float_outs=None,
                     device="cuda") -> Tuple[Optional[float], Dict]:
    """Quantize the float ``model`` with each of ``caps`` on ``device``
    and return (best cap, {cap: score}) by detection agreement with the
    float model on ``calib_batches`` (the first of equal scores)."""
    from yolo_tpu_torch.quant.dispatch import build_int8_detector

    calib_batches = _as_f32_batches(calib_batches)
    if float_outs is None:
        float_outs = _float_reference(version, model, cfg, calib_batches,
                                      device)
    scores: Dict = {}
    best_cap, best_score = None, -1.0
    for cap in caps:
        _, detect = build_int8_detector(version, model, cfg, calib_batches,
                                        head_clip=cap, device=device)
        s = _agreement(detect, float_outs, calib_batches)
        scores[cap] = s
        if verbose:
            print(f"head_clip={cap}: agreement {s:.4f}")
        if s > best_score:
            best_cap, best_score = cap, s
    return best_cap, scores


# ---------------------------------------------------------------------------
# The per-tracker clip search. The head cap reaches the prediction-head
# trackers only; per-tensor abs-max grids in the backbone lose too. Two
# per-tracker mechanisms, scored by the same agreement:
#
#   1. percentile calibration: every tracker but the input's clips to the
#      q-th percentile of |act| instead of the max (one swept knob);
#   2. greedy refinement: per tracker, one bit more resolution (double
#      the tracked scale, half the range), kept where agreement improves.
# ---------------------------------------------------------------------------


def calibrate_states(version: str, model, cfg, calib_batches,
                     head_clip: Optional[float] = None,
                     act_percentile: Optional[float] = None,
                     device="cuda"):
    """Family-aware calibration of the float ``model`` on ``device``: the
    tracker states (slim: a name dict, the others: a call-ordered list)
    that ``build_int8_detector(states=...)`` takes."""
    from yolo_tpu_torch.quant.bn_fold import fold_batch_norm
    from yolo_tpu_torch.quant.dispatch import has_batch_norm
    from yolo_tpu_torch.quant.fixed_point import resolve_device

    model = model.to(resolve_device(device))
    fused = fold_batch_norm(model) if has_batch_norm(version) else model
    if version.startswith("slim_yolo_v2"):
        from yolo_tpu_torch.quant import qsim
        params_q = qsim.fake_quantize_params(fused)
        return qsim.calibrate(params_q, cfg, calib_batches,
                              head_clip=head_clip,
                              act_percentile=act_percentile)
    from yolo_tpu_torch.quant.generic import (calibrate_generic,
                                              fake_quantize_all_convs)
    params_q = fake_quantize_all_convs(fused)
    return calibrate_generic(params_q, cfg, list(calib_batches),
                             head_clip=head_clip,
                             act_percentile=act_percentile)


def _tracker_items(states):
    """(key, state) pairs, the input tap left out (image data has no
    outlier tail; clipping it only loses information)."""
    if isinstance(states, dict):
        return [(k, v) for k, v in states.items() if k != "in"]
    return list(enumerate(states))[1:]


def _with_scale(states, key, factor: float):
    """A copy of ``states`` with tracker ``key``'s EMA scale times
    ``factor`` (2.0: one bit finer, half the representable range)."""
    out = dict(states) if isinstance(states, dict) else list(states)
    st = dict(out[key])
    st["scale"] = st["scale"] * factor
    out[key] = st
    return out


def select_quant_config(version: str, model, cfg,
                        calib_batches: Iterable,
                        caps: Sequence[Optional[float]] = DEFAULT_CAPS,
                        percentiles: Sequence[Optional[float]] =
                        DEFAULT_PERCENTILES,
                        greedy_rounds: int = 0,
                        min_gain: float = 1e-4,
                        verbose: bool = False,
                        device="cuda") -> Tuple[dict, Dict]:
    """The label-free PTQ configuration search on ``device``: stage 1 the
    head cap (``select_head_clip``); stage 2 the activation percentile at
    that cap; stage 3 (``greedy_rounds`` > 0) per tracker, one bit more
    resolution, each flip kept where agreement improves by more than
    ``min_gain`` (a round rebuilds ~one engine per tracker).

    Returns (best, info): ``best`` holds head_clip, act_percentile,
    states and score (serve it with ``build_int8_detector(states=...)``),
    ``info`` cap_scores, pct_scores and greedy_flips [(round, tracker,
    score)]."""
    from yolo_tpu_torch.quant.dispatch import build_int8_detector

    calib_batches = _as_f32_batches(calib_batches)
    float_outs = _float_reference(version, model, cfg, calib_batches,
                                  device)
    cap, cap_scores = select_head_clip(version, model, cfg, calib_batches,
                                       caps, verbose, float_outs=float_outs,
                                       device=device)

    def score_states(states) -> float:
        _, detect = build_int8_detector(version, model, cfg, calib_batches,
                                        states=states, device=device)
        return _agreement(detect, float_outs, calib_batches)

    pct_scores: Dict = {}
    best_p, best_states, best_score = None, None, -1.0
    for p in percentiles:
        states = calibrate_states(version, model, cfg, calib_batches,
                                  head_clip=cap, act_percentile=p,
                                  device=device)
        s = score_states(states)
        pct_scores[p] = s
        if verbose:
            print(f"act_percentile={p}: agreement {s:.4f}")
        if s > best_score:
            best_p, best_states, best_score = p, states, s

    flips = []
    for r in range(greedy_rounds):
        improved = False
        for key, _ in _tracker_items(best_states):
            cand = _with_scale(best_states, key, 2.0)
            s = score_states(cand)
            if s > best_score + min_gain:
                if verbose:
                    print(f"greedy[{r}] tracker {key}: {best_score:.4f} "
                          f"-> {s:.4f} (kept)")
                best_states, best_score = cand, s
                flips.append((r, key, s))
                improved = True
        if not improved:
            break

    best = {"head_clip": cap, "act_percentile": best_p,
            "states": best_states, "score": best_score}
    info = {"cap_scores": cap_scores, "pct_scores": pct_scores,
            "greedy_flips": flips}
    return best, info
