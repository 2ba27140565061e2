"""Fixed-shape, batched detection postprocess: pre-NMS top-k and
class-aware greedy NMS (counterpart of ``yolo_tpu/ops/nms.py``:
``_pairwise_iou``, ``postprocess_jax`` and ``batched_postprocess``).

Top-k uses a stable descending sort, so equal scores keep the lower
index first, as ``lax.top_k`` does (``torch.topk`` promises no order
among ties on CUDA). The suppression count is a boolean any-reduction:
CUDA torch has no integer matmul.
"""

from __future__ import annotations

import torch


def _pairwise_iou(boxes: torch.Tensor) -> torch.Tensor:
    """[..., K, 4] corner boxes -> [..., K, K] IoU with the reference's NMS
    math (areas without +1, intersection sides floored at 1e-28)."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    areas = (x2 - x1) * (y2 - y1)
    xx1 = torch.maximum(x1[..., :, None], x1[..., None, :])
    yy1 = torch.maximum(y1[..., :, None], y1[..., None, :])
    xx2 = torch.minimum(x2[..., :, None], x2[..., None, :])
    yy2 = torch.minimum(y2[..., :, None], y2[..., None, :])
    w = torch.clamp(xx2 - xx1, min=1e-28)
    h = torch.clamp(yy2 - yy1, min=1e-28)
    inter = w * h
    return inter / (areas[..., :, None] + areas[..., None, :] - inter)


def _top_k(values: torch.Tensor, k: int):
    """lax.top_k over the last dim: descending, lower index first among
    equal values."""
    vals, idx = torch.sort(values, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def batched_postprocess(boxes: torch.Tensor, class_probs: torch.Tensor,
                        conf_thresh: float, nms_thresh: float,
                        pre_nms_top_k: int = 512, top_k: int = 100,
                        mode: str = "greedy", topk_method: str = "exact"):
    """[B, N, 4] corner boxes x [B, N, C] class confidences -> fixed-shape
    (boxes [B, top_k, 4], scores [B, top_k], classes [B, top_k] int32,
    valid [B, top_k] bool); invalid slots are zeroed (classes -1).

    ``mode='greedy'`` is exact greedy NMS as a Jacobi fixpoint:
    keep[i] = valid[i] & ~any_j(keep[j] & sup[j, i]) over j < i in score
    order, iterated until no image's keep changes (at most k sweeps) —
    the result of the JAX package's vmapped while_loop. ``'fast'`` keeps
    a box iff no higher-scored same-class box overlaps it.
    """
    if topk_method == "approx":
        raise ValueError("topk_method='approx' (lax.approx_max_k) is "
                         "TPU-only; use 'exact'")
    if topk_method != "exact":
        raise ValueError(f"unknown topk_method {topk_method!r}")
    if mode not in ("greedy", "fast"):
        raise ValueError(f"unknown nms mode {mode!r}")
    b, n, _ = class_probs.shape
    k = min(pre_nms_top_k, n)

    scores_all = class_probs.amax(dim=-1)
    # argmax returns the first maximal index, as jnp.argmax does
    cls_all = class_probs.argmax(dim=-1)
    scores, idx = _top_k(scores_all, k)
    cand_boxes = torch.gather(boxes, 1, idx[..., None].expand(b, k, 4))
    cand_cls = torch.gather(cls_all, 1, idx).to(torch.int32)
    valid = scores >= conf_thresh

    iou = _pairwise_iou(cand_boxes)
    same_cls = cand_cls[:, :, None] == cand_cls[:, None, :]
    # sup_lower[b, j, i]: candidate j (higher score, j < i) suppresses i
    upper = torch.ones((k, k), dtype=torch.bool,
                       device=boxes.device).triu(diagonal=1)
    sup_lower = (iou > nms_thresh) & same_cls & upper

    if mode == "greedy":
        keep = valid
        for _ in range(k):
            hit = (keep[:, :, None] & sup_lower).any(dim=1)
            new = valid & ~hit
            if torch.equal(new, keep):
                break
            keep = new
    else:
        keep = valid & ~sup_lower.any(dim=1)

    final_scores = torch.where(keep, scores, torch.zeros_like(scores))
    kk = min(top_k, k)
    out_scores, out_idx = _top_k(final_scores, kk)
    out_valid = out_scores > 0.0
    out_boxes = torch.gather(cand_boxes, 1,
                             out_idx[..., None].expand(b, kk, 4))
    out_boxes = torch.where(out_valid[..., None], out_boxes,
                            torch.zeros_like(out_boxes))
    out_cls = torch.where(out_valid, torch.gather(cand_cls, 1, out_idx),
                          torch.full_like(out_idx, -1, dtype=torch.int32))
    if top_k > k:  # fixed output budget even for tiny inputs
        pad = top_k - k
        out_boxes = torch.nn.functional.pad(out_boxes, (0, 0, 0, pad))
        out_scores = torch.nn.functional.pad(out_scores, (0, pad))
        out_cls = torch.nn.functional.pad(out_cls, (0, pad), value=-1)
        out_valid = torch.nn.functional.pad(out_valid, (0, pad))
    return out_boxes, out_scores, out_cls, out_valid


def postprocess(boxes: torch.Tensor, class_probs: torch.Tensor,
                conf_thresh: float, nms_thresh: float,
                pre_nms_top_k: int = 512, top_k: int = 100,
                mode: str = "greedy", topk_method: str = "exact"):
    """Single-image form ([N, 4] x [N, C]) of batched_postprocess (the JAX
    package's ``postprocess_jax``)."""
    out = batched_postprocess(boxes[None], class_probs[None], conf_thresh,
                              nms_thresh, pre_nms_top_k, top_k, mode,
                              topk_method)
    return tuple(o[0] for o in out)
