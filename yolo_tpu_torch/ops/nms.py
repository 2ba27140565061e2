"""Fixed-shape, batched detection postprocess: pre-NMS top-k and
class-aware greedy NMS (counterpart of ``yolo_tpu/ops/nms.py``:
``_pairwise_iou``, ``postprocess_jax`` and ``batched_postprocess``).

Top-k uses a stable descending sort, so equal scores keep the lower
index first, as ``lax.top_k`` does (``torch.topk`` promises no order
among ties on CUDA). Greedy NMS is the custom op
``yolo_tpu_torch::greedy_nms_keep``: on a CUDA tensor the hand-written
kernel ``kernels/csrc/nms_greedy.cu`` (one launch, no host read, so a
detect fn can be captured or exported whole), on a CPU tensor its plain
version, the JAX package's Jacobi fixpoint as torch ops (its suppression
count a boolean any-reduction: CUDA torch has no integer matmul).
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from yolo_tpu_torch.kernels import launch

# the kernel keeps the K x K/32 suppression bits of an image in shared
# memory
NMS_MAX_K = 1024


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


def greedy_nms_keep_plain(cand_boxes: torch.Tensor, cand_cls: torch.Tensor,
                          valid: torch.Tensor,
                          nms_thresh: float) -> torch.Tensor:
    """Greedy NMS over score-ordered candidates as the JAX package's
    Jacobi fixpoint: keep[i] = valid[i] & ~any_j(keep[j] & sup[j, i]) over
    j < i, iterated until no image's keep changes (at most K sweeps, each
    read back to the host). Any device."""
    k = cand_boxes.shape[1]
    iou = _pairwise_iou(cand_boxes)
    same_cls = cand_cls[:, :, None] == cand_cls[:, None, :]
    # sup_lower[b, j, i]: candidate j (higher score, j < i) suppresses i
    upper = torch.ones((k, k), dtype=torch.bool,
                       device=cand_boxes.device).triu(diagonal=1)
    sup_lower = (iou > nms_thresh) & same_cls & upper
    keep = valid
    for _ in range(k):
        hit = (keep[:, :, None] & sup_lower).any(dim=1)
        new = valid & ~hit
        if torch.equal(new, keep):
            break
        keep = new
    # a new tensor: the op's output must not alias its input
    return keep.clone() if keep is valid else keep


@torch.library.custom_op("yolo_tpu_torch::greedy_nms_keep", mutates_args=())
def greedy_nms_keep(cand_boxes: torch.Tensor, cand_cls: torch.Tensor,
                    valid: torch.Tensor, nms_thresh: float) -> torch.Tensor:
    """Class-aware greedy NMS keep mask: cand_boxes [B, K, 4] float32
    corner boxes in score order, cand_cls [B, K] int32, valid [B, K] bool
    -> keep [B, K] bool. On the CPU the plain version; on CUDA the kernel
    (below)."""
    return greedy_nms_keep_plain(cand_boxes, cand_cls, valid, nms_thresh)


@greedy_nms_keep.register_kernel("cuda")
def _(cand_boxes, cand_cls, valid, nms_thresh):
    b, k = valid.shape
    if (cand_boxes.dtype != torch.float32 or cand_cls.dtype != torch.int32
            or valid.dtype != torch.bool
            or tuple(cand_boxes.shape) != (b, k, 4)
            or tuple(cand_cls.shape) != (b, k)):
        raise ValueError(f"greedy_nms_keep takes float32 [B, K, 4], int32 "
                         f"[B, K] and bool [B, K], got {cand_boxes.dtype} "
                         f"{list(cand_boxes.shape)}, {cand_cls.dtype} "
                         f"{list(cand_cls.shape)}, {valid.dtype} "
                         f"{list(valid.shape)}")
    if k > NMS_MAX_K:
        raise ValueError(f"the NMS kernel takes K <= {NMS_MAX_K} candidates,"
                         f" got {k}")
    keep = torch.empty_like(valid)
    if keep.numel() == 0:
        return keep
    boxes = cand_boxes.contiguous()
    # the threshold as a float32, as torch compares with a Python scalar
    bits = struct.unpack("<i", struct.pack("<f", nms_thresh))[0]
    launch("greedy_nms_keep", "yolo_nms_greedy", boxes,
           cand_cls.contiguous(), valid.contiguous(), keep, b, k, bits,
           writes=(keep,), align=[("cand_boxes", boxes, 16)])
    return keep


@greedy_nms_keep.register_fake
def _(cand_boxes, cand_cls, valid, nms_thresh):
    return torch.empty_like(valid)


def _top_k(values: torch.Tensor, k: int):
    """lax.top_k over the last dim: descending, lower index first among
    equal values."""
    vals, idx = torch.sort(values, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def nms_candidates(boxes: torch.Tensor, class_probs: torch.Tensor,
                   conf_thresh: float, pre_nms_top_k: int = 512):
    """The pre-NMS top-k of [B, N, 4] boxes x [B, N, C] class confidences
    by best-class score -> (scores [B, K], cand_boxes [B, K, 4], cand_cls
    [B, K] int32, valid [B, K]), K = min(pre_nms_top_k, N), in score
    order: what greedy NMS takes."""
    b, n, _ = class_probs.shape
    k = min(pre_nms_top_k, n)
    scores_all = class_probs.amax(dim=-1)
    # argmax returns the first maximal index, as jnp.argmax does
    cls_all = class_probs.argmax(dim=-1)
    scores, idx = _top_k(scores_all, k)
    cand_boxes = torch.gather(boxes, 1, idx[..., None].expand(b, k, 4))
    cand_cls = torch.gather(cls_all, 1, idx).to(torch.int32)
    return scores, cand_boxes, cand_cls, scores >= conf_thresh


def batched_postprocess(boxes: torch.Tensor, class_probs: torch.Tensor,
                        conf_thresh: float, nms_thresh: float,
                        pre_nms_top_k: int = 512, top_k: int = 100,
                        mode: str = "greedy", topk_method: str = "exact"):
    """[B, N, 4] corner boxes x [B, N, C] class confidences -> fixed-shape
    (boxes [B, top_k, 4], scores [B, top_k], classes [B, top_k] int32,
    valid [B, top_k] bool); invalid slots are zeroed (classes -1).

    ``mode='greedy'`` is exact greedy NMS (``greedy_nms_keep``): the
    result of the JAX package's vmapped while_loop. ``'fast'`` keeps a box
    iff no higher-scored same-class box overlaps it.
    """
    if topk_method == "approx":
        raise ValueError("topk_method='approx' (lax.approx_max_k) is "
                         "TPU-only; use 'exact'")
    if topk_method != "exact":
        raise ValueError(f"unknown topk_method {topk_method!r}")
    if mode not in ("greedy", "fast"):
        raise ValueError(f"unknown nms mode {mode!r}")
    b = class_probs.shape[0]
    scores, cand_boxes, cand_cls, valid = nms_candidates(
        boxes, class_probs, conf_thresh, pre_nms_top_k)
    k = scores.shape[1]

    if mode == "greedy":
        keep = greedy_nms_keep(cand_boxes, cand_cls, valid, float(nms_thresh))
    else:
        iou = _pairwise_iou(cand_boxes)
        same_cls = cand_cls[:, :, None] == cand_cls[:, None, :]
        upper = torch.ones((k, k), dtype=torch.bool,
                           device=boxes.device).triu(diagonal=1)
        keep = valid & ~((iou > nms_thresh) & same_cls & upper).any(dim=1)

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


# ---------------------------------------------------------------------------
# Numpy oracle (the reference's semantics, one image).
# ---------------------------------------------------------------------------


def nms_greedy_numpy(dets: np.ndarray, scores: np.ndarray,
                     nms_thresh: float):
    """Pure-numpy greedy NMS with the reference baseline's math (areas
    without +1, intersection sides floored at 1e-28, boxes kept with
    overlap <= thresh) -> kept indices."""
    x1, y1, x2, y2 = dets[:, 0], dets[:, 1], dets[:, 2], dets[:, 3]
    areas = (x2 - x1) * (y2 - y1)
    order = scores.argsort()[::-1]
    keep = []
    while order.size > 0:
        i = order[0]
        keep.append(i)
        xx1 = np.maximum(x1[i], x1[order[1:]])
        yy1 = np.maximum(y1[i], y1[order[1:]])
        xx2 = np.minimum(x2[i], x2[order[1:]])
        yy2 = np.minimum(y2[i], y2[order[1:]])
        w = np.maximum(1e-28, xx2 - xx1)
        h = np.maximum(1e-28, yy2 - yy1)
        inter = w * h
        ovr = inter / (areas[i] + areas[order[1:]] - inter)
        order = order[np.where(ovr <= nms_thresh)[0] + 1]
    return keep


def postprocess_numpy(bbox_pred: np.ndarray, prob_pred: np.ndarray,
                      num_classes: int, conf_thresh: float,
                      nms_thresh: float):
    """The reference postprocess (the JAX package's ``postprocess_numpy``):
    argmax class, conf threshold, class-wise NMS -> (boxes, scores,
    cls_inds), variable length."""
    cls_inds = np.argmax(prob_pred, axis=1)
    scores = prob_pred[np.arange(prob_pred.shape[0]), cls_inds].copy()
    keep = np.where(scores >= conf_thresh)
    bbox_pred, scores, cls_inds = bbox_pred[keep], scores[keep], \
        cls_inds[keep]
    keep = np.zeros(len(bbox_pred), dtype=np.int64)
    for i in range(num_classes):
        inds = np.where(cls_inds == i)[0]
        if len(inds) == 0:
            continue
        keep[inds[nms_greedy_numpy(bbox_pred[inds], scores[inds],
                                   nms_thresh)]] = 1
    keep = np.where(keep > 0)
    return bbox_pred[keep], scores[keep], cls_inds[keep]
