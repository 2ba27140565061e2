"""Plain detection postprocess: head decode, pre-NMS top-k, class-aware
greedy NMS and the fixed-shape output, in float32 torch ops.

Decode (YOLOv2 / YOLOv3): each head [B, H, W, A * (1 + C + 4)] holds per
cell A objectness logits, A * C class logits (anchor-major) and A * 4 box
offsets. A box is ((sigmoid(tx, ty) + cell) * stride, exp(tw, th) *
anchor), the anchor in grid cells (times the stride) or in pixels, as
corners over the input size, clamped to [0, 1]; its class scores are
softmax(class logits) * sigmoid(objectness). Anchors run scale by scale,
cell-major within a scale.

Postprocess: each anchor's best class and score; the ``pre_nms_top_k``
best by score (ties: the lower index first); those at or above
``conf_thresh`` go through greedy NMS (a kept box suppresses every later
box of its class whose IoU exceeds ``nms_thresh``; IoU without +1 on the
sides, each intersection side floored at 1e-28); the ``top_k`` best kept
boxes, score order, the rest of the slots zero with class -1."""

from __future__ import annotations

import torch


def decode(heads, sizes: dict):
    """[(int8 head, scale exponent)] in stride order -> (boxes [B, N, 4]
    normalized corners, class probabilities [B, N, C])."""
    a = len(sizes["anchors"]) // len(sizes["strides"])
    c = sizes["num_classes"]
    size = sizes["input_size"]
    grid_units = sizes["anchor_units"] == "grid"
    confs, clss, boxes = [], [], []
    for i, ((q, sa), stride) in enumerate(zip(heads, sizes["strides"])):
        pred = q.to(torch.float32) * (2.0 ** -sa)
        b, h, w, _ = pred.shape
        pred = pred.reshape(b, h * w, -1)
        confs.append(pred[:, :, :a].reshape(b, h * w * a, 1))
        clss.append(pred[:, :, a:(1 + c) * a].reshape(b, h * w * a, c))
        t = pred[:, :, (1 + c) * a:].reshape(b, h * w, a, 4)
        gy, gx = torch.meshgrid(torch.arange(h, device=q.device),
                                torch.arange(w, device=q.device),
                                indexing="ij")
        grid = torch.stack([gx, gy], -1).reshape(1, h * w, 1, 2).float()
        anchors = torch.tensor(sizes["anchors"][i * a:(i + 1) * a],
                               dtype=torch.float32, device=q.device)
        xy = (torch.sigmoid(t[..., :2]) + grid) * stride
        wh = torch.exp(t[..., 2:]) * anchors.reshape(1, 1, a, 2)
        if grid_units:
            wh = wh * stride
        corners = torch.cat([xy - wh * 0.5, xy + wh * 0.5], -1)
        boxes.append(corners.reshape(b, h * w * a, 4))
    boxes = torch.clamp(torch.cat(boxes, 1) / size, 0.0, 1.0)
    probs = torch.softmax(torch.cat(clss, 1), -1) * torch.sigmoid(
        torch.cat(confs, 1))
    return boxes, probs


def _iou(boxes: torch.Tensor) -> torch.Tensor:
    x1, y1, x2, y2 = boxes.unbind(-1)
    area = (x2 - x1) * (y2 - y1)
    iw = torch.clamp(torch.minimum(x2[:, :, None], x2[:, None, :])
                     - torch.maximum(x1[:, :, None], x1[:, None, :]),
                     min=1e-28)
    ih = torch.clamp(torch.minimum(y2[:, :, None], y2[:, None, :])
                     - torch.maximum(y1[:, :, None], y1[:, None, :]),
                     min=1e-28)
    inter = iw * ih
    return inter / (area[:, :, None] + area[:, None, :] - inter)


def postprocess(boxes, probs, traffic: dict):
    """-> (boxes [B, top_k, 4], scores [B, top_k], classes [B, top_k],
    valid [B, top_k])."""
    b, n, _ = probs.shape
    k = min(traffic["pre_nms_top_k"], n)
    best = probs.amax(-1)
    cls = probs.argmax(-1)  # the first maximal class
    order = torch.sort(best, dim=-1, descending=True,
                       stable=True).indices[:, :k]
    scores = torch.gather(best, 1, order)
    cand = torch.gather(boxes, 1, order[..., None].expand(b, k, 4))
    cand_cls = torch.gather(cls, 1, order)
    keep = scores >= traffic["conf_thresh"]
    later = torch.ones(k, k, dtype=torch.bool, device=probs.device).triu(1)
    sup = ((_iou(cand) > traffic["nms_thresh"])
           & (cand_cls[:, :, None] == cand_cls[:, None, :]) & later)
    for i in range(k):
        keep = keep & ~(keep[:, i:i + 1] & sup[:, i])
    final = torch.where(keep, scores, torch.zeros_like(scores))
    top = min(traffic["top_k"], k)
    s, idx = torch.sort(final, dim=-1, descending=True, stable=True)
    s, idx = s[:, :top], idx[:, :top]
    valid = s > 0
    out_boxes = torch.where(valid[..., None], torch.gather(
        cand, 1, idx[..., None].expand(b, top, 4)), torch.zeros(()))
    out_cls = torch.where(valid, torch.gather(cand_cls, 1, idx),
                          torch.full_like(idx, -1))
    return out_boxes, torch.where(valid, s, torch.zeros(())), out_cls, valid
