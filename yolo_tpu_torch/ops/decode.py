"""YOLO head decode: prediction splitting and anchor-grid box decode
(counterpart of ``yolo_tpu/ops/decode.py``)."""

from __future__ import annotations

from functools import lru_cache
from typing import Sequence, Tuple

import torch


@lru_cache(maxsize=16)
def _grid_cached(input_size: Tuple[int, int], stride: int,
                 anchor_size: Tuple[Tuple[float, float], ...], device: str):
    h, w = input_size
    hs, ws = int(round(h / stride)), int(round(w / stride))
    gy, gx = torch.meshgrid(torch.arange(hs, device=device),
                            torch.arange(ws, device=device), indexing="ij")
    grid_xy = torch.stack([gx, gy], dim=-1).reshape(1, hs * ws, 1, 2)
    anchor_wh = torch.tensor(anchor_size, dtype=torch.float32,
                             device=device).reshape(1, 1, -1, 2)
    return grid_xy.to(torch.float32), anchor_wh


def make_grid(input_size: Tuple[int, int], stride: int,
              anchor_size: Sequence[Tuple[float, float]], device="cpu"):
    """(grid_xy [1, HW, 1, 2], anchor_wh [1, 1, A, 2]) for one scale,
    row-major over (y, x) with the last dim (grid_x, grid_y). Cached per
    device, so a serving loop makes no host-to-device copy for it; the
    tensors are shared and must not be written."""
    return _grid_cached(tuple(input_size), int(stride),
                        tuple(tuple(float(v) for v in a) for a in anchor_size),
                        str(torch.device(device)))


def split_predictions(pred: torch.Tensor, num_anchors: int,
                      num_classes: int):
    """[B, HW, A*(1+C+4)] -> (conf [B, HW*A, 1], cls [B, HW*A, C],
    txtytwth [B, HW, A, 4]): A objectness channels, then A*C class logits
    (anchor-major), then A*4 box offsets."""
    b, hw, _ = pred.shape
    a, c = num_anchors, num_classes
    conf = pred[:, :, :a].reshape(b, hw * a, 1)
    cls = pred[:, :, a:(1 + c) * a].reshape(b, hw * a, c)
    txtytwth = pred[:, :, (1 + c) * a:].reshape(b, hw, a, 4)
    return conf, cls, txtytwth


def decode_xywh(txtytwth: torch.Tensor, grid_xy, anchor_wh, stride: int,
                anchor_units: str = "grid"):
    """[B, HW, A, 4] (tx,ty,tw,th) -> [B, HW*A, 4] (cx,cy,w,h) in input px."""
    b, hw, a, _ = txtytwth.shape
    xy = (torch.sigmoid(txtytwth[..., :2]) + grid_xy) * stride
    wh = torch.exp(txtytwth[..., 2:]) * anchor_wh
    if anchor_units == "grid":
        wh = wh * stride
    elif anchor_units != "pixel":
        raise ValueError(f"unknown anchor_units {anchor_units!r}")
    return torch.cat([xy, wh], dim=-1).reshape(b, hw * a, 4)


def decode_boxes(txtytwth: torch.Tensor, grid_xy, anchor_wh, stride: int,
                 anchor_units: str = "grid"):
    """Corner boxes [B, HW*A, 4] = (x1, y1, x2, y2) in input px."""
    xywh = decode_xywh(txtytwth, grid_xy, anchor_wh, stride, anchor_units)
    cxcy, wh = xywh[..., :2], xywh[..., 2:]
    return torch.cat([cxcy - wh * 0.5, cxcy + wh * 0.5], dim=-1)
