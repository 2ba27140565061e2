"""Model building blocks (counterpart of ``yolo_tpu/ops/blocks.py``; this
slice needs only ``flatten_grid``)."""

import torch


def flatten_grid(pred: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] -> [B, H*W, C]."""
    b, h, w, c = pred.shape
    return pred.reshape(b, h * w, c)
