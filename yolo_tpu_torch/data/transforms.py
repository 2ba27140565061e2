"""Eval-time image transforms in numpy (cv2 where present) on the host
(counterpart of the eval half of ``yolo_tpu/data/transforms.py``; the
train-time augmentations wait for training).

Behaviour as the reference pipeline's: ``base_transform`` resizes
bilinearly to the model input, divides by 255 and normalizes with the
ImageNet statistics in **BGR order** (frames come from cv2, i.e. BGR);
``BaseTransform`` then flips the channels to RGB as the datasets do.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

try:
    import cv2
except ImportError:  # the numpy resize below takes over
    cv2 = None

from yolo_tpu_torch.config import BGR_MEAN, BGR_STD


def _resize(image: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """Bilinear resize to (h, w): cv2 where present (the reference's
    resize), else a numpy half-pixel-centers resize. An image already of
    that size comes back as it is: at scale 1 both resizes are the
    identity (cv2 copies; the numpy weights are 1 and 0)."""
    h, w = size
    if image.shape[:2] == (h, w):
        return image
    if cv2 is not None:
        return cv2.resize(image, (w, h))
    return _numpy_bilinear_resize(image, h, w)


def _numpy_bilinear_resize(img: np.ndarray, out_h: int, out_w: int):
    in_h, in_w = img.shape[:2]
    ys = (np.arange(out_h) + 0.5) * in_h / out_h - 0.5
    xs = (np.arange(out_w) + 0.5) * in_w / out_w - 0.5
    y0 = np.clip(np.floor(ys).astype(int), 0, in_h - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, in_w - 1)
    y1 = np.clip(y0 + 1, 0, in_h - 1)
    x1 = np.clip(x0 + 1, 0, in_w - 1)
    fy = np.clip(ys - y0, 0, 1)[:, None, None]
    fx = np.clip(xs - x0, 0, 1)[None, :, None]
    im = img.astype(np.float32)
    top = im[y0][:, x0] * (1 - fx) + im[y0][:, x1] * fx
    bot = im[y1][:, x0] * (1 - fx) + im[y1][:, x1] * fx
    return top * (1 - fy) + bot * fy


def base_transform(image, size, mean=BGR_MEAN, std=BGR_STD):
    """Resize + /255 + normalize (BGR stats). Returns float32 HWC (BGR)."""
    x = _resize(image, size).astype(np.float32)
    x /= 255.0
    x -= np.asarray(mean, np.float32)
    x /= np.asarray(std, np.float32)
    return x


def to_rgb(image: np.ndarray) -> np.ndarray:
    """BGR -> RGB channel flip (the datasets' final step)."""
    return image[:, :, ::-1].copy()


def letterbox(image: np.ndarray, size, pad_value: int = 114):
    """Aspect-preserving resize + centered pad to ``size`` (h, w) ->
    (canvas u8, scale, (pad_x, pad_y)): the mapping that projects
    detections back to the original frame."""
    h, w = size
    ih, iw = image.shape[:2]
    scale = min(h / ih, w / iw)
    rh, rw = int(round(ih * scale)), int(round(iw * scale))
    resized = _resize(image, (rh, rw)).astype(image.dtype)
    canvas = np.full((h, w, image.shape[2]), pad_value, image.dtype)
    py, px = (h - rh) // 2, (w - rw) // 2
    canvas[py:py + rh, px:px + rw] = resized
    return canvas, scale, (px, py)


def unletterbox_boxes(boxes_norm: np.ndarray, size, scale, pads):
    """Normalized boxes on the letterboxed canvas -> original frame
    pixel coordinates."""
    h, w = size
    px, py = pads
    b = boxes_norm * [w, h, w, h]
    b[:, 0::2] -= px
    b[:, 1::2] -= py
    return b / scale


class BaseTransform:
    """Eval-time transform (reference data/__init__.py:49-56) with the
    datasets' BGR -> RGB flip folded in, so callers get model-ready
    arrays."""

    def __init__(self, size, mean=BGR_MEAN, std=BGR_STD, rgb: bool = True):
        self.size = tuple(size)
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        self.rgb = rgb

    def __call__(self, image, boxes=None, labels=None):
        x = base_transform(image, self.size, self.mean, self.std)
        if self.rgb:
            x = to_rgb(x)
        return x, boxes, labels
