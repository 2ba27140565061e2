"""Image transforms in numpy (cv2 where present) on the host
(counterpart of ``yolo_tpu/data/transforms.py``).

Behaviour as the reference pipeline's: ``base_transform`` resizes
bilinearly to the model input, divides by 255 and normalizes with the
ImageNet statistics in **BGR order** (frames come from cv2, i.e. BGR);
``BaseTransform`` then flips the channels to RGB as the datasets do.
``SSDAugmentation`` (utils/augmentations.py:413-431) is the train-time
pipeline: photometric distort (HSV jitter), expand with mean fill,
IoU-constrained random crop, mirror, resize, normalize, all random draws
from a numpy Generator in the reference's order, so that one seed gives
one stream on both pixel backends (numpy here, or the native library).
"""

from __future__ import annotations

import threading
from typing import Optional, Tuple

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


# ---------------------------------------------------------------------------
# SSD-style train augmentation.
# ---------------------------------------------------------------------------


def _jaccard(boxes: np.ndarray, rect: np.ndarray) -> np.ndarray:
    max_xy = np.minimum(boxes[:, 2:], rect[2:])
    min_xy = np.maximum(boxes[:, :2], rect[:2])
    inter_wh = np.clip(max_xy - min_xy, 0, None)
    inter = inter_wh[:, 0] * inter_wh[:, 1]
    area_a = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    area_b = (rect[2] - rect[0]) * (rect[3] - rect[1])
    return inter / (area_a + area_b - inter)


def draw_photometric_params(rng) -> dict:
    """Draw the photometric jitter parameters in the reference's exact
    rng order (utils/augmentations.py:388-410) — shared by the numpy and
    native backends so switching backends preserves the random stream."""
    p = {}
    p["bright"] = float(rng.uniform(-32, 32)) if rng.integers(2) else None
    p["contrast_first"] = bool(rng.integers(2))

    def draw_contrast():
        return float(rng.uniform(0.5, 1.5)) if rng.integers(2) else None

    if p["contrast_first"]:
        p["contrast"] = draw_contrast()
    p["sat"] = float(rng.uniform(0.5, 1.5)) if rng.integers(2) else None
    p["hue"] = float(rng.uniform(-18, 18)) if rng.integers(2) else None
    if not p["contrast_first"]:
        p["contrast"] = draw_contrast()
    return p


def draw_expand_params(rng, height: int, width: int):
    """Expand decision + geometry (utils/augmentations.py:324-340).
    Returns None (no expand) or (canvas_h, canvas_w, top, left)."""
    if rng.integers(2):
        return None
    ratio = rng.uniform(1, 4)
    left = rng.uniform(0, width * ratio - width)
    top = rng.uniform(0, height * ratio - height)
    return int(height * ratio), int(width * ratio), int(top), int(left)


def _bgr2hsv_np(im):
    """cv2's float BGR->HSV conventions in numpy (H degrees [0,360),
    S = diff/(|V|+eps), V = max channel) — fallback when cv2 is absent
    so the numpy and native backends always agree."""
    eps = np.float32(1.1920929e-7)
    b, g, r = im[..., 0], im[..., 1], im[..., 2]
    v = np.max(im, axis=-1)
    diff = v - np.min(im, axis=-1)
    s = diff / (np.abs(v) + eps)
    k = np.float32(60.0) / (diff + eps)
    h = np.where(v == r, (g - b) * k,
                 np.where(v == g, (b - r) * k + 120.0,
                          (r - g) * k + 240.0))
    h = np.where(h < 0.0, h + 360.0, h)
    return np.stack([h, s, v], axis=-1).astype(np.float32)


def _hsv2bgr_np(hsv):
    """cv2's float HSV->BGR (sector formula; S>1 / wrapped H allowed)."""
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    hh = h / 60.0
    sector = np.floor(hh)
    f = (hh - sector).astype(np.float32)
    sector = np.mod(sector, 6).astype(np.int32)
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    r = np.choose(sector, [v, q, p, p, t, v])
    g = np.choose(sector, [t, v, v, q, p, p])
    b = np.choose(sector, [p, p, t, v, v, q])
    return np.stack([b, g, r], axis=-1).astype(np.float32)


def _apply_photometric(image, p: dict):
    """Numpy application of draw_photometric_params output. Image is
    float32 BGR 0..255 (mutated/copied)."""
    im = image.copy()
    if p["bright"] is not None:
        im += p["bright"]
    if p["contrast_first"] and p["contrast"] is not None:
        im *= p["contrast"]
    if p["sat"] is not None or p["hue"] is not None:
        if cv2 is not None:
            hsv = cv2.cvtColor(im.astype(np.float32), cv2.COLOR_BGR2HSV)
        else:
            hsv = _bgr2hsv_np(im.astype(np.float32))
        if p["sat"] is not None:
            hsv[:, :, 1] *= p["sat"]
        if p["hue"] is not None:
            hsv[:, :, 0] += p["hue"]
            hsv[:, :, 0][hsv[:, :, 0] > 360.0] -= 360.0
            hsv[:, :, 0][hsv[:, :, 0] < 0.0] += 360.0
        im = (cv2.cvtColor(hsv, cv2.COLOR_HSV2BGR) if cv2 is not None
              else _hsv2bgr_np(hsv))
    if not p["contrast_first"] and p["contrast"] is not None:
        im *= p["contrast"]
    return im


def _photometric_distort(rng, image):
    """Brightness/contrast/saturation/hue jitter
    (utils/augmentations.py:388-410). Image is float32 BGR 0..255."""
    return _apply_photometric(image, draw_photometric_params(rng))


def _apply_expand(image, boxes, mean, ep):
    """Numpy application of draw_expand_params output."""
    if ep is None:
        return image, boxes
    canvas_h, canvas_w, top, left = ep
    canvas = np.zeros((canvas_h, canvas_w, image.shape[2]), image.dtype)
    canvas[:, :, :] = mean
    canvas[top:top + image.shape[0], left:left + image.shape[1]] = image
    boxes = boxes.copy()
    boxes[:, :2] += (left, top)
    boxes[:, 2:] += (left, top)
    return canvas, boxes


def _expand(rng, image, boxes, mean):
    """Canvas expansion with mean fill (utils/augmentations.py:324-350)."""
    h, w = image.shape[:2]
    return _apply_expand(image, boxes, mean, draw_expand_params(rng, h, w))


_CROP_MODES = (None, (0.1, None), (0.3, None), (0.7, None), (0.9, None),
               (None, None))

_EMPTY_BOXES = np.zeros((0, 4), np.float32)


def draw_crop(rng, height: int, width: int, boxes, labels):
    """IoU-constrained random crop GEOMETRY
    (utils/augmentations.py:220-321): all rng draws and box math, no
    pixel work — shared by the numpy and native backends. Returns
    (rect [x0, y0, x1, y1] or None, boxes, labels); rect=None keeps the
    full image."""
    while True:
        mode = _CROP_MODES[rng.integers(len(_CROP_MODES))]
        if mode is None:
            return None, boxes, labels
        min_iou, max_iou = mode
        min_iou = -np.inf if min_iou is None else min_iou
        max_iou = np.inf if max_iou is None else max_iou

        for _ in range(50):
            w = rng.uniform(0.3 * width, width)
            h = rng.uniform(0.3 * height, height)
            if h / w < 0.5 or h / w > 2:
                continue
            left = rng.uniform(0, width - w)
            top = rng.uniform(0, height - h)
            rect = np.array([int(left), int(top), int(left + w),
                             int(top + h)])
            overlap = _jaccard(boxes, rect)
            if overlap.min() < min_iou and max_iou < overlap.max():
                continue
            centers = (boxes[:, :2] + boxes[:, 2:]) / 2.0
            mask = ((rect[0] < centers[:, 0]) & (rect[1] < centers[:, 1]) &
                    (rect[2] > centers[:, 0]) & (rect[3] > centers[:, 1]))
            if not mask.any():
                continue
            new_boxes = boxes[mask].copy()
            new_boxes[:, :2] = np.maximum(new_boxes[:, :2], rect[:2])
            new_boxes[:, :2] -= rect[:2]
            new_boxes[:, 2:] = np.minimum(new_boxes[:, 2:], rect[2:])
            new_boxes[:, 2:] -= rect[:2]
            return rect, new_boxes, labels[mask]


def _random_sample_crop(rng, image, boxes, labels):
    """IoU-constrained random crop (utils/augmentations.py:220-321)."""
    height, width, _ = image.shape
    rect, boxes, labels = draw_crop(rng, height, width, boxes, labels)
    if rect is not None:
        image = image[rect[1]:rect[3], rect[0]:rect[2], :]
    return image, boxes, labels


class SSDAugmentation:
    """Training augmentation pipeline (utils/augmentations.py:413-431).

    Input: uint8 BGR image, normalized [0,1] corner boxes, labels.
    Output: normalized float32 image (BGR stats, flipped to RGB),
    normalized boxes, labels.
    """

    def __init__(self, size=(416, 416), mean=BGR_MEAN, std=BGR_STD,
                 rgb: bool = True, seed: Optional[int] = None,
                 normalize: bool = True, backend: str = "auto"):
        """``normalize=False`` returns the augmented image as uint8
        (before normalization): a batch then crosses to the card as 1
        byte a value (4x less traffic) and ``detector.normalize_u8``
        normalizes it there. It differs from the float output by the
        round to the 8-bit grid after the resize and the clip of jitter
        overshoot beyond [0, 255].

        ``backend``: 'auto' takes the native C++ pixel path
        (``native/augment.cpp``: one fused pass, the random stream still
        drawn here in numpy) where the library loads, else numpy;
        'numpy' / 'native' force one ('native' raises where the library
        does not load)."""
        if backend not in ("auto", "numpy", "native"):
            raise ValueError(f"backend must be 'auto', 'numpy' or "
                             f"'native', got {backend!r}")
        self.size = tuple(size)
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        self.rgb = rgb
        self.normalize = normalize
        self.backend = backend
        self._native: Optional[bool] = None
        self._shared_rng = np.random.default_rng(seed)
        self._tls = threading.local()

    # The rng is a thread-local-overridable property: BatchLoader workers
    # (thread OR process pools) assign a fresh per-item Generator before
    # each __getitem__ — the assignment lands in that worker's
    # thread-local slot, so concurrent threads never share mutable rng
    # state and batches are deterministic under any scheduling. Direct
    # single-threaded use falls back to the seed-constructed generator.
    @property
    def rng(self):
        r = getattr(self._tls, "rng", None)
        return self._shared_rng if r is None else r

    @rng.setter
    def rng(self, gen):
        self._tls.rng = gen

    def __getstate__(self):
        d = dict(self.__dict__)
        d.pop("_tls", None)
        return d

    def __setstate__(self, d):
        self.__dict__.update(d)
        self._tls = threading.local()

    def _native_ok(self) -> bool:
        if self._native is None:
            if self.backend == "numpy":
                self._native = False
            else:
                from yolo_tpu_torch.utils import native
                self._native = native.available()
                if self.backend == "native" and not self._native:
                    raise RuntimeError(
                        "native augmentation backend unavailable "
                        "(build with: make -C native)")
        return self._native

    def __call__(self, image, boxes, labels):
        rng = self.rng
        height, width = image.shape[:2]
        boxes = np.asarray(boxes, np.float32).copy()
        labels = np.asarray(labels)

        # to absolute coords
        boxes[:, 0::2] *= width
        boxes[:, 1::2] *= height

        # ALL rng draws and box geometry happen here, identically for
        # both backends (the random streams match by construction); only
        # the pixel work differs.
        pp = draw_photometric_params(rng)
        ep = draw_expand_params(rng, height, width)
        if ep is not None:
            eh, ew, top, left = ep
            boxes[:, :2] += (left, top)
            boxes[:, 2:] += (left, top)
        else:
            eh, ew = height, width
        rect, boxes, labels = draw_crop(rng, eh, ew, boxes, labels)
        ch_, cw_ = ((rect[3] - rect[1], rect[2] - rect[0])
                    if rect is not None else (eh, ew))
        mirror = bool(rng.integers(2))
        if mirror:
            boxes = boxes.copy()
            boxes[:, 0::2] = cw_ - boxes[:, 2::-2]
        # back to percent coords
        boxes[:, 0::2] /= cw_
        boxes[:, 1::2] /= ch_

        if image.dtype == np.uint8 and self._native_ok():
            # fused single pass: photometric -> expand -> crop -> mirror
            # -> resize -> normalize/u8, no intermediate canvases
            from yolo_tpu_torch.utils import native
            im = native.augment_one(image, pp, ep, rect, mirror,
                                    self.size, self.mean, self.std,
                                    rgb=self.rgb,
                                    u8_out=not self.normalize)
            return im, boxes, labels

        im = _apply_photometric(image.astype(np.float32), pp)
        im, _ = _apply_expand(im, _EMPTY_BOXES, self.mean, ep)
        if rect is not None:
            im = im[rect[1]:rect[3], rect[0]:rect[2], :]
        if mirror:
            im = im[:, ::-1]
        im = _resize(im, self.size).astype(np.float32)
        if self.normalize:
            im /= 255.0
            im -= self.mean
            im /= self.std
        else:
            im = np.clip(np.rint(im), 0, 255).astype(np.uint8)
        if self.rgb:
            im = to_rgb(im)
        return im, boxes, labels
