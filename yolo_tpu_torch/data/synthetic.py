"""Synthetic detection dataset: colored shapes on noise backgrounds
(counterpart of ``yolo_tpu/data/synthetic.py``: the same arrays for the
same ``(size, num_classes, length, seed, hard)``).

Deterministic data with known ground truth and no download, for the
tests, the evaluation CLIs and ``chip_smoke.py``. Two regimes:

- ``hard=False``: 1..max_objects large solid rectangles on faint noise.
- ``hard=True``: crowded scenes (1..10 objects, down to ~6% linear
  size, log-uniform sizes, aspect jitter, overlaps in draw order),
  rectangles and ellipses with per-instance color jitter, gray
  distractor shapes, textured backgrounds with illumination gradients,
  global brightness / contrast jitter and pixel noise. Classes stay
  color-coded (saturated colors with a channel spread gray distractors
  cannot reach).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _class_colors(num_classes: int) -> np.ndarray:
    """Saturated, mutually distinct class colors with a channel spread of
    at least 70 (max - min channel), so near-gray distractors never
    collide with a class color."""
    rng = np.random.default_rng(1234)
    colors = []
    while len(colors) < num_classes:
        c = rng.integers(32, 255, 3)
        if int(c.max()) - int(c.min()) < 70:
            continue
        if any(np.abs(c - p).sum() < 120 for p in colors):
            continue
        colors.append(c)
    return np.asarray(colors)


class SyntheticDetection:
    """Images with 1..max_objects colored shapes; class = color index.

    Each index draws from its own generator (``seed * 100003 + index``);
    with ``cache`` the raw samples are kept, and copies handed out."""

    def __init__(self, size: Tuple[int, int] = (240, 320),
                 num_classes: int = 2, length: int = 64,
                 max_objects: int = None, transform=None, seed: int = 0,
                 hard: bool = False, cache: bool = True):
        self.size = size
        self.num_classes = num_classes
        self.length = length
        self.max_objects = max_objects or (10 if hard else 3)
        self.transform = transform
        self.seed = seed
        self.hard = hard
        self._cache = {} if cache else None
        self.name = "synthetic-hard" if hard else "synthetic"
        # distinct colors per class (BGR, uint8)
        if hard:
            self.colors = _class_colors(num_classes)
        else:
            rng = np.random.default_rng(1234)
            self.colors = rng.integers(64, 255, (num_classes, 3))

    def __len__(self):
        return self.length

    def _make_easy(self, rng, h, w):
        img = (rng.random((h, w, 3)) * 40).astype(np.uint8)
        n = int(rng.integers(1, self.max_objects + 1))
        boxes, labels = [], []
        for _ in range(n):
            bw = rng.uniform(0.15, 0.5) * w
            bh = rng.uniform(0.15, 0.5) * h
            x1 = rng.uniform(0, w - bw)
            y1 = rng.uniform(0, h - bh)
            cls = int(rng.integers(0, self.num_classes))
            img[int(y1):int(y1 + bh), int(x1):int(x1 + bw)] = \
                self.colors[cls]
            boxes.append([x1 / w, y1 / h, (x1 + bw) / w, (y1 + bh) / h])
            labels.append(cls)
        return img, np.asarray(boxes, np.float32), np.asarray(labels)

    @staticmethod
    def _shape_mask(rng, bh: int, bw: int, kind: str) -> np.ndarray:
        """Boolean [bh, bw] footprint filling most of its bounding box."""
        if kind == "rect":
            return np.ones((bh, bw), bool)
        yy, xx = np.mgrid[0:bh, 0:bw].astype(np.float32)
        cy, cx = (bh - 1) / 2.0, (bw - 1) / 2.0
        if kind == "ellipse":
            m = (((yy - cy) / max(cy, 0.5)) ** 2 +
                 ((xx - cx) / max(cx, 0.5)) ** 2) <= 1.0
        else:  # "bar": a rotated thick stripe through the center
            ang = rng.uniform(0, np.pi)
            d = np.abs((yy - cy) * np.cos(ang) - (xx - cx) * np.sin(ang))
            m = d <= max(1.0, 0.25 * min(bh, bw))
        # a tight bbox: each edge row / column has a pixel on
        if not m[0].any():
            m[0, int(cx)] = True
        if not m[-1].any():
            m[-1, int(cx)] = True
        if not m[:, 0].any():
            m[int(cy), 0] = True
        if not m[:, -1].any():
            m[int(cy), -1] = True
        return m

    def _paste(self, img, rng, bh, bw, y1, x1, color, kind):
        mask = self._shape_mask(rng, bh, bw, kind)
        region = img[y1:y1 + bh, x1:x1 + bw]
        region[mask] = np.clip(color, 0, 255).astype(np.uint8)

    def _make_hard(self, rng, h, w):
        # textured background: noise + a random illumination gradient
        base = rng.uniform(20, 110)
        amp = rng.uniform(10, 45)
        img = base + rng.random((h, w, 3)) * amp
        gy, gx = rng.uniform(-40, 40), rng.uniform(-40, 40)
        ramp = (np.linspace(0, 1, h)[:, None] * gy +
                np.linspace(0, 1, w)[None, :] * gx)
        img = np.clip(img + ramp[..., None], 0, 255)

        # gray distractor shapes (channel spread ~0: never a class color)
        for _ in range(int(rng.integers(0, 5))):
            s = np.exp(rng.uniform(np.log(0.06), np.log(0.4)))
            bh = max(3, int(s * rng.uniform(0.6, 1.6) * h))
            bw = max(3, int(s * rng.uniform(0.6, 1.6) * w))
            bh, bw = min(bh, h - 1), min(bw, w - 1)
            y1 = int(rng.integers(0, h - bh))
            x1 = int(rng.integers(0, w - bw))
            g = rng.uniform(30, 225)
            color = g + rng.uniform(-8, 8, 3)
            kind = ("rect", "ellipse", "bar")[int(rng.integers(0, 3))]
            self._paste(img, rng, bh, bw, y1, x1, color, kind)

        # class objects: log-uniform size, aspect jitter, overlaps, rect
        # or ellipse footprint, per-instance color jitter
        n = int(rng.integers(1, self.max_objects + 1))
        boxes, labels = [], []
        min_px = 4
        for _ in range(n):
            s = np.exp(rng.uniform(np.log(0.06), np.log(0.45)))
            ar = np.exp(rng.uniform(np.log(0.5), np.log(2.0)))
            bh = int(np.clip(s * np.sqrt(ar) * h, min_px, h - 1))
            bw = int(np.clip(s / np.sqrt(ar) * w, min_px, w - 1))
            y1 = int(rng.integers(0, h - bh))
            x1 = int(rng.integers(0, w - bw))
            cls = int(rng.integers(0, self.num_classes))
            color = self.colors[cls] + rng.uniform(-20, 20, 3)
            kind = "rect" if rng.random() < 0.6 else "ellipse"
            self._paste(img, rng, bh, bw, y1, x1, color, kind)
            boxes.append([x1 / w, y1 / h, (x1 + bw) / w, (y1 + bh) / h])
            labels.append(cls)

        # global photometric jitter + pixel noise (mild enough that the
        # jittered class colors stay nearest to their own class)
        img = img * rng.uniform(0.8, 1.2) + rng.uniform(-18, 18)
        img = img + rng.normal(0, 6, img.shape)
        img = np.clip(img, 0, 255).astype(np.uint8)
        return img, np.asarray(boxes, np.float32), np.asarray(labels)

    def _make(self, index):
        if self._cache is not None:
            hit = self._cache.get(index)
            if hit is not None:
                img, boxes, labels = hit
                # consumers may write into what they get: copies
                return img.copy(), boxes.copy(), labels.copy()
        rng = np.random.default_rng(self.seed * 100003 + index)
        h, w = self.size
        out = (self._make_hard(rng, h, w) if self.hard
               else self._make_easy(rng, h, w))
        if self._cache is not None:
            self._cache[index] = out
            img, boxes, labels = out
            return img.copy(), boxes.copy(), labels.copy()
        return out

    def __getitem__(self, index):
        im, gt, _, _ = self.pull_item(index)
        return im, gt

    def pull_item(self, index):
        """-> (image, transformed if a transform is set; target [N, 5]
        normalized boxes + label; original h; original w)."""
        img, boxes, labels = self._make(index)
        h, w = img.shape[:2]
        if self.transform is not None:
            img, boxes, labels = self.transform(img, boxes, labels)
        target = np.hstack((boxes, labels[:, None].astype(np.float32)))
        return img, target, h, w

    def pull_image(self, index):
        img, _, _ = self._make(index)
        return img, ("synthetic", str(index))

    def pull_anno(self, index):
        _, boxes, labels = self._make(index)
        return str(index), np.hstack(
            (boxes, labels[:, None].astype(np.float32))).tolist()
