"""Synthetic camera frames drawn on the device from a generator, in bulk,
then preprocessed as the server preprocesses a frame.

The scene is the recipe of the port's synthetic data set in its hard
regime (``yolo_tpu_torch/data/synthetic.py``, ``hard=True``): a textured
background (a level, uniform texture and an illumination gradient), gray
distractor shapes (rectangles, ellipses, rotated bars), then the objects,
rectangles or ellipses in the jittered color of their class, drawn over
each other in order, and last a global gain and offset and Gaussian pixel
noise; 8-bit BGR. Every per-frame draw is a tensor over the frames, so a
pool of hundreds of 416 x 416 frames takes milliseconds on the card. The
traffic mix's ``images`` block sets the counts, sizes, colors and noise;
the configuration's ``input_norm`` the normalization.

The preprocess is the serving pipeline's ``BaseTransform``: /255, minus
the BGR mean, over the BGR std, BGR -> RGB."""

from __future__ import annotations

import math

import torch

CHUNK = 32  # frames drawn at a time: bounds the float temporaries


def _uniform(g, n, lo, hi, device, *shape):
    return lo + (hi - lo) * torch.rand((n, *shape), generator=g,
                                       device=device)


def _log_uniform(g, n, lo, hi, device):
    return torch.exp(_uniform(g, n, math.log(lo), math.log(hi), device))


def _paint(img, grid, box, color, kind, angle, active):
    """Frames ``img`` [n, S, S, 3] with one shape a frame drawn over them:
    ``box`` (y1, x1, bh, bw) [n] each, ``kind`` 0 rectangle, 1 ellipse,
    2 bar through the centre at ``angle``; frames not ``active`` keep
    theirs."""
    yy, xx = grid
    y1, x1, bh, bw = (t.view(-1, 1, 1) for t in box)
    inside = (yy >= y1) & (yy < y1 + bh) & (xx >= x1) & (xx < x1 + bw)
    cy, cx = y1 + (bh - 1) / 2, x1 + (bw - 1) / 2
    ry = torch.clamp((bh - 1) / 2, min=0.5)
    rx = torch.clamp((bw - 1) / 2, min=0.5)
    ellipse = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1.0
    a = angle.view(-1, 1, 1)
    bar = (torch.abs((yy - cy) * torch.cos(a) - (xx - cx) * torch.sin(a))
           <= torch.clamp(0.25 * torch.minimum(bh, bw), min=1.0))
    k = kind.view(-1, 1, 1)
    shape = torch.where(k == 0, True, torch.where(k == 1, ellipse, bar))
    m = inside & shape & active.view(-1, 1, 1)
    color = torch.floor(torch.clamp(color, 0, 255))
    return torch.where(m[..., None], color.view(-1, 1, 1, 3), img)


def _box(g, n, size, bh, bw, lo, device):
    """Integer heights and widths clipped to [lo, size - 1] and a top-left
    corner drawn uniformly where the box fits."""
    bh = torch.clamp(torch.floor(bh), lo, size - 1)
    bw = torch.clamp(torch.floor(bw), lo, size - 1)
    y1 = torch.floor(torch.rand(n, generator=g, device=device) * (size - bh))
    x1 = torch.floor(torch.rand(n, generator=g, device=device) * (size - bw))
    return y1, x1, bh, bw


def frames(g, n: int, size: int, spec: dict, device) -> torch.Tensor:
    """``n`` BGR frames [n, size, size, 3], float32 holding 8-bit values."""
    u = lambda lo, hi, *shape: _uniform(g, n, lo, hi, device, *shape)  # noqa: E731
    img = (u(20, 110)[:, None, None, None]
           + torch.rand((n, size, size, 3), generator=g, device=device)
           * u(10, 45)[:, None, None, None])
    lin = torch.linspace(0, 1, size, device=device)
    ramp = (lin.view(1, -1, 1) * u(-40, 40).view(-1, 1, 1)
            + lin.view(1, 1, -1) * u(-40, 40).view(-1, 1, 1))
    img = torch.clamp(img + ramp[..., None], 0, 255)
    ax = torch.arange(size, device=device, dtype=torch.float32)
    grid = (ax.view(1, -1, 1), ax.view(1, 1, -1))

    lo, hi = spec["distractors"]
    count = torch.randint(lo, hi + 1, (n,), generator=g, device=device)
    for k in range(hi):
        s = _log_uniform(g, n, *spec["distractor_scale"], device)
        box = _box(g, n, size, s * u(0.6, 1.6) * size,
                   s * u(0.6, 1.6) * size, 3, device)
        color = u(30, 225)[:, None] + u(-8, 8, 3)
        kind = torch.randint(0, 3, (n,), generator=g, device=device)
        img = _paint(img, grid, box, color, kind, u(0, math.pi), k < count)

    colors = torch.tensor(spec["class_colors_bgr"], dtype=torch.float32,
                          device=device)
    lo, hi = spec["objects"]
    count = torch.randint(lo, hi + 1, (n,), generator=g, device=device)
    for k in range(hi):
        s = _log_uniform(g, n, *spec["object_scale"], device)
        root = torch.sqrt(_log_uniform(g, n, *spec["object_aspect"], device))
        box = _box(g, n, size, s * root * size, s / root * size, 4, device)
        cls = torch.randint(0, len(colors), (n,), generator=g, device=device)
        color = colors[cls] + u(-20, 20, 3)
        kind = (torch.rand(n, generator=g, device=device)
                >= spec["rect_share"]).to(torch.int64)
        img = _paint(img, grid, box, color, kind, torch.zeros(n, device=device),
                     k < count)

    img = img * u(0.8, 1.2).view(-1, 1, 1, 1) + u(-18, 18).view(-1, 1, 1, 1)
    img = img + spec["noise_sd"] * torch.randn(img.shape, generator=g,
                                               device=device)
    return torch.floor(torch.clamp(img, 0, 255))


def preprocess(bgr: torch.Tensor, norm: dict) -> torch.Tensor:
    """8-bit BGR frames -> the model's normalized RGB float input."""
    mean = torch.tensor(norm["bgr_mean"], dtype=torch.float32,
                        device=bgr.device)
    std = torch.tensor(norm["bgr_std"], dtype=torch.float32,
                       device=bgr.device)
    return ((bgr / 255.0 - mean) / std).flip(-1)
