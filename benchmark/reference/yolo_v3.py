"""Plain integer forward of YOLOv3 (Redmon & Farhadi, arXiv:1804.02767):
darknet53 (a 3x3 stem, then per stage a stride-2 3x3 and residual blocks
of 1x1 + 3x3 convs with an add, LeakyReLU 0.1) and three heads at strides
32, 16, 8 (five-conv sets of alternating 1x1 and 3x3 convs, a lateral 1x1,
a 2x bilinear align-corners upsample and a concat with the backbone
feature, a 3x3 and a 1x1 prediction conv per scale, LeakyReLU 0.125), on
the fixed-point contract of ``intops``.

Weights: the seeded recipe (``seeded_weights``: uniform draws with torch's
nn.Conv2d bounds from ``np.random.default_rng(seed)``, conv by conv in
program order, quantized per tensor on the power-of-two grid), checked
against the configuration's sha256; tables from its arrays."""

from __future__ import annotations

import hashlib
import math
from typing import List

import numpy as np
import torch

from benchmark.reference import intops
from benchmark.reference.slim_yolo_v2 import narrow_weights


def conv_specs(sizes: dict) -> List[tuple]:
    """(name, k, C_in, C_out, stride, padding, slope) of every conv in
    program order."""
    b_slope, h_slope = sizes["backbone_slope"], True
    specs = [("stem", 3, 3, sizes["stem"], 1, 1, b_slope)]
    c = sizes["stem"]
    for s, (ch, blocks) in enumerate(sizes["stages"]):
        specs.append((f"stage{s}.down", 3, c, ch, 2, 1, b_slope))
        for j in range(blocks):
            specs.append((f"stage{s}.block{j}.a", 1, ch, ch // 2, 1, 0,
                          b_slope))
            specs.append((f"stage{s}.block{j}.b", 3, ch // 2, ch, 1, 1,
                          b_slope))
        c = ch
    widths = sizes["head_widths"]
    feats = [ch for ch, _ in sizes["stages"]][::-1]  # c5, c4, c3
    c_in = feats[0]
    for i, mid in enumerate(widths):
        for j in range(5):
            k = 1 if j % 2 == 0 else 3
            specs.append((f"set{i}.{j}", k, c_in if j == 0 else
                          (mid if k == 3 else 2 * mid),
                          mid if k == 1 else 2 * mid, 1, k // 2, h_slope))
        if i + 1 < len(widths):
            specs.append((f"lateral{i}", 1, mid, mid // 2, 1, 0, h_slope))
            c_in = mid // 2 + feats[i + 1]
    for i, mid in enumerate(widths):
        specs.append((f"extra{i}", 3, mid, 2 * mid, 1, 1, h_slope))
    pred_out = (len(sizes["anchors"]) // len(sizes["strides"])
                * (5 + sizes["num_classes"]))
    for i, mid in enumerate(widths):
        specs.append((f"pred{i}", 1, 2 * mid, pred_out, 1, 0, False))
    return specs


def _pow2(t: np.ndarray):
    """Per-tensor levels and exponent on the power-of-two grid, in
    float32: 2^s is the largest power of two with max|t| 2^s <= 127."""
    max_abs = np.max(np.abs(t))
    if max_abs <= 0:
        return np.zeros_like(t), 0
    s = int(np.floor(np.log2(np.float32(127.0) / max_abs)))
    return np.round(t * np.float32(2.0 ** s)), s


def seeded_weights(sizes: dict, seed: int):
    """-> (w_q int8 HWIO list, b_q int32 list, sw list, sb list, sha256
    over each conv's int8 weight bytes then int32 bias bytes)."""
    rng = np.random.default_rng(seed)
    w_q, b_q, sw, sb = [], [], [], []
    h = hashlib.sha256()
    for _, k, c_in, c_out, *_ in conv_specs(sizes):
        fan_in = c_in * k * k
        bound = math.sqrt(2.0 / 6.0) * math.sqrt(3.0 / fan_in)
        w = rng.uniform(-bound, bound, (k, k, c_in, c_out)).astype(np.float32)
        b = rng.uniform(-1 / math.sqrt(fan_in), 1 / math.sqrt(fan_in),
                        (c_out,)).astype(np.float32)
        wl, ws = _pow2(w)
        bl, bs = _pow2(b)
        w_q.append(np.clip(wl, -128, 127).astype(np.int8))
        b_q.append(np.clip(bl, -128, 127).astype(np.int32))
        sw.append(ws)
        sb.append(bs)
        h.update(np.ascontiguousarray(w_q[-1]).tobytes())
        h.update(np.ascontiguousarray(b_q[-1]).tobytes())
    return w_q, b_q, sw, sb, h.hexdigest()


class Model:
    """The integer model on ``device``. ``weights``: ``seeded_weights``'
    first four lists; ``tables``: ``sa_in``, ``tap_sa`` (one scale per conv
    output and per residual sum, in program order), ``retune``."""

    def __init__(self, sizes: dict, weights, tables, device,
                 weight_bits: int = 8):
        self.sizes = sizes
        self.specs = conv_specs(sizes)
        self.sa_in = int(tables["sa_in"])
        self.tap_sa = [int(v) for v in np.asarray(tables["tap_sa"])]
        retune = [int(v) for v in np.asarray(tables["retune"])]
        w_q, b_q, sw, sb = weights
        self.convs = []
        for i, spec in enumerate(self.specs):
            w, s = narrow_weights(torch.as_tensor(w_q[i]).to(torch.int64),
                                  int(sw[i]), weight_bits)
            self.convs.append((w.to(device), torch.as_tensor(b_q[i]).to(
                device), dict(sw=s, sb=int(sb[i]), retune=retune[i])))

    def heads(self, x: torch.Tensor):
        """int8 NHWC images -> [(int8 head, scale)] at strides 8, 16, 32."""
        convs, taps = iter(zip(self.specs, self.convs)), iter(self.tap_sa)

        def conv(parts):
            (_, _, _, _, stride, pad, slope), (w, b, p) = next(convs)
            sa = next(taps)
            return intops.conv_requant(parts, w, b, stride=stride,
                                       padding=pad, slope=slope, sa_out=sa,
                                       **p), sa

        t = conv([(x, self.sa_in)])
        feats = []
        for _, blocks in self.sizes["stages"]:
            t = conv([t])
            for _ in range(blocks):
                y = conv([conv([t])])
                sa = next(taps)
                t = (intops.add_requant(*y, *t, sa), sa)
            feats.append(t)
        feats = feats[::-1][:3]  # c5, c4, c3
        widths = self.sizes["head_widths"]
        t, sets = feats[0], []
        for i in range(len(widths)):
            parts = [t] if i == 0 else [feats[i], t]
            for j in range(5):
                t = conv(parts)
                parts = [t]
            sets.append(t)
            if i + 1 < len(widths):
                lat, sa = conv([t])
                t = (intops.upsample2x(lat), sa)
        extras = [conv([s]) for s in sets]
        preds = [conv([e]) for e in extras]
        return preds[::-1]  # strides 8, 16, 32


def layers(sizes: dict):
    """(name, k, C_in, C_out, stride, H at the input, pooled, residual) of
    every conv in program order, for the op and byte counts; a residual
    block's 3x3 also reads the block's input for the add."""
    h = sizes["input_size"]
    n_sets = len(sizes["head_widths"])
    at = {f"set{i}": h // sizes["strides"][::-1][i] for i in range(n_sets)}
    out = []
    for name, k, c_in, c_out, stride, _, _ in conv_specs(sizes):
        part = name.split(".")[0]
        if part == "stem":
            hi = h
        elif name.endswith(".down"):
            hi = h
            h //= 2
        elif part.startswith("stage"):
            hi = h
        else:  # set<i>, lateral<i>, extra<i>, pred<i> at head i's grid
            hi = at[f"set{part[-1]}"]
        out.append((name, k, c_in, c_out, stride, hi, False,
                    name.endswith(".b") and part.startswith("stage")))
    return out
