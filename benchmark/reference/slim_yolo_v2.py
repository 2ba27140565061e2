"""Plain integer forward of slim_yolo_v2 (the FPGA target of
https://github.com/ZLkanyo009/Yolo-compression-and-deployment-in-FPGA,
``models/slim_yolo_v2.py``): nine 3x3 conv + LeakyReLU(0.125) layers with
2x2 max pools after the layers the configuration marks, and a 3x3
prediction conv without activation, all on the fixed-point contract of
``intops``. Weights and tables come from the configuration's arrays."""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import intops


class Model:
    """The integer model of one configuration, on ``device``.

    ``sizes``: the configuration's JSON (``layers``: [name, C_in, C_out,
    pool] of the nine backbone convs; the prediction conv maps the last
    width to anchors * (5 + classes)); ``arrays``: ``w_q.<name>`` int8
    HWIO, ``b_q.<name>``, and the exponents ``sw.<name>``, ``sb.<name>``,
    ``retune.<name>``, ``sa.in``, ``sa.<name>``."""

    def __init__(self, sizes: dict, arrays, device, weight_bits: int = 8):
        self.layers = [tuple(v) for v in sizes["layers"]]
        pred_out = len(sizes["anchors"]) * (5 + sizes["num_classes"])
        self.layers.append(("pred", self.layers[-1][2], pred_out, False))
        self.sa_in = int(arrays["sa.in"])
        self.params = []
        sa = self.sa_in
        for name, c_in, c_out, pool in self.layers:
            w = torch.as_tensor(np.asarray(arrays[f"w_q.{name}"]))
            if tuple(w.shape) != (3, 3, c_in, c_out):
                raise ValueError(f"{name}: weights {tuple(w.shape)}, the "
                                 f"configuration says 3x3 {c_in} -> {c_out}")
            sw = int(arrays[f"sw.{name}"])
            w, sw = narrow_weights(w.to(torch.int64), sw, weight_bits)
            p = dict(sw=sw, sb=int(arrays[f"sb.{name}"]),
                     retune=int(arrays[f"retune.{name}"]),
                     sa_out=int(arrays[f"sa.{name}"]))
            b = torch.as_tensor(np.asarray(arrays[f"b_q.{name}"]))
            self.params.append((name, w.to(device), b.to(device), sa, p,
                                pool))
            sa = p["sa_out"]
        self.sa_pred = sa

    def heads(self, x: torch.Tensor):
        """int8 NHWC images -> [the int8 head, its scale exponent]."""
        for name, w, b, sa_in, p, pool in self.params:
            x = intops.conv_requant([(x, sa_in)], w, b, stride=1, padding=1,
                                    slope=name != "pred", **p)
            if pool:
                x = intops.maxpool2(x)
        return [(x, self.sa_pred)]


def narrow_weights(w: torch.Tensor, sw: int, bits: int):
    """int8 weights at 2^sw -> the same weights at ``bits`` bits (the
    control's lower precision): shifted right by 8 - bits, rounded half
    away from zero, clamped, at 2^(sw - 8 + bits)."""
    if bits == 8:
        return w, sw
    d = 8 - bits
    lo, hi = -(1 << (bits - 1)), (1 << (bits - 1)) - 1
    return torch.clamp(intops.shift(w, d), lo, hi), sw - d


def layers(sizes: dict):
    """(name, k, C_in, C_out, stride, H at the input, pooled, residual) of
    every conv, for the op and byte counts."""
    h, out = sizes["input_size"], []
    pred_out = len(sizes["anchors"]) * (5 + sizes["num_classes"])
    for name, c_in, c_out, pool in [tuple(v) for v in sizes["layers"]] + [
            ("pred", sizes["layers"][-1][2], pred_out, False)]:
        out.append((name, 3, c_in, c_out, 1, h, pool, False))
        h = h // 2 if pool else h
    return out
