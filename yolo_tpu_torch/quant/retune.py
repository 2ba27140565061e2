"""Exponent-table export (counterpart of ``export_tables`` and
``export_c_header`` in ``yolo_tpu/quant/retune.py``): the per-layer
scale_w / scale_b / scale_a / retune tables and int8 weights that the
reference C engine consumes. ``retune_finetune`` waits for the port's
trainer."""

from __future__ import annotations

from typing import Dict

import numpy as np

from yolo_tpu_torch.quant.fixed_point import Int8Model
from yolo_tpu_torch.quant.qsim import QUANT_LAYER_NAMES, TRACKER_NAMES

# The header's first line: the JAX package's own, so that both packages
# write byte-identical headers for one model.
HEADER_LINE = "// generated by yolo_tpu.quant.retune.export_c_header"


def export_tables(m: Int8Model) -> Dict[str, list]:
    """The four exponent tables in C-engine layer order; ValueError for a
    model with per-channel weight scales (weight.h holds one scale_w per
    layer)."""
    if m.per_channel:
        raise ValueError(
            "per-channel weight scales cannot export to the shift-chain "
            "weight.h contract (one scale_w entry per layer, "
            "c_embedding/yolo_forward.c:32); rebuild the pipeline with "
            "per_channel=False for embedded deployment")
    return {
        "scale_w": [int(m.sw[n]) for n in QUANT_LAYER_NAMES],
        "scale_b": [int(m.sb[n]) for n in QUANT_LAYER_NAMES],
        "scale_a": [int(m.sa[n]) for n in TRACKER_NAMES],
        "retune": [int(m.retune[n]) for n in QUANT_LAYER_NAMES],
    }


def c_header(m: Int8Model) -> str:
    """The weight.h text: exponent tables, then each layer's int8 weights
    (OIHW order, the embedded engine's layout) and biases."""
    t = export_tables(m)
    lines = [HEADER_LINE, ""]
    for name in ("scale_w", "scale_b", "retune", "scale_a"):
        vals = ", ".join(str(v) for v in t[name])
        lines.append(f"const char {name}[{len(t[name])}] = {{{vals}}};")
    lines.append("")
    for i, layer in enumerate(QUANT_LAYER_NAMES):
        w = m.w_q[layer].cpu().numpy()  # HWIO
        oihw = np.transpose(w, (3, 2, 0, 1)).ravel()
        b = m.b_q[layer].cpu().numpy().astype(np.int8)
        lines.append(
            f"const signed char weight_{i}[{oihw.size}] = "
            f"{{{', '.join(str(int(v)) for v in oihw)}}};")
        lines.append(
            f"const signed char bias_{i}[{b.size}] = "
            f"{{{', '.join(str(int(v)) for v in b)}}};")
    return "\n".join(lines) + "\n"


def export_c_header(m: Int8Model, path: str) -> None:
    """Write ``c_header(m)`` to ``path``."""
    with open(path, "w") as f:
        f.write(c_header(m))
