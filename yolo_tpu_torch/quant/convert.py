"""Carry an integer model across from the JAX package, and save / load it.

``int8_model_from_numpy`` takes the fields of a ``yolo_tpu`` ``Int8Model``
after ``jax.device_get`` (numpy arrays and ints) and returns the port's
``Int8Model``; the npz round trip stores the same fields under
``<field>.<layer>`` keys. Layouts stay the JAX package's (HWIO weights).
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from yolo_tpu_torch.quant.fixed_point import Int8Model, resolve_device

_TABLES = ("sw", "sb", "sa", "retune")


def _exponent(v):
    """An int, or (per-channel) an int32 numpy array."""
    return int(v) if np.ndim(v) == 0 else np.asarray(v, np.int32)


def int8_model_from_numpy(w_q: Mapping, b_q: Mapping, sw: Mapping,
                          sb: Mapping, sa: Mapping, retune: Mapping,
                          device="cuda") -> Int8Model:
    """numpy weights (int8 HWIO), biases (int8-valued) and exponent tables
    -> the port's Int8Model on ``device``."""
    dev = resolve_device(device)

    def tensors(d: Mapping, dtype) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(np.asarray(v).astype(dtype)).to(dev)
                for k, v in d.items()}

    return Int8Model(
        w_q=tensors(w_q, np.int8), b_q=tensors(b_q, np.int32),
        sw={k: _exponent(v) for k, v in sw.items()},
        sb={k: _exponent(v) for k, v in sb.items()},
        sa={k: _exponent(v) for k, v in sa.items()},
        retune={k: _exponent(v) for k, v in retune.items()})


def int8_model_arrays(m: Int8Model) -> Dict[str, np.ndarray]:
    """The model as a flat {'<field>.<layer>': array} dict."""
    out = {}
    for k, v in m.w_q.items():
        out[f"w_q.{k}"] = v.cpu().numpy()
    for k, v in m.b_q.items():
        out[f"b_q.{k}"] = v.cpu().numpy()
    for field in _TABLES:
        for k, v in getattr(m, field).items():
            out[f"{field}.{k}"] = np.asarray(v, np.int32)
    return out


def int8_model_from_arrays(arrays: Mapping[str, np.ndarray],
                           device="cuda") -> Int8Model:
    """Inverse of int8_model_arrays; keys of other fields are ignored."""
    fields = {f: {} for f in ("w_q", "b_q") + _TABLES}
    for key, v in arrays.items():
        field, _, layer = key.partition(".")
        if field in fields and layer:
            fields[field][layer] = v
    return int8_model_from_numpy(device=device, **fields)


def save_int8_model_npz(path, m: Int8Model, **extra: np.ndarray) -> None:
    """Write the model (and any ``extra`` arrays under their own keys) to a
    compressed npz."""
    np.savez_compressed(path, **int8_model_arrays(m), **extra)


def load_int8_model_npz(path, device="cuda") -> Int8Model:
    with np.load(path) as z:
        return int8_model_from_arrays({k: z[k] for k in z.files}, device)
