"""Carry an integer model across from the JAX package, and save / load it.

``int8_model_from_numpy`` takes the fields of a ``yolo_tpu`` ``Int8Model``
after ``jax.device_get`` (numpy arrays and ints) and returns the port's
``Int8Model``; the npz round trip stores the same fields under
``<field>.<layer>`` keys. ``int8_yolo_v3_from_numpy`` and its npz round
trip do the same for ``Int8YoloV3``, whose per-conv lists are keyed by
conv index. Layouts stay the JAX package's (HWIO weights).
"""

from __future__ import annotations

import hashlib
from typing import Dict, Mapping, Sequence

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


# ---------------------------------------------------------------------------
# yolo_v3: Int8YoloV3 (per-conv lists in program order).
# ---------------------------------------------------------------------------

_V3_LISTS = ("sw", "sb", "retune")


def int8_yolo_v3_from_numpy(w_q: Sequence, b_q: Sequence, sw: Sequence,
                            sb: Sequence, sa_in, tap_sa: Sequence,
                            retune: Sequence, spp: bool = False,
                            device="cuda"):
    """The fields of a JAX ``Int8YoloV3`` after ``jax.device_get`` (numpy
    int8 HWIO weights, int8-valued biases, exponent lists) -> the port's
    ``Int8YoloV3`` on ``device``."""
    from yolo_tpu_torch.quant.int8_yolo_v3 import Int8YoloV3

    dev = resolve_device(device)
    return Int8YoloV3(
        spp=bool(spp),
        w_q=[torch.as_tensor(np.asarray(w).astype(np.int8)).to(dev)
             for w in w_q],
        b_q=[torch.as_tensor(np.asarray(b).astype(np.int32)).to(dev)
             for b in b_q],
        sw=[_exponent(v) for v in sw], sb=[int(v) for v in sb],
        sa_in=int(sa_in), tap_sa=[int(v) for v in tap_sa],
        retune=[int(v) for v in retune])


def int8_yolo_v3_tables(m) -> Dict[str, np.ndarray]:
    """The model's exponent tables as {'sw', 'sb', 'retune': [n convs],
    'tap_sa': [n taps] int32, 'sa_in', 'spp'} (per-tensor sw only)."""
    return {"sa_in": np.int32(m.sa_in), "spp": np.bool_(m.spp),
            **{field: np.asarray(getattr(m, field), np.int32)
               for field in _V3_LISTS + ("tap_sa",)}}


def _v3_tables_from_arrays(arrays: Mapping[str, np.ndarray]) -> dict:
    return {"sa_in": int(arrays["sa_in"]), "spp": bool(arrays["spp"]),
            **{field: [int(v) for v in arrays[field]]
               for field in _V3_LISTS + ("tap_sa",)}}


def save_int8_yolo_v3_npz(path, m, **extra: np.ndarray) -> None:
    """Write the model's weights ('w_q.<i>', 'b_q.<i>') and tables (and
    any ``extra`` arrays) to a compressed npz."""
    arrays = {f"w_q.{i}": w.cpu().numpy() for i, w in enumerate(m.w_q)}
    arrays.update({f"b_q.{i}": b.cpu().numpy() for i, b in enumerate(m.b_q)})
    np.savez_compressed(path, **arrays, **int8_yolo_v3_tables(m), **extra)


def load_int8_yolo_v3_npz(path, device="cuda"):
    with np.load(path) as z:
        n = sum(1 for k in z.files if k.startswith("w_q."))
        return int8_yolo_v3_from_numpy(
            [z[f"w_q.{i}"] for i in range(n)],
            [z[f"b_q.{i}"] for i in range(n)],
            device=device, **_v3_tables_from_arrays(z))


def weights_sha256(w_q: Sequence, b_q: Sequence) -> str:
    """sha256 over every conv's int8 weight bytes then int32 bias bytes,
    in program order: the checksum of the seeded golden weights."""
    h = hashlib.sha256()
    for w, b in zip(w_q, b_q):
        h.update(np.ascontiguousarray(np.asarray(w, np.int8)).tobytes())
        h.update(np.ascontiguousarray(np.asarray(b, np.int32)).tobytes())
    return h.hexdigest()


def int8_yolo_v3_from_seed(arrays: Mapping[str, np.ndarray], device="cuda"):
    """The yolo_v3 golden fixture's model: int8 weights rebuilt from the
    seed it names (``seeded_fused_params`` + ``quantize_weights``), checked
    against its ``wb_sha256``, with its calibrated tables."""
    from yolo_tpu_torch.quant.int8_yolo_v3 import (
        quantize_weights, seeded_fused_params)

    fused = seeded_fused_params(int(arrays["weight_seed"]),
                                int(arrays["pred_out"]))
    w_q, b_q, sw, sb = quantize_weights(fused)
    digest = weights_sha256(w_q, b_q)
    if digest != str(arrays["wb_sha256"]):
        raise ValueError(f"the weights rebuilt from seed "
                         f"{int(arrays['weight_seed'])} do not match the "
                         f"fixture: sha256 {digest} != "
                         f"{arrays['wb_sha256']}")
    tables = _v3_tables_from_arrays(arrays)
    if tables["sw"] != sw or tables["sb"] != sb:
        raise ValueError("the fixture's sw / sb tables differ from the "
                         "rebuilt weights' exponents")
    return int8_yolo_v3_from_numpy(w_q, b_q, device=device, **tables)
