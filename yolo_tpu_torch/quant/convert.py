"""Carry an integer model across from the JAX package, and save / load it.

``int8_model_from_numpy`` takes the fields of a ``yolo_tpu`` ``Int8Model``
after ``jax.device_get`` (numpy arrays and ints; a per-channel sw as an
int32 [C_out] array) and returns the port's ``Int8Model``; the npz round
trip stores the same fields under ``<field>.<layer>`` keys.
``int8_model_from_seed`` rebuilds the per-channel slim golden fixture's
model from its seed and tables. ``int8_yolo_v3_from_numpy`` and its npz round
trip do the same for ``Int8YoloV3``, whose per-conv lists are keyed by
conv index (a per-channel sw under ``sw.<i>``), and
``int8_yolo_v3_from_seed`` rebuilds either yolo_v3 golden fixture's model.
Layouts stay the JAX package's (HWIO weights).

tiny_yolo_v3's ``Int8Tiny`` and yolo_v2's ``Int8YoloV2`` are keyed by
conv name as slim's model is: ``int8_tiny_from_numpy`` /
``int8_yolo_v2_from_numpy`` take a JAX model's fields after
``jax.device_get``, ``int8_model_arrays`` gives their tables under the same
``<field>.<name>`` keys, and ``int8_tiny_from_seed`` /
``int8_yolo_v2_from_seed`` rebuild their golden fixtures' models from the
seeded weights of ``tiny_seeded_fused_params`` /
``yolo_v2_seeded_fused_params``.

The float models cross too: ``module_to_params`` gives a model's
parameters as the JAX package's tree (numpy, HWIO weights, 'bn' dicts in
the BN form), ``load_params`` loads such a tree (the one ``init_params``
or ``fold_batch_norm`` returns there) into a model, and
``slim_from_params`` / ``yolo_v3_from_params`` / ``tiny_from_params`` /
``yolo_v2_from_params`` build the model in the tree's form and load it.
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict, Mapping, Sequence

import numpy as np
import torch
from torch import nn

from yolo_tpu_torch.models.slim_yolo_v2 import CONV_LAYERS, SlimYOLOv2
from yolo_tpu_torch.models.tiny_yolo_v3 import TinyYOLOv3
from yolo_tpu_torch.models.yolo_v2 import YOLOv2
from yolo_tpu_torch.models.yolo_v3 import YOLOv3
from yolo_tpu_torch.models.yolo_v3_spp import YOLOv3SPP
from yolo_tpu_torch.ops.blocks import Conv
from yolo_tpu_torch.quant.fixed_point import (
    INT8_MAX, INT8_MIN, Int8Model, resolve_device)
from yolo_tpu_torch.quant.qsim import QUANT_LAYER_NAMES
from yolo_tpu_torch.quant.quantize import quantize_pow2_np

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


def int8_model_arrays(m) -> Dict[str, np.ndarray]:
    """The model (an ``Int8Model``, ``Int8Tiny`` or ``Int8YoloV2``) as a
    flat {'<field>.<layer>': array} dict."""
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


def slim_seeded_fused_params(seed: int, pred_out: int) -> dict:
    """BN-fused float slim_yolo_v2 params {layer: {'w': HWIO, 'b':
    [C_out]}} (the tree ``fold_batch_norm`` returns), drawn from
    ``np.random.default_rng(seed)`` layer by layer with the kaiming-uniform
    bounds of ``blocks.init_conv`` (torch's nn.Conv2d defaults), each
    output channel's weights then scaled by 2^-u, u drawn per channel from
    {0, 1, 2, 3}: channels whose pow2 exponents differ, so that a
    per-channel sw holds several values (uniform random weights give every
    channel the per-tensor exponent)."""
    rng = np.random.default_rng(seed)
    params = {}
    for name, c_in, c_out, _ in CONV_LAYERS + (("pred", 256, pred_out,
                                                 False),):
        fan_in = 9 * c_in
        bound = math.sqrt(2.0 / 6.0) * math.sqrt(3.0 / fan_in)
        b_bound = 1.0 / math.sqrt(fan_in)
        w = rng.uniform(-bound, bound, (3, 3, c_in, c_out)).astype(np.float32)
        b = rng.uniform(-b_bound, b_bound, (c_out,)).astype(np.float32)
        u = rng.integers(0, 4, c_out)
        params[name] = {"w": w * np.exp2(-u).astype(np.float32), "b": b}
    return params


def slim_seeded_bn_params(seed: int, pred_out: int) -> dict:
    """Float slim_yolo_v2 params in the BN form {layer: {'w': HWIO, 'bn':
    {'gamma', 'beta', 'mean', 'var'}}, 'pred': {'w', 'b'}} (the tree
    ``init_params(batch_norm=True)`` returns), drawn from
    ``np.random.default_rng(seed)`` layer by layer: the weights with the
    kaiming-uniform bounds of ``blocks.init_conv``, then the BN stats as
    the JAX package's quantization tests draw them (gamma U[0.5, 1.5),
    beta N(0, 1), mean 0.1 N(0, 1), var U[0.5, 1.5)); pred's weights and
    bias with nn.Conv2d's bounds."""
    rng = np.random.default_rng(seed)
    params = {}
    for name, c_in, c_out, _ in CONV_LAYERS + (("pred", 256, pred_out,
                                                 False),):
        fan_in = 9 * c_in
        bound = math.sqrt(2.0 / 6.0) * math.sqrt(3.0 / fan_in)
        w = rng.uniform(-bound, bound, (3, 3, c_in, c_out)).astype(np.float32)
        if name == "pred":
            b_bound = 1.0 / math.sqrt(fan_in)
            params[name] = {"w": w, "b": rng.uniform(
                -b_bound, b_bound, (c_out,)).astype(np.float32)}
            continue
        params[name] = {"w": w, "bn": {
            "gamma": rng.random(c_out, dtype=np.float32) + 0.5,
            "beta": rng.standard_normal(c_out).astype(np.float32),
            "mean": rng.standard_normal(c_out).astype(np.float32) * 0.1,
            "var": rng.random(c_out, dtype=np.float32) + 0.5}}
    return params


def quantize_slim_weights(fused: Mapping, per_channel: bool = False,
                          bitwidth: int = 8, weight_bitwidth: int = None):
    """Per layer the int8 weights, int8-valued int32 biases and their pow2
    exponents, as the JAX package's ``fixed_point.quantize_model``
    computes them (weights at ``weight_bitwidth or bitwidth`` bits, biases
    at ``bitwidth``; ``per_channel``: one weight exponent per output
    channel, an int32 [C_out] array) -> (w_q, b_q, sw, sb) dicts."""
    w_q, b_q, sw, sb = {}, {}, {}, {}
    for name in QUANT_LAYER_NAMES:
        wq, sw[name] = quantize_pow2_np(fused[name]["w"],
                                        weight_bitwidth or bitwidth,
                                        channel_axis=-1 if per_channel
                                        else None)
        bq, sb[name] = quantize_pow2_np(fused[name]["b"], bitwidth)
        w_q[name] = np.clip(wq, INT8_MIN, INT8_MAX).astype(np.int8)
        b_q[name] = np.clip(bq, INT8_MIN, INT8_MAX).astype(np.int32)
    return w_q, b_q, sw, sb


def int8_model_from_seed(arrays: Mapping[str, np.ndarray],
                         device="cuda") -> Int8Model:
    """The per-channel slim golden fixture's model: int8 weights rebuilt
    from the seed it names (``slim_seeded_fused_params`` +
    ``quantize_slim_weights``), checked against its ``wb_sha256``, with
    its calibrated tables (its ``sw.<layer>``, ``sb``, ``sa``, ``retune``
    keys)."""
    fused = slim_seeded_fused_params(int(arrays["weight_seed"]),
                                     int(arrays["pred_out"]))
    w_q, b_q, sw, sb = quantize_slim_weights(
        fused, per_channel=bool(arrays["per_channel"]))
    names = list(QUANT_LAYER_NAMES)
    digest = weights_sha256([w_q[n] for n in names], [b_q[n] for n in names])
    if digest != str(arrays["wb_sha256"]):
        raise ValueError(f"the weights rebuilt from seed "
                         f"{int(arrays['weight_seed'])} do not match the "
                         f"fixture: sha256 {digest} != "
                         f"{arrays['wb_sha256']}")
    m = int8_model_from_arrays(
        {**{k: v for k, v in arrays.items()
            if k.partition(".")[0] in _TABLES},
         **{f"w_q.{n}": w_q[n] for n in names},
         **{f"b_q.{n}": b_q[n] for n in names}}, device)
    for n in names:
        if (not np.array_equal(np.asarray(m.sw[n]), np.asarray(sw[n]))
                or m.sb[n] != sb[n]):
            raise ValueError(f"the fixture's sw / sb of {n} differ from the "
                             f"rebuilt weights' exponents")
    return m


# ---------------------------------------------------------------------------
# yolo_v3: Int8YoloV3 (per-conv lists in program order).
# ---------------------------------------------------------------------------

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
    """The model's exponent tables as {'sb', 'retune': [n convs],
    'tap_sa': [n taps] int32, 'sa_in', 'spp', 'per_channel'} and its sw:
    'sw' [n convs] int32 where every sw is an int, else (per-channel) one
    int32 [C_out] array 'sw.<i>' per conv."""
    per_channel = any(np.ndim(v) for v in m.sw)
    sw = ({f"sw.{i}": np.asarray(v, np.int32) for i, v in enumerate(m.sw)}
          if per_channel else {"sw": np.asarray(m.sw, np.int32)})
    return {"sa_in": np.int32(m.sa_in), "spp": np.bool_(m.spp),
            "per_channel": np.bool_(per_channel), **sw,
            **{field: np.asarray(getattr(m, field), np.int32)
               for field in ("sb", "retune", "tap_sa")}}


def _v3_tables_from_arrays(arrays: Mapping[str, np.ndarray]) -> dict:
    """Inverse of ``int8_yolo_v3_tables`` (tables written before the
    'per_channel' key existed are per tensor)."""
    tables = {"sa_in": int(arrays["sa_in"]), "spp": bool(arrays["spp"]),
              **{field: [int(v) for v in arrays[field]]
                 for field in ("sb", "retune", "tap_sa")}}
    if "per_channel" in arrays and bool(arrays["per_channel"]):
        tables["sw"] = [np.asarray(arrays[f"sw.{i}"], np.int32)
                        for i in range(len(tables["sb"]))]
    else:
        tables["sw"] = [int(v) for v in arrays["sw"]]
    return tables


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
    """A yolo_v3 (or, where its 'spp' flag is set, yolo_v3_spp) golden
    fixture's model: int8 weights rebuilt from the seed it names
    (``seeded_fused_params``, or where its 'per_channel' flag is set
    ``seeded_fused_params_per_channel`` with per-channel
    ``quantize_weights``), checked against its ``wb_sha256``, with its
    calibrated tables, whose sw / sb must be the rebuilt weights'
    exponents."""
    from yolo_tpu_torch.quant.int8_yolo_v3 import (
        quantize_weights, seeded_fused_params,
        seeded_fused_params_per_channel)

    per_channel = "per_channel" in arrays and bool(arrays["per_channel"])
    seed, pred_out = int(arrays["weight_seed"]), int(arrays["pred_out"])
    fused = (seeded_fused_params_per_channel(seed, pred_out) if per_channel
             else seeded_fused_params(seed, pred_out,
                                      spp=bool(arrays["spp"])))
    w_q, b_q, sw, sb = quantize_weights(fused, per_channel=per_channel)
    digest = weights_sha256(w_q, b_q)
    if digest != str(arrays["wb_sha256"]):
        raise ValueError(f"the weights rebuilt from seed "
                         f"{int(arrays['weight_seed'])} do not match the "
                         f"fixture: sha256 {digest} != "
                         f"{arrays['wb_sha256']}")
    tables = _v3_tables_from_arrays(arrays)
    if (len(tables["sw"]) != len(sw) or tables["sb"] != sb
            or not all(np.array_equal(a, b)
                       for a, b in zip(tables["sw"], sw))):
        raise ValueError("the fixture's sw / sb tables differ from the "
                         "rebuilt weights' exponents")
    return int8_yolo_v3_from_numpy(w_q, b_q, device=device, **tables)


# ---------------------------------------------------------------------------
# tiny_yolo_v3 and yolo_v2: Int8Tiny, Int8YoloV2 (dicts keyed by conv name).
# ---------------------------------------------------------------------------


def int8_named_from_numpy(cls, w_q: Mapping, b_q: Mapping, sw: Mapping,
                          sb: Mapping, sa: Mapping, retune: Mapping,
                          device="cuda"):
    """numpy weights (int8 HWIO), biases (int8-valued) and exponent tables
    keyed by conv name (sa: 'in' and each conv) -> ``cls`` (``Int8Tiny``
    or ``Int8YoloV2``) on ``device``; a per-channel sw stays an int32
    array."""
    dev = resolve_device(device)
    missing = set(cls.CONV_ORDER) ^ set(w_q)
    if missing:
        raise ValueError(f"{cls.__name__} takes the convs "
                         f"{list(cls.CONV_ORDER)}; the weights differ at "
                         f"{sorted(missing)}")
    return cls(
        w_q={k: torch.as_tensor(np.asarray(w_q[k]).astype(np.int8)).to(dev)
             for k in cls.CONV_ORDER},
        b_q={k: torch.as_tensor(np.asarray(b_q[k]).astype(np.int32)).to(dev)
             for k in cls.CONV_ORDER},
        sw={k: _exponent(sw[k]) for k in cls.CONV_ORDER},
        sb={k: int(sb[k]) for k in cls.CONV_ORDER},
        sa={k: int(v) for k, v in sa.items()},
        retune={k: int(retune[k]) for k in cls.CONV_ORDER})


def int8_tiny_from_numpy(w_q, b_q, sw, sb, sa, retune, device="cuda"):
    """The fields of a JAX ``Int8Tiny`` after ``jax.device_get`` -> the
    port's ``Int8Tiny`` on ``device``."""
    from yolo_tpu_torch.quant.int8_models import Int8Tiny

    return int8_named_from_numpy(Int8Tiny, w_q, b_q, sw, sb, sa, retune,
                                 device)


def int8_yolo_v2_from_numpy(w_q, b_q, sw, sb, sa, retune, device="cuda"):
    """The fields of a JAX ``Int8YoloV2`` after ``jax.device_get`` -> the
    port's ``Int8YoloV2`` on ``device``."""
    from yolo_tpu_torch.quant.int8_models import Int8YoloV2

    return int8_named_from_numpy(Int8YoloV2, w_q, b_q, sw, sb, sa, retune,
                                 device)


def int8_named_tables(m) -> Dict[str, np.ndarray]:
    """An ``Int8Tiny`` / ``Int8YoloV2``'s exponent tables, without its
    weights: {'sw.<conv>', 'sb.<conv>', 'retune.<conv>', 'sa.<tap>'}
    int32 (a per-channel sw an int32 [C_out] array)."""
    return {k: v for k, v in int8_model_arrays(m).items()
            if k.partition(".")[0] in _TABLES}


def _seeded_named(rng, specs, per_channel=False) -> Dict[str, dict]:
    """{name: {'w': HWIO, 'b': [C_out]}} drawn conv by conv in the order of
    ``specs`` ((name, k, c_in, c_out)) with the kaiming-uniform bounds of
    ``blocks.init_conv`` (torch's nn.Conv2d defaults); with
    ``per_channel`` each conv's w and b are followed by u =
    ``rng.integers(0, 4, C_out)`` and its output channels' weights scaled
    by 2^-u, so that a per-channel sw holds several values (the
    per-channel yolo_v3 fixture's recipe)."""
    layers = {}
    for name, k, c_in, c_out in specs:
        fan_in = c_in * k * k
        bound = math.sqrt(2.0 / 6.0) * math.sqrt(3.0 / fan_in)
        b_bound = 1.0 / math.sqrt(fan_in)
        w = rng.uniform(-bound, bound, (k, k, c_in, c_out)).astype(np.float32)
        b = rng.uniform(-b_bound, b_bound, (c_out,)).astype(np.float32)
        if per_channel:
            w = w * np.exp2(-rng.integers(0, 4, c_out)).astype(np.float32)
        layers[name] = {"w": w, "b": b}
    return layers


def _module_specs(model: nn.Module, flat, order) -> list:
    """(name, k, c_in, c_out) of each conv of ``order`` in ``model`` (built
    on the meta device: shapes only), through the tree walk of
    ``module_to_params`` flattened by ``flat``."""
    def shapes(m):
        if isinstance(m, Conv):
            c_out, c_in, k, _ = m.conv.weight.shape
            return {"w": (k, c_in, c_out)}
        if isinstance(m, nn.ModuleList):
            return [shapes(c) for c in m]
        return {name: shapes(c) for name, c in m.named_children()}

    tree = flat(shapes(model))
    return [(n, *tree[n]["w"]) for n in order]


def tiny_seeded_fused_params(seed: int, pred_out: int,
                             per_channel: bool = False) -> dict:
    """BN-fused float tiny_yolo_v3 params in the JAX package's tree layout
    (what ``fold_batch_norm`` returns there), drawn from
    ``np.random.default_rng(seed)`` conv by conv in ``TINY_CONV_ORDER``:
    the tiny golden fixture's recipe (no weight tensor in git); with
    ``per_channel`` the per-channel fixture's (``_seeded_named``)."""
    from yolo_tpu_torch.quant.int8_models import (
        TINY_CONV_ORDER, flat_tiny_params)

    specs = _module_specs(TinyYOLOv3(pred_out, batch_norm=False,
                                     device="meta"), flat_tiny_params,
                          TINY_CONV_ORDER)
    layers = _seeded_named(np.random.default_rng(seed), specs, per_channel)
    tree = {"backbone": {n: [layers[n]] for n in TINY_CONV_ORDER[:7]}}
    tree.update({n: layers[n] for n in TINY_CONV_ORDER[7:]})
    return tree


def yolo_v2_seeded_fused_params(seed: int, pred_out: int,
                                per_channel: bool = False) -> dict:
    """As ``tiny_seeded_fused_params``, for yolo_v2 (``V2_CONV_ORDER``):
    the yolo_v2 golden fixtures' recipe."""
    from yolo_tpu_torch.quant.int8_models import (
        _D19_SEQ_LENS, V2_CONV_ORDER, flat_v2_params)

    specs = _module_specs(YOLOv2(pred_out, batch_norm=False, device="meta"),
                          flat_v2_params, V2_CONV_ORDER)
    layers = _seeded_named(np.random.default_rng(seed), specs, per_channel)
    return {
        "backbone": {seq: [layers[f"{seq}.{j}"] for j in range(n)]
                     for seq, n in _D19_SEQ_LENS},
        "convsets_1": [layers["convsets_1.0"], layers["convsets_1.1"]],
        "route_layer": layers["route_layer"],
        "convsets_2": [layers["convsets_2.0"]],
        "pred": layers["pred"]}


def _named_from_seed(cls, seeded, flat, arrays: Mapping, device):
    from yolo_tpu_torch.quant.int8_models import quantize_named_weights

    order = cls.CONV_ORDER
    per_channel = "per_channel" in arrays and bool(arrays["per_channel"])
    fused = seeded(int(arrays["weight_seed"]), int(arrays["pred_out"]),
                   per_channel)
    w_q, b_q, sw, sb = quantize_named_weights(flat(fused), order,
                                              per_channel=per_channel)
    digest = weights_sha256([w_q[n] for n in order], [b_q[n] for n in order])
    if digest != str(arrays["wb_sha256"]):
        raise ValueError(f"the weights rebuilt from seed "
                         f"{int(arrays['weight_seed'])} do not match the "
                         f"fixture: sha256 {digest} != "
                         f"{arrays['wb_sha256']}")
    tables = {f: {} for f in _TABLES}
    for key, v in arrays.items():
        f, _, name = key.partition(".")
        if f in tables and name:
            tables[f][name] = v
    for n in order:
        if (not np.array_equal(np.asarray(tables["sw"][n]), sw[n])
                or int(tables["sb"][n]) != sb[n]):
            raise ValueError(f"the fixture's sw / sb of {n} differ from the "
                             f"rebuilt weights' exponents")
    return int8_named_from_numpy(cls, w_q, b_q, device=device, **tables)


def int8_tiny_from_seed(arrays: Mapping[str, np.ndarray], device="cuda"):
    """A tiny_yolo_v3 golden fixture's model: int8 weights rebuilt from
    the seed it names (``tiny_seeded_fused_params``, per-tensor
    quantization, or where its 'per_channel' flag is set the per-channel
    recipe and per-channel quantization), checked against its
    ``wb_sha256``, with its calibrated tables, whose sw / sb must be the
    rebuilt weights' exponents."""
    from yolo_tpu_torch.quant.int8_models import Int8Tiny, flat_tiny_params

    return _named_from_seed(Int8Tiny, tiny_seeded_fused_params,
                            flat_tiny_params, arrays, device)


def int8_yolo_v2_from_seed(arrays: Mapping[str, np.ndarray], device="cuda"):
    """As ``int8_tiny_from_seed``, for the yolo_v2 golden fixtures."""
    from yolo_tpu_torch.quant.int8_models import Int8YoloV2, flat_v2_params

    return _named_from_seed(Int8YoloV2, yolo_v2_seeded_fused_params,
                            flat_v2_params, arrays, device)


# ---------------------------------------------------------------------------
# Float models <-> the JAX package's parameter trees.
# ---------------------------------------------------------------------------

_BN_KEYS = (("gamma", "weight"), ("beta", "bias"), ("mean", "running_mean"),
            ("var", "running_var"))


def module_to_params(model: nn.Module):
    """The model's parameters as the JAX package's tree: a ``blocks.Conv``
    is {'w': HWIO[, 'b'][, 'bn': {'gamma', 'beta', 'mean', 'var'}]}, a
    ModuleList a list, any other module a dict of its children; float32
    numpy arrays."""
    def arr(t):
        return t.detach().to(torch.float32).cpu().numpy()

    if isinstance(model, Conv):
        out = {"w": np.ascontiguousarray(arr(model.conv.weight)
                                         .transpose(2, 3, 1, 0))}
        if model.conv.bias is not None:
            out["b"] = arr(model.conv.bias)
        if model.bn is not None:
            out["bn"] = {k: arr(getattr(model.bn, a)) for k, a in _BN_KEYS}
        return out
    if isinstance(model, nn.ModuleList):
        return [module_to_params(m) for m in model]
    return {name: module_to_params(m) for name, m in model.named_children()}


def load_params(model: nn.Module, params) -> nn.Module:
    """Copy a JAX-layout tree (numpy arrays or tensors, HWIO weights) into
    ``model`` in place, on its device; the tree's form (a 'b' and a 'bn'
    per conv) must be the model's. Returns ``model``."""
    def put(dst: torch.Tensor, v, what):
        # a bfloat16 leaf of a checkpoint is a tensor (numpy has no bf16)
        v = (v.detach().cpu().to(torch.float32)
             if isinstance(v, torch.Tensor)
             else torch.as_tensor(np.array(v, np.float32)))
        if tuple(v.shape) != tuple(dst.shape):
            raise ValueError(f"{what}: shape {tuple(v.shape)}, the model's "
                             f"is {tuple(dst.shape)}")
        dst.copy_(v)

    def visit(m, p, path):
        if isinstance(m, Conv):
            if set(p) - {"w", "b", "bn"} or (
                    ("b" in p) != (m.conv.bias is not None)
                    or ("bn" in p) != (m.bn is not None)):
                raise ValueError(f"{path}: tree keys {sorted(p)} do not fit "
                                 f"the model's form")
            w = p["w"]
            put(m.conv.weight, (w.permute(3, 2, 0, 1)
                                if isinstance(w, torch.Tensor)
                                else np.asarray(w).transpose(3, 2, 0, 1)),
                path + ".w")
            if "b" in p:
                put(m.conv.bias, p["b"], path + ".b")
            if "bn" in p:
                for k, a in _BN_KEYS:
                    put(getattr(m.bn, a), p["bn"][k], f"{path}.bn.{k}")
            return
        children = (list(enumerate(m)) if isinstance(m, nn.ModuleList)
                    else list(m.named_children()))
        keys = range(len(p)) if isinstance(p, (list, tuple)) else p
        if {k for k, _ in children} != set(keys):
            raise ValueError(f"{path or 'model'}: children "
                             f"{[k for k, _ in children]}, tree keys "
                             f"{list(keys)}")
        for k, child in children:
            visit(child, p[k], f"{path}.{k}" if path else str(k))

    with torch.no_grad():
        visit(model, params, "")
    return model


def _has_bn(params) -> bool:
    if isinstance(params, dict):
        return "bn" in params or any(_has_bn(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return any(_has_bn(v) for v in params)
    return False


def slim_from_params(params, device="cuda"):
    """A ``SlimYOLOv2`` on ``device`` in the tree's form (BN where its
    convs have a 'bn'), loaded from a JAX-layout slim tree."""
    model = SlimYOLOv2(int(np.shape(params["pred"]["w"])[-1]),
                       batch_norm=_has_bn(params),
                       device=resolve_device(device))
    return load_params(model, params)


def yolo_v3_from_params(params, device="cuda"):
    """A ``YOLOv3`` on ``device`` in the tree's form, loaded from a
    JAX-layout yolo_v3 tree (every conv with a BN, or every conv fused);
    a ``YOLOv3SPP`` where conv_set_3's first conv takes 4096 channels (the
    yolo_v3_spp tree)."""
    spp = np.shape(params["conv_set_3"][0]["w"])[2] == 4096
    model = (YOLOv3SPP if spp else YOLOv3)(
        int(np.shape(params["pred_1"]["w"])[-1]), batch_norm=_has_bn(params),
        device=resolve_device(device))
    return load_params(model, params)


def tiny_from_params(params, device="cuda"):
    """A ``TinyYOLOv3`` on ``device`` in the tree's form, loaded from a
    JAX-layout tiny_yolo_v3 tree (every conv with a BN, or every conv
    fused)."""
    model = TinyYOLOv3(int(np.shape(params["pred_1"]["w"])[-1]),
                       batch_norm=_has_bn(params),
                       device=resolve_device(device))
    return load_params(model, params)


def yolo_v2_from_params(params, device="cuda"):
    """A ``YOLOv2`` on ``device`` in the tree's form, loaded from a
    JAX-layout yolo_v2 tree."""
    model = YOLOv2(int(np.shape(params["pred"]["w"])[-1]),
                   batch_norm=_has_bn(params), device=resolve_device(device))
    return load_params(model, params)
