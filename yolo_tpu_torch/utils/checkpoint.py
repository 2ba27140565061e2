"""Checkpoints: msgpack save/load of parameter trees in flax's layout, and
reference ``.pth`` import (counterpart of ``yolo_tpu/utils/checkpoint.py``
without its orbax backend).

A checkpoint is ``{"params": tree, "extra": tree}`` (``extra`` only where
given) written as flax's ``msgpack_serialize`` writes it, so each package
reads the other's: nested maps with string keys and arrays (lists), each
array leaf an extension of code 1 holding the msgpack array (shape, dtype
name, C-order bytes), each numpy scalar one of code 3, and an array above
2^30 bytes a map ``{"__msgpack_chunked_array__": True, "shape": {"0": ..},
"chunks": {"0": flat chunk, ..}}``. The bytes go through the port's own
codec (``utils.msgpack_codec``), not the ``msgpack`` package. Array leaves
load as numpy arrays, except bfloat16 ones (numpy has no such type), which
load as ``torch.bfloat16`` tensors.

``load_torch_*`` map a reference-layout torch state dict onto the JAX
package's parameter trees (HWIO weights, a ``"bn"`` dict per conv), which
``quant.convert.load_params`` copies into the port's modules.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from yolo_tpu_torch.utils import msgpack_codec as mp

_NDARRAY, _NPSCALAR = 1, 3
MAX_CHUNK_SIZE = 2 ** 30
_CHUNKED = "__msgpack_chunked_array__"


def _array_bytes(x) -> bytes:
    """A leaf as flax's (shape, dtype name, C-order bytes)."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:  # numpy has no bf16: its raw bytes
            data = t.reshape(-1).view(torch.uint8).numpy().tobytes()
            return mp.packb([list(t.shape), "bfloat16", data])
        x = t.numpy()
    a = np.asarray(x)
    if a.dtype.hasobject or a.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes cannot be saved")
    return mp.packb([list(a.shape), a.dtype.name, a.tobytes("C")])


def _ext_pack(x):
    if isinstance(x, (np.ndarray, torch.Tensor)):
        return mp.ExtType(_NDARRAY, _array_bytes(x))
    if isinstance(x, np.generic):
        return mp.ExtType(_NPSCALAR, _array_bytes(np.asarray(x)))
    return x


def _array_from_bytes(data: bytes):
    shape, name, buf = mp.unpackb(data, raw=True)
    name = name.decode()
    if name == "bfloat16":
        flat = torch.frombuffer(bytearray(buf), dtype=torch.bfloat16)
        return flat.reshape(shape)
    return np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape)


def _ext_unpack(code: int, data: bytes):
    if code == _NDARRAY:
        return _array_from_bytes(data)
    if code == _NPSCALAR:
        a = _array_from_bytes(data)
        return a.reshape(()) if isinstance(a, torch.Tensor) else a[()]
    return mp.ExtType(code, data)


def _itemsize(x) -> int:
    return (x.element_size() if isinstance(x, torch.Tensor)
            else x.dtype.itemsize)


def _chunk(arr) -> dict:
    flat = arr.reshape(-1)
    step = max(1, MAX_CHUNK_SIZE // _itemsize(arr))
    chunks = [flat[i:i + step] for i in range(0, flat.shape[0], step)]
    return {_CHUNKED: True,
            "shape": {str(i): int(d) for i, d in enumerate(arr.shape)},
            "chunks": {str(i): c for i, c in enumerate(chunks)}}


def _prepare(tree):
    """A copy of ``tree`` with array leaves above 2^30 bytes chunked (as
    flax chunks them: the root and the values of maps) and each map's keys
    sorted (flax's copy of the tree, a ``jax.tree_util.tree_map``, sorts
    them)."""
    def big(x):
        if isinstance(x, torch.Tensor):
            return x.numel() * x.element_size() > MAX_CHUNK_SIZE
        return isinstance(x, np.ndarray) and x.nbytes > MAX_CHUNK_SIZE

    if isinstance(tree, dict):
        return {k: (_chunk(tree[k]) if big(tree[k]) else _prepare(tree[k]))
                for k in sorted(tree)}
    if isinstance(tree, list):
        return [_prepare(v) for v in tree]
    return _chunk(tree) if big(tree) else tree


def _unchunk(tree):
    if isinstance(tree, dict):
        if _CHUNKED in tree:
            shape = [tree["shape"][str(i)] for i in range(len(tree["shape"]))]
            chunks = [tree["chunks"][str(i)]
                      for i in range(len(tree["chunks"]))]
            if isinstance(chunks[0], torch.Tensor):
                return torch.cat(chunks).reshape(shape)
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_unchunk(v) for v in tree]
    return tree


def serialize(tree) -> bytes:
    """``tree`` (maps with string keys, lists, numpy arrays and scalars,
    tensors, Python numbers and strings) as flax's ``msgpack_serialize``
    writes it."""
    return mp.packb(_prepare(tree), default=_ext_pack)


def restore(data: bytes):
    """flax's ``msgpack_restore``: the tree of ``serialize`` (or flax's)
    bytes."""
    return _unchunk(mp.unpackb(data, ext_hook=_ext_unpack))


def save_checkpoint(path: str, params, extra: Optional[dict] = None) -> None:
    """Write ``{"params": params, "extra": extra}`` (``extra`` only where
    given) to ``path``, as the JAX package's ``save_checkpoint`` does."""
    payload = {"params": params}
    if extra:
        payload["extra"] = extra
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(serialize(payload))


def load_checkpoint(path: str):
    """-> (params, extra or None) of a checkpoint either package wrote."""
    with open(path, "rb") as f:
        payload = restore(f.read())
    return payload["params"], payload.get("extra")


# ---------------------------------------------------------------------------
# Torch .pth import (reference checkpoint compatibility).
# ---------------------------------------------------------------------------


def _read_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    return {k: v.detach().numpy() for k, v in sd.items()
            if hasattr(v, "detach")}


def _conv_w(t: np.ndarray) -> np.ndarray:
    """OIHW (torch) -> HWIO (the JAX layout)."""
    return np.transpose(t, (2, 3, 1, 0))


def _map_conv_block(sd: Dict[str, np.ndarray], prefix: str,
                    has_bn: bool) -> dict:
    """A reference Conv2d / Conv2d_fuse block: '<prefix>.convs.0' is the
    conv, '.convs.1' the BN where there is one."""
    out = {"w": _conv_w(sd[f"{prefix}.convs.0.weight"])}
    if f"{prefix}.convs.0.bias" in sd:
        out["b"] = sd[f"{prefix}.convs.0.bias"]
    if has_bn:
        out["bn"] = {
            "gamma": sd[f"{prefix}.convs.1.weight"],
            "beta": sd[f"{prefix}.convs.1.bias"],
            "mean": sd[f"{prefix}.convs.1.running_mean"],
            "var": sd[f"{prefix}.convs.1.running_var"],
        }
    return out


def load_torch_slim_yolo_v2(path: str, fused: bool = False):
    """Reference SlimYOLOv2 (.pth) -> (params, tracker_scales).

    ``fused=False``: the BN form (keys like 'conv1.convs.{0,1}.*');
    ``fused=True``: the BN-folded form of the conv+bn2conv pass and the
    retune scripts (biased convs). ``tracker_scales``: tracker name (our
    layer names, 'in', 'pred') -> EMA scale, empty for a checkpoint that
    was never quantized."""
    from yolo_tpu_torch.models.slim_yolo_v2 import CONV_LAYERS

    sd = _read_torch_state_dict(path)
    params = {name: _map_conv_block(sd, name, has_bn=not fused)
              for name, _, _, _ in CONV_LAYERS}
    params["pred"] = {"w": _conv_w(sd["pred.weight"]), "b": sd["pred.bias"]}
    tracker_map = {"a_tracker_in": "in", "a_tracker_pred": "pred"}
    for name, _, _, _ in CONV_LAYERS:
        tracker_map[f"a_tracker{name[4:]}"] = name  # conv3_1 -> a_tracker3_1
    trackers = {ours: float(np.asarray(sd[f"{tk}.scale"]).reshape(()))
                for tk, ours in tracker_map.items() if f"{tk}.scale" in sd}
    return params, trackers


def load_torch_darknet19(path: str):
    """Reference darknet19 ImageNet checkpoint -> backbone tree (keys
    'conv_N.M.convs.K.*')."""
    from yolo_tpu_torch.models.darknet import _D19_SPECS

    sd = _read_torch_state_dict(path)
    return {name: [_map_conv_block(sd, f"{name}.{j}", has_bn=True)
                   for j in range(len(specs))]
            for name, specs in _D19_SPECS.items()}


def load_torch_darknet53(path: str):
    """Reference darknet53 ImageNet checkpoint -> backbone tree ('layer_N.0'
    the entry convs, then the residual blocks as
    'layer_N.M.module_list.K.{0,1}')."""
    from yolo_tpu_torch.models.darknet import _D53_LAYERS

    sd = _read_torch_state_dict(path)
    params = {}
    for name, entry, _, nblocks in _D53_LAYERS:
        # the residual blocks live in one ModuleList at the next index
        res = f"{name}.{len(entry)}.module_list"
        params[name] = {
            "entry": [_map_conv_block(sd, f"{name}.{j}", has_bn=True)
                      for j in range(len(entry))],
            "blocks": [[_map_conv_block(sd, f"{res}.{k}.{i}", has_bn=True)
                        for i in range(2)] for k in range(nblocks)]}
    return params


def load_torch_darknet_light(path: str):
    """Reference darknet_light checkpoint -> backbone tree (plain
    'conv_N.convs.K.*' blocks)."""
    from yolo_tpu_torch.models.darknet import _DLIGHT_SPECS

    sd = _read_torch_state_dict(path)
    return {name: [_map_conv_block(sd, name, has_bn=True)]
            for name in _DLIGHT_SPECS}
