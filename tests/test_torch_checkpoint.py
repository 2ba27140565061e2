"""The port's checkpoints against the JAX package's on the CPU: each
package reads the other's msgpack files (nested maps, lists, float32 /
int8 / int32 / bfloat16 arrays, numpy scalars, ``extra``), the port
writes flax's bytes, its own MessagePack codec reads what
``msgpack.unpackb`` reads, chunked arrays round-trip, and each reference
``.pth`` loader gives the JAX loader's tree on a seeded state dict.
Exact throughout."""

import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch
from flax import serialization

from yolo_tpu.models import darknet as jdarknet
from yolo_tpu.models.slim_yolo_v2 import CONV_LAYERS
from yolo_tpu.utils import checkpoint as jck
from yolo_tpu_torch.utils import checkpoint as ck
from yolo_tpu_torch.utils import msgpack_codec as mp

torch.set_num_threads(1)


def _tree(rng):
    return {
        "conv1": {"w": rng.normal(size=(3, 3, 3, 16)).astype(np.float32),
                  "bn": {"mean": rng.normal(size=16).astype(np.float32)}},
        "blocks": [{"w": rng.integers(-128, 128, (4, 8)).astype(np.int8)},
                   {"b": rng.integers(-9, 9, 5).astype(np.int32)},
                   [np.asarray(jnp.asarray(rng.normal(size=(2, 3)),
                                           jnp.bfloat16))]],
        "scale": np.float32(0.125),
        "count": np.int32(7),
    }


def _assert_tree_equal(got, want):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want)
        for k in want:
            _assert_tree_equal(got[k], want[k])
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want)
        for g, w in zip(got, want):
            _assert_tree_equal(g, w)
    elif isinstance(want, (np.ndarray, np.generic)) or hasattr(want,
                                                               "dtype"):
        w = np.asarray(want)
        if w.dtype.name == "bfloat16":
            assert isinstance(got, torch.Tensor)
            assert got.dtype == torch.bfloat16
            np.testing.assert_array_equal(got.float().numpy(),
                                          w.astype(np.float32))
        else:
            g = np.asarray(got)
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)
    else:
        assert got == want and type(got) is type(want)


EXTRA = {"epoch": 12, "lr": 2.5e-4, "version": "slim_yolo_v2",
         "best": np.float32(0.75), "tags": ["a", "b"], "none": None}


def test_port_reads_the_jax_checkpoint(rng, tmp_path):
    tree = _tree(rng)
    path = str(tmp_path / "jax.msgpack")
    jck.save_checkpoint(path, tree, extra=EXTRA)
    params, extra = ck.load_checkpoint(path)
    _assert_tree_equal(params, tree)
    _assert_tree_equal(extra, EXTRA)


def test_jax_reads_the_port_checkpoint(rng, tmp_path):
    tree = _tree(rng)
    path = str(tmp_path / "port.msgpack")
    ck.save_checkpoint(path, tree, extra=EXTRA)
    params, extra = jck.load_checkpoint(path)
    _assert_tree_equal(ck.restore(serialization.msgpack_serialize(params)),
                       tree)
    _assert_tree_equal(extra, EXTRA)
    # the same bytes as flax writes, and torch tensors save as arrays
    payload = {"params": tree, "extra": EXTRA}
    assert ck.serialize(payload) == serialization.msgpack_serialize(payload)
    as_tensors = dict(tree, conv1={"w": torch.from_numpy(tree["conv1"]["w"]),
                                   "bn": tree["conv1"]["bn"]})
    assert ck.serialize(as_tensors) == ck.serialize(tree)
    ck.save_checkpoint(path, tree)
    assert jck.load_checkpoint(path)[1] is None


def test_chunked_arrays_round_trip(rng, tmp_path, monkeypatch):
    """Arrays above the chunk size (2^30 bytes; 64 here) are written and
    read as flax's ``__msgpack_chunked_array__`` maps."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(ck, "MAX_CHUNK_SIZE", 64)
    tree = {"big": rng.normal(size=(9, 7)).astype(np.float32),
            "small": np.arange(3, dtype=np.int32)}
    blob = serialization.msgpack_serialize(tree)
    assert b"__msgpack_chunked_array__" in blob
    assert ck.serialize(tree) == blob
    _assert_tree_equal(ck.restore(blob), tree)
    _assert_tree_equal(serialization.msgpack_restore(ck.serialize(tree)),
                       tree)


OBJECTS = [0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32, 2 ** 63 - 1,
           -1, -32, -33, -128, -129, -32768, -32769, -2 ** 31 - 1, -2 ** 63,
           0.5, -1e300, float("inf"), True, False, None, "", "a" * 31,
           "b" * 32, "é" * 200, "c" * 70000, b"", b"x" * 255, b"y" * 256,
           b"z" * 70000, list(range(15)), list(range(16)),
           list(range(70000)), {str(i): i for i in range(15)},
           {str(i): [i] for i in range(16)},
           {"nested": {"deep": [1, [2, [3, {"k": b"v"}]]]}}]


@pytest.mark.parametrize("obj", OBJECTS, ids=range(len(OBJECTS)))
def test_codec_matches_msgpack(obj):
    b = msgpack.packb(obj, use_bin_type=True)
    assert mp.unpackb(b) == msgpack.unpackb(b, raw=False)
    assert mp.packb(obj) == b


def test_codec_reads_every_form():
    """Forms msgpack-python writes only on request: single floats,
    extension types of each size, raw strings."""
    for obj in (1.5, -0.25):
        b = msgpack.packb(obj, use_single_float=True)
        assert mp.unpackb(b) == msgpack.unpackb(b)
    for n in (1, 2, 3, 4, 8, 16, 17, 300, 70000):
        e = msgpack.ExtType(5, bytes(range(256)) * (n // 256) +
                            bytes(range(n % 256)))
        b = msgpack.packb(e)
        assert mp.unpackb(b) == mp.ExtType(5, e.data)
        assert mp.packb(mp.ExtType(5, e.data)) == b
    b = msgpack.packb({"k": "v"}, use_bin_type=True)
    assert mp.unpackb(b, raw=True) == {b"k": b"v"}
    with pytest.raises(TypeError):
        mp.packb((1, 2))
    with pytest.raises(ValueError):
        mp.unpackb(msgpack.packb([1, 2])[:-1])


# ---------------------------------------------------------------------------
# Reference .pth import.
# ---------------------------------------------------------------------------


def _conv_entries(g, prefix, k, bn, bias, c_in=2, c_out=3):
    sd = {f"{prefix}.convs.0.weight": g.normal(size=(c_out, c_in, k, k))}
    if bias:
        sd[f"{prefix}.convs.0.bias"] = g.normal(size=c_out)
    if bn:
        for name in ("weight", "bias", "running_mean"):
            sd[f"{prefix}.convs.1.{name}"] = g.normal(size=c_out)
        sd[f"{prefix}.convs.1.running_var"] = g.random(c_out) + 0.5
        sd[f"{prefix}.convs.1.num_batches_tracked"] = np.int64(3)
    return sd


def _save(sd, path):
    torch.save({k: torch.tensor(np.asarray(v, np.float32)
                                if np.asarray(v).dtype.kind == "f"
                                else np.asarray(v))
                for k, v in sd.items()}, path)
    return str(path)


def _slim_sd(g, fused):
    sd = {}
    for name, _, _, _ in CONV_LAYERS:
        sd.update(_conv_entries(g, name, 3, bn=not fused, bias=fused))
        if fused:
            sd[f"a_tracker{name[4:]}.scale"] = np.float32(g.random())
    sd["pred.weight"] = g.normal(size=(35, 2, 3, 3))
    sd["pred.bias"] = g.normal(size=35)
    if fused:
        sd["a_tracker_in.scale"] = np.float32(0.5)
        sd["a_tracker_pred.scale"] = np.float32(4.0)
    return sd


def _d19_sd(g):
    sd = {}
    for name, specs in jdarknet._D19_SPECS.items():
        for j, spec in enumerate(specs):
            sd.update(_conv_entries(g, f"{name}.{j}", spec[0], True, False))
    return sd


def _d53_sd(g):
    sd = {}
    for name, entry, _, nblocks in jdarknet._D53_LAYERS:
        for j, spec in enumerate(entry):
            sd.update(_conv_entries(g, f"{name}.{j}", spec[0], True, False))
        for k in range(nblocks):
            for i, ks in enumerate((1, 3)):
                sd.update(_conv_entries(
                    g, f"{name}.{len(entry)}.module_list.{k}.{i}", ks, True,
                    False))
    return sd


def _dlight_sd(g):
    sd = {}
    for name, specs in jdarknet._DLIGHT_SPECS.items():
        sd.update(_conv_entries(g, name, specs[0][0], True, False))
    return sd


@pytest.mark.parametrize("which", ["slim_bn", "slim_fused", "darknet19",
                                   "darknet53", "darknet_light"])
def test_pth_loaders_match_jax(tmp_path, which):
    g = np.random.default_rng(5)
    sd = {"slim_bn": lambda: _slim_sd(g, False),
          "slim_fused": lambda: _slim_sd(g, True),
          "darknet19": lambda: _d19_sd(g), "darknet53": lambda: _d53_sd(g),
          "darknet_light": lambda: _dlight_sd(g)}[which]()
    path = _save(sd, tmp_path / f"{which}.pth")
    if which.startswith("slim"):
        fused = which == "slim_fused"
        got, got_tr = ck.load_torch_slim_yolo_v2(path, fused=fused)
        want, want_tr = jck.load_torch_slim_yolo_v2(path, fused=fused)
        assert got_tr == want_tr and bool(got_tr) == fused
    else:
        got = getattr(ck, f"load_torch_{which}")(path)
        want = getattr(jck, f"load_torch_{which}")(path)
    _assert_tree_equal(got, want)
