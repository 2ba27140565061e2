"""``serving.export`` on the CPU: slim INT8 at 32² (s2d and NHWC input)
and the float ``Detector`` round-trip through ``save_artifact`` /
``load_artifact`` equal to their live detect fns (``torch.equal``) and,
for the INT8 fns, to the JAX package's artifact of the same model where
its outputs are integers (classes, valid exact; boxes and scores within
1e-5); the header's meta survives; another shape raises; neither package
loads the other's blob; a process that cannot import the port's models
or quantization loads and runs the artifact."""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolo_tpu.config import get_config
from yolo_tpu.quant import fixed_point as jfp
from yolo_tpu.quant.int8_graph import make_int8_detect_fn, quantize_pipeline
from yolo_tpu.serving import export as jexport
from yolo_tpu_torch.config import get_config as t_get_config
from yolo_tpu_torch.detector import Detector
from yolo_tpu_torch.quant import convert as C
from yolo_tpu_torch.quant.int8_graph import (
    make_int8_detect_fn as t_make_int8_detect_fn)
from yolo_tpu_torch.serving import export

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SIZE = 32
KW = dict(input_size=(SIZE, SIZE), pre_nms_top_k=64, top_k=20,
          conf_thresh=0.001)
TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def slim():
    """(JAX Int8Model, the port's with its weights, JAX cfg, port cfg)."""
    cfg = get_config("slim_yolo_v2", "mask", **KW)
    tree = C.slim_seeded_fused_params(0, 35)
    calib = [np.random.default_rng(1).random((4, SIZE, SIZE, 3),
                                             dtype=np.float32)]
    m = quantize_pipeline(jax.tree_util.tree_map(jnp.asarray, tree), cfg,
                          calib, fold_bn=False)
    mn = jax.device_get(m)
    tm = C.int8_model_from_numpy(mn.w_q, mn.b_q, mn.sw, mn.sb, mn.sa,
                                 mn.retune, device="cpu")
    return m, tm, cfg, t_get_config("slim_yolo_v2", "mask", **KW)


def _input(m, s2d):
    x = np.random.default_rng(2).random((2, SIZE, SIZE, 3), np.float32)
    x_q = np.asarray(jfp.quantize_input(jnp.asarray(x), int(m.sa["in"])))
    return jfp.s2d_input_np(x_q) if s2d else x_q


def _assert_equal(got, want):
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.fixture(scope="module")
def artifacts(slim, tmp_path_factory):
    """{s2d: (input, live detect fn, its meta, its artifact's path)}."""
    m, tm, _, tcfg = slim
    out = {}
    for s2d in (True, False):
        x = _input(m, s2d)
        live = t_make_int8_detect_fn(tm, tcfg, input_s2d=s2d, device="cpu")
        meta = {"input": "s2d" if s2d else "int8", "sa_in": int(m.sa["in"]),
                "batch": 2, "input_size": [SIZE, SIZE],
                "version": "slim_yolo_v2"}
        path = str(tmp_path_factory.mktemp("art") / "slim.bin")
        out[s2d] = x, live, meta, export.save_artifact(live, x, path,
                                                       meta=meta)
    return out


@pytest.mark.parametrize("s2d", [True, False], ids=["s2d", "nhwc"])
def test_int8_artifact_round_trip(slim, artifacts, tmp_path, s2d):
    m, _, cfg, _ = slim
    x, live, meta, path = artifacts[s2d]
    serve, got_meta = export.load_artifact(path, with_meta=True)
    assert got_meta == meta and serve.device == torch.device("cpu")
    got = serve(x)
    _assert_equal(got, live(x))
    assert got[3].float().mean() >= 0.25

    # the JAX package's artifact of the same model: integers exact
    jpath = str(tmp_path / "slim_jax.bin")
    jexport.save_artifact(make_int8_detect_fn(m, cfg, input_s2d=s2d), x,
                          jpath, platforms=("cpu",), meta=meta)
    jserve = jexport.load_artifact(jpath)
    want = [np.asarray(a) for a in jserve(x)]
    np.testing.assert_array_equal(got[2].numpy(), want[2])
    np.testing.assert_array_equal(got[3].numpy(), want[3])
    np.testing.assert_allclose(got[0].numpy(), want[0], **TOL)
    np.testing.assert_allclose(got[1].numpy(), want[1], **TOL)

    # neither package loads the other's blob
    with pytest.raises(Exception):
        export.load_artifact(jpath)
    with pytest.raises(Exception):
        jexport.load_artifact(path)
    # one shape only
    with pytest.raises(RuntimeError, match="shape"):
        serve(np.concatenate([x, x]))


def test_detector_artifact_round_trip(tmp_path):
    cfg = t_get_config("slim_yolo_v2", "mask", **KW)
    det = Detector(cfg, device="cpu").init_params(
        torch.Generator().manual_seed(1))
    x = np.random.default_rng(3).random((2, SIZE, SIZE, 3), np.float32)
    blob = export.export_detect(det.detect_fn(), x)
    serve = export.load_artifact(blob)  # a raw blob: no header
    _, meta = export.load_artifact(blob, with_meta=True)
    assert meta == {}
    _assert_equal(serve(x), det.detect(x))
    u8 = np.random.default_rng(4).integers(0, 256, (2, SIZE, SIZE, 3),
                                           dtype=np.uint8)
    _assert_equal(export.load_artifact(export.export_detect(
        det.detect_fn(), u8))(u8), det.detect(u8))


PROBE = r"""
import sys
sys.modules["jax"] = None
for name in ("yolo_tpu_torch.models", "yolo_tpu_torch.quant"):
    sys.modules[name] = None  # importing them (or below them) now raises
import numpy as np
import torch
from yolo_tpu_torch.serving.export import load_artifact
serve, meta = load_artifact(sys.argv[1], with_meta=True)
x = np.load(sys.argv[2])
out = serve(x)
np.savez(sys.argv[3], *[o.numpy() for o in out])
print(meta["version"])
"""


def test_artifact_loads_without_model_code(artifacts, tmp_path):
    x, live, _, path = artifacts[True]
    np.save(tmp_path / "x.npy", x)
    out = subprocess.run(
        [sys.executable, "-c", PROBE, path, str(tmp_path / "x.npy"),
         str(tmp_path / "out.npz")], cwd=ROOT, capture_output=True,
        text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("slim_yolo_v2")
    with np.load(tmp_path / "out.npz") as z:
        got = [z[f"arr_{i}"] for i in range(4)]
    for g, w in zip(got, live(x)):
        np.testing.assert_array_equal(g, w.numpy())
