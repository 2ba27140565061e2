"""The port's compression CLI (``yolo_tpu_torch.cli.quantize``) against the
JAX package's on the CPU: every stage on the synthetic set at 32², both
CLIs from the same checkpoint (slim_yolo_v2 seeded BN weights, then the
JAX CLI's BN-folded checkpoint for the stages after bnfold, so that both
quantize the same floats).

Tolerances: bnfold rtol 1e-6, atol 1e-7 (XLA's CPU rsqrt lies 1-4 ulps
off the port's IEEE 1/sqrt, ``test_torch_ptq_slim.py``); findbest's
tables, ptq's checkpoint (int8 weights, biases, tables) and the export's
weight.h exactly; qat and retune after two steps: every parameter within
1e-4 of its leaf's largest |value| of the JAX CLI's (the trainer tests'
bound), at an LR that moves the weights past that bound; the exported
artifact ``torch.equal`` to the live detect fn."""

import os

import numpy as np
import pytest
import torch

from yolo_tpu.cli import quantize as jcli
from yolo_tpu_torch.cli import quantize as tcli
from yolo_tpu_torch.cli import serve as tserve
from yolo_tpu_torch.quant import convert as C
from yolo_tpu_torch.quant import fixed_point as tfp
from yolo_tpu_torch.quant import qat
from yolo_tpu_torch.quant.int8_graph import make_int8_detect_fn
from yolo_tpu_torch.serving.export import load_artifact
from yolo_tpu_torch.utils import checkpoint as tckpt

torch.set_num_threads(1)

TOL = 1e-4
COMMON = ["-d", "synthetic", "--input_size", "32", "32", "--calib_images",
          "8", "--batch_size", "4"]
FUSED = ["-v", "slim_yolo_v2_q_bf"]


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """{'bn': a BN-form slim checkpoint, 'fused': the JAX CLI's bnfold of
    it, 'fused_port': the port CLI's}."""
    d = tmp_path_factory.mktemp("ckpt")
    bn = str(d / "bn.msgpack")
    tckpt.save_checkpoint(bn, C.slim_seeded_bn_params(0, 35))
    out = {"bn": bn, "fused": str(d / "fused.msgpack"),
           "fused_port": str(d / "fused_port.msgpack")}
    jcli.main(jcli.parse_args(["bnfold", "-r", bn, "--out", out["fused"],
                               "--no_eval"] + COMMON))
    model = tcli.main(tcli.parse_args(
        ["bnfold", "-r", bn, "--out", out["fused_port"], "--no_eval",
         "--device", "cpu"] + COMMON))
    assert qat.bn_paths(model) == []
    return out


def _run(package, argv):
    if package == "jax":
        return jcli.main(jcli.parse_args(argv))
    return tcli.main(tcli.parse_args(argv + ["--device", "cpu"]))


def _flat(tree, path=""):
    if isinstance(tree, dict):
        out = {}
        for k in tree:
            out.update(_flat(tree[k], f"{path}.{k}" if path else str(k)))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{path}.{i}"))
        return out
    return {path: np.asarray(tree)}


def test_bnfold_matches_jax(ckpts):
    want, _ = tckpt.load_checkpoint(ckpts["fused"])
    got, _ = tckpt.load_checkpoint(ckpts["fused_port"])
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want) and "conv1.b" in got
    assert not any(".bn." in k for k in got)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-7,
                                   err_msg=k)


def test_findbest_tables_equal_jax(ckpts):
    argv = ["findbest", "-r", ckpts["fused"], "--head_clip", "16",
            "--no_eval"] + FUSED + COMMON
    want, got = _run("jax", argv), _run("torch", argv)
    assert got == want and len(got["retune"]) == 10


def test_ptq_checkpoint_equal_jax(ckpts, tmp_path):
    outs = {p: str(tmp_path / f"{p}.msgpack") for p in ("jax", "torch")}
    for p, out in outs.items():
        _run(p, ["ptq", "-r", ckpts["fused"], "--head_clip", "16",
                 "--no_eval", "--out", out] + FUSED + COMMON)
    want, _ = tckpt.load_checkpoint(outs["jax"])
    got, _ = tckpt.load_checkpoint(outs["torch"])
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want)
    assert any(k.startswith("w_q.") for k in got)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        if k.startswith(("w_q.", "b_q.")):
            assert got[k].dtype == want[k].dtype, k


@pytest.mark.parametrize("head_clip", ["none", "16", "auto"])
def test_export_header_byte_equal_jax(ckpts, tmp_path, head_clip):
    headers = {}
    for p in ("jax", "torch"):
        headers[p] = str(tmp_path / f"{p}.h")
        _run(p, ["export", "-r", ckpts["fused"], "--head_clip", head_clip,
                 "--header", headers[p], "--no_eval"] + FUSED + COMMON)
    with open(headers["jax"], "rb") as f:
        want = f.read()
    with open(headers["torch"], "rb") as f:
        assert f.read() == want


def test_export_artifact_serves_as_the_live_fn(ckpts, tmp_path):
    blob = str(tmp_path / "slim_s2d.pt2")
    m = _run("torch", ["export", "-r", ckpts["fused"], "--head_clip", "16",
                       "--header", str(tmp_path / "w.h"), "--artifact",
                       blob, "--artifact_input", "s2d", "--no_eval"]
             + FUSED + COMMON)
    serve, meta = load_artifact(blob, with_meta=True)
    assert meta == {"version": "slim_yolo_v2_q_bf", "input": "s2d",
                    "sa_in": int(m.sa["in"]), "batch": 4,
                    "input_size": [32, 32]}
    x = np.random.default_rng(3).random((4, 32, 32, 3), np.float32)
    x_q = tfp.s2d_input(tfp.quantize_input(torch.tensor(x),
                                           int(m.sa["in"])))
    cfg = tcli.build_cfg(tcli.parse_args(["export"] + FUSED + COMMON))
    live = make_int8_detect_fn(m, cfg, input_s2d=True, device="cpu")
    for a, b in zip(serve(x_q), live(x_q)):
        assert torch.equal(a, b)
    out = tserve.main(["--artifact", blob, "--iters", "1", "-d",
                       "synthetic", "--device", "cpu"])
    assert out["fps"] > 0


@pytest.mark.parametrize("stage,lr", [("qat", "1e-4"), ("retune", "1e-4")])
def test_two_fine_tune_steps_match_jax(ckpts, tmp_path, stage, lr):
    outs = {p: str(tmp_path / f"{p}.msgpack") for p in ("jax", "torch")}
    for p, out in outs.items():
        _run(p, [stage, "-r", ckpts["fused"], "--head_clip", "16",
                 "--steps", "2", "--lr", lr, "--no_eval", "--out", out]
             + FUSED + COMMON)
    start = _flat(tckpt.load_checkpoint(ckpts["fused"])[0])
    want = _flat(tckpt.load_checkpoint(outs["jax"])[0])
    got = _flat(tckpt.load_checkpoint(outs["torch"])[0])
    assert sorted(got) == sorted(want)
    moved = 0.0
    for k in want:
        scale = max(float(np.abs(want[k]).max()), 1e-30)
        err = float(np.abs(got[k] - want[k]).max()) / scale
        assert err <= TOL, f"{stage} {k}: {err} of the leaf's largest |value|"
        moved = max(moved, float(np.abs(want[k] - start[k]).max()) / scale)
    assert moved > 10 * TOL, moved  # the steps moved the weights


def test_refusals_match_jax(ckpts):
    argv = ["export", "-v", "tiny_yolo_v3"] + COMMON
    with pytest.raises(SystemExit) as jerr:
        _run("jax", argv)
    with pytest.raises(SystemExit) as err:
        _run("torch", argv)
    assert str(err.value) == str(jerr.value) and "--artifact" in str(
        err.value)
    with pytest.raises(SystemExit, match="per_channel"):
        _run("torch", ["export", "-r", ckpts["fused"], "--head_clip", "16",
                       "--per_channel"] + FUSED + COMMON)


def test_device_defaults_to_cuda_and_raises_without_one(tmp_path):
    args = tcli.parse_args(["bnfold"] + COMMON)
    assert args.device == "cuda" and args.head_clip == "auto"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.main(args)
    assert not os.path.exists(tmp_path / "model_bnfuse.msgpack")
