"""The port's slim_yolo_v2 PTQ toolchain against the JAX package, on the CPU
at 32²: BN fold, pow2 fake-quant, tracker calibration, the retune search,
``quantize_model`` and ``quantize_pipeline`` with every option, the
weight.h export and the C engine that consumes it.

The float params are ``convert.slim_seeded_bn_params(0, 35)`` (BN form,
mask config), the calibration batches 3 x 2 seeded images; both packages
get the same numpy floats. Held exactly: every exponent table (sw, sb,
sa, retune) of every pipeline, and the int8 weights and biases whenever
both packages quantize the same folded floats. Held to rtol 1e-5: float
tracker scales and pre-activation maxima (XLA's CPU convs and oneDNN's
sum in other orders).

The BN fold is held to rtol 1e-6 (atol 1e-7, for biases near a
cancellation): XLA's CPU backend lowers the JAX package's 1/sqrt to an
approximate reciprocal square root refined by two Newton steps, which
differs from the port's IEEE 1/sqrt by an ulp in ~12% of values, so a
quarter of the folded weights differ by 1-4 ulps. A weight whose level
sits within those ulps of a rounding tie then takes the neighbouring
int8 level; ``test_own_fold_int8_differs_only_at_fold_ties`` holds every
such difference to that explanation.
"""

import shutil
import subprocess
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolo_tpu.config import get_config
from yolo_tpu.models import slim_yolo_v2 as jslim
from yolo_tpu.quant import fixed_point as jfp
from yolo_tpu.quant import qsim as jqsim
from yolo_tpu.quant import quantize as jq
from yolo_tpu.quant.bn_fold import fold_batch_norm as jax_fold
from yolo_tpu.quant.int8_graph import quantize_pipeline as jax_pipeline
from yolo_tpu.quant.retune import export_c_header as jax_export_c_header
from yolo_tpu_torch.config import get_config as t_get_config
from yolo_tpu_torch.ops import blocks
from yolo_tpu_torch.quant import convert as C
from yolo_tpu_torch.quant import fixed_point as tfp
from yolo_tpu_torch.quant import qsim
from yolo_tpu_torch.quant import quantize as tq
from yolo_tpu_torch.quant.bn_fold import fold_batch_norm
from yolo_tpu_torch.quant.int8_graph import build_int8_detect, \
    quantize_pipeline
from yolo_tpu_torch.quant.qsim import QUANT_LAYER_NAMES, TRACKER_NAMES
from yolo_tpu_torch.quant.retune import c_header, export_c_header, \
    export_tables

from test_c_engine import _write_model_h as write_model_h  # noqa: E402

torch.set_num_threads(1)

CC = shutil.which("cc") or shutil.which("gcc")
SIZE, PRED_OUT = 32, 35
TABLES = ("sw", "sb", "sa", "retune")
# the pipeline options, each one JAX pipeline (fold_bn=True) per module
OPTIONS = {
    "plain": {},
    "per_channel": {"per_channel": True},
    "weight_bitwidth_4": {"weight_bitwidth": 4},
    # binds on pred (range ~0.81 here), not on conv7 (~2.7)
    "head_clip": {"head_clip": 0.5},
    "act_percentile": {"act_percentile": 99.9},
}
# the fake-quant options of fake_quantize_params
FQ_OPTIONS = {k: OPTIONS[k] for k in ("plain", "per_channel",
                                      "weight_bitwidth_4")}
SCALE_RTOL = 1e-5


def cfgs():
    return (get_config("slim_yolo_v2", "mask", input_size=(SIZE, SIZE)),
            t_get_config("slim_yolo_v2", "mask", input_size=(SIZE, SIZE)))


def calib_batches():
    rng = np.random.default_rng(5)
    return [rng.random((2, SIZE, SIZE, 3), dtype=np.float32)
            for _ in range(3)]


def jtree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def np_states(states):
    return {k: {f: np.asarray(v, np.float32) for f, v in st.items()}
            for k, st in states.items()}


@pytest.fixture(scope="module")
def params():
    """(BN-form tree, the JAX package's fold of it as numpy)."""
    bn = C.slim_seeded_bn_params(0, PRED_OUT)
    return bn, jax.device_get(jax_fold(jtree(bn)))


@pytest.fixture(scope="module")
def jax_runs(params):
    """{option: (JAX Int8Model as numpy, its tracker states)}: the JAX
    pipeline with fold_bn=True; the states are those its quantize_model
    received."""
    bn, _ = params
    cfg, _ = cfgs()
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        seen = {}
        real = jfp.quantize_model

        def spy(fused, states, retune, **kw):
            seen["states"] = np_states(jax.device_get(states))
            return real(fused, states, retune, **kw)

        mp.setattr(jfp, "quantize_model", spy)
        for key, opts in OPTIONS.items():
            m = jax_pipeline(jtree(bn), cfg, calib_batches(), fold_bn=True,
                             **opts)
            out[key] = (jax.device_get(m), seen.pop("states"))
    return out


def assert_tables_equal(mj, mt):
    for f in TABLES:
        got, want = getattr(mt, f), getattr(mj, f)
        assert set(got) == set(want), f
        for k in want:
            np.testing.assert_array_equal(np.asarray(got[k]),
                                          np.asarray(want[k]),
                                          err_msg=f"{f}.{k}")


def assert_int8_equal(mj, mt):
    for k in QUANT_LAYER_NAMES:
        np.testing.assert_array_equal(mt.w_q[k].numpy(), mj.w_q[k])
        np.testing.assert_array_equal(mt.b_q[k].numpy(), mj.b_q[k])


# ---------------------------------------------------------------------------
# The float pieces.
# ---------------------------------------------------------------------------


def test_fold_batch_norm_matches_jax(params):
    """Tree and module forms give the same floats, within rtol 1e-6 of
    the JAX package's fold (see the module docstring)."""
    bn, fj = params
    ft = fold_batch_norm(bn)
    fm = C.module_to_params(fold_batch_norm(C.slim_from_params(
        bn, device="cpu")))
    for k in QUANT_LAYER_NAMES:
        assert set(ft[k]) == set(fm[k]) == {"w", "b"}
        for f in ("w", "b"):
            np.testing.assert_array_equal(ft[k][f], fm[k][f])
            np.testing.assert_allclose(ft[k][f], fj[k][f], rtol=1e-6,
                                       atol=1e-7, err_msg=f"{k}.{f}")


def test_fold_preserves_the_float_forward(params):
    bn, _ = params
    model = C.slim_from_params(bn, device="cpu")
    x = torch.as_tensor(calib_batches()[0])
    with torch.no_grad():
        want = model(x)[0]
        got = fold_batch_norm(model)(x)[0]
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("form", ["bn", "fused"])
def test_float_forward_matches_jax(params, form):
    bn, fj = params
    tree = bn if form == "bn" else fj
    cfg, _ = cfgs()
    x = calib_batches()[0]
    want = np.asarray(jax.jit(lambda p, x: jslim.forward(p, x, cfg)[0])(
        jtree(tree), x))
    with torch.no_grad():
        got = C.slim_from_params(tree, device="cpu")(torch.as_tensor(x))[0]
    assert got.shape == want.shape == (2, SIZE // 16, SIZE // 16, PRED_OUT)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                               atol=1e-5 * np.abs(want).max())


def test_module_tree_round_trip(params):
    bn, fj = params
    for tree in (bn, fj):
        back = C.module_to_params(C.slim_from_params(tree, device="cpu"))
        for k in QUANT_LAYER_NAMES:
            assert set(back[k]) == set(tree[k])
            np.testing.assert_array_equal(back[k]["w"], tree[k]["w"])
    with pytest.raises(ValueError, match="form"):
        C.load_params(C.slim_from_params(fj, device="cpu"), bn)
    bad = dict(fj, conv2={"w": fj["conv2"]["w"][:, :, :8],
                          "b": fj["conv2"]["b"]})
    with pytest.raises(ValueError, match="shape"):
        C.slim_from_params(bad, device="cpu")


@pytest.mark.parametrize("key", list(FQ_OPTIONS))
def test_fake_quantize_params_equal(params, key):
    _, fj = params
    opts = FQ_OPTIONS[key]
    want = jax.device_get(jqsim.fake_quantize_params(jtree(fj), **opts))
    got = C.module_to_params(qsim.fake_quantize_params(
        C.slim_from_params(fj, device="cpu"), **opts))
    for k in QUANT_LAYER_NAMES:
        np.testing.assert_array_equal(got[k]["w"], want[k]["w"])
        np.testing.assert_array_equal(got[k]["b"], want[k]["b"])


def test_weight_scale_exponents_equal(params):
    _, fj = params
    want = jqsim.weight_scale_exponents(jtree(fj))
    assert qsim.weight_scale_exponents(
        C.slim_from_params(fj, device="cpu")) == want


@pytest.mark.parametrize("key", list(OPTIONS))
def test_tracker_scales_and_sa(params, jax_runs, key):
    """The port's calibration of the JAX-folded floats: every float scale
    within rtol 1e-5 of the JAX package's, every sa equal."""
    _, fj = params
    opts = OPTIONS[key]
    mj, states_j = jax_runs[key]
    _, cfg = cfgs()
    pq = qsim.fake_quantize_params(
        C.slim_from_params(fj, device="cpu"),
        weight_bitwidth=opts.get("weight_bitwidth"),
        per_channel=opts.get("per_channel", False))
    states = qsim.calibrate(pq, cfg, calib_batches(),
                            head_clip=opts.get("head_clip"),
                            act_percentile=opts.get("act_percentile"))
    assert set(states) == set(TRACKER_NAMES)
    for k in TRACKER_NAMES:
        assert states[k]["scale"].dtype == torch.float32
        np.testing.assert_allclose(float(states[k]["scale"]),
                                   states_j[k]["scale"], rtol=SCALE_RTOL,
                                   err_msg=k)
    assert qsim.activation_scale_exponents(states) == mj.sa


def test_maxima_and_retune_equal(params, jax_runs):
    """Pre-activation maxima within rtol 1e-5, the retune search equal,
    both on the JAX-calibrated states."""
    _, fj = params
    mj, states_j = jax_runs["plain"]
    cfg_j, cfg = cfgs()
    pq_j = jqsim.fake_quantize_params(jtree(fj))
    pq = qsim.fake_quantize_params(C.slim_from_params(fj, device="cpu"))
    states = {k: tq.as_state(s) for k, s in states_j.items()}
    for x in calib_batches():
        _, _, mx_j = jqsim.quant_forward(pq_j, jnp.asarray(x), cfg_j,
                                         jtree(states_j))
        _, _, mx = qsim.quant_forward(pq, torch.as_tensor(x), cfg, states)
        for k in QUANT_LAYER_NAMES:
            np.testing.assert_allclose(float(mx[k]), float(mx_j[k]),
                                       rtol=SCALE_RTOL, err_msg=k)
    got = qsim.find_retune_exponents(pq, cfg, states, calib_batches())
    assert got == mj.retune == jqsim.find_retune_exponents(
        pq_j, cfg_j, jtree(states_j), calib_batches())


# ---------------------------------------------------------------------------
# The pipeline.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("key", list(OPTIONS))
def test_pipeline_tables_equal(params, jax_runs, key):
    """The port's own pipeline, BN fold included: every table equal."""
    bn, _ = params
    mt = quantize_pipeline(C.slim_from_params(bn, device="cpu"), cfgs()[1],
                           calib_batches(), fold_bn=True, **OPTIONS[key])
    assert_tables_equal(jax_runs[key][0], mt)
    assert mt.per_channel == (key == "per_channel")


@pytest.mark.parametrize("key", list(OPTIONS))
def test_pipeline_on_jax_fold_equal(params, jax_runs, key):
    """On the JAX-folded floats (fold_bn=False), int8 weights, biases and
    every table equal to the JAX pipeline's."""
    _, fj = params
    mj = jax_runs[key][0]
    mt = quantize_pipeline(C.slim_from_params(fj, device="cpu"), cfgs()[1],
                           calib_batches(), fold_bn=False, **OPTIONS[key])
    assert_int8_equal(mj, mt)
    assert_tables_equal(mj, mt)
    if key == "weight_bitwidth_4":
        assert max(int(w.abs().max()) for w in mt.w_q.values()) <= 7


@pytest.mark.parametrize("key", list(OPTIONS))
def test_own_fold_int8_differs_only_at_fold_ties(params, jax_runs, key):
    """With the port's own fold, an int8 weight may differ from the JAX
    package's only where the two folds' floats differ and the level sits
    at a rounding tie: by one level, each side's float rounding to its
    own level on the same pow2 grid. Biases are equal."""
    bn, fj = params
    mj = jax_runs[key][0]
    opts = OPTIONS[key]
    ft = fold_batch_norm(bn)
    mt = quantize_pipeline(C.slim_from_params(bn, device="cpu"), cfgs()[1],
                           calib_batches(), fold_bn=True, **opts)
    axis = -1 if opts.get("per_channel") else None
    bits = opts.get("weight_bitwidth", 8)
    for k in QUANT_LAYER_NAMES:
        np.testing.assert_array_equal(mt.b_q[k].numpy(), mj.b_q[k])
        got, want = mt.w_q[k].numpy(), mj.w_q[k]
        diff = got != want
        if not diff.any():
            continue
        lt, _ = tq.quantize_pow2_np(ft[k]["w"], bits, axis)
        lj, _ = tq.quantize_pow2_np(fj[k]["w"], bits, axis)
        np.testing.assert_array_equal(lt, got)
        np.testing.assert_array_equal(lj, want)
        assert (ft[k]["w"][diff] != fj[k]["w"][diff]).all(), k
        assert (np.abs(got[diff].astype(int) - want[diff]) == 1).all(), k


def test_states_given_skips_calibration(params, jax_runs, monkeypatch):
    """``states=`` skips calibration; the model equals the JAX pipeline's
    on the same states."""
    _, fj = params
    cfg_j, cfg = cfgs()
    states_j = jax_runs["head_clip"][1]  # states no default run gives
    mj = jax.device_get(jax_pipeline(jtree(fj), cfg_j, calib_batches(),
                                     fold_bn=False, states=states_j))

    def refuse(*a, **k):
        raise AssertionError("calibrate ran although states were given")

    monkeypatch.setattr(qsim, "calibrate", refuse)
    mt = quantize_pipeline(C.slim_from_params(fj, device="cpu"), cfg,
                           calib_batches(), fold_bn=False, states=states_j)
    assert_int8_equal(mj, mt)
    assert_tables_equal(mj, mt)
    assert mt.sa == jax_runs["head_clip"][0].sa


def test_max_images_stops_calibration(params):
    """The loop ends once more than max_images images were seen: with
    max_images=1 only the first batch of 2 calibrates."""
    _, fj = params
    _, cfg = cfgs()
    pq = qsim.fake_quantize_params(C.slim_from_params(fj, device="cpu"))
    batches = calib_batches()
    one = qsim.calibrate(pq, cfg, batches[:1])
    capped = qsim.calibrate(pq, cfg, batches, max_images=1)
    full = qsim.calibrate(pq, cfg, batches)
    for k in TRACKER_NAMES:
        assert torch.equal(capped[k]["scale"], one[k]["scale"])
    assert any(not torch.equal(full[k]["scale"], one[k]["scale"])
               for k in TRACKER_NAMES)


def test_percentile_position_in_float32():
    """jnp.percentile's arithmetic: at n = 3,000,017 distinct integers the
    float32 position 0.999 * (n - 1) rounds to 2997016.0 (float64 gives
    2997015.98), and the result is that order statistic, bit for bit the
    JAX package's."""
    n = 3_000_017
    x = np.random.default_rng(0).permutation(n).astype(np.float32)
    want = np.asarray(jnp.percentile(jnp.asarray(x), 99.9))
    got = tq.percentile_f32(torch.as_tensor(x), 99.9).numpy()
    assert got == want == np.float32(2997016.0)
    assert np.percentile(x.astype(np.float64), 99.9) != float(got)
    big = torch.zeros(2 ** 24 + 5)
    big[7] = 9.0
    assert float(tq.percentile_f32(big, 100.0)) == 9.0
    with pytest.raises(RuntimeError, match="too large"):
        torch.quantile(big, 0.5)
    x[3] = np.nan
    assert np.isnan(tq.percentile_f32(torch.as_tensor(x), 50.0).numpy())


@pytest.mark.parametrize("axis", [None, -1])
def test_pow2_primitives_match_jax(axis):
    rng = np.random.default_rng(3)
    t = (rng.standard_normal((3, 3, 8, 16)) * np.exp2(
        rng.integers(-6, 6, 16))).astype(np.float32)
    want = np.asarray(jax.jit(lambda v: jq.fake_quantize(v, 8, axis))(t))
    got = tq.fake_quantize(torch.as_tensor(t), 8, axis).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        tq.pow2_scale(torch.as_tensor(t), 8, axis).numpy(),
        np.asarray(jq.pow2_scale(jnp.asarray(t), 8, axis)))
    z = tq.pow2_scale(torch.zeros(5))
    assert float(z) == 1.0


def test_tf32_is_off_in_the_float_forward(params, monkeypatch):
    """Every float conv of the pipeline runs with TF32 off for cuDNN and
    matmuls, and the flags come back as they were."""
    _, fj = params
    seen = []
    real = blocks.F.conv2d

    def spy(*a, **k):
        seen.append((torch.backends.cudnn.allow_tf32,
                     torch.backends.cuda.matmul.allow_tf32))
        return real(*a, **k)

    monkeypatch.setattr(blocks.F, "conv2d", spy)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    quantize_pipeline(C.slim_from_params(fj, device="cpu"), cfgs()[1],
                      calib_batches()[:1], fold_bn=False)
    assert len(seen) == 2 * len(QUANT_LAYER_NAMES)
    assert set(seen) == {(False, False)}
    assert torch.backends.cudnn.allow_tf32
    assert torch.backends.cuda.matmul.allow_tf32


def test_quantize_model_on_a_tree(params, jax_runs):
    """quantize_model takes the JAX package's fused tree too."""
    _, fj = params
    mj, states_j = jax_runs["plain"]
    mt = tfp.quantize_model(fj, states_j, mj.retune, device="cpu")
    assert_int8_equal(mj, mt)
    assert_tables_equal(mj, mt)


def test_build_int8_detect_on_the_cpu():
    _, cfg = cfgs()
    fn, m = build_int8_detect(cfg, device="cpu")
    assert not m.per_channel and set(m.sa) == set(TRACKER_NAMES)
    images = np.random.default_rng(2).random((2, SIZE, SIZE, 3),
                                             dtype=np.float32)
    boxes, scores, classes, valid = fn(None, images)
    assert boxes.shape == (2, cfg.top_k, 4)
    assert torch.isfinite(boxes).all() and torch.isfinite(scores).all()


@pytest.mark.parametrize("family", ["slim_yolo_v2", "yolo_v3"])
def test_models_without_device_need_cuda(family):
    """The float models are built on the card unless the caller asks for
    the CPU; without a card they raise, never falling back."""
    from yolo_tpu_torch.models.slim_yolo_v2 import SlimYOLOv2
    from yolo_tpu_torch.models.yolo_v3 import YOLOv3

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    cls = SlimYOLOv2 if family == "slim_yolo_v2" else YOLOv3
    with pytest.raises(RuntimeError, match="CUDA"):
        cls(PRED_OUT)
    assert next(cls(PRED_OUT, device="cpu").parameters()).device.type == \
        "cpu"


@pytest.mark.parametrize("build", ["conv_block", "quantize_model"])
def test_builders_without_device_need_cuda(params, jax_runs, build):
    """A conv block is built, and a JAX-layout tree quantized, on the card
    unless the caller asks for the CPU; without a card they raise."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    _, fj = params
    mj, states_j = jax_runs["plain"]
    make = {
        "conv_block": lambda **kw: blocks.ConvBlock(
            3, 3, 16, **kw).conv.weight,
        "quantize_model": lambda **kw: tfp.quantize_model(
            fj, states_j, mj.retune, **kw).w_q["conv1"],
    }[build]
    with pytest.raises(RuntimeError, match="CUDA"):
        make()
    assert make(device="cpu").device.type == "cpu"


# ---------------------------------------------------------------------------
# weight.h.
# ---------------------------------------------------------------------------


def test_export_tables_refuses_per_channel(jax_runs):
    mj = jax_runs["per_channel"][0]
    mt = C.int8_model_from_numpy(mj.w_q, mj.b_q, mj.sw, mj.sb, mj.sa,
                                 mj.retune, device="cpu")
    with pytest.raises(ValueError, match="per-channel"):
        export_tables(mt)


@pytest.mark.parametrize("key", ["plain", "weight_bitwidth_4"])
def test_c_header_byte_identical_to_jax(params, jax_runs, key, tmp_path):
    _, fj = params
    mj = jax_runs[key][0]
    mt = quantize_pipeline(C.slim_from_params(fj, device="cpu"), cfgs()[1],
                           calib_batches(), fold_bn=False, **OPTIONS[key])
    jax_export_c_header(mj, str(tmp_path / "jax.h"))
    export_c_header(mt, str(tmp_path / "port.h"))
    want = (tmp_path / "jax.h").read_bytes()
    assert (tmp_path / "port.h").read_bytes() == want
    assert c_header(mt).encode() == want
    assert export_tables(mt)["scale_a"] == [mj.sa[n] for n in TRACKER_NAMES]


@pytest.mark.skipif(CC is None, reason="no C compiler on PATH")
@pytest.mark.parametrize("rounding", ["nearest", "floor"])
def test_c_engine_consumes_the_port_header(params, rounding, tmp_path):
    """The port's own pipeline (BN fold included) -> its weight.h ->
    ``native/int8_engine.c``, compiled with the system compiler around it:
    the C engine's int8 head equals the port's plain ``int8_forward``."""
    bn, _ = params
    mt = quantize_pipeline(C.slim_from_params(bn, device="cpu"), cfgs()[1],
                           calib_batches(), fold_bn=True)
    export_c_header(mt, str(tmp_path / "weight.h"))
    x_q = tfp.quantize_input(torch.as_tensor(calib_batches()[0]),
                             mt.sa["in"])
    head = tfp.int8_forward(mt, x_q, rounding)
    expected = torch.round(head * 2.0 ** mt.sa["pred"]).to(torch.int8)
    write_model_h(tmp_path / "model.h", mt, x_q.numpy(), expected.numpy(),
                  rounding)
    exe = tmp_path / "engine"
    subprocess.run(
        [CC, "-O2", "-I", str(tmp_path), "-o", str(exe),
         str(Path(__file__).resolve().parents[1] / "native"
             / "int8_engine.c")],
        check=True, capture_output=True, text=True)
    res = subprocess.run([str(exe)], capture_output=True, text=True)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "match" in res.stdout
