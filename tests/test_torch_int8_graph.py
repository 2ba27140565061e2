"""The port's slim INT8 serving slice against the JAX package at 32²:
the int8 head bit-exact, detections with classes/valid exact and
boxes/scores allclose (atol = rtol = 1e-5: float32 sigmoid, exp and
softmax in another framework)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolo_tpu.config import get_config
from yolo_tpu.models import slim_yolo_v2
from yolo_tpu.quant import fixed_point as fp
from yolo_tpu.quant.int8_graph import make_int8_detect_fn, quantize_pipeline
from yolo_tpu_torch.config import get_config as t_get_config
from yolo_tpu_torch.quant import fixed_point as tfp
from yolo_tpu_torch.quant.convert import (
    int8_model_from_numpy, load_int8_model_npz, save_int8_model_npz)
from yolo_tpu_torch.quant.int8_graph import (
    make_int8_detect_fn as t_make_int8_detect_fn)

torch.set_num_threads(1)

SIZE = 32
TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def models():
    """(JAX Int8Model, port Int8Model on the CPU, float images)."""
    rng = np.random.default_rng(0)
    cfg = get_config("slim_yolo_v2", "mask", input_size=(SIZE, SIZE))
    params = slim_yolo_v2.init_params(jax.random.PRNGKey(1), cfg,
                                      batch_norm=True)
    batches = [rng.random((3, SIZE, SIZE, 3), dtype=np.float32)]
    m = quantize_pipeline(params, cfg, batches)
    mn = jax.device_get(m)
    tm = int8_model_from_numpy(mn.w_q, mn.b_q, mn.sw, mn.sb, mn.sa,
                               mn.retune, device="cpu")
    return m, tm, batches[0]


def _cfgs():
    kw = dict(input_size=(SIZE, SIZE), pre_nms_top_k=64, top_k=20)
    return (get_config("slim_yolo_v2", "mask", **kw),
            t_get_config("slim_yolo_v2", "mask", **kw))


@pytest.mark.parametrize("rounding", ["nearest", "floor"])
def test_head_bit_exact_s2d(models, rounding):
    m, tm, images = models
    x_q = np.asarray(fp.quantize_input(jnp.asarray(images), m.sa["in"]))
    x2 = fp.s2d_input_np(x_q)
    want = np.asarray(fp.int8_forward(m, jnp.asarray(x2), rounding,
                                      input_s2d=True))
    oracle = fp.int8_forward_numpy(m, x_q, rounding)
    got = tfp.int8_forward(tm, torch.tensor(x2), rounding,
                           input_s2d=True).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, oracle)


@pytest.mark.parametrize("rounding", ["nearest", "floor"])
def test_head_bit_exact_nhwc(models, rounding):
    m, tm, images = models
    x_q = np.asarray(fp.quantize_input(jnp.asarray(images), m.sa["in"]))
    want = np.asarray(fp.int8_forward(m, jnp.asarray(x_q), rounding))
    got = tfp.int8_forward(tm, torch.tensor(x_q), rounding).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("rounding", ["nearest", "floor"])
def test_detections_match_jax(models, rounding):
    m, tm, images = models
    cfg, tcfg = _cfgs()
    x_q = np.asarray(fp.quantize_input(jnp.asarray(images), m.sa["in"]))
    x2 = fp.s2d_input_np(x_q)
    want = jax.device_get(make_int8_detect_fn(m, cfg, rounding,
                                              input_s2d=True)(x2))
    got = t_make_int8_detect_fn(tm, tcfg, rounding, input_s2d=True,
                                device="cpu")(x2)
    boxes, scores, classes, valid = (t.numpy() for t in got)
    np.testing.assert_array_equal(valid, want[3])
    np.testing.assert_array_equal(classes, want[2])
    np.testing.assert_allclose(boxes, want[0], **TOL)
    np.testing.assert_allclose(scores, want[1], **TOL)
    assert valid.any()


def test_float_int8_and_s2d_inputs_agree(models):
    m, tm, images = models
    _, tcfg = _cfgs()
    x_q = tfp.quantize_input(torch.as_tensor(images), tm.sa["in"])
    outs = [
        t_make_int8_detect_fn(tm, tcfg, device="cpu")(images),
        t_make_int8_detect_fn(tm, tcfg, device="cpu")(x_q),
        t_make_int8_detect_fn(tm, tcfg, input_s2d=True,
                              device="cpu")(images),
        t_make_int8_detect_fn(tm, tcfg, input_s2d=True,
                              device="cpu")(tfp.s2d_input(x_q)),
    ]
    for out in outs[1:]:
        for a, b in zip(outs[0], out):
            assert torch.equal(a, b)


def test_npz_round_trip(models, tmp_path):
    _, tm, images = models
    path = tmp_path / "m.npz"
    save_int8_model_npz(path, tm, note=np.arange(3))
    tm2 = load_int8_model_npz(path, device="cpu")
    assert tm2.sw == tm.sw and tm2.sa == tm.sa and tm2.retune == tm.retune
    for k in tm.w_q:
        assert torch.equal(tm.w_q[k], tm2.w_q[k])
        assert torch.equal(tm.b_q[k], tm2.b_q[k])
    x_q = tfp.quantize_input(torch.as_tensor(images), tm.sa["in"])
    assert torch.equal(tfp.int8_forward(tm, x_q), tfp.int8_forward(tm2, x_q))


def test_per_channel_sw_raises(models):
    """A per-channel sw runs on NHWC input only: the s2d forward and an
    s2d detect fn refuse it, as the JAX package does."""
    _, tm, images = models
    _, tcfg = _cfgs()
    sw = dict(tm.sw)
    sw["conv5"] = np.full(256, 7, np.int32)
    pc = tfp.Int8Model(tm.w_q, tm.b_q, sw, tm.sb, tm.sa, tm.retune)
    x_q = tfp.quantize_input(torch.as_tensor(images), tm.sa["in"])
    with pytest.raises(ValueError, match="per-channel"):
        tfp.int8_forward(pc, tfp.s2d_input(x_q), input_s2d=True)
    with pytest.raises(ValueError, match="per-channel"):
        t_make_int8_detect_fn(pc, tcfg, input_s2d=True, device="cpu")


def test_bad_input_shape_raises(models):
    _, tm, _ = models
    _, tcfg = _cfgs()
    detect = t_make_int8_detect_fn(tm, tcfg, input_s2d=True, device="cpu")
    with pytest.raises(ValueError, match="s2d"):
        detect(torch.zeros((1, SIZE, SIZE, 3), dtype=torch.int8))
