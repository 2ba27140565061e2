"""The port's float ``Detector`` against the JAX package's on the CPU, on
the same parameters (the JAX init, loaded into the port's model):
``predict`` at 32² (slim) and 64² (yolo_v3) within rtol = 1e-4, atol =
1e-5 (float32 convs summed in another order); the port's postprocess on
the JAX ``predict`` outputs equal to the JAX one (classes and valid
exact, boxes and scores within 1e-6); ``detect``,
``detect_single_numpy``, uint8 input through ``normalize_u8`` (equal to
the JAX one), and bf16 within 3e-2 of the port's float32."""

import jax
import numpy as np
import pytest
import torch

from yolo_tpu.config import get_config
from yolo_tpu.detector import Detector as JaxDetector
from yolo_tpu.detector import normalize_u8 as jax_normalize_u8
from yolo_tpu.ops import nms
from yolo_tpu_torch import detector as tdet
from yolo_tpu_torch.config import get_config as t_get_config
from yolo_tpu_torch.ops import nms as tnms

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-5)
# a threshold low enough that most slots hold a detection
KW = dict(conf_thresh=0.001, nms_thresh=0.45)
CASES = {"slim_yolo_v2": dict(input_size=(32, 32), top_k=20, **KW),
         "yolo_v3": dict(input_size=(64, 64), top_k=60, **KW)}


@pytest.fixture(scope="module", params=sorted(CASES))
def pair(request):
    """(JAX Detector, its params, the port's Detector with them, images)."""
    version = request.param
    cfg = get_config(version, "mask", **CASES[version])
    jd = JaxDetector(cfg)
    params = jax.device_get(jd.init_params(jax.random.PRNGKey(0)))
    td = tdet.Detector(t_get_config(version, "mask", **CASES[version]),
                       device="cpu").load_params(params)
    h, w = cfg.input_size
    x = np.random.default_rng(0).random((2, h, w, 3), dtype=np.float32)
    return jd, params, td, x


def test_predict_matches_jax(pair):
    jd, params, td, x = pair
    jb, jp = jd.predict(params, x)
    tb, tp = td.predict(x)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), **TOL)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), **TOL)


def test_postprocess_on_jax_predictions_matches_jax(pair):
    jd, params, td, x = pair
    cfg = td.cfg
    jb, jp = (np.asarray(a) for a in jd.predict(params, x))
    want = nms.batched_postprocess(jb, jp, cfg.conf_thresh, cfg.nms_thresh,
                                   cfg.pre_nms_top_k, cfg.top_k)
    got = tnms.batched_postprocess(torch.from_numpy(jb),
                                   torch.from_numpy(jp), cfg.conf_thresh,
                                   cfg.nms_thresh, cfg.pre_nms_top_k,
                                   cfg.top_k)
    boxes, scores, classes, valid = (a.numpy() for a in got)
    np.testing.assert_array_equal(classes, np.asarray(want[2]))
    np.testing.assert_array_equal(valid, np.asarray(want[3]))
    np.testing.assert_allclose(boxes, np.asarray(want[0]), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(scores, np.asarray(want[1]), rtol=0,
                               atol=1e-6)
    assert valid.mean() >= 0.25  # NMS has work to do


def test_detect_and_single_numpy(pair):
    jd, params, td, x = pair
    got = td.detect(x)
    want = tnms.batched_postprocess(*td.predict(x), td.cfg.conf_thresh,
                                    td.cfg.nms_thresh, td.cfg.pre_nms_top_k,
                                    td.cfg.top_k)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert not td._detect.graphs  # nothing is captured on the CPU
    jwant = jd.detect(params, x)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(jwant[2]))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(jwant[3]))
    for g, w in zip(td.detect_single_numpy(x[0]),
                    jd.detect_single_numpy(params, x[0])):
        np.testing.assert_allclose(g, np.asarray(w), **TOL)


def test_uint8_input_matches_jax(pair):
    jd, params, td, _ = pair
    h, w = td.cfg.input_size
    u8 = np.random.default_rng(1).integers(0, 256, (2, h, w, 3),
                                           dtype=np.uint8)
    np.testing.assert_array_equal(
        tdet.normalize_u8(torch.from_numpy(u8)).numpy(),
        np.asarray(jax_normalize_u8(u8)))
    jb, jp = jd.predict(params, u8)
    tb, tp = td.predict(u8)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), **TOL)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), **TOL)


def test_bf16_close_to_fp32(pair):
    _, params, td, x = pair
    bf = tdet.Detector(td.cfg, dtype=torch.bfloat16,
                       device="cpu").load_params(params)
    assert next(bf.model.parameters()).dtype == torch.bfloat16
    fb, fp_ = td.predict(x)
    bb, bp = bf.predict(x)
    assert bb.dtype == bp.dtype == torch.float32  # decode in float32
    np.testing.assert_allclose(bb.numpy(), fb.numpy(), rtol=0, atol=3e-2)
    np.testing.assert_allclose(bp.numpy(), fp_.numpy(), rtol=0, atol=3e-2)
    out = bf.detect(x)
    assert out[0].dtype == torch.float32 and out[3].dtype == torch.bool


def test_build_detector_forms():
    det = tdet.build_detector("slim_yolo_v2_q_bf", "mask", device="cpu",
                              input_size=(32, 32))
    assert det.cfg.name == "slim_yolo_v2_q_bf" and not det.batch_norm
    assert det.model.conv1.bn is None and det.model.conv1.conv.bias is not None
    det.init_params(torch.Generator().manual_seed(0))
    boxes, scores, classes, valid = det.detect(
        np.zeros((1, 32, 32, 3), np.float32))
    assert tuple(boxes.shape) == (1, det.cfg.top_k, 4)
    with pytest.raises(ValueError, match="input_size"):
        det.detect(np.zeros((1, 64, 64, 3), np.float32))


def test_detector_form_follows_the_version_name():
    """``batch_norm`` has one source, the version name: None takes it, a
    model built here refuses another form, a given model keeps its
    label."""
    cfg = t_get_config("slim_yolo_v2", "mask", input_size=(32, 32))
    det = tdet.Detector(cfg, device="cpu")
    assert det.batch_norm and det.model.conv1.bn is not None
    assert tdet.Detector(cfg, batch_norm=True, device="cpu").batch_norm
    with pytest.raises(ValueError, match="slim_yolo_v2_q_bf"):
        tdet.Detector(cfg, batch_norm=False, device="cpu")
    fused = tdet.build_detector("slim_yolo_v2_q_bf", "mask", device="cpu",
                                input_size=(32, 32))
    assert not tdet.Detector(cfg, model=fused.model, batch_norm=False,
                             device="cpu").batch_norm
