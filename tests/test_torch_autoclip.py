"""The port's clip search (``quant/autoclip.py``), ``build_int8_detector(
head_clip="auto")`` and ``quant/analysis.py`` against the JAX package on
the CPU: slim_yolo_v2_q_bf at 32² and tiny_yolo_v3 at 64², BN-fused
floats (the same in both packages), the prediction heads' weights scaled
up (HEAD_GAIN) so that their range (~20-50) passes the caps and the cap
sweep binds.

Held: ``detection_agreement`` exactly (the same numpy arithmetic);
every choice of the search (the cap, the percentile, the greedy flips)
equal, every agreement score within SCORE_TOL = 1e-4 (two float32
reference forwards sum in other orders: a box moves by ~1e-6); tracker
scales rtol 1e-5 (the PTQ tests' bound); ``analysis`` rows: names
exact, floats rtol 1e-6 (the same numpy arithmetic on the same float32
weights and states)."""

import jax
import numpy as np
import pytest
import torch

from yolo_tpu.config import get_config as jget_config
from yolo_tpu.quant import analysis as janalysis
from yolo_tpu.quant import autoclip as jautoclip
from yolo_tpu.quant.bn_fold import fold_batch_norm as jax_fold
from yolo_tpu_torch.config import get_config
from yolo_tpu_torch.quant import analysis, autoclip
from yolo_tpu_torch.quant import convert as C
from yolo_tpu_torch.quant import dispatch

torch.set_num_threads(1)

SCORE_TOL = 1e-4
SCALE_RTOL = 1e-5
FAMILIES = {"slim_yolo_v2_q_bf": (32, 2), "tiny_yolo_v3": (64, 1)}
CAPS = (None, 8.0, 16.0)
PERCENTILES = (None, 99.0)
# the heads' range: slim's 0.8 -> 24, tiny's 0.01 / 0.015 (its
# activations shrink through the seeded layers) -> 29 / 45
HEAD_GAIN = {"slim_yolo_v2_q_bf": 30.0, "tiny_yolo_v3": 3000.0}


def _float(version):
    """-> (JAX cfg, fused JAX-layout params (numpy), port cfg, calibration
    batches)."""
    size, n = FAMILIES[version]
    jcfg = jget_config(version, "mask", input_size=(size, size))
    pred_out = jcfg.anchors_per_scale * (1 + 4 + jcfg.num_classes)
    if version.startswith("slim"):
        fused = jax.device_get(jax_fold(C.slim_seeded_bn_params(0,
                                                                pred_out)))
        heads = ("pred",)
    else:
        fused = C.tiny_seeded_fused_params(0, pred_out)
        heads = ("pred_1", "pred_2")
    fused = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                   fused)
    for h in heads:
        fused[h]["w"] = fused[h]["w"] * np.float32(HEAD_GAIN[version])
    rng = np.random.default_rng(7)
    batches = [rng.random((2, size, size, 3), dtype=np.float32)
               for _ in range(n)]
    return jcfg, fused, get_config(version, "mask",
                                   input_size=(size, size)), batches


def _model(version, fused):
    return (C.slim_from_params if version.startswith("slim")
            else C.tiny_from_params)(fused, device="cpu")


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def searched(request):
    """Both packages' ``select_quant_config(greedy_rounds=1)`` on one
    family (its first stage is ``select_head_clip``)."""
    version = request.param
    jcfg, fused, cfg, batches = _float(version)
    kw = dict(caps=CAPS, percentiles=PERCENTILES, greedy_rounds=1)
    jbest, jinfo = jautoclip.select_quant_config(version, fused, jcfg,
                                                 batches, **kw)
    best, info = autoclip.select_quant_config(
        version, _model(version, fused), cfg, batches, device="cpu", **kw)
    return version, (jbest, jinfo), (best, info)


def _close_scores(got, want):
    assert list(got) == list(want)
    for k in want:
        assert abs(got[k] - want[k]) <= SCORE_TOL, (k, got[k], want[k])


def _close_states(got, want):
    items = (list(want.items()) if isinstance(want, dict)
             else list(enumerate(want)))
    assert len(got) == len(want)
    for k, w in items:
        np.testing.assert_allclose(float(got[k]["scale"]),
                                   float(np.asarray(w["scale"])),
                                   rtol=SCALE_RTOL, err_msg=str(k))


def test_head_clip_sweep_picks_jax_cap_and_binds(searched):
    version, (jbest, jinfo), (best, info) = searched
    assert best["head_clip"] == jbest["head_clip"]
    _close_scores(info["cap_scores"], jinfo["cap_scores"])
    # an option that never binds tests nothing: a cap changes the score
    assert len(set(np.round(list(info["cap_scores"].values()), 6))) > 1, \
        info["cap_scores"]


def test_percentile_sweep_picks_jax_percentile(searched):
    version, (jbest, jinfo), (best, info) = searched
    assert best["act_percentile"] == jbest["act_percentile"]
    _close_scores(info["pct_scores"], jinfo["pct_scores"])


def test_greedy_round_makes_jax_flips(searched):
    version, (jbest, jinfo), (best, info) = searched
    assert [(r, k) for r, k, _ in info["greedy_flips"]] == \
        [(r, k) for r, k, _ in jinfo["greedy_flips"]]
    for (_, _, s), (_, _, js) in zip(info["greedy_flips"],
                                     jinfo["greedy_flips"]):
        assert abs(s - js) <= SCORE_TOL
    assert abs(best["score"] - jbest["score"]) <= SCORE_TOL
    _close_states(best["states"], jbest["states"])
    assert best["score"] >= max(info["pct_scores"].values()) - 1e-9


@pytest.mark.parametrize("version", sorted(FAMILIES))
def test_calibrate_states_match_jax(version):
    jcfg, fused, cfg, batches = _float(version)
    want = jautoclip.calibrate_states(version, fused, jcfg, batches,
                                      head_clip=16.0, act_percentile=99.5)
    got = autoclip.calibrate_states(version, _model(version, fused), cfg,
                                    batches, head_clip=16.0,
                                    act_percentile=99.5, device="cpu")
    assert isinstance(got, dict) == version.startswith("slim")
    _close_states(got, want)


def test_build_int8_detector_auto_picks_the_jax_cap():
    version = "slim_yolo_v2_q_bf"
    jcfg, fused, cfg, batches = _float(version)
    want, _ = jautoclip.select_head_clip(version, fused, jcfg, batches)
    m, detect = dispatch.build_int8_detector(
        version, _model(version, fused), cfg, batches, head_clip="auto",
        device="cpu")
    ref, _ = dispatch.build_int8_detector(
        version, _model(version, fused), cfg, batches, head_clip=want,
        device="cpu")
    assert m.sa == ref.sa and m.retune == ref.retune
    out = detect(batches[0])
    assert tuple(out[0].shape) == (2, cfg.top_k, 4)


@pytest.mark.parametrize("seed", range(4))
def test_detection_agreement_is_the_jax_metric(seed):
    rng = np.random.default_rng(seed)

    def dets(b=3, k=20):
        xy = rng.uniform(0, 0.7, (b, k, 2))
        boxes = np.concatenate([xy, xy + rng.uniform(0.05, 0.3, (b, k, 2))],
                               -1).astype(np.float32)
        return (boxes, rng.random((b, k), dtype=np.float32),
                rng.integers(0, 3, (b, k)).astype(np.int32),
                rng.random((b, k)) < 0.6)

    f = dets()
    near = (f[0] + rng.normal(0, 0.02, f[0].shape).astype(np.float32),
            np.clip(f[1] + rng.normal(0, 0.1, f[1].shape), 0, 1).astype(
                np.float32), f[2], f[3] & (rng.random(f[3].shape) < 0.8))
    for other in (f, near, dets()):
        want = jautoclip.detection_agreement(f, other)
        got = autoclip.detection_agreement(
            tuple(torch.as_tensor(a) for a in f), other)
        assert got == want
    assert autoclip.detection_agreement(f, f) == 1.0
    empty = (f[0], f[1], f[2], np.zeros_like(f[3]))
    assert autoclip.detection_agreement(empty, f) == 1.0


def _close_rows(got, want, key):
    """Rows by their name (``key``), in any order: the JAX tree's key
    order and the model's module order differ for tiny_yolo_v3."""
    got = {r[key]: r for r in got}
    want = {r[key]: r for r in want}
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        g = got[name]
        assert list(g) == list(w)
        for k in w:
            if isinstance(w[k], float):
                np.testing.assert_allclose(g[k], w[k], rtol=1e-6,
                                           err_msg=str((w, k)))
            else:
                assert g[k] == w[k], (k, g[k], w[k])


@pytest.mark.parametrize("version", sorted(FAMILIES))
def test_analysis_rows_match_jax(version, capsys):
    jcfg, fused, cfg, batches = _float(version)
    model = _model(version, fused)
    want = janalysis.weight_report(fused)
    got = analysis.weight_report(model)
    _close_rows(got, want, "layer")
    assert got[0]["layer"] == ("conv1" if version.startswith("slim")
                               else "backbone.conv_1[0]")
    _close_rows(analysis.weight_report(fused, bitwidth=4),
                janalysis.weight_report(fused, bitwidth=4), "layer")
    jstates = jautoclip.calibrate_states(version, fused, jcfg, batches)
    states = autoclip.calibrate_states(version, model, cfg, batches,
                                       device="cpu")
    _close_rows(analysis.activation_report(states),
                janalysis.activation_report(jstates), "tracker")
    analysis.print_report(want, "weights")
    out = capsys.readouterr().out
    janalysis.print_report(want, "weights")
    assert capsys.readouterr().out == out
