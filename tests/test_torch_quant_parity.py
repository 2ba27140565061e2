"""The port's accuracy scripts (``scripts/quant_parity_torch.py``,
``quant_parity_v3_torch.py``, ``quant_bitwidth_torch.py``) against the
JAX scripts' calls on the CPU, hard synthetic regime.

- (a) slim_yolo_v2 at 64²: the JAX package's ``PRNGKey(0)`` params
  (every BN's running variance set so that both packages fold it
  exactly: EXACT_FOLD_VAR), carried into the port
  (``convert.slim_from_params``); 16 val images,
  2 calibration batches of 8. Each stage of ``scripts/quant_parity.py:
  121-213`` built with the JAX calls it makes and with the port script's
  own stage code, scored by each package's evaluator on its own copy of
  the images.
- (b) the port script's ``main`` end to end: a training run (its stage
  names are the JAX script's, in its order; its JSON has the keys of the
  one the JAX script wrote, ``docs/examples/parity_slim_416_hard.json``),
  and ``--skip_train`` on a checkpoint the JAX package saved, whose
  ``int8_integer`` detections are the JAX pipeline's. The clip search's
  candidate lists are shrunk here, in the test only.
- (c) the v3 script's ``build_integer`` for tiny_yolo_v3 and yolo_v2 at
  64² against the JAX script's on the same carried weights.
- (d) the bitwidth script's w4 engines, per tensor and per channel:
  max |w_q| <= 7, the sw tables and detections the JAX pipeline's.

Tolerances. slim's integer stages: every image's detections of each
class equal (``np.array_equal``: the heads are bit-exact and the decode,
softmax and NMS on them give the JAX package's floats), the mAP equal, at
least one detection. tiny_yolo_v3's and yolo_v2's: scores, classes and
counts equal, boxes within BOX_ATOL (tiny's pixel-anchor decode takes an
exp whose float32 result is an ulp off XLA's), the mAP equal. Float
stages: as many detections per class and image, each within 1e-4
absolute of one of the JAX package's in any order (float32 convs in
another framework move scores by ~1e-6, and two near-tied detections
may swap places), the mAP within 1e-3 (such a near-tie can swap a
match). Bootstrap rows: equal, the same raw detections and seed through
both packages' ``bootstrap_delta_ci``.
"""

import functools
import importlib
import json
import os
import re
import sys
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolo_tpu import detector as jdet_mod
from yolo_tpu.config import get_config as jget_config
from yolo_tpu.data import BaseTransform as JBaseTransform
from yolo_tpu.data import SyntheticDetection as JSynthetic
from yolo_tpu.eval import voc_eval as jvoc
from yolo_tpu.ops import nms as jnms
from yolo_tpu.quant import qsim as jqsim
from yolo_tpu.quant.bn_fold import fold_batch_norm as jfold
from yolo_tpu.quant.int8_graph import make_int8_detect_fn as jmake
from yolo_tpu.quant.int8_graph import quantize_pipeline as jpipeline
from yolo_tpu_torch.config import get_config
from yolo_tpu_torch.eval import voc_eval
from yolo_tpu_torch.quant import autoclip
from yolo_tpu_torch.quant import convert as C

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))

import quant_bitwidth_torch as qbw  # noqa: E402
import quant_parity_torch as qp  # noqa: E402
import quant_parity_v3_torch as qv3  # noqa: E402

SIZE, VAL, CALIB_B = 64, 16, 8
FLOAT_ATOL, FLOAT_MAP_TOL = 1e-4, 1e-3
BOX_ATOL = SIZE * 1e-6  # pixels: a few ulps of a normalized box
N_BOOT = 20
# (b): the clip search on fewer candidates (each an engine build)
CAPS, PERCENTILES = (None, 16.0), (None, 99.0)
SLIM_JSON = ROOT / "docs" / "examples" / "parity_slim_416_hard.json"
# every BN's running variance: var + eps is exactly 1 in float32, so both
# packages' BN folds multiply by exactly 1. At PRNGKey(0)'s var = 1 the
# JAX package's 1/sqrt (XLA's CPU rsqrt and two Newton steps) is an ulp
# off the port's IEEE one (``quant/bn_fold.py``), and slim's conv3_2 and
# conv7 then round a weight at a tie to the other int8 level
EXACT_FOLD_VAR = np.float32(1) - np.float32(1e-5)


def _cfgs(version="slim_yolo_v2"):
    kw = dict(input_size=(SIZE, SIZE), conf_thresh=0.01)
    return jget_config(version, "mask", **kw), get_config(version, "mask",
                                                          **kw)


def _exact_fold(tree):
    """``tree`` with every BN's running variance EXACT_FOLD_VAR."""
    if isinstance(tree, dict):
        out = {k: _exact_fold(v) for k, v in tree.items()}
        if "bn" in tree:
            out["bn"] = dict(tree["bn"], var=np.full_like(
                np.asarray(tree["bn"]["var"]), EXACT_FOLD_VAR))
        return out
    if isinstance(tree, (list, tuple)):
        return type(tree)(_exact_fold(v) for v in tree)
    return tree


def _jax_params(version):
    """The JAX package's ``PRNGKey(0)`` params of ``version``, BN
    variances at EXACT_FOLD_VAR."""
    jcfg, _ = _cfgs(version)
    return _exact_fold(jax.device_get(jdet_mod.Detector(jcfg).init_params(
        jax.random.PRNGKey(0))))


def _val_sets(n=VAL):
    """(the JAX package's val set, the port's): the scripts' seed 99."""
    kw = dict(num_classes=2, length=n, hard=True, seed=99)
    return (JSynthetic((SIZE, SIZE), transform=JBaseTransform((SIZE, SIZE)),
                       **kw),
            qp.SyntheticDetection((SIZE, SIZE),
                                  transform=qp.BaseTransform((SIZE, SIZE)),
                                  **kw))


def _calib():
    """Two batches of 8 hard training images: (JAX arrays, CPU tensors)."""
    train, _ = qp.synthetic_sets(SIZE, True, 2 * CALIB_B, VAL)
    batches = qp.calib_batches(train, torch.device("cpu"), n=2,
                               batch=CALIB_B, num_workers=0)
    return [jnp.asarray(b.numpy()) for b in batches], batches


def _jax_pass(dataset, detect):
    ev = jvoc.VOCEvaluator(dataset, 2, (SIZE, SIZE), batch_size=64)
    return ev.evaluate(lambda im: detect(np.asarray(im, np.float32))), \
        ev.raw


def _matched(a, b, atol):
    """Whether each row of ``a`` has its own row of ``b`` within ``atol``
    (two detections whose scores nearly tie may come out in either
    order)."""
    free = list(range(len(b)))
    for row in a:
        hit = next((j for j in free
                    if np.all(np.abs(b[j] - row) <= atol)), None)
        if hit is None:
            return False
        free.remove(hit)
    return True


def _same_raw(got, want, mode, where):
    """Per class and image, as many detections and: ``mode`` "exact"
    array_equal; "decode": scores equal, boxes within BOX_ATOL pixels
    (the decode's exp, another framework's float32); "float": rows
    matched within FLOAT_ATOL in any order. The ground truth equal. ->
    detections compared."""
    n = 0
    for cls_g, cls_w in zip(got[0], want[0]):
        for a, b in zip(cls_g, cls_w):
            assert a.shape == b.shape, where
            if mode == "exact":
                assert np.array_equal(a, b), where
            elif mode == "decode":
                np.testing.assert_array_equal(a[:, 4], b[:, 4], where)
                np.testing.assert_allclose(a[:, :4], b[:, :4], rtol=0,
                                           atol=BOX_ATOL, err_msg=where)
            else:
                assert _matched(a, b, FLOAT_ATOL), where
            n += len(a)
    for g, w in zip(got[1], want[1]):  # the ground truth
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
    return n


# ---------------------------------------------------------------------------
# (a) slim's stages.
# ---------------------------------------------------------------------------


def _jax_stages(params, jcfg, calib):
    """{stage: detect fn} as ``scripts/quant_parity.py:121-213`` builds
    them (int8_perchan at head_clip 16, the cap the port builds it at
    here: the search is not run)."""
    det = jdet_mod.Detector(jcfg)
    fused = jfold(params)
    det_f = jdet_mod.Detector(jcfg, batch_norm=False)
    params_q = jqsim.fake_quantize_params(fused)
    states = jqsim.calibrate(params_q, jcfg, calib)

    def sim(qmod, p):
        @jax.jit
        def detect(images):
            boxes, probs = jdet_mod.predict(qmod, p, images, jcfg)
            return jnms.batched_postprocess(
                boxes, probs, jcfg.conf_thresh, jcfg.nms_thresh,
                jcfg.pre_nms_top_k, jcfg.top_k)
        return detect

    def engine(**kw):
        return jmake(jpipeline(params, jcfg, calib, **kw), jcfg)

    return {
        "fp32": lambda im: det.detect(params, im),
        "bn_fused": lambda im: det_f.detect(fused, im),
        "int8_fakequant": sim(jqsim.make_quant_module(params_q, states),
                              params_q),
        "weights_only_q": lambda im: det_f.detect(params_q, im),
        "acts_only_q": sim(jqsim.make_quant_module(fused, states), fused),
        "int8_integer": engine(),
        "int8_headclip": engine(head_clip=16.0),
        "int8_perchan": engine(head_clip=16.0, per_channel=True),
    }


def _port_stages(model, cfg, calib):
    """The same stages from the port script's own stage code."""
    dev = torch.device("cpu")
    out = dict(qp.float_stages(model, cfg, calib, dev))
    out["int8_integer"] = qp.int8_engine(model, cfg, calib, dev)[1]
    out["int8_headclip"] = qp.int8_engine(model, cfg, calib, dev,
                                          head_clip=16.0)[1]
    out["int8_perchan"] = qp.int8_engine(model, cfg, calib, dev,
                                         head_clip=16.0,
                                         per_channel=True)[1]
    return out


@pytest.fixture(scope="module")
def slim_runs():
    """Both packages' stages scored on 16 val images: ({stage: (mAP,
    raw)} of the JAX package's, the port's Stages)."""
    jcfg, cfg = _cfgs()
    params = _jax_params("slim_yolo_v2")
    model = C.slim_from_params(params, device="cpu")
    for a, b in zip(jax.tree_util.tree_leaves(jax.device_get(jfold(params))),
                    jax.tree_util.tree_leaves(C.module_to_params(
                        qp.fold_batch_norm(model)))):
        np.testing.assert_array_equal(np.asarray(a), b)
    jcalib, calib = _calib()
    jval, val = _val_sets()
    img_j, tgt_j, _, _ = jval.pull_item(3)
    img_t, tgt_t, _, _ = val.pull_item(3)
    np.testing.assert_array_equal(np.asarray(img_j), np.asarray(img_t))
    np.testing.assert_array_equal(np.asarray(tgt_j), np.asarray(tgt_t))
    want = {name: _jax_pass(jval, fn)
            for name, fn in _jax_stages(params, jcfg, jcalib).items()}
    stages = qp.Stages(voc_eval.VOCEvaluator(val, 2, (SIZE, SIZE),
                                             batch_size=64,
                                             cache_device=True))
    for name, fn in _port_stages(model, cfg, calib).items():
        stages.run(name, fn)
    return want, stages


INTEGER = ("int8_integer", "int8_headclip", "int8_perchan")
FLOAT = ("fp32", "bn_fused", "int8_fakequant", "weights_only_q",
         "acts_only_q")


@pytest.mark.parametrize("stage", INTEGER)
def test_slim_integer_stage_matches_jax(slim_runs, stage):
    want, stages = slim_runs
    map_j, raw_j = want[stage]
    n = _same_raw(stages.raw[stage], raw_j, "exact", stage)
    assert n > 0
    assert stages.results[stage] == map_j


@pytest.mark.parametrize("stage", FLOAT)
def test_slim_float_stage_matches_jax(slim_runs, stage):
    want, stages = slim_runs
    map_j, raw_j = want[stage]
    assert _same_raw(stages.raw[stage], raw_j, "float", stage) > 0
    assert abs(stages.results[stage] - map_j) <= FLOAT_MAP_TOL


@pytest.mark.parametrize("stage", INTEGER + ("int8_fakequant",))
def test_bootstrap_rows_match_jax(slim_runs, stage):
    """The stage-vs-fp32 row of both packages' paired bootstrap, on the
    JAX package's raw detections and on the port's; the port script's
    table holds the port's row in points."""
    want, stages = slim_runs
    rows, _ = qp.stage_table(stages, N_BOOT, [], "")
    for (dets_a, gts), (dets_b, _) in (
            (want[stage][1], want["fp32"][1]),
            (stages.raw[stage], stages.raw["fp32"])):
        row = voc_eval.bootstrap_delta_ci(dets_a, dets_b, gts,
                                          n_boot=N_BOOT)
        assert row == jvoc.bootstrap_delta_ci(dets_a, dets_b, gts,
                                              n_boot=N_BOOT)
    assert rows[stage] == tuple(100 * v for v in row)


# ---------------------------------------------------------------------------
# (b) main end to end.
# ---------------------------------------------------------------------------


def _recording(monkeypatch):
    """The scripts' VOCEvaluator, recording each pass's raw detections."""
    passes = []

    class Recording(voc_eval.VOCEvaluator):
        def evaluate(self, detect_batch):
            out = super().evaluate(detect_batch)
            passes.append(self.raw)
            return out

    monkeypatch.setattr(qp, "VOCEvaluator", Recording)
    return passes


def _small_search(monkeypatch):
    monkeypatch.setattr(autoclip, "select_quant_config", functools.partial(
        autoclip.select_quant_config, caps=CAPS, percentiles=PERCENTILES))


MAIN = dict(size=SIZE, hard=True, train_images=16, val_images=VAL,
            epochs=1, qat_steps=2, n_boot=N_BOOT, device="cpu")


def _generic_names(names):
    """Stage names with the searched values taken out of the brackets."""
    return [re.sub(r"^(int8_autoclip|int8_ptclip)\[.*\]$", r"\1", n)
            for n in names]


@pytest.fixture(scope="module")
def trained_main(tmp_path_factory):
    """The port's main, training 1 epoch: (results, its JSON)."""
    tmp = tmp_path_factory.mktemp("parity")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tempfile, "tempdir", str(tmp))
        _small_search(mp)
        results = qp.main(ckpt=str(tmp / "slim.msgpack"), **MAIN)
    with open(tmp / f"quant_parity_torch_results_{SIZE}_hard.json") as f:
        return results, json.load(f)


def test_main_runs_the_jax_scripts_stages_in_order(trained_main):
    results, _ = trained_main
    with open(SLIM_JSON) as f:
        jax_names = list(json.load(f)["map"])
    assert _generic_names(list(results)) == _generic_names(jax_names)
    assert all(0.0 <= v <= 1.0 for v in results.values())


def test_main_json_has_the_jax_scripts_keys(trained_main):
    results, got = trained_main
    with open(SLIM_JSON) as f:
        want = json.load(f)
    assert list(got) == list(want)
    assert list(got["ptq_search"]) == list(want["ptq_search"])
    assert got["map"] == results
    assert set(got["delta_ci_pts"]) == set(results) - {"fp32"} | {
        "qat_vs_ptq_autoclip", "qat_vs_ptq_ptclip"}
    assert (got["input_size"], got["hard"], got["val_images"],
            got["train_images"], got["epochs"]) == (SIZE, True, VAL, 16, 1)
    assert set(got["ptq_search"]["cap_scores"]) == {str(c) for c in CAPS}


def test_skip_train_on_a_jax_checkpoint_gives_the_jax_integers(
        tmp_path, monkeypatch):
    from yolo_tpu.utils.checkpoint import save_checkpoint

    params = _jax_params("slim_yolo_v2")
    ckpt = tmp_path / "jax.msgpack"
    save_checkpoint(str(ckpt), params)
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    _small_search(monkeypatch)
    passes = _recording(monkeypatch)
    results = qp.main(ckpt=str(ckpt), skip_train=True, **MAIN)
    got = passes[list(results).index("int8_integer")]

    # the JAX script's int8_integer on its own load of the file
    from yolo_tpu.utils.checkpoint import load_checkpoint

    jcfg, _ = _cfgs()
    jparams, _ = load_checkpoint(str(ckpt))
    train = JSynthetic((SIZE, SIZE), num_classes=2, length=16, hard=True,
                       transform=JBaseTransform((SIZE, SIZE)))
    from yolo_tpu.data import BatchLoader as JBatchLoader
    jcalib = [jnp.asarray(np.asarray(b, np.float32)) for b, _ in
              list(JBatchLoader(train, 16, shuffle=False,
                                num_workers=0))][:8]
    map_j, raw_j = _jax_pass(_val_sets()[0],
                             jmake(jpipeline(jparams, jcfg, jcalib), jcfg))
    assert _same_raw(got, raw_j, "exact", "int8_integer") > 0
    assert results["int8_integer"] == map_j


# ---------------------------------------------------------------------------
# (c) the v3 script's build_integer; (d) the bitwidth script's engines.
# ---------------------------------------------------------------------------


def _jax_v3_script():
    spec = importlib.util.spec_from_file_location(
        "jax_quant_parity_v3", ROOT / "scripts" / "quant_parity_v3.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


FROM_PARAMS = {"tiny_yolo_v3": C.tiny_from_params,
               "yolo_v2": C.yolo_v2_from_params}


@pytest.mark.parametrize("version", sorted(FROM_PARAMS))
def test_build_integer_matches_the_jax_script(version):
    jcfg, cfg = _cfgs(version)
    params = _jax_params(version)
    jcalib, calib = _calib()
    _, jdetect = _jax_v3_script().build_integer(version, params, jcfg,
                                                jcalib)
    _, detect = qv3.build_integer(version,
                                  FROM_PARAMS[version](params, "cpu"), cfg,
                                  calib, device="cpu")
    jval, val = _val_sets(8)
    map_j, raw_j = _jax_pass(jval, jdetect)
    ev = voc_eval.VOCEvaluator(val, 2, (SIZE, SIZE), batch_size=64)
    assert ev.evaluate(detect) == map_j
    assert _same_raw(ev.raw, raw_j, "decode", version) > 0


@pytest.mark.parametrize("per_channel", [False, True])
def test_w4_engine_matches_jax(per_channel):
    jcfg, cfg = _cfgs()
    params = _jax_params("slim_yolo_v2")
    jcalib, calib = _calib()
    jm = jpipeline(params, jcfg, jcalib, head_clip=16.0, weight_bitwidth=4,
                   per_channel=per_channel)
    name, m, detect, wmax = qbw.weight_variant(
        C.slim_from_params(params, "cpu"), cfg, calib, 16.0, 4, per_channel,
        torch.device("cpu"))
    assert name == "w4a8" + ("/pc" if per_channel else "")
    assert 0 < wmax <= 7
    assert wmax == max(int(np.abs(np.asarray(w)).max())
                       for w in jm.w_q.values())
    assert {k: qbw._plain(v) for k, v in m.sw.items()} == {
        k: np.asarray(v).tolist() for k, v in jm.sw.items()}
    jval, val = _val_sets(8)
    map_j, raw_j = _jax_pass(jval, jmake(jm, jcfg))
    ev = voc_eval.VOCEvaluator(val, 2, (SIZE, SIZE), batch_size=64)
    assert ev.evaluate(detect) == map_j
    assert _same_raw(ev.raw, raw_j, "exact", name) > 0


@pytest.mark.parametrize("run", [
    lambda: qp.main(size=SIZE), lambda: qv3.main(size=SIZE),
    lambda: qbw.main(["--size", str(SIZE)])],
    ids=["quant_parity", "quant_parity_v3", "quant_bitwidth"])
def test_scripts_default_to_the_card(run):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA"):
        run()


def test_default_paths_are_under_the_temp_dir(monkeypatch, tmp_path):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    path = qp.temp_path("quant_parity_torch_slim_64.msgpack")
    assert os.path.dirname(path) == str(tmp_path)
