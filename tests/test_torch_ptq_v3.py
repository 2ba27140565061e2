"""The port's yolo_v3 PTQ (``quantize_pipeline_yolo_v3`` on the float
``YOLOv3``, the generic tap, darknet53 and the v3 head) against the JAX
package, on the CPU at 64².

Five option sets, one JAX pipeline each:

- ``scalar``: BN-form params (``seeded_fused_params(0, 21)``'s weights,
  every conv but the preds given BN stats drawn from
  ``np.random.default_rng(7)`` as the JAX package's quantization tests
  draw them), ``fold_bn=True``, per-tensor weight scales;
- ``per_channel``: ``seeded_fused_params_per_channel(0, 21)``,
  ``fold_bn=False``, ``per_channel=True``;
- ``head_clip``, ``act_percentile`` and ``weight_bitwidth_4``:
  ``seeded_fused_params(0, 21)``, ``fold_bn=False``, with that option
  (a head clip of 0.02 binds on the three heads, whose ranges are about
  0.032, 0.055 and 0.081 here, and would on the tap before them, ~0.070,
  were the caps one tap off).

Held exactly, whenever both packages quantize the same floats: sa_in,
every tap_sa, sw, sb and retune, the int8 weights and biases; and the
list of tap kinds against the JAX forward's. Held to rtol 1e-5: float
tracker scales and pre-activation maxima. The port's own BN fold differs
from the JAX package's by ulps (``tests/test_torch_ptq_slim.py``), and
``test_own_fold_pipeline`` holds what that moves here to its
explanation.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import yolo_tpu.quant.int8_yolo_v3 as jv3
from yolo_tpu.config import get_config
from yolo_tpu.models import yolo_v3 as jyolo
from yolo_tpu.ops import blocks as jblocks
from yolo_tpu.quant.generic import fake_quantize_all_convs as jax_fq
from yolo_tpu_torch.config import get_config as t_get_config
from yolo_tpu_torch.models.yolo_v3 import YOLOv3
from yolo_tpu_torch.ops import blocks
from yolo_tpu_torch.quant import convert as C
from yolo_tpu_torch.quant import generic as tgeneric
from yolo_tpu_torch.quant import int8_yolo_v3 as tv3
from yolo_tpu_torch.quant import quantize as tq
from yolo_tpu_torch.quant.bn_fold import fold_batch_norm
from yolo_tpu_torch.quant.generic import (
    calibrate_generic, fake_quantize_all_convs, quant_forward_generic,
    tap_count)

torch.set_num_threads(1)

SIZE, PRED_OUT = 64, 21
N_CONVS, N_TAPS = 75, 98
SCALE_RTOL = 1e-5
OPTION_SETS = {
    "head_clip": {"head_clip": 0.02},
    "act_percentile": {"act_percentile": 99.9},
    "weight_bitwidth_4": {"weight_bitwidth": 4},
}
SETS = ("scalar", "per_channel") + tuple(OPTION_SETS)
# the sets whose fake-quant grid differs
FQ_SETS = ("scalar", "per_channel", "weight_bitwidth_4")


def cfgs():
    return (get_config("yolo_v3", "mask", input_size=(SIZE, SIZE)),
            t_get_config("yolo_v3", "mask", input_size=(SIZE, SIZE)))


def calib_batches():
    return [np.random.default_rng(1).random((2, SIZE, SIZE, 3),
                                            dtype=np.float32)]


def jtree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def bn_params(seed: int = 7) -> dict:
    """``seeded_fused_params(0, 21)``'s weights; every conv but the three
    preds in the BN form, its stats drawn in program order."""
    rng = np.random.default_rng(seed)
    tree = tv3.seeded_fused_params(0, PRED_OUT)
    for op in tv3._program():
        if op[0] != "conv" or op[1][0].startswith("pred"):
            continue
        node = tree
        for p in op[1][:-1]:
            node = node[p]
        layer = node[op[1][-1]]
        c = layer["w"].shape[-1]
        node[op[1][-1]] = {"w": layer["w"], "bn": {
            "gamma": rng.random(c, dtype=np.float32) + 0.5,
            "beta": rng.standard_normal(c).astype(np.float32),
            "mean": rng.standard_normal(c).astype(np.float32) * 0.1,
            "var": rng.random(c, dtype=np.float32) + 0.5}}
    return tree


def conv_layers(tree):
    """The tree's conv dicts in program order."""
    out = []
    for op in tv3._program():
        if op[0] == "conv":
            node = tree
            for p in op[1]:
                node = node[p]
            out.append(node)
    return out


@pytest.fixture(scope="module")
def runs():
    """{set: dict(params (the tree the port takes), fused (the JAX fold,
    or the fused tree), opts, mj (JAX Int8YoloV3 as numpy), states and
    maxima (what its quantize_yolo_v3 received))}."""
    cfg, _ = cfgs()
    out = {}
    seen = {}
    real = jv3.quantize_yolo_v3

    def spy(fused, states, agg, **kw):
        seen.update(fused=jax.device_get(fused),
                    states=jax.device_get(states), maxima=list(agg))
        return real(fused, states, agg, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jv3, "quantize_yolo_v3", spy)
        for key in SETS:
            if key == "scalar":
                params, opts = bn_params(), dict(fold_bn=True)
            elif key == "per_channel":
                params = tv3.seeded_fused_params_per_channel(0, PRED_OUT)
                opts = dict(fold_bn=False, per_channel=True)
            else:
                params = tv3.seeded_fused_params(0, PRED_OUT)
                opts = dict(fold_bn=False, **OPTION_SETS[key])
            mj = jax.device_get(jv3.quantize_pipeline_yolo_v3(
                jtree(params), cfg, calib_batches(), **opts))
            out[key] = dict(params=params, opts=opts, mj=mj, **seen)
            seen.clear()
    return out


def fq_opts(opts) -> dict:
    """The fake-quant options of an option set."""
    return dict(per_channel=opts.get("per_channel", False),
                weight_bitwidth=opts.get("weight_bitwidth"))


def assert_tables_equal(mj, mt):
    assert mt.sa_in == mj.sa_in
    assert list(mt.tap_sa) == [int(v) for v in mj.tap_sa]
    assert list(mt.retune) == [int(v) for v in mj.retune]
    assert list(mt.sb) == [int(v) for v in mj.sb]
    assert len(mt.sw) == len(mj.sw) == N_CONVS
    for a, b in zip(mt.sw, mj.sw):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def assert_int8_equal(mj, mt):
    for i in range(N_CONVS):
        np.testing.assert_array_equal(mt.w_q[i].numpy(), mj.w_q[i])
        np.testing.assert_array_equal(mt.b_q[i].numpy(), mj.b_q[i])


def test_tap_kinds_match_the_jax_forward():
    """The port's taps fire in the JAX forward's order: 'conv' (a conv
    block or head, after its pre hook) or 'res' (a residual sum), 98 in
    all, 23 of them residual sums; the program's convs and res ops in the
    same order; tap_count from the structure agrees."""
    cfg, _ = cfgs()

    class Record:
        def __init__(self):
            self.kinds, self.pending = [], False

        def pre(self, act):
            self.pending = True

        def __call__(self, act):
            self.kinds.append("conv" if self.pending else "res")
            self.pending = False
            return act

    rec, port = Record(), Record()

    def forward(p, x):
        with jblocks.quantization_context(rec):
            return jyolo.forward(p, x, cfg)

    shapes = jax.eval_shape(lambda: jyolo.init_params(
        jax.random.PRNGKey(0), cfg, batch_norm=True))
    jax.eval_shape(forward, shapes,
                   jax.ShapeDtypeStruct((1, SIZE, SIZE, 3), jnp.float32))
    model = YOLOv3(PRED_OUT, batch_norm=False, device="cpu",
                   generator=torch.Generator().manual_seed(0))
    x = torch.rand(1, SIZE, SIZE, 3)
    with torch.no_grad(), blocks.quantization_context(port):
        model(x)
    assert port.kinds == rec.kinds
    assert len(rec.kinds) == N_TAPS and rec.kinds.count("res") == 23
    program = [op[0] for op in tv3._program() if op[0] in ("conv", "res")]
    assert port.kinds == program
    outs, states, pre = quant_forward_generic(model, x, cfgs()[1], [])
    assert len(states) == tap_count(model) == N_TAPS + 1
    assert len(pre) == N_CONVS
    assert [tuple(o.shape) for o in outs] == [
        (1, SIZE // s, SIZE // s, PRED_OUT) for s in (8, 16, 32)]


def test_float_forward_matches_jax(runs):
    """The BN-form float YOLOv3 against the JAX forward on the same
    params."""
    params = runs["scalar"]["params"]
    cfg, _ = cfgs()
    x = calib_batches()[0][:1]
    want = jax.jit(lambda p, x: jyolo.forward(p, x, cfg))(jtree(params), x)
    with torch.no_grad():
        got = C.yolo_v3_from_params(params, device="cpu")(
            torch.as_tensor(x))
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-5 * np.abs(w).max())


def test_fold_matches_jax(runs):
    r = runs["scalar"]
    ft = conv_layers(fold_batch_norm(r["params"]))
    fj = conv_layers(r["fused"])
    fm = conv_layers(C.module_to_params(fold_batch_norm(
        C.yolo_v3_from_params(r["params"], device="cpu"))))
    for a, b, c in zip(ft, fj, fm):
        for f in ("w", "b"):
            np.testing.assert_array_equal(a[f], c[f])
            np.testing.assert_allclose(a[f], b[f], rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("key", FQ_SETS)
def test_fake_quantize_all_convs_equal(runs, key):
    r = runs[key]
    fq = fq_opts(r["opts"])
    want = conv_layers(jax.device_get(jax_fq(
        jtree(r["fused"]), 8, fq["weight_bitwidth"], fq["per_channel"])))
    got = conv_layers(C.module_to_params(fake_quantize_all_convs(
        C.yolo_v3_from_params(r["fused"], device="cpu"), **fq)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["w"], w["w"])
        np.testing.assert_array_equal(g["b"], w["b"])


def port_calibration(r):
    """The port's generic calibration and pre-activation maxima on the
    floats the JAX pipeline quantized, with the set's options -> (states,
    their scales, the JAX scales, the maxima)."""
    _, cfg = cfgs()
    pq = fake_quantize_all_convs(
        C.yolo_v3_from_params(r["fused"], device="cpu"),
        **fq_opts(r["opts"]))
    states = calibrate_generic(pq, cfg, calib_batches(),
                               head_clip=r["opts"].get("head_clip"),
                               act_percentile=r["opts"].get(
                                   "act_percentile"))
    assert len(states) == len(r["states"]) == N_TAPS + 1
    got = np.array([float(s["scale"]) for s in states])
    want = np.array([float(s["scale"]) for s in r["states"]])
    assert [tq.tracker_sa_np(s) for s in states] == [
        tq.tracker_sa_np(s) for s in r["states"]]
    _, _, pre = quant_forward_generic(
        pq, torch.as_tensor(calib_batches()[0]), cfg, states)
    return states, got, want, np.array([float(v) for v in pre])


@pytest.mark.parametrize("key", [k for k in SETS
                                 if k != "weight_bitwidth_4"])
def test_tracker_scales_and_maxima(runs, key):
    """Float scales and maxima within rtol 1e-5 of the JAX package's,
    every exponent equal; the head clip binds on the three heads and on
    no other tap. (4-bit weights: the test after this one.)"""
    r = runs[key]
    _, got, want, pre = port_calibration(r)
    np.testing.assert_allclose(got, want, rtol=SCALE_RTOL)
    capped = np.float32(127) / np.float32(OPTION_SETS["head_clip"][
        "head_clip"])
    assert list(got[-4:] == capped) == [False] + [key == "head_clip"] * 3
    np.testing.assert_allclose(pre, r["maxima"], rtol=SCALE_RTOL)


def test_weight_bitwidth_4_scales_move_only_past_a_rounding_tie(
        runs, monkeypatch):
    """At 4-bit weights the fake-quant conv sums often land exactly on a
    half level of the next tap's grid, and a sum that XLA's CPU conv and
    oneDNN order differently can sit one ulp to either side of it: the
    tap rounds it to the other level. Taps recorded on both sides with
    the JAX states: up to the first tap where a level differs, scales and
    maxima are within rtol 1e-5; there, every differing level is one
    level apart, on the two sides of a half level, each value within two
    ulps of it (here one element of conv_set_2's first conv, the first
    conv fed by off-grid upsampled values: 10.5 in the JAX package,
    10.500002 in the port); past it, the float scales and maxima drift
    by less than 0.5%, and every exponent, int8 tensor and table is still
    equal (port_calibration and the pipeline tests)."""
    from yolo_tpu.quant import generic as jgeneric

    r = runs["weight_bitwidth_4"]
    cfg_j, cfg = cfgs()
    x = calib_batches()[0]
    seen = {"jax": [], "port": []}

    class JaxRecord(jgeneric._Tap):
        def __call__(self, act):
            seen["jax"].append(np.asarray(act))
            return super().__call__(act)

    class PortRecord(tgeneric._Tap):
        def __call__(self, act):
            seen["port"].append(act.permute(0, 2, 3, 1).numpy())
            return super().__call__(act)

    monkeypatch.setattr(jgeneric, "_Tap", JaxRecord)
    monkeypatch.setattr(tgeneric, "_Tap", PortRecord)
    jgeneric.quant_forward_generic(
        jyolo, jax_fq(jtree(r["fused"]), 8, 4, False), jnp.asarray(x),
        cfg_j, r["states"])
    quant_forward_generic(
        fake_quantize_all_convs(C.yolo_v3_from_params(r["fused"],
                                                      device="cpu"),
                                weight_bitwidth=4),
        torch.as_tensor(x), cfg, [tq.as_state(s, "cpu")
                                  for s in r["states"]])
    monkeypatch.undo()
    assert len(seen["jax"]) == len(seen["port"]) == N_TAPS
    flip = N_TAPS
    for i, (a, b) in enumerate(zip(seen["jax"], seen["port"])):
        scale = np.float32(2.0 ** tq.tracker_sa_np(r["states"][i + 1]))
        sa, sb = scale * a, scale * b
        qa, qb = np.round(sa), np.round(sb)
        moved = qa != qb
        if moved.any():
            flip = i
            assert (np.abs(qa - qb)[moved] == 1).all()
            half = np.minimum(qa, qb)[moved] + np.float32(0.5)
            ulp = np.spacing(half)
            assert (np.abs(sa[moved] - half) <= 2 * ulp).all()
            assert (np.abs(sb[moved] - half) <= 2 * ulp).all()
            break
    _, got, want, pre = port_calibration(r)
    np.testing.assert_allclose(got[:flip + 2], want[:flip + 2],
                               rtol=SCALE_RTOL)
    np.testing.assert_allclose(got, want, rtol=5e-3)
    program = [op[0] for op in tv3._program() if op[0] in ("conv", "res")]
    before = sum(k == "conv" for k in program[:flip + 1])
    np.testing.assert_allclose(pre[:before], r["maxima"][:before],
                               rtol=SCALE_RTOL)
    np.testing.assert_allclose(pre, r["maxima"], rtol=5e-3)


@pytest.mark.parametrize("key", SETS)
def test_quantize_yolo_v3_equal(runs, key):
    """On the JAX pipeline's own floats, states and maxima: every int8
    tensor and table equal."""
    r = runs[key]
    mt = tv3.quantize_yolo_v3(r["fused"], r["states"], r["maxima"],
                              device="cpu", **fq_opts(r["opts"]))
    assert_int8_equal(r["mj"], mt)
    assert_tables_equal(r["mj"], mt)


@pytest.mark.parametrize("key", SETS)
def test_pipeline_equal_on_the_same_floats(runs, key):
    """The port's pipeline on the floats the JAX pipeline quantized (its
    BN fold's, for the scalar set): every int8 tensor and every table
    equal."""
    r = runs[key]
    opts = dict(r["opts"], fold_bn=False)
    model = C.yolo_v3_from_params(r["fused"], device="cpu")
    mt = tv3.quantize_pipeline_yolo_v3(model, cfgs()[1], calib_batches(),
                                       **opts)
    assert_int8_equal(r["mj"], mt)
    assert_tables_equal(r["mj"], mt)
    assert mt.per_channel == (key == "per_channel")


def test_own_fold_pipeline(runs):
    """The port's pipeline with its own BN fold. Its floats differ from
    the JAX fold's by 1-4 ulps (test_fold_matches_jax), so a few
    fake-quant weights sit on the other side of a rounding tie: each int8
    weight that differs does so by one level where the two folds' floats
    differ, biases are equal, and the flipped weights move later
    activation maxima by up to ~1.5% in this 75-conv random net at 64²,
    so an exponent whose log2 lies that close to an integer may move by
    one (two of the 98 tap_sa here, every sw / sb / retune equal)."""
    r = runs["scalar"]
    model = C.yolo_v3_from_params(r["params"], device="cpu")
    mt = tv3.quantize_pipeline_yolo_v3(model, cfgs()[1], calib_batches(),
                                       **r["opts"])
    ft = conv_layers(fold_batch_norm(r["params"]))
    fj = conv_layers(r["fused"])
    flipped = 0
    for i in range(N_CONVS):
        np.testing.assert_array_equal(mt.b_q[i].numpy(), r["mj"].b_q[i])
        got, want = mt.w_q[i].numpy(), r["mj"].w_q[i]
        diff = got != want
        flipped += int(diff.sum())
        assert (ft[i]["w"][diff] != fj[i]["w"][diff]).all(), i
        assert (np.abs(got[diff].astype(int) - want[diff]) == 1).all(), i
    assert 0 < flipped < 1000
    assert mt.sa_in == r["mj"].sa_in
    for field in ("sb", "retune"):
        assert list(getattr(mt, field)) == [int(v) for v in
                                            getattr(r["mj"], field)]
    assert list(mt.sw) == [int(v) for v in r["mj"].sw]
    tap = np.asarray(mt.tap_sa) - np.asarray(r["mj"].tap_sa)
    assert np.abs(tap).max() <= 1 and np.count_nonzero(tap) <= 2


def test_states_given_skip_calibration(runs, monkeypatch):
    r = runs["per_channel"]

    def refuse(*a, **k):
        raise AssertionError("calibrate_generic ran although states were "
                             "given")

    monkeypatch.setattr(tgeneric, "calibrate_generic", refuse)
    mt = tv3.quantize_pipeline_yolo_v3(
        C.yolo_v3_from_params(r["params"], device="cpu"), cfgs()[1],
        calib_batches(), states=r["states"], **r["opts"])
    assert_int8_equal(r["mj"], mt)
    assert_tables_equal(r["mj"], mt)


def test_head_clip_caps_the_three_pred_taps():
    """head_clip caps the last len(STRIDES) taps, the three preds: at a
    cap below every head's range their scales are 127 / cap; the other
    taps are the uncapped calibration's."""
    model = fake_quantize_all_convs(YOLOv3(
        PRED_OUT, batch_norm=False, device="cpu",
        generator=torch.Generator().manual_seed(3)))
    _, cfg = cfgs()
    free = calibrate_generic(model, cfg, calib_batches())
    capped = calibrate_generic(model, cfg, calib_batches(), head_clip=1e-3)
    for i, (a, b) in enumerate(zip(free, capped)):
        if i >= len(free) - 3:
            assert float(b["scale"]) == np.float32(127) / np.float32(1e-3)
            assert float(a["scale"]) < float(b["scale"])
        else:
            assert torch.equal(a["scale"], b["scale"]), i


@pytest.mark.parametrize("build", ["darknet53", "quantize_yolo_v3"])
def test_builders_without_device_need_cuda(runs, build):
    """The backbone is built, and a JAX-layout tree quantized, on the card
    unless the caller asks for the CPU; without a card they raise."""
    from yolo_tpu_torch.models.darknet import Darknet53

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    r = runs["per_channel"]
    if build == "darknet53":
        def make(**kw):
            return next(Darknet53(**kw).parameters())
    else:
        def make(**kw):
            return tv3.quantize_yolo_v3(r["fused"], r["states"], r["maxima"],
                                        per_channel=True, **kw).w_q[0]
    with pytest.raises(RuntimeError, match="CUDA"):
        make()
    assert make(device="cpu").device.type == "cpu"


def test_spp_is_not_ported():
    """yolo_v3_spp is ported (its tables: ``test_spp_pipeline_equal``);
    what no pipeline takes is a model that is not the one ``spp`` names:
    a YOLOv3 with spp=True, a YOLOv3SPP without, each refused by name."""
    from yolo_tpu_torch.models.yolo_v3_spp import YOLOv3SPP

    for model, spp in ((YOLOv3, True), (YOLOv3SPP, False)):
        with pytest.raises(ValueError, match=f"spp={spp}.*{model.__name__}"):
            tv3.quantize_pipeline_yolo_v3(
                model(PRED_OUT, batch_norm=False, device="cpu"), cfgs()[1],
                calib_batches(), spp=spp, fold_bn=False)


def test_module_tree_round_trip(runs):
    for key in SETS:
        tree = runs[key]["params"]
        back = C.module_to_params(C.yolo_v3_from_params(tree, device="cpu"))
        for a, b in zip(conv_layers(back), conv_layers(tree)):
            assert set(a) == set(b)
            np.testing.assert_array_equal(a["w"], b["w"])
    assert C.module_to_params(YOLOv3(PRED_OUT, device="cpu"))[
        "backbone"]["layer_3"]["blocks"][7][1]["w"].shape == (3, 3, 128, 256)
    with pytest.raises(ValueError):
        C.load_params(YOLOv3(PRED_OUT, device="cpu"),
                      runs["per_channel"]["params"])

