"""The port's QAT (``quant/qat.py``), ``qsim.make_quant_module`` and
``generic.quantize_detector`` against the JAX package on the CPU:
slim_yolo_v2 at 32², tiny_yolo_v3 at 64², both BN-fused by the JAX
package (the same folded floats in both), calibrated by the JAX package
(the same tracker states in both).

Tolerances:
- the STE's values: equal to the port's ``tracker_quantize(update=False)``
  and the JAX package's (``torch.equal`` / array_equal); its gradients
  equal ``jax.grad``'s, 0.5 exactly on a rail; the weight STE's values
  on the engine's grid (atol 1e-7, the JAX test's) and gradients 1;
- the QAT forward: ``torch.equal`` to the port's
  ``quant_forward_generic`` on the same states; against the JAX
  ``QATModule.forward`` atol = rtol = 1e-5 once the JAX forward takes
  the port's tap levels (``_jax_branches``); without them, every
  element further off is traced to the tap levels: the port's forward
  on the JAX package's own levels (``_port_levels``) is within 1e-5 of
  the JAX forward, and every level the two packages round apart on the
  same path lies within TIE = 1e-5 of a level of the half-integer (two
  float32 convs sum in other orders);
- masters bit-identical after a step at lr 0;
- three ``qat_finetune`` steps: every parameter leaf within 1e-4 of its
  largest |value| of the JAX package's three steps on the port's
  branches (its leaky signs and tap levels), after the steps moved the
  parameters by more than ten times that;
- ``quantize_detector`` / ``make_quant_module`` detections: as many,
  classes equal, boxes and scores within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolo_tpu import detector as jdet
from yolo_tpu.ops import blocks as jblocks
from yolo_tpu.quant import generic as jgeneric
from yolo_tpu.quant import qat as jqat
from yolo_tpu.quant import qsim as jqsim
from yolo_tpu.quant import quantize as jq
from yolo_tpu.quant.bn_fold import fold_batch_norm as jax_fold
from yolo_tpu.train import trainer as jtrainer
from yolo_tpu_torch.config import get_config
from yolo_tpu_torch.detector import Detector
from yolo_tpu_torch.ops import blocks
from yolo_tpu_torch.quant import convert as C
from yolo_tpu_torch.quant import generic, qat, qsim
from yolo_tpu_torch.quant import quantize as tq
from yolo_tpu_torch.train import targets as ttargets
from yolo_tpu_torch.train import trainer as ttrainer

torch.set_num_threads(1)

TOL = 1e-5
TIE = 1e-5
STEP_TOL = 1e-4
FAMILIES = {"slim_yolo_v2": 32, "tiny_yolo_v3": 64}


def _frozen(max_abs):
    return jax.device_get(jq.tracker_update(jq.tracker_init(),
                                            jnp.asarray([max_abs])))


def _np_states(states):
    return [{k: np.asarray(v, np.float32) for k, v in s.items()}
            for s in jax.device_get(states)]


def _setup(version, batch=2):
    """-> (JAX detector, JAX fused params, port cfg, port fused model,
    tracker states (numpy, the JAX package's calibration), images)."""
    size = FAMILIES[version]
    d = jdet.build_detector(version, "mask", input_size=(size, size))
    pred_out = d.cfg.anchors_per_scale * (1 + 4 + d.cfg.num_classes)
    if version == "slim_yolo_v2":
        fused = jax.device_get(jax_fold(C.slim_seeded_bn_params(0,
                                                                pred_out)))
        model = C.slim_from_params(fused, device="cpu")
    else:
        fused = C.tiny_seeded_fused_params(0, pred_out)
        model = C.tiny_from_params(fused, device="cpu")
    fused = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                   fused)
    det = jdet.Detector(d.cfg, batch_norm=False)
    images = np.random.default_rng(1).random((batch, size, size, 3),
                                             dtype=np.float32)
    params_q = jgeneric.fake_quantize_all_convs(fused)
    states = _np_states(jgeneric.calibrate_generic(det.module, params_q,
                                                   det.cfg, [images]))
    cfg = get_config(version, "mask", input_size=(size, size))
    return det, fused, cfg, model, states, images


def _labels(rng, batch):
    out = []
    for _ in range(batch):
        n = int(rng.integers(1, 4))
        xy = rng.uniform(0.0, 0.6, (n, 2))
        wh = rng.uniform(0.1, 0.4, (n, 2))
        out.append(np.hstack([np.clip(np.hstack([xy, xy + wh]), 0, 1),
                              rng.integers(0, 2, (n, 1))]).astype(np.float32))
    return out


def _jax_choices(b, x_shape):
    """The port's recorded leaky signs and tap levels in the JAX layout:
    (leaky masks, levels), each in call order; the input tap's levels are
    NHWC already, the others NCHW."""
    def nhwc(c):
        c = c.numpy()
        return c if c.shape == tuple(x_shape) else c.transpose(0, 2, 3, 1)

    leaky = [nhwc(c) for c, k in zip(b.choices, b.kinds) if k == "leaky"]
    levels = [nhwc(c) for c, k in zip(b.choices, b.kinds) if k == "round"]
    return leaky, levels


class _jax_branches:
    """``with _jax_branches(leaky, levels) as j: <a JAX QAT forward>``:
    each ``blocks.leaky_relu`` takes the next of ``leaky`` (None: its
    own sign), each ``qat.tracker_quantize_ste`` the next of ``levels``
    (None: its own rounding); ``j.scaled`` collects each tap's clipped
    value in levels, ``j.taken`` the levels it took."""

    def __init__(self, leaky, levels):
        self.leaky = None if leaky is None else iter(leaky)
        self.levels = None if levels is None else iter(levels)
        self.scaled, self.taken = [], []

    def __enter__(self):
        self.plain = jblocks.leaky_relu, jqat.tracker_quantize_ste

        def leaky_relu(v, slope=jblocks.MODEL_LEAKY_SLOPE):
            if self.leaky is None:
                return self.plain[0](v, slope)
            m = next(self.leaky)
            assert m.shape == v.shape, (m.shape, v.shape)
            return jnp.where(m, v, v * slope)

        def ste(state, act, bitwidth=8):
            scale = jq.tracker_pow2(state)
            lim = 2.0 ** (bitwidth - 1) - 1
            a_c = jnp.clip(act, (-lim - 1) / scale, lim / scale)
            if self.levels is None:
                lv = jnp.round(scale * a_c)
            else:
                lv = next(self.levels)
                assert lv.shape == act.shape, (lv.shape, act.shape)
            self.scaled.append(scale * a_c)
            self.taken.append(lv)
            return jqat._ste(a_c, lv / scale)

        jblocks.leaky_relu, jqat.tracker_quantize_ste = leaky_relu, ste
        return self

    def __exit__(self, *exc):
        jblocks.leaky_relu, jqat.tracker_quantize_ste = self.plain
        assert (exc[0] is not None or self.levels is None
                or next(self.levels, None) is None)
        return False


class _port_levels:
    """``with _port_levels(levels): <a port QAT forward>``: each
    ``qat.tracker_quantize_ste`` takes the next of ``levels`` (in the
    JAX layout, NHWC) in place of its own rounding."""

    def __init__(self, levels):
        self.levels = iter(levels)

    def __enter__(self):
        self.plain = qat.tracker_quantize_ste

        def ste(state, act, bitwidth=8):
            lv = torch.tensor(np.asarray(next(self.levels)))
            if lv.shape != act.shape:
                lv = lv.permute(0, 3, 1, 2)
            assert lv.shape == act.shape, (lv.shape, act.shape)
            scale = tq.tracker_pow2(tq.as_state(state, act.device))
            lim = 2.0 ** (bitwidth - 1) - 1
            a_c = torch.minimum(torch.maximum(act, (-lim - 1) / scale),
                                lim / scale)
            return qat._ste(a_c, lv / scale)

        qat.tracker_quantize_ste = ste
        return self

    def __exit__(self, *exc):
        qat.tracker_quantize_ste = self.plain
        assert exc[0] is not None or next(self.levels, None) is None
        return False


def _ties(scaled, levels):
    """[(tap, elements the JAX package rounds otherwise than ``levels``,
    their largest distance from the half-integer in levels)]."""
    out = []
    for i, (x, lv) in enumerate(zip(scaled, levels)):
        x = np.asarray(x, np.float64)
        own = np.round(x)
        n = int((own != lv).sum())
        if n:
            out.append((i, n, float(np.abs(np.abs(x - lv) - 0.5)[
                own != lv].max())))
    return out


# ---------------------------------------------------------------------------
# The STE functions.
# ---------------------------------------------------------------------------


def test_tracker_ste_values_match_ptq_sim_and_jax():
    st = _frozen(3.7)
    x = np.linspace(-6.0, 6.0, 4001).astype(np.float32)
    ours = qat.tracker_quantize_ste(st, torch.tensor(x))
    ref, _ = tq.tracker_quantize(st, torch.tensor(x), update=False)
    assert torch.equal(ours, ref)
    np.testing.assert_array_equal(
        ours.numpy(), np.asarray(jqat.tracker_quantize_ste(st,
                                                           jnp.asarray(x))))


def test_tracker_ste_gradients_match_jax_half_on_a_rail():
    st = _frozen(3.7)
    scale = float(tq.tracker_pow2(st))
    hi, lo = 127.0 / scale, -128.0 / scale
    pts = np.concatenate([
        np.asarray([0.0, hi * 0.5, -hi * 0.9, hi * 2.0, -hi * 3.0, hi, lo],
                   np.float32),
        np.linspace(-6.0, 6.0, 4001).astype(np.float32)])
    x = torch.tensor(pts, requires_grad=True)
    qat.tracker_quantize_ste(st, x).sum().backward()
    want = np.asarray(jax.grad(lambda v: jnp.sum(
        jqat.tracker_quantize_ste(st, v)))(jnp.asarray(pts)))
    np.testing.assert_array_equal(x.grad.numpy(), want)
    np.testing.assert_array_equal(x.grad.numpy()[:7],
                                  [1.0, 1.0, 1.0, 0.0, 0.0, 0.5, 0.5])
    # torch.clamp would give 1 on the rails
    y = torch.tensor(pts[5:7], requires_grad=True)
    torch.clamp(y, lo, hi).sum().backward()
    assert y.grad.tolist() == [1.0, 1.0]


@pytest.mark.parametrize("bits,per_channel", [(8, False), (8, True),
                                              (4, False), (4, True),
                                              (5, True)])
def test_weight_ste_is_identity_on_the_engine_grid(bits, per_channel):
    rng = np.random.default_rng(3)
    w_hwio = rng.normal(0, 0.3, (3, 3, 4, 8)).astype(np.float32)
    w = torch.tensor(w_hwio.transpose(3, 2, 0, 1), requires_grad=True)
    ste = qat.fake_quantize_ste(w, bits, 0 if per_channel else None)
    ste.sum().backward()
    assert torch.equal(w.grad, torch.ones_like(w))
    got = ste.detach().numpy().transpose(2, 3, 1, 0)
    lv, s_exp = tq.quantize_pow2_np(w_hwio, bits, channel_axis=(
        -1 if per_channel else None))
    np.testing.assert_allclose(got, lv / np.exp2(np.float32(s_exp)),
                               rtol=0, atol=1e-7)
    np.testing.assert_array_equal(got, np.asarray(jqat.fake_quantize_ste(
        jnp.asarray(w_hwio), bits, -1 if per_channel else None)))


# ---------------------------------------------------------------------------
# The QAT forward.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("version", sorted(FAMILIES))
def test_qat_forward_matches_generic_and_jax(version):
    det, fused, cfg, model, states, images = _setup(version)
    x = torch.tensor(images)
    qmod = qat.QATModule(model, states)
    with torch.no_grad(), blocks.branch_context() as b:
        outs = qmod(x)
    ref, _, _ = generic.quant_forward_generic(
        generic.fake_quantize_all_convs(model), x, cfg, states)
    assert len(outs) == len(ref) == len(model.STRIDES)
    for a, r in zip(outs, ref):
        assert torch.equal(a, r)
    # the JAX forward on the port's levels
    leaky, levels = _jax_choices(b, x.shape)
    jmod = jqat.QATModule(det.module, states)

    def imposed(params, images, levels):
        with _jax_branches(None, levels) as j:
            return jmod.forward(params, images, det.cfg), j.scaled

    jouts, scaled = jax.jit(imposed)(fused, jnp.asarray(images), levels)
    for a, r in zip(outs, jouts):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=TOL,
                                   rtol=TOL)
    # its own levels: every element further off goes with the levels the
    # two packages take, and those they round apart are ties
    def own(params, images):
        with _jax_branches(None, None) as j:
            return jmod.forward(params, images, det.cfg), j.taken

    plain, jlevels = jax.jit(own)(fused, jnp.asarray(images))
    far = sum(int((~np.isclose(a.numpy(), np.asarray(r), atol=TOL,
                               rtol=TOL)).sum())
              for a, r in zip(outs, plain))
    with torch.no_grad(), _port_levels(jlevels):
        on_jax_levels = qmod(x)
    for a, r in zip(on_jax_levels, plain):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=TOL,
                                   rtol=TOL)
    apart = [(i, int((np.asarray(j) != p).sum()))
             for i, (j, p) in enumerate(zip(jlevels, levels))
             if (np.asarray(j) != p).any()]
    ties = _ties(scaled, levels)
    print(f"{version}: {far} head elements off by more than {TOL}; "
          f"levels apart (tap, elements): {apart}; on the port's path "
          f"(tap, elements, distance from the tie): {ties}")
    assert all(m <= TIE for _, _, m in ties), ties
    assert far == 0 or ties


def _sub8_states(model, cfg, images):
    params_q = qsim.fake_quantize_params(model, weight_bitwidth=4,
                                         per_channel=True)
    return generic.calibrate_generic(params_q, cfg, [images])


def test_qat_sub8_per_channel_forward_matches_generic():
    _, _, cfg, model, _, images = _setup("slim_yolo_v2")
    states = _sub8_states(model, cfg, images)
    x = torch.tensor(images)
    with torch.no_grad():
        outs = qat.QATModule(model, states, weight_bitwidth=4,
                             per_channel=True)(x)
    ref, _, _ = generic.quant_forward_generic(
        qsim.fake_quantize_params(model, weight_bitwidth=4,
                                  per_channel=True), x, cfg, states)
    assert torch.equal(outs[0], ref[0])


# ---------------------------------------------------------------------------
# Training through it.
# ---------------------------------------------------------------------------


def _gt(cfg, batch, seed=2):
    return ttargets.build_targets(cfg, _labels(np.random.default_rng(seed),
                                               batch))


@pytest.mark.parametrize("grid", [{}, {"weight_bitwidth": 5,
                                       "per_channel": True}])
def test_masters_bit_identical_at_lr0(grid):
    _, _, cfg, model, states, images = _setup("slim_yolo_v2")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    det = Detector(cfg, model=model, batch_norm=False, device="cpu")
    out, last = qat.qat_finetune(det, states, [(images, _gt(cfg, 2))],
                                 base_lr=0.0, steps=1, **grid)
    assert out is model and np.isfinite(float(last["total_loss"]))
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_loss_falls_over_ten_steps():
    _, _, cfg, model, states, images = _setup("slim_yolo_v2")
    gt = _gt(cfg, 2)
    qmod = qat.QATModule(model, states)
    opt, step = ttrainer.make_train_step(
        qmod, cfg, ttrainer.TrainConfig(base_lr=1e-4, wp_epoch=0))
    state = opt.init(qmod)
    # the optimizer's tree is the base model's, without a prefix
    assert state.paths == [p for p, _ in ttrainer.tree_leaves(model)]
    assert state.paths[0] == ("conv1", "w")
    losses = [float(step(state, torch.tensor(images), gt, 1e-4)
                    ["total_loss"]) for _ in range(10)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses


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
    return {path: np.asarray(tree, np.float64)}


def _close(got, want, tol, what):
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want), what
    for k in want:
        scale = max(float(np.abs(want[k]).max()), 1e-30)
        err = float(np.abs(got[k] - want[k]).max()) / scale
        assert err <= tol, f"{what} {k}: {err} of the leaf's largest |value|"


def test_three_qat_finetune_steps_match_jax():
    det, fused, cfg, model, states, _ = _setup("slim_yolo_v2")
    rng = np.random.default_rng(5)
    batches = [(rng.random((2, 32, 32, 3), dtype=np.float32),
                _gt(cfg, 2, seed=10 + i)) for i in range(3)]
    lr = 1e-3
    tdet = Detector(cfg, model=model, batch_norm=False, device="cpu")
    with blocks.branch_context() as b:
        qat.qat_finetune(tdet, states, batches, base_lr=lr, steps=3)
    n = len(b.choices) // 3
    # the JAX package's qat_finetune, step by step on the port's branches
    jmod = jqat.QATModule(det.module, states)
    jopt, jstep = jtrainer.make_train_step(
        jmod, det.cfg, jtrainer.TrainConfig(base_lr=lr, wp_epoch=0),
        donate=False)

    def masked(params, state, x, gt, leaky, levels):
        with _jax_branches(leaky, levels):
            return jstep(params, state, x, gt, lr)

    run = jax.jit(masked)
    params, jstate = fused, jopt.init(fused)
    for i, (x, gt) in enumerate(batches):
        sub = blocks.branch_context()
        sub.choices = b.choices[i * n:(i + 1) * n]
        sub.kinds = b.kinds[i * n:(i + 1) * n]
        leaky, levels = _jax_choices(sub, x.shape)
        params, jstate, _ = run(params, jstate, x, gt, leaky, levels)
    got = _flat(C.module_to_params(model))
    start = _flat(fused)
    moved = max(float(np.abs(got[k] - start[k]).max())
                / max(float(np.abs(start[k]).max()), 1e-30) for k in start)
    assert moved > 10 * STEP_TOL, moved  # the steps moved the parameters
    _close(C.module_to_params(model), jax.device_get(params), STEP_TOL,
           "params")


def test_bn_model_refused_before_any_step():
    d = jdet.build_detector("slim_yolo_v2", "mask", input_size=(32, 32))
    params = C.slim_seeded_bn_params(0, 35)
    with pytest.raises(ValueError) as jerr:
        jqat._assert_bn_free(params, "qat_finetune")
    model = C.slim_from_params(params, device="cpu")
    cfg = get_config("slim_yolo_v2", "mask", input_size=(32, 32))
    det = Detector(cfg, model=model, device="cpu")

    def batches():
        raise AssertionError("a step ran")
        yield

    with pytest.raises(ValueError, match="BN-folded") as err:
        qat.qat_finetune(det, [], batches())
    assert str(err.value) == str(jerr.value)
    assert "conv1" in str(err.value) and d is not None
    tiny = C.tiny_from_params(C.tiny_seeded_fused_params(0, 21),
                              device="cpu")
    assert qat.bn_paths(tiny) == []


def test_states_from_qsim_order():
    st = {n: {"scale": np.float32(i + 1), "initialized": np.float32(1)}
          for i, n in enumerate(reversed(qsim.TRACKER_NAMES))}
    got = qat.states_from_qsim(st)
    assert got == jqat.states_from_qsim(st)
    assert [float(s["scale"]) for s in got] == list(
        range(len(st), 0, -1))


# ---------------------------------------------------------------------------
# The frozen simulation as a detector.
# ---------------------------------------------------------------------------


def _same_detections(got, want):
    gb, gs, gc, gv = (a.numpy() for a in got)
    wb, ws, wc, wv = (np.asarray(a) for a in want)
    np.testing.assert_array_equal(gv, wv)
    assert gv.sum() > 0
    np.testing.assert_array_equal(gc[gv], wc[wv])
    np.testing.assert_allclose(gs[gv], ws[wv], atol=TOL, rtol=TOL)
    np.testing.assert_allclose(gb[gv], wb[wv], atol=TOL, rtol=TOL)


def test_quantize_detector_frozen_states_detect_as_jax():
    det, fused, cfg, model, states, images = _setup("tiny_yolo_v3")
    frozen = [dict(s) for s in states]
    frozen[2] = _frozen(1e4)  # re-calibration would disagree with it
    tdet = Detector(cfg, model=model, batch_norm=False, device="cpu")
    model_q, out_states, detect = generic.quantize_detector(
        tdet, [images], fold_bn=False, states=frozen)
    assert out_states is frozen and detect.device.type == "cpu"
    jparams_q, _, jdetect = jgeneric.quantize_detector(
        det, fused, [images], fold_bn=False, states=frozen)
    _same_detections(detect(images), jdetect(jnp.asarray(images)))
    # calibration when no states are given: the JAX package's states
    _, calibrated, _ = generic.quantize_detector(tdet, [images],
                                                 fold_bn=False)
    for a, w in zip(calibrated, states):
        np.testing.assert_allclose(float(a["scale"]), float(w["scale"]),
                                   rtol=1e-5)


def test_make_quant_module_detects_as_jax_and_refuses_training():
    det, fused, cfg, model, _, images = _setup("slim_yolo_v2")
    jq_params = jqsim.fake_quantize_params(fused)
    states = jax.device_get(jqsim.calibrate(jq_params, det.cfg, [images]))
    det.module = jqsim.make_quant_module(jq_params, states)
    want = det.detect(jq_params, jnp.asarray(images))
    model_q = qsim.fake_quantize_params(model)
    mod = qsim.make_quant_module(model_q, states)
    assert mod.STRIDES == (16,)
    got = Detector(cfg, model=mod, batch_norm=False,
                   device="cpu").detect(images)
    _same_detections(got, want)
    with pytest.raises(RuntimeError, match="inference-only"):
        with blocks.train_context():
            mod(torch.tensor(images))
