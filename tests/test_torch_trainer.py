"""The port's trainer against the JAX package on the CPU: ``lr_at`` and
``multi_scale_sizes``, the optimizer (SGD with coupled weight decay over
the whole tree, the BN running stats included) and its state's layout,
``make_train_step`` over three steps (slim_yolo_v2 at 32², yolo_v3 at
64²), one bf16 step, a rematerialized step, the s2d pooled form
(``fast_pool_cin``), ``train_device_resident`` and ``retune_finetune``.

Tolerances:
- ``lr_at`` and ``multi_scale_sizes``: equal (the same Python floats);
- three float32 steps, the device-resident loop and the retune
  fine-tune: every parameter, running stat and momentum-trace leaf
  within TOL = 1e-4 of that leaf's largest |value| (the loss test's
  gradient bound: the forward's sums in another order, through three
  updates), but yolo_v3's trace within V3_TRACE_TOL = 2e-3: its float32
  gradients at 64² lie 4e-5 to 1.9e-4 of a leaf's largest value from
  float64 ones on the same branches (batch 2 to 8, the port on the CPU;
  BN over 16 to 64 values a channel at the coarse scale, the finest
  head's 3x3 and 1x1 summing thousands of cancelling terms), and the
  trace sums three steps' (seen: 4e-4 to 6e-4 at batch 4, its
  parameters and stats within 2e-5). The JAX package's forwards take
  the port's leaky branches there (``_jax_masked``): unmasked, a value
  within 3e-7 of a leaky's zero flips in one package and moves a leaf by
  7%;
- one bf16 step: the masters, the stats and the trace float32; the
  parameters and the running stats within BF16_TOL = 2e-2 of each
  leaf's largest |value| (bf16 keeps an 8-bit mantissa: 4e-3 a
  rounding), the losses rtol 1e-2; the momentum trace (the gradients),
  over the whole tree, at most half as far (relative L2) from the JAX
  package's bf16 trace as that is from its float32 one: one bf16
  rounding moves a gradient leaf of this size by tens of percent in
  either package;
- the remat step against a plain one: the running stats equal
  (``torch.equal``, the same forward once), the gradients within 1e-6 of
  each leaf's largest |value| (the recompute takes another conv
  algorithm on no device here; the bound leaves room for one that
  does);
- the s2d pooled form: outputs and BN stats within 1e-5 of their largest
  |value| of the JAX package's form and of the port's plain conv + pool
  (another summation order), the loss gradients within TOL.
Both packages take the same normalized floats (see
``test_torch_train_loss.py``)."""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from yolo_tpu import detector as jdet
from yolo_tpu.data import BaseTransform as JBaseTransform
from yolo_tpu.data import SyntheticDetection as JSynthetic
from yolo_tpu.ops import blocks as jblocks
from yolo_tpu.quant import retune as jretune
from yolo_tpu.train import trainer as jtrainer
from yolo_tpu_torch import detector as tdet
from yolo_tpu_torch.config import BGR_MEAN, BGR_STD, get_config
from yolo_tpu_torch.data import BaseTransform, SyntheticDetection
from yolo_tpu_torch.ops import blocks
from yolo_tpu_torch.quant import convert as C
from yolo_tpu_torch.quant import retune as tretune
from yolo_tpu_torch.train import targets as ttargets
from yolo_tpu_torch.train import trainer as ttrainer

torch.set_num_threads(1)

TOL = 1e-4
V3_TRACE_TOL = 2e-3
BF16_TOL = 2e-2
FAMILIES = {"slim_yolo_v2": (32, C.slim_from_params),
            "yolo_v3": (64, C.yolo_v3_from_params)}
# the three-step test: (batch, the momentum trace's bound)
STEPS = {"slim_yolo_v2": (2, TOL), "yolo_v3": (4, V3_TRACE_TOL)}
# the first steps of a warmup (lr_at's quartic ramp to 1e-3)
LRS = (1e-4, 1e-3, 5e-4)


def _jax_params(name, size, seed=1):
    """The JAX init, BN away from the identity (a stat mixed up shows)."""
    d = jdet.build_detector(name, "mask", input_size=(size, size))
    params = d.init_params(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)

    def perturb(path, p):
        keys = [getattr(k, "key", None) for k in path]
        if "bn" not in keys:
            return p
        lo, hi = {"gamma": (0.5, 1.5), "beta": (-0.5, 0.5),
                  "mean": (-0.3, 0.3), "var": (0.5, 2.0)}[keys[-1]]
        return jnp.asarray(rng.uniform(lo, hi, p.shape), p.dtype)

    return d, jax.device_get(jax.tree_util.tree_map_with_path(perturb,
                                                              params))


def _labels(rng, batch, n_max=4):
    out = []
    for _ in range(batch):
        n = int(rng.integers(1, n_max + 1))
        xy = rng.uniform(0.0, 0.6, (n, 2))
        wh = rng.uniform(0.1, 0.4, (n, 2))
        boxes = np.clip(np.hstack([xy, xy + wh]), 0.0, 1.0)
        out.append(np.hstack([boxes, rng.integers(0, 2, (n, 1))]
                             ).astype(np.float32))
    return out


def _normalize_np(images):
    mean = np.asarray(BGR_MEAN[::-1], np.float32)
    std = np.asarray(BGR_STD[::-1], np.float32)
    return (images.astype(np.float32) / np.float32(255.0) - mean) / std


def _batches(cfg, size, batch, n, seed):
    """``n`` (normalized float images, targets) batches."""
    rng = np.random.default_rng(seed)
    return [(_normalize_np(rng.integers(0, 256, (batch, size, size, 3),
                                        dtype=np.uint8)),
             ttargets.build_targets(cfg, _labels(rng, batch)))
            for _ in range(n)]


def _flat(tree, path=""):
    """{path: leaf} of a tree of dicts and lists (a list index and a
    to_state_dict '0' key alike)."""
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


def _assert_trees_close(got, want, tol, what):
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want), what
    for k in want:
        w = want[k].astype(np.float64)
        g = got[k].astype(np.float64)
        assert g.shape == w.shape, (what, k)
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(g - w).max()) / scale
        assert err <= tol, f"{what} {k}: {err} of the leaf's largest |value|"


def _nhwc(choices):
    """The port's recorded leaky sign masks (NCHW) in the JAX layout."""
    return [c.permute(0, 2, 3, 1).numpy() for c in choices
            if c.dtype == torch.bool]


def _jax_masked(step):
    """``step`` (a JAX train step) jitted with one more argument, the
    leaky sign masks that each ``blocks.leaky_relu`` of the forward takes
    in call order in place of its own (the port's branches: two float32
    forwards part at a near-tie of zero, and one flipped element moves a
    gradient leaf by far more than rounding)."""
    plain = jblocks.leaky_relu

    def masked(params, state, x, gt, lr, masks):
        calls = iter(masks)

        def leaky(v, slope=jblocks.MODEL_LEAKY_SLOPE):
            m = next(calls)
            assert m.shape == v.shape, (m.shape, v.shape)
            return jnp.where(m, v, v * slope)

        jblocks.leaky_relu = leaky
        try:
            out = step(params, state, x, gt, lr)
        finally:
            jblocks.leaky_relu = plain
        assert next(calls, None) is None, "masks left over"
        return out

    return jax.jit(masked)


def _steps_both(d, params, model, cfg, batches, lrs, jtc, tc, masks=True):
    """The same steps in both packages from the same weights, the JAX
    package's forwards on the port's leaky branches (``masks``) -> (JAX
    params, JAX opt state dict, JAX metrics, port SGDState, port
    metrics); ``model`` trained in place."""
    jopt, jstep = jtrainer.make_train_step(d.module, d.cfg, jtc,
                                           donate=False)
    jstate = jopt.init(params)
    run = _jax_masked(jstep) if masks else None
    opt, step = ttrainer.make_train_step(model, cfg, tc)
    state = opt.init(model)
    for (x, gt), lr in zip(batches, lrs):
        with blocks.branch_context() as b:
            metrics = step(state, torch.tensor(x), gt, lr)
        args = (params, jstate, jnp.asarray(x), jnp.asarray(gt, jnp.float32),
                lr)
        params, jstate, jmetrics = (run(*args, _nhwc(b.choices)) if masks
                                    else jstep(*args))
    return (jax.device_get(params),
            jax.device_get(serialization.to_state_dict(jstate)),
            jax.device_get(jmetrics), state, metrics)


def test_lr_at_matches_jax():
    cases = [dict(), dict(cos=True, max_epoch=150), dict(wp_epoch=0),
             dict(base_lr=2.5e-4, lr_epoch=(3, 5), wp_epoch=1),
             dict(cos=True, wp_epoch=3, max_epoch=9, base_lr=1e-2)]
    n = 0
    for kw in cases:
        tc, jtc = ttrainer.TrainConfig(**kw), jtrainer.TrainConfig(**kw)
        for epoch in range(0, 12):
            for it in range(0, 9, 2):
                for size in (1, 4, 9):
                    assert ttrainer.lr_at(tc, epoch, it, size) == \
                        jtrainer.lr_at(jtc, epoch, it, size)
                    n += 1
    for epoch in (0, 100, 149, 160, 200, 259):
        tc, jtc = ttrainer.TrainConfig(), jtrainer.TrainConfig()
        assert ttrainer.lr_at(tc, epoch, 3, 100) == \
            jtrainer.lr_at(jtc, epoch, 3, 100)
    assert n == len(cases) * 12 * 5 * 3


def test_multi_scale_sizes_match_jax():
    assert ttrainer.multi_scale_sizes() == jtrainer.multi_scale_sizes()
    assert ttrainer.multi_scale_sizes(16, 2, 5) == \
        jtrainer.multi_scale_sizes(16, 2, 5)
    assert ttrainer.multi_scale_sizes()[0] == (320, 320)


def test_train_config_matches_jax():
    ours = {f.name: f.default for f in dataclasses.fields(
        ttrainer.TrainConfig)}
    theirs = {f.name: f.default for f in dataclasses.fields(
        jtrainer.TrainConfig)}
    assert ours == theirs


@pytest.mark.parametrize("name", ["slim_yolo_v2", "yolo_v3"])
def test_opt_state_dict_has_optax_layout(name):
    size, from_params = FAMILIES[name]
    d, params = _jax_params(name, size)
    want = serialization.to_state_dict(
        jtrainer.make_optimizer(jtrainer.TrainConfig()).init(params))
    model = from_params(params, device="cpu")
    got = ttrainer.SGD(ttrainer.TrainConfig()).init(model).state_dict()
    fw, fg = _flat(jax.device_get(want)), _flat(got)
    assert sorted(fg) == sorted(fw)
    for k in fw:
        assert fg[k].shape == fw[k].shape and fg[k].dtype == fw[k].dtype, k
    assert got["hyperparams_states"] == {} and got["inner_state"]["0"] == {}


@pytest.mark.parametrize("name", ["slim_yolo_v2", "yolo_v3"])
def test_three_steps_match_jax(name):
    """Params, running stats and the momentum trace (trap: optax decays
    the BN running stats and carries momentum for them) after three
    steps, and the last step's losses."""
    size, from_params = FAMILIES[name]
    batch, trace_tol = STEPS[name]
    d, params = _jax_params(name, size)
    cfg = get_config(name, "mask", input_size=(size, size))
    batches = _batches(cfg, size, batch, 3, seed=3)
    model = from_params(params, device="cpu")
    jparams, jstate, jmetrics, state, metrics = _steps_both(
        d, params, model, cfg, batches, LRS, jtrainer.TrainConfig(),
        ttrainer.TrainConfig())
    _assert_trees_close(C.module_to_params(model), jparams, TOL, "params")
    sd = state.state_dict()
    _assert_trees_close(sd["inner_state"], jstate["inner_state"], trace_tol,
                        "trace")
    assert int(sd["count"]) == int(jstate["count"]) == 3
    assert sd["hyperparams"]["learning_rate"] == \
        jstate["hyperparams"]["learning_rate"]
    for k, v in jmetrics.items():
        np.testing.assert_allclose(float(metrics[k]), float(v), rtol=1e-4)
    for p in model.parameters():
        assert p.dtype == torch.float32


def test_running_stats_decay_and_carry_momentum():
    """The trap on its own: a leaf without a gradient (a running stat)
    moves by the decay and its trace after the forward's EMA."""
    size, from_params = FAMILIES["slim_yolo_v2"]
    _, params = _jax_params("slim_yolo_v2", size)
    cfg = get_config("slim_yolo_v2", "mask", input_size=(size, size))
    (x, gt), = _batches(cfg, size, 2, 1, seed=4)
    model = from_params(params, device="cpu")
    with blocks.train_context():
        model(torch.tensor(x))   # the EMA alone, on a copy of the model
    ema = model.conv1.bn.running_var.detach().clone()
    model = from_params(params, device="cpu")
    opt, step = ttrainer.make_train_step(model, cfg, ttrainer.TrainConfig())
    state = opt.init(model)
    step(state, torch.tensor(x), gt, 0.1)
    torch.testing.assert_close(model.conv1.bn.running_var,
                               ema * (1 - 0.1 * 5e-4), rtol=1e-6, atol=0)
    trace = state.trace[state.paths.index(("conv1", "bn", "var"))]
    torch.testing.assert_close(trace, ema * 5e-4, rtol=1e-6, atol=0)


def _rel_l2(got, want):
    """||got - want|| / ||want|| over every leaf of two trees."""
    got, want = _flat(got), _flat(want)
    num = sum(float(((got[k] - want[k]).astype(np.float64) ** 2).sum())
              for k in want)
    return (num / sum(float((want[k].astype(np.float64) ** 2).sum())
                      for k in want)) ** 0.5


def test_bf16_step_matches_jax():
    """One bf16 step: the port casts what the JAX package casts (every
    parameter, gamma and beta too, and the images; the running stats and
    the loss stay float32), so its step lands nearer the JAX package's
    bf16 step than bf16 rounding puts either from float32."""
    size, from_params = FAMILIES["slim_yolo_v2"]
    d, params = _jax_params("slim_yolo_v2", size)
    cfg = get_config("slim_yolo_v2", "mask", input_size=(size, size))
    batches = _batches(cfg, size, 4, 1, seed=5)
    runs = {}
    for dtype in (None, "bfloat16"):
        model = from_params(params, device="cpu")
        runs[dtype] = _steps_both(
            d, params, model, cfg, batches, LRS[:1],
            jtrainer.TrainConfig(compute_dtype=dtype),
            ttrainer.TrainConfig(compute_dtype=dtype)) + (model,)
    jparams, jstate, jmetrics, state, metrics, model = runs["bfloat16"]
    for t in list(model.parameters()) + list(model.buffers()):
        assert t.dtype in (torch.float32, torch.int64)
    assert all(t.dtype == torch.float32 for t in state.trace)
    got = C.module_to_params(model)
    stats = {k: v for k, v in _flat(jparams).items()
             if k.endswith((".mean", ".var"))}
    _assert_trees_close({k: _flat(got)[k] for k in stats}, stats, BF16_TOL,
                        "running stats")
    _assert_trees_close(got, jparams, BF16_TOL, "params")
    # the gradients of a bf16 forward at 32² move by tens of percent of a
    # leaf with one rounding (BN over 8 values a channel, bf16 ties at
    # the leaky and the pools), in either package: the whole trace tree
    # is held to the JAX package's own bf16-to-float32 distance instead
    trace = state.state_dict()["inner_state"]
    yardstick = _rel_l2(jstate["inner_state"], runs[None][1]["inner_state"])
    assert _rel_l2(trace, jstate["inner_state"]) <= 0.5 * yardstick
    for k, v in jmetrics.items():
        np.testing.assert_allclose(float(metrics[k]), float(v), rtol=1e-2)


@pytest.mark.parametrize("tc_kw", [dict(), dict(compute_dtype="bfloat16")])
def test_remat_step_equals_plain(tc_kw):
    """The recompute in the backward leaves the running stats alone: they
    equal the plain step's, which moved them once."""
    size, from_params = FAMILIES["slim_yolo_v2"]
    _, params = _jax_params("slim_yolo_v2", size)
    cfg = get_config("slim_yolo_v2", "mask", input_size=(size, size))
    (x, gt), = _batches(cfg, size, 2, 1, seed=6)
    runs = []
    for remat in (False, True):
        model = from_params(params, device="cpu")
        tc = ttrainer.TrainConfig(remat=remat, **tc_kw)
        total, _ = ttrainer.loss_fn(model, cfg, tc, torch.tensor(x), gt)
        total.backward()
        runs.append((total.item(),
                     {n: p.grad.clone() for n, p in model.named_parameters()},
                     {n: b.clone() for n, b in model.named_buffers()}))
    (t0, g0, s0), (t1, g1, s1) = runs
    assert t0 == t1
    for n in s0:
        assert torch.equal(s0[n], s1[n]), n
    for n in g0:
        scale = float(g0[n].abs().max())
        assert float((g0[n] - g1[n]).abs().max()) <= 1e-6 * scale, n
    with pytest.raises(ValueError, match="branch_context"):
        with blocks.branch_context():
            ttrainer.loss_fn(model, cfg, ttrainer.TrainConfig(remat=True),
                             torch.tensor(x), gt)


def _close(got, want, what, rel=1e-5):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    scale = float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= rel * scale, what


@pytest.mark.parametrize("train", [True, False])
def test_conv_block_pool_s2d_matches_jax_and_plain(train):
    """The s2d pooled form of a conv + BN + leaky + pool at C_in 3 and
    16 (slim's conv1, conv2): outputs and the new BN stats against the
    JAX package's ``conv_block_pool_s2d`` and the port's plain trace."""
    _, params = _jax_params("slim_yolo_v2", 32)
    rng = np.random.default_rng(7)
    for name, c_in in (("conv1", 3), ("conv2", 16)):
        x = rng.standard_normal((2, 20, 24, c_in)).astype(np.float32)
        p = params[name]
        if train:
            want, jnew = jblocks.conv_block_pool_s2d(p, jnp.asarray(x),
                                                     train=True)
        else:
            want = jblocks.conv_block_pool_s2d(p, jnp.asarray(x))
        outs = []
        for fast in (32, 0):
            model = C.slim_from_params(params, device="cpu")
            block = getattr(model, name)
            xt = torch.tensor(x).permute(0, 3, 1, 2)
            ctx = (blocks.train_context() if train
                   else blocks.fast_pool_context(0))
            with ctx, blocks.fast_pool_context(fast):
                y = blocks.conv_block_pool(block, xt)
            outs.append((y.permute(0, 2, 3, 1).detach().numpy(),
                         block.bn.running_mean.clone().numpy(),
                         block.bn.running_var.clone().numpy()))
        (got, mean, var), (plain, pmean, pvar) = outs
        _close(got, want, f"{name} vs JAX")
        _close(got, plain, f"{name} vs plain")
        if train:
            _close(mean, jnew["bn"]["mean"], f"{name} mean vs JAX")
            _close(var, jnew["bn"]["var"], f"{name} var vs JAX")
            _close(mean, pmean, f"{name} mean vs plain")
            _close(var, pvar, f"{name} var vs plain")
            assert not np.array_equal(mean, params[name]["bn"]["mean"])


def test_fast_pool_step_matches_jax():
    size, from_params = FAMILIES["slim_yolo_v2"]
    d, params = _jax_params("slim_yolo_v2", size)
    cfg = get_config("slim_yolo_v2", "mask", input_size=(size, size))
    batches = _batches(cfg, size, 2, 1, seed=8)
    jtc = jtrainer.TrainConfig(fast_pool_cin=32)
    (jtotal, _), jgrads = jax.jit(jax.value_and_grad(
        partial(jtrainer.loss_fn, d.module, d.cfg, jtc), has_aux=True))(
        params, jnp.asarray(batches[0][0]),
        jnp.asarray(batches[0][1], jnp.float32))
    model = from_params(params, device="cpu")
    total, _ = ttrainer.loss_fn(model, cfg,
                                ttrainer.TrainConfig(fast_pool_cin=32),
                                torch.tensor(batches[0][0]), batches[0][1])
    total.backward()
    np.testing.assert_allclose(total.item(), float(jtotal), rtol=1e-5)
    grads = C.module_to_params(model, grads=True)
    jgrads = jax.device_get(jgrads)
    for layer in ("conv1", "conv2", "conv3_1", "pred"):
        _assert_trees_close(grads[layer], jgrads[layer], TOL, layer)


def test_train_device_resident_matches_jax():
    size = 32
    d, params = _jax_params("slim_yolo_v2", size)
    cfg = get_config("slim_yolo_v2", "mask", input_size=(size, size))
    kw = dict(size=(size, size), num_classes=2, length=8, seed=3)
    tc = dict(base_lr=1e-2, wp_epoch=1, max_epoch=2)
    jparams, jmetrics = jtrainer.train_device_resident(
        d, d.cfg, jtrainer.TrainConfig(**tc),
        JSynthetic(transform=JBaseTransform((size, size)), **kw), 4,
        params, seed=5, verbose=False)
    det = tdet.Detector(cfg, model=C.slim_from_params(params, device="cpu"),
                        device="cpu")
    model, metrics = ttrainer.train_device_resident(
        det, cfg, ttrainer.TrainConfig(**tc),
        SyntheticDetection(transform=BaseTransform((size, size)), **kw), 4,
        seed=5, verbose=False)
    assert model is det.model
    _assert_trees_close(C.module_to_params(model),
                        jax.device_get(jparams), TOL, "params")
    for k, v in jax.device_get(jmetrics).items():
        np.testing.assert_allclose(metrics[k], float(v), rtol=1e-4)


def _fused_slim(size):
    from yolo_tpu.quant.bn_fold import fold_batch_norm

    d, params = _jax_params("slim_yolo_v2", size)
    return d, jax.device_get(fold_batch_norm(params))


def test_retune_finetune_matches_jax():
    size = 32
    d, fused = _fused_slim(size)
    dj = jdet.Detector(d.cfg, batch_norm=False)
    cfg = get_config("slim_yolo_v2", "mask", input_size=(size, size))
    batches = _batches(cfg, size, 2, 4, seed=9)
    # a larger LR than the default 1e-7, so that three steps move the
    # weights past rounding
    jp, jlast = jretune.retune_finetune(
        dj, fused, [(jnp.asarray(x), jnp.asarray(g, jnp.float32))
                    for x, g in batches], base_lr=1e-3, steps=3)
    det = tdet.Detector(cfg, model=C.slim_from_params(fused, device="cpu"),
                        device="cpu")
    model, last = tretune.retune_finetune(det, batches, base_lr=1e-3,
                                          steps=3)
    assert model.conv1.bn is None
    _assert_trees_close(C.module_to_params(model), jax.device_get(jp), TOL,
                        "params")
    for k, v in jax.device_get(jlast).items():
        np.testing.assert_allclose(float(last[k]), float(v), rtol=1e-4)


def test_retune_finetune_keeps_the_best_state():
    """With a stub eval_fn the best-scoring state comes back, the final
    one included, as the JAX package picks it (first of equal scores)."""
    size = 32
    _, fused = _fused_slim(size)
    cfg = get_config("slim_yolo_v2", "mask", input_size=(size, size))
    batches = _batches(cfg, size, 2, 6, seed=10)
    for scores, best_call in (([0.1, 0.5, 0.3], 1), ([0.2, 0.2, 0.7], 2),
                              ([0.4, 0.1, 0.4], 0)):
        det = tdet.Detector(cfg, model=C.slim_from_params(fused,
                                                          device="cpu"),
                            device="cpu")
        seen = []

        def eval_fn(model, scores=scores, seen=seen):
            seen.append(C.module_to_params(model))
            return scores[len(seen) - 1]

        model, _ = tretune.retune_finetune(det, batches, base_lr=1e-3,
                                           steps=6, eval_fn=eval_fn,
                                           eval_every=2)
        # evaluated after steps 2 and 4, then the final state (step 6)
        assert len(seen) == 3
        _assert_trees_close(C.module_to_params(model), seen[best_call], 0.0,
                            f"scores {scores}")
        if best_call != 2:
            assert not np.array_equal(C.module_to_params(model)["pred"]["b"],
                                      seen[2]["pred"]["b"])

    # JAX's picks the same call on the same scores
    d, _ = _fused_slim(size)
    dj = jdet.Detector(d.cfg, batch_norm=False)
    calls = []

    def jeval(p):
        calls.append(p)
        return [0.1, 0.5, 0.3][len(calls) - 1]

    jp, _ = jretune.retune_finetune(
        dj, fused, [(jnp.asarray(x), jnp.asarray(g, jnp.float32))
                    for x, g in batches], base_lr=1e-3, steps=6,
        eval_fn=jeval, eval_every=2)
    assert len(calls) == 3 and jp is calls[1]


def test_make_train_step_refuses_a_mesh():
    cfg = get_config("slim_yolo_v2", "mask", input_size=(32, 32))
    model = C.slim_from_params(_jax_params("slim_yolo_v2", 32)[1],
                               device="cpu")
    with pytest.raises(NotImplementedError, match="Queue 1 item 5"):
        ttrainer.make_train_step(model, cfg, ttrainer.TrainConfig(),
                                 mesh=object())


def test_guard_determinism_switch_restores_the_flags():
    """``chip_smoke.deterministic_algorithms`` (11c trains the map guard's
    recipe under it) turns on torch's and cuDNN's deterministic
    algorithms inside the block and puts both flags back after it, also
    when the block raises; ``state_digest`` sees a running stat move."""
    import chip_smoke

    was = (torch.are_deterministic_algorithms_enabled(),
           torch.backends.cudnn.deterministic)
    with pytest.raises(RuntimeError, match="inside"):
        with chip_smoke.deterministic_algorithms():
            assert torch.are_deterministic_algorithms_enabled()
            assert torch.backends.cudnn.deterministic
            raise RuntimeError("inside")
    assert (torch.are_deterministic_algorithms_enabled(),
            torch.backends.cudnn.deterministic) == was
    model = C.slim_from_params(_jax_params("slim_yolo_v2", 32)[1],
                               device="cpu")
    before = chip_smoke.state_digest(model)
    assert chip_smoke.state_digest(model) == before
    with torch.no_grad():
        model.conv1.bn.running_var[0] += 1e-6
    assert chip_smoke.state_digest(model) != before
