"""One training batch of the port against the JAX package on the CPU:
``train.targets`` (single and multi-scale, with ignored anchors, dirty
boxes and collisions), ``train.loss.yolo_loss`` and its input gradients,
``blocks.batch_norm_train``, the train-mode forward of the five float
families with their new BN running stats, ``detector.train_outputs``,
and ``train.trainer.loss_fn`` with every gradient leaf against
``jax.value_and_grad`` (slim_yolo_v2 at 32², tiny_yolo_v3 at 64²).

Tolerances, each set from float32 and the depth of the computation:
- targets: equal, element for element (the same numpy code);
- ``yolo_loss`` on given inputs: values rtol 1e-5, input gradients
  within 1e-5 of each input's largest |gradient| (a few float32 sums);
- ``batch_norm_train``: outputs and running stats rtol 1e-5, atol 1e-6
  (XLA's CPU rsqrt is 1-4 ulps off IEEE);
- a family's train-mode forward: heads within 5e-4 of their largest |value|
  (train-mode BN over as few as 8 values a channel at the coarse scale
  amplifies the conv sums' reordering through up to 75 layers; seen:
  up to 9.4e-5), BN running stats rtol 1e-4, atol 5e-5;
- ``loss_fn``: the loss components rtol 1e-5, every gradient leaf within
  1e-4 of that leaf's largest |gradient| (seen: 1.0e-5), the new BN stats
  as the forward's. Both packages take the same normalized floats:
  XLA's jitted ``normalize_u8`` can round up to an ulp off the formula,
  and at these sizes (BN over as few as 12 values at the 2x2 scale,
  pools and leaky slopes at near-ties) an input change that small can
  move a gradient leaf past this tolerance in either package, so the
  comparison holds the two to one input; u8 input is held equal to the
  floats it normalizes to, bit for bit, in the port.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolo_tpu import detector as jdet
from yolo_tpu.config import get_config as jget_config
from yolo_tpu.ops import blocks as jblocks
from yolo_tpu.train import loss as jloss
from yolo_tpu.train import targets as jtargets
from yolo_tpu.train import trainer as jtrainer
from yolo_tpu_torch import detector as tdet
from yolo_tpu_torch.config import BGR_MEAN, BGR_STD, get_config
from yolo_tpu_torch.ops import blocks
from yolo_tpu_torch.quant import convert as C
from yolo_tpu_torch.train import loss as tloss
from yolo_tpu_torch.train import targets as ttargets
from yolo_tpu_torch.train import trainer as ttrainer

torch.set_num_threads(1)

FAMILIES = {
    "slim_yolo_v2": (32, C.slim_from_params),
    "tiny_yolo_v3": (64, C.tiny_from_params),
    "yolo_v2": (64, C.yolo_v2_from_params),
    "yolo_v3": (64, C.yolo_v3_from_params),
    "yolo_v3_spp": (64, C.yolo_v3_from_params),
}


def _labels(rng, batch, n_max=6, dirty=True):
    """Random label lists [N, 5] (x0, y0, x1, y1, class): boxes from
    tiny to large, some in one grid cell (collisions), some below one
    pixel (dirty, skipped)."""
    out = []
    for _ in range(batch):
        n = int(rng.integers(0, n_max + 1))
        xy = rng.uniform(0.0, 0.7, (n, 2))
        wh = rng.uniform(0.01, 0.3, (n, 2)) * rng.choice([0.3, 1.0, 3.0],
                                                         (n, 1))
        boxes = np.clip(np.hstack([xy, xy + wh]), 0.0, 1.0)
        lab = np.hstack([boxes, rng.integers(0, 2, (n, 1))])
        if n and dirty:
            # a twin of the first box (same cell, same best anchor: the
            # last write wins) and a sub-pixel box
            twin = lab[:1].copy()
            twin[0, 4] = 1 - twin[0, 4]
            tiny = np.array([[0.5, 0.5, 0.5005, 0.6, 0.0]])
            lab = np.vstack([lab, twin, tiny])
        out.append(lab.astype(np.float32))
    return out


# ---------------------------------------------------------------------------
# Targets.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,size", [("slim_yolo_v2", (32, 48)),
                                       ("yolo_v2", (64, 64)),
                                       ("tiny_yolo_v3", (320, 416)),
                                       ("yolo_v3", (416, 416))])
def test_build_targets_match_jax(name, size):
    cfg = get_config(name, "mask", input_size=size)
    jcfg = jget_config(name, "mask", input_size=size)
    rng = np.random.default_rng(0)
    seen_ignore = seen_pos = 0
    for _ in range(6):
        labels = _labels(rng, 3)
        got = ttargets.build_targets(cfg, labels)
        want = jtargets.build_targets(jcfg, labels)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
        assert got.shape[-1] == ttargets.GT_WIDTH
        seen_ignore += int((got[..., 0] == -1).sum())
        seen_pos += int((got[..., 0] == 1).sum())
    assert seen_pos > 0
    if cfg.num_scales > 1:
        assert seen_ignore > 0  # the ignore threshold binds


def test_targets_collision_last_write_wins():
    cfg = get_config("slim_yolo_v2", "mask", input_size=(32, 32))
    box = [0.2, 0.2, 0.6, 0.7]
    labels = [np.array([box + [0.0], box + [1.0]], np.float32)]
    got = ttargets.gt_creator(cfg.input_size, 16, labels, cfg.anchor_size)
    want = jtargets.gt_creator(cfg.input_size, 16, labels, cfg.anchor_size)
    np.testing.assert_array_equal(got, want)
    pos = got[0, got[0, :, 0] == 1]
    assert len(pos) == 1 and pos[0, 1] == 1.0  # the second GT's class
    np.testing.assert_array_equal(
        ttargets.anchor_iou_wh(np.array(cfg.anchor_size), np.array([2, 3.])),
        jtargets.anchor_iou_wh(np.array(cfg.anchor_size), np.array([2, 3.])))
    # single scale with two anchors above the ignore threshold: the best
    # one positive, the other ignored (-1 objectness and weight)
    anchors = ((1.0, 1.0), (1.1, 1.1), (0.3, 0.3))
    labels = [np.array([[0.1, 0.1, 0.6, 0.6, 1.0]], np.float32)]
    got = ttargets.gt_creator((32, 32), 16, labels, anchors)
    np.testing.assert_array_equal(
        got, jtargets.gt_creator((32, 32), 16, labels, anchors))
    slot = got[0].reshape(2, 2, 3, ttargets.GT_WIDTH)[0, 0]
    np.testing.assert_array_equal(slot[:, 0], [1.0, -1.0, 0.0])
    np.testing.assert_array_equal(slot[1:, 6], [-1.0, 0.0])


# ---------------------------------------------------------------------------
# The loss.
# ---------------------------------------------------------------------------


def _loss_inputs(rng, cfg, batch=3):
    gt = ttargets.build_targets(cfg, _labels(rng, batch))
    n, c = gt.shape[1], cfg.num_classes
    conf = rng.standard_normal((batch, n, 1)).astype(np.float32) * 2
    cls = rng.standard_normal((batch, n, c)).astype(np.float32)
    txt = rng.standard_normal((batch, n, 4)).astype(np.float32)
    xy = rng.uniform(0, 0.8, (batch, n, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(0.01, 0.3, (batch, n, 2))],
                           -1).astype(np.float32)
    return conf, cls, txt, boxes, gt


@pytest.mark.parametrize("obj_loss_f", ["mse", "bce"])
@pytest.mark.parametrize("name", ["slim_yolo_v2", "yolo_v3"])
def test_yolo_loss_and_input_grads_match_jax(name, obj_loss_f):
    cfg = get_config(name, "mask", input_size=(64, 64))
    conf, cls, txt, boxes, gt = _loss_inputs(np.random.default_rng(1), cfg)

    def jax_total(conf, cls, txt):
        out = jloss.yolo_loss(conf, cls, txt, jnp.asarray(boxes),
                              jnp.asarray(gt, jnp.float32), cfg.num_classes,
                              obj_loss_f)
        return out[3], out

    (_, want), jgrads = jax.value_and_grad(jax_total, argnums=(0, 1, 2),
                                           has_aux=True)(conf, cls, txt)
    ins = [torch.tensor(a, requires_grad=True) for a in (conf, cls, txt)]
    got = tloss.yolo_loss(*ins, torch.tensor(boxes), gt, cfg.num_classes,
                          obj_loss_f)
    got[3].backward()
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.ndim == 0
        np.testing.assert_allclose(g.item(), float(w), rtol=1e-5)
    assert all(float(w) > 0 for w in want)
    for t, jg in zip(ins, jgrads):
        jg = np.asarray(jg)
        assert np.abs(jg).max() > 0
        np.testing.assert_allclose(t.grad.numpy(), jg, rtol=0,
                                   atol=1e-5 * np.abs(jg).max())
    # the IoU objectness target takes no gradient
    b = torch.tensor(boxes, requires_grad=True)
    assert not tloss.yolo_loss(*(t.detach() for t in ins), b, gt,
                               cfg.num_classes, obj_loss_f)[3].requires_grad
    with pytest.raises(ValueError, match="obj_loss_f"):
        tloss.yolo_loss(*ins, b, gt, cfg.num_classes, "l1")


def test_iou_score_matches_jax():
    rng = np.random.default_rng(2)
    a = np.sort(rng.uniform(0, 1, (64, 2, 2)), axis=1).reshape(64, 4)
    b = np.sort(rng.uniform(0, 1, (64, 2, 2)), axis=1).reshape(64, 4)
    b[:8] = 0.0  # the no-GT slots
    a, b = a.astype(np.float32), b.astype(np.float32)
    np.testing.assert_allclose(
        tloss.iou_score(torch.tensor(a), torch.tensor(b)).numpy(),
        np.asarray(jloss.iou_score(a, b)), rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# Train-mode BN and forwards.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(3, 8, 5, 7), (1, 4, 1, 1)],
                         ids=["batch", "one_value"])
def test_batch_norm_train_matches_jax(shape):
    rng = np.random.default_rng(3)
    x = (rng.standard_normal(shape) * 3 + 1).astype(np.float32)
    c = shape[1]
    bn_np = {"gamma": rng.uniform(0.5, 1.5, c), "beta": rng.normal(0, 1, c),
             "mean": rng.normal(0, 1, c), "var": rng.uniform(0.5, 2, c)}
    bn_np = {k: v.astype(np.float32) for k, v in bn_np.items()}
    y_j, new = jblocks.batch_norm_train(jnp.asarray(x.transpose(0, 2, 3, 1)),
                                        bn_np)
    bn = torch.nn.BatchNorm2d(c)
    with torch.no_grad():
        for k, a in C._BN_KEYS:
            getattr(bn, a).copy_(torch.tensor(bn_np[k]))
    y = blocks.batch_norm_train(torch.tensor(x), bn)
    tol = dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(y.detach().numpy().transpose(0, 2, 3, 1),
                               np.asarray(y_j), **tol)
    for k, a in C._BN_KEYS:
        np.testing.assert_allclose(getattr(bn, a).detach().numpy(),
                                   np.asarray(new[k]), **tol)
    assert not bn.running_var.requires_grad


def _jax_params(name, size, seed=1):
    d = jdet.build_detector(name, "mask", input_size=(size, size))
    params = d.init_params(jax.random.PRNGKey(seed))
    # BN away from the identity, so that a stat mixed up shows
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


def _assert_stats(model, want_tree):
    got = jax.tree_util.tree_leaves(C.module_to_params(model))
    want = jax.tree_util.tree_leaves(want_tree)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4, atol=5e-5)


@pytest.mark.parametrize("name", list(FAMILIES))
def test_train_forward_and_bn_stats_match_jax(name):
    size, from_params = FAMILIES[name]
    d, params = _jax_params(name, size)
    x = np.random.default_rng(4).standard_normal(
        (2, size, size, 3)).astype(np.float32)
    outs, new_params = jax.jit(
        lambda p, x: d.module.forward(p, x, d.cfg, train=True))(params, x)
    model = from_params(params, device="cpu")
    with torch.no_grad(), blocks.train_context():
        got = model(torch.tensor(x))
    assert len(got) == len(outs)
    for g, w in zip(got, outs):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=5e-4 * np.abs(w).max())
    _assert_stats(model, new_params)
    # every running mean and variance moved: BN ran in train mode
    moved = [not np.array_equal(a, np.asarray(b)) for a, b in zip(
        jax.tree_util.tree_leaves(C.module_to_params(model)),
        jax.tree_util.tree_leaves(params))]
    conv_bns = [m.bn for m in model.modules()
                if isinstance(m, blocks.Conv) and m.bn is not None]
    assert sum(moved) == 2 * len(conv_bns)
    # no BN outside a blocks.Conv, where the train switch is read
    assert len(conv_bns) == sum(isinstance(m, torch.nn.BatchNorm2d)
                                for m in model.modules())


def test_forward_outside_the_train_switch_is_unchanged():
    """Outside ``train_context`` BN runs from the running stats, whatever
    the modules' ``training`` flags (every nn.Module starts in training
    mode), and leaves them as they are."""
    d, params = _jax_params("slim_yolo_v2", 32)
    model = C.slim_from_params(params, device="cpu")
    assert model.training
    x = torch.tensor(np.random.default_rng(5).standard_normal(
        (2, 32, 32, 3)).astype(np.float32))
    before = C.module_to_params(model)
    with torch.no_grad():
        first = model(x)[0]
        model.eval()
        second = model(x)[0]
    assert torch.equal(first, second)
    _equal_trees(C.module_to_params(model), before)
    want = np.asarray(jax.jit(lambda p, x: d.module.forward(p, x, d.cfg))(
        params, x.numpy())[0])
    np.testing.assert_allclose(first.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    # a train forward moves the stats, and the switch is off after it
    with torch.no_grad(), blocks.train_context():
        model(x)
    assert not blocks._TRAIN
    moved = C.module_to_params(model)
    assert not np.array_equal(moved["conv1"]["bn"]["mean"],
                              before["conv1"]["bn"]["mean"])
    with torch.no_grad():
        model(x)
    _equal_trees(C.module_to_params(model), moved)


def _equal_trees(a, b):
    la, lb = jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(x, y)


def test_train_outputs_match_jax():
    size = 64
    d, params = _jax_params("yolo_v3", size)
    cfg = get_config("yolo_v3", "mask", input_size=(size, size))
    x = np.random.default_rng(6).standard_normal(
        (2, size, size, 3)).astype(np.float32)
    (want, _) = jax.jit(lambda p, x: jdet.train_outputs(
        d.module, p, x, d.cfg))(params, x)
    model = C.yolo_v3_from_params(params, device="cpu")
    got = tdet.train_outputs(model, torch.tensor(x), cfg)
    n = sum(h * w for h, w in cfg.grid_sizes()) * cfg.anchors_per_scale
    for g, w, width in zip(got, want, (1, cfg.num_classes, 4, 4)):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape == (2, n, width)
        np.testing.assert_allclose(g.detach().numpy(), w, rtol=0,
                                   atol=5e-4 * np.abs(w).max())
    assert got[0].requires_grad and not got[3].requires_grad


# ---------------------------------------------------------------------------
# loss_fn and its gradients.
# ---------------------------------------------------------------------------


def _batch(cfg, size, batch, seed):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (batch, size, size, 3), dtype=np.uint8)
    return images, ttargets.build_targets(cfg, _labels(rng, batch))


@pytest.mark.parametrize("images_as", ["u8", "float"])
@pytest.mark.parametrize("name", ["slim_yolo_v2", "tiny_yolo_v3"])
def test_loss_fn_value_and_grads_match_jax(name, images_as):
    size, from_params = FAMILIES[name]
    d, params = _jax_params(name, size)
    cfg = get_config(name, "mask", input_size=(size, size))
    images, gt = _batch(cfg, size, 3, seed=7)
    normalized = _normalize_np(images)
    tc = jtrainer.TrainConfig()
    # the JAX package takes the normalized floats in both cases: its
    # jitted normalize_u8 can round up to an ulp off the formula, which
    # the port's normalize_u8 follows exactly
    (total_j, aux), grads_j = jax.jit(jax.value_and_grad(
        partial(jtrainer.loss_fn, d.module, d.cfg, tc), has_aux=True))(
        params, jnp.asarray(normalized), jnp.asarray(gt, jnp.float32))
    if images_as == "float":
        images = normalized
    model = from_params(params, device="cpu")
    total, parts = ttrainer.loss_fn(model, cfg, ttrainer.TrainConfig(),
                                    torch.tensor(images), gt)
    total.backward()
    np.testing.assert_allclose(total.item(), float(total_j), rtol=1e-5)
    for k in ("conf_loss", "cls_loss", "txtytwth_loss"):
        np.testing.assert_allclose(parts[k].item(), float(aux[k]), rtol=1e-5)
    got = jax.tree_util.tree_leaves(C.module_to_params(model, grads=True))
    want = jax.tree_util.tree_flatten_with_path(jax.device_get(grads_j))[0]
    assert len(got) == len(want)
    nonzero = 0
    for g, (path, w) in zip(got, want):
        w = np.asarray(w)
        scale = np.abs(w).max()
        nonzero += scale > 0
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * scale,
                                   err_msg=jax.tree_util.keystr(path))
    # every leaf but the BN running stats takes a gradient
    stats = 2 * sum(1 for m in model.modules()
                    if isinstance(m, blocks.Conv) and m.bn is not None)
    assert nonzero == len(want) - stats
    _assert_stats(model, aux["new_params"])


def _normalize_np(images):
    """uint8 RGB -> normalized float32: normalize_u8's formula in numpy."""
    mean = np.asarray(BGR_MEAN[::-1], np.float32)
    std = np.asarray(BGR_STD[::-1], np.float32)
    return (images.astype(np.float32) / np.float32(255.0) - mean) / std


def test_u8_input_equals_normalized_float_input():
    size, from_params = FAMILIES["slim_yolo_v2"]
    _, params = _jax_params("slim_yolo_v2", size)
    cfg = get_config("slim_yolo_v2", "mask", input_size=(size, size))
    images, gt = _batch(cfg, size, 2, seed=8)
    tc = ttrainer.TrainConfig()
    np.testing.assert_array_equal(
        tdet.normalize_u8(torch.tensor(images)).numpy(),
        _normalize_np(images))
    runs = []
    for x in (torch.tensor(images), torch.tensor(_normalize_np(images))):
        model = from_params(params, device="cpu")
        total, parts = ttrainer.loss_fn(model, cfg, tc, x, gt)
        total.backward()
        runs.append((total.item(), C.module_to_params(model, grads=True),
                     C.module_to_params(model)))
    assert runs[0][0] == runs[1][0]
    _equal_trees(runs[0][1], runs[1][1])
    _equal_trees(runs[0][2], runs[1][2])


def test_train_config_matches_jax_and_unported_options_raise():
    import dataclasses

    ours = {f.name: f.default for f in dataclasses.fields(
        ttrainer.TrainConfig)}
    theirs = {f.name: f.default for f in dataclasses.fields(
        jtrainer.TrainConfig)}
    assert ours == theirs
    cfg = get_config("slim_yolo_v2", "mask", input_size=(32, 32))
    model = C.slim_from_params(_jax_params("slim_yolo_v2", 32)[1],
                               device="cpu")
    images, gt = _batch(cfg, 32, 1, seed=9)
    for kw in (dict(compute_dtype="bfloat16"), dict(remat=True),
               dict(fast_pool_cin=32)):
        with pytest.raises(NotImplementedError, match="Queue 1 item 2"):
            ttrainer.loss_fn(model, cfg, ttrainer.TrainConfig(**kw),
                             torch.tensor(images), gt)
    total, _ = ttrainer.loss_fn(model, cfg,
                                ttrainer.TrainConfig(obj_loss_f="bce"),
                                torch.tensor(images), gt)
    assert torch.isfinite(total)


def _grads(model):
    return {n: p.grad.detach().to(torch.float64).numpy()
            for n, p in model.named_parameters() if p.grad is not None}


@pytest.mark.parametrize("name", ["slim_yolo_v2", "yolo_v3"])
def test_branch_context_replays_a_forward_exactly(name):
    """A forward's recorded branches (each leaky's sign, each pool's
    argmax), imposed on the same forward again, change nothing: no flip,
    the same loss and gradients bit for bit."""
    size, from_params = FAMILIES[name]
    _, params = _jax_params(name, size)
    cfg = get_config(name, "mask", input_size=(size, size))
    images, gt = _batch(cfg, size, 2, seed=10)
    runs, choices = [], None
    for _ in range(2):
        model = from_params(params, device="cpu")
        with blocks.branch_context(choices) as b:
            total, _ = ttrainer.loss_fn(model, cfg, ttrainer.TrainConfig(),
                                        torch.tensor(images), gt)
        total.backward()
        choices = b.choices
        runs.append((total.item(), _grads(model)))
    kinds = {kind for kind, *_ in b.flips}
    assert kinds == ({"leaky", "pool"} if name == "slim_yolo_v2"
                     else {"leaky"})
    assert all(n == 0 for _, n, _, _ in b.flips)
    assert runs[0][0] == runs[1][0]
    for k, g in runs[0][1].items():
        np.testing.assert_array_equal(runs[1][1][k], g, err_msg=k)


def test_branch_context_takes_and_counts_imposed_choices():
    """An imposed leaky sign and pool argmax are taken, the gradient
    follows them, and each place the forward would branch otherwise is
    counted with its margin; a choice of another shape raises."""
    x = torch.tensor([[[[1.0, -2.0, 3.0, 0.5],
                        [0.25, 4.0, -1.0, 2.0]]]], requires_grad=True)
    with blocks.branch_context() as rec:
        blocks.leaky_relu(x, 0.1)
        blocks.max_pool(x)
    sign, argmax = rec.choices
    sign = sign.clone()
    sign[0, 0, 0, 0] = False        # 1.0 through the negative slope
    argmax = argmax.clone()
    argmax[0, 0, 0, 0] = 0          # the window [1, -2; 0.25, 4] takes 1
    with blocks.branch_context([sign, argmax]) as b:
        y = blocks.leaky_relu(x, 0.1)
        p = blocks.max_pool(x)
    assert y[0, 0, 0, 0].item() == pytest.approx(0.1)
    assert p.flatten().tolist() == [1.0, 3.0]
    assert b.flips == [("leaky", 1, 1.0, 4.0), ("pool", 1, 3.0, 4.0)]
    p.sum().backward()
    assert x.grad.flatten().tolist() == [1, 0, 1, 0, 0, 0, 0, 0]
    with pytest.raises(ValueError, match="imposed"):
        with blocks.branch_context([sign[..., :2]]):
            blocks.leaky_relu(x)


def test_float32_on_float64_branches_matches_float64():
    """yolo_v3 at 64²: a float32 training step that takes a float64
    step's branches has every gradient leaf within 1e-3 of its largest
    |g| in float64, and each branch it would take otherwise lies within
    1e-4 of the layer's largest |x| (a leaky's zero or a pool's
    runner-up within float32 rounding). Both the loss and train-mode BN
    keep float64 in float64."""
    size, from_params = FAMILIES["yolo_v3"]
    _, params = _jax_params("yolo_v3", size)
    cfg = get_config("yolo_v3", "mask", input_size=(size, size))
    images, gt = _batch(cfg, size, 2, seed=11)
    x = tdet.normalize_u8(torch.tensor(images))
    runs, choices = [], None
    for dtype in (torch.float64, torch.float32):
        model = from_params(params, device="cpu").to(dtype)
        with blocks.branch_context(choices) as b:
            total, _ = ttrainer.loss_fn(model, cfg, ttrainer.TrainConfig(),
                                        x.to(dtype), gt)
        assert total.dtype == dtype
        total.backward()
        choices = b.choices
        runs.append(_grads(model))
    for kind, n, margin, scale in b.flips:
        assert margin <= 1e-4 * scale, (kind, n, margin, scale)
    want, got = runs
    for k, w in want.items():
        scale = np.abs(w).max()
        assert np.abs(got[k] - w).max() <= 1e-3 * scale, k
