"""The port's tiny_yolo_v3 (the darknet_light backbone, the zero-pad
stride-1 pool, the float model, its PTQ pipeline, integer engine and
detect fn) against the JAX package, on the CPU at 64², mask config.

Weights: ``convert.tiny_seeded_fused_params(0, 21)`` (BN-fused), and for
per-channel sw the same with each output channel scaled by 2^-u, u drawn
from {0, 1, 2, 3} (so that a per-channel sw holds several values); the
float forward also in the BN form, with random BN stats. Both pipelines
take the same fused floats (``fold_bn=False``), so no BN fold is
involved, and the JAX integer model is carried over
(``int8_tiny_from_numpy``) for the forwards.

Held exactly: the PTQ tables and int8 weights, the int8 heads (scalar
and per-channel sw, NHWC and s2d input, rounding 'nearest'; 'floor' on
pred_2, which no upsample feeds: the JAX package's floor upsample
depends on the tensor's size), detected classes and valid slots. Boxes
and scores within atol = rtol = 1e-5, float heads within 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import yolo_tpu.quant.int8_models as jim
from yolo_tpu.config import get_config
from yolo_tpu.models import tiny_yolo_v3 as jtiny
from yolo_tpu.ops import blocks as jblocks
from yolo_tpu.quant import fixed_point as jfp
from yolo_tpu_torch.config import get_config as t_get_config
from yolo_tpu_torch.models.tiny_yolo_v3 import TinyYOLOv3
from yolo_tpu_torch.ops import blocks
from yolo_tpu_torch.quant import convert as C
from yolo_tpu_torch.quant import fixed_point as tfp
from yolo_tpu_torch.quant import int8_models as tim
from yolo_tpu_torch.quant.generic import tap_count

torch.set_num_threads(1)

SIZE, PRED_OUT = 64, 21
TOL = dict(atol=1e-5, rtol=1e-5)
# the per-forward launches on the card, by route (scalar and per-channel
# sw): the entry conv, the one-part wgmma 3x3s, conv_set_1 on their
# two-part form, conv_2 with its pool on their pooled form, the 1x1s
TINY_ROUTES = {"entry": 1, "conv3x3": 7, "parts": 1, "pool": 1,
               "conv1x1": 3}


def cfgs():
    return (get_config("tiny_yolo_v3", "mask", input_size=(SIZE, SIZE)),
            t_get_config("tiny_yolo_v3", "mask", input_size=(SIZE, SIZE)))


def images(n=2, seed=1):
    return np.random.default_rng(seed).random((n, SIZE, SIZE, 3),
                                              dtype=np.float32)


def per_channel_params(seed=3):
    """The seeded fused tree with each conv's output channels scaled by
    2^-u, u in {0, 1, 2, 3}."""
    rng = np.random.default_rng(seed)
    tree = C.tiny_seeded_fused_params(0, PRED_OUT)
    for layer in tim.flat_tiny_params(tree).values():
        u = rng.integers(0, 4, layer["w"].shape[-1])
        layer["w"] *= np.exp2(-u).astype(np.float32)
    return tree


def bn_form(tree, seed=7):
    """The tree with every conv but the preds in the BN form, its stats
    random (as the JAX package's quantization tests draw them)."""
    rng = np.random.default_rng(seed)
    flat = tim.flat_tiny_params(tree)
    for name, layer in flat.items():
        if name.startswith("pred"):
            continue
        c = layer["w"].shape[-1]
        del layer["b"]
        layer["bn"] = {
            "gamma": rng.random(c, dtype=np.float32) + 0.5,
            "beta": rng.standard_normal(c).astype(np.float32),
            "mean": rng.standard_normal(c).astype(np.float32) * 0.1,
            "var": rng.random(c, dtype=np.float32) + 0.5}
    return tree


def jtree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


@pytest.fixture(scope="module")
def runs():
    """{'scalar' | 'per_channel': dict(params, mj (the JAX Int8Tiny as
    numpy), mt (the port's model of the JAX one's fields), pt (the port's
    own pipeline's model))}."""
    cfg, tcfg = cfgs()
    out = {}
    for key, params in (("scalar", C.tiny_seeded_fused_params(0, PRED_OUT)),
                        ("per_channel", per_channel_params())):
        pc = key == "per_channel"
        mj = jax.device_get(jim.quantize_pipeline_tiny(
            jtree(params), cfg, [images()], fold_bn=False, per_channel=pc))
        mt = C.int8_tiny_from_numpy(mj.w_q, mj.b_q, mj.sw, mj.sb, mj.sa,
                                    mj.retune, device="cpu")
        pt = tim.quantize_pipeline_tiny(
            C.tiny_from_params(params, device="cpu"), tcfg, [images()],
            fold_bn=False, per_channel=pc)
        out[key] = dict(params=params, mj=mj, mt=mt, pt=pt)
    return out


def test_zero_pad_maxpool_s1_matches_jax(rng):
    """Zero padding on the bottom row and right column (not -inf): an
    all-negative input's edge becomes 0; float (NCHW) and int8 (NHWC)."""
    x = rng.standard_normal((2, 5, 7, 3)).astype(np.float32)
    x[:, -1, :, :] = -np.abs(x[:, -1, :, :]) - 1.0
    want = np.asarray(jblocks.zero_pad_maxpool_s1(jnp.asarray(x)))
    got = blocks.zero_pad_maxpool_s1(torch.tensor(x).permute(0, 3, 1, 2))
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)
    assert (want[:, -1] >= 0).all()
    q = rng.integers(-128, 128, (2, 5, 7, 3), dtype=np.int8)
    np.testing.assert_array_equal(
        tfp.int_zero_pad_maxpool_s1(torch.tensor(q)).numpy(),
        np.asarray(jfp.int_zero_pad_maxpool_s1(jnp.asarray(q))))


def test_float_forward_matches_jax():
    """The BN-form float model (random BN stats), both heads, against the
    JAX forward (the fused form's floats meet the JAX ones in the PTQ
    tests)."""
    cfg, _ = cfgs()
    tree = bn_form(C.tiny_seeded_fused_params(0, PRED_OUT))
    want = jax.jit(lambda p, x: jtiny.forward(p, x, cfg))(
        jtree(tree), jnp.asarray(images()))
    model = C.tiny_from_params(tree, device="cpu")
    assert model.conv_set_1.bn is not None and model.pred_1.bn is None
    with torch.no_grad():
        got = model(torch.tensor(images()))
    assert len(got) == 2
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-5)


def test_module_tree_round_trip():
    tree = C.tiny_seeded_fused_params(0, PRED_OUT)
    back = C.module_to_params(C.tiny_from_params(tree, device="cpu"))
    for name, layer in tim.flat_tiny_params(tree).items():
        got = tim.flat_tiny_params(back)[name]
        np.testing.assert_array_equal(got["w"], layer["w"])
        np.testing.assert_array_equal(got["b"], layer["b"])


def test_taps_fire_in_conv_call_order():
    """One tap per conv (the input's first), in TINY_CONV_ORDER: each tap's
    activation has its conv's output channels, pred_2 before pred_1."""
    model = TinyYOLOv3(PRED_OUT, batch_norm=False, device="cpu",
                       generator=torch.Generator().manual_seed(0))
    seen = []

    def tap(act):
        seen.append(act.shape[1])
        return act

    with torch.no_grad(), blocks.quantization_context(tap):
        model(torch.rand(1, SIZE, SIZE, 3))
    flat = tim.flat_tiny_params(C.module_to_params(model))
    want = [flat[n]["w"].shape[-1] for n in tim.TINY_CONV_ORDER]
    assert seen == want and tap_count(model) == 1 + len(want)


@pytest.mark.parametrize("key", ["scalar", "per_channel"])
def test_ptq_tables_equal_jax(runs, key):
    """The port's pipeline on the same fused floats: every sa, sw, sb,
    retune and int8 weight of the JAX package's."""
    r = runs[key]
    mj, pt = r["mj"], r["pt"]
    assert pt.per_channel == (key == "per_channel")
    if key == "per_channel":
        assert len(np.unique(np.asarray(pt.sw["conv_5"]))) > 1
    assert pt.sa == {k: int(v) for k, v in mj.sa.items()}
    assert pt.retune == {k: int(v) for k, v in mj.retune.items()}
    assert pt.sb == {k: int(v) for k, v in mj.sb.items()}
    for name in tim.TINY_CONV_ORDER:
        np.testing.assert_array_equal(np.asarray(pt.sw[name]),
                                      np.asarray(mj.sw[name]))
        np.testing.assert_array_equal(pt.w_q[name].numpy(), mj.w_q[name])
        np.testing.assert_array_equal(pt.b_q[name].numpy(), mj.b_q[name])


def jax_heads(mj, x_q, rounding, input_s2d):
    heads = jim.int8_tiny_forward(mj, jnp.asarray(x_q), rounding,
                                  input_s2d=input_s2d)
    return [np.asarray(h) for h in heads]


CASES = [("scalar", "nhwc", "nearest"), ("scalar", "s2d", "nearest"),
         ("per_channel", "nhwc", "nearest"), ("scalar", "nhwc", "floor"),
         ("scalar", "s2d", "floor"), ("per_channel", "nhwc", "floor")]


@pytest.mark.parametrize("key,layout,rounding", CASES)
def test_int8_heads_bit_exact(runs, key, layout, rounding):
    """The port's forward on the JAX model's integers: both heads equal
    under 'nearest'; under 'floor' pred_2 (pred_1 is fed by the
    upsample)."""
    r = runs[key]
    mj, mt = r["mj"], r["mt"]
    x_q = np.asarray(jfp.quantize_input(jnp.asarray(images()),
                                        int(mj.sa["in"])))
    if layout == "s2d":
        x_q = jfp.s2d_input_np(x_q)
    want = jax_heads(mj, x_q, rounding, layout == "s2d")
    got = tim.int8_tiny_forward(mt, torch.tensor(x_q), rounding,
                                input_s2d=layout == "s2d")
    assert [tuple(g.shape) for g in got] == [w.shape for w in want]
    heads = (0, 1) if rounding == "nearest" else (1,)
    for i in heads:
        np.testing.assert_array_equal(got[i].numpy(), want[i])


@pytest.mark.parametrize("layout", ["nhwc", "s2d"])
def test_detections_equal_jax(runs, layout):
    """The detect fns on float images and (s2d) on int8 input: classes and
    valid exact, boxes and scores within 1e-5."""
    cfg, tcfg = cfgs()
    mj, mt = runs["scalar"]["mj"], runs["scalar"]["mt"]
    s2d = layout == "s2d"
    x = images()
    if s2d:
        x = jfp.s2d_input_np(np.asarray(jfp.quantize_input(
            jnp.asarray(x), int(mj.sa["in"]))))
    want = jax.device_get(jim.make_int8_tiny_detect_fn(
        mj, cfg, input_s2d=s2d)(jnp.asarray(x)))
    got = tim.make_int8_tiny_detect_fn(mt, tcfg, input_s2d=s2d,
                                       device="cpu")(x)
    assert int(want[3].sum()) > 0
    for g, w in zip(got, want):
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g.numpy(), w, **TOL)
        else:
            np.testing.assert_array_equal(g.numpy(), w)


def test_per_channel_detections_on_the_cpu(runs):
    cfg, tcfg = cfgs()
    mj, mt = runs["per_channel"]["mj"], runs["per_channel"]["mt"]
    want = jax.device_get(jim.make_int8_tiny_detect_fn(mj, cfg)(
        jnp.asarray(images())))
    got = tim.make_int8_tiny_detect_fn(mt, tcfg, device="cpu")(images())
    np.testing.assert_array_equal(got[2].numpy(), want[2])
    np.testing.assert_array_equal(got[3].numpy(), want[3])
    np.testing.assert_allclose(got[0].numpy(), want[0], **TOL)


def test_makers_refuse(runs):
    """mesh; per-channel with input_s2d (forward too). A per-channel model
    is no longer refused on the card: every conv has a per-column route
    (conv_2 and conv_set_1 ran the mma.sync conv, which takes a scalar sw
    only), and the refusal that named them is gone."""
    _, tcfg = cfgs()
    mt, pc = runs["scalar"]["mt"], runs["per_channel"]["mt"]
    with pytest.raises(ValueError, match="mesh"):
        tim.make_int8_tiny_detect_fn(mt, tcfg, mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="plain conv path"):
        tim.make_int8_tiny_detect_fn(pc, tcfg, input_s2d=True, device="cpu")
    with pytest.raises(ValueError, match="plain conv path"):
        tim.int8_tiny_forward(pc, torch.zeros((1, 35, 35, 12), dtype=torch
                                              .int8), input_s2d=True)
    assert pc.per_channel
    assert all(pc.conv_route(n) is not None for n in pc.CONV_ORDER)
    assert not hasattr(tim, "_check_card_routes")


@pytest.mark.parametrize("key", ["scalar", "per_channel"])
def test_card_routes_and_packing(runs, key):
    """Per forward (scalar and per-channel sw): the entry conv, 7 wgmma
    3x3s, conv_set_1 on their two-part form, conv_2 with its pool on their
    pooled form, 3 wgmma 1x1s, none on the mma.sync conv; ``pack`` packs
    each routed conv once (K2's s2d form at a scalar sw) and, per-channel,
    each conv's shift tables (one per input scale of its parts, both
    roundings); the scales the forward passes are ``conv_sas``; a forward
    on the packed model equals the unpacked one."""
    from yolo_tpu_torch.kernels import int8_conv as K

    ref = runs[key]["mt"]
    mt = ref.to("cpu")
    routes = {n: mt.conv_route(n) for n in mt.CONV_ORDER}
    assert {r: list(routes.values()).count(r) for r in set(
        routes.values())} == TINY_ROUTES
    assert routes["conv_2"] == "pool" and routes["conv_set_1"] == "parts"
    K.reset_conv3x3_pack_count()
    K.reset_conv3x3_parts_pack_count()
    K.reset_pool_s2d_pack_count()
    K.reset_shift_table_count()
    mt.pack()
    assert K.conv3x3_pack_count() == 8 and K.conv3x3_parts_pack_count() == 1
    assert K.pool_s2d_pack_count() == (key == "scalar")
    assert sorted(mt.packed) == sorted(mt.CONV_ORDER)
    assert mt.packed["conv_set_1"].shape == (
        mt.w_q["conv_set_1"].shape[3], 9 * sum(mt.conv_cins("conv_set_1")))
    tables = {n: len(set(mt.conv_sas(n))) for n in mt.CONV_ORDER}
    if key == "per_channel":
        assert K.shift_table_count() == 2 * sum(tables.values())
        for rounding in ("nearest", "floor"):
            assert {n: len(t) for n, t in mt.shift_tables[rounding].items()
                    } == tables
    else:
        assert K.shift_table_count() == 0
    seen = {}
    real = mt.conv

    def spy(name, x, sa_in, rounding, leaky=True):
        seen[name] = (tuple(sa for _, sa in x) if isinstance(x, list)
                      else (sa_in,))
        return real(name, x, sa_in, rounding, leaky)

    x_q = tfp.quantize_input(torch.tensor(images(1)), mt.sa["in"])
    for s2d in ((False, True) if key == "scalar" else (False,)):
        x = tfp.s2d_input(x_q) if s2d else x_q
        mt.conv = spy
        try:
            got = tim.int8_tiny_forward(mt, x, input_s2d=s2d)
        finally:
            del mt.conv
        for a, b in zip(got, tim.int8_tiny_forward(ref, x, input_s2d=s2d)):
            assert torch.equal(a, b)
    assert all(seen[n] == mt.conv_sas(n) for n in seen)
    assert sorted(seen) == sorted(set(mt.CONV_ORDER) - {"conv_2"})


@pytest.mark.parametrize("equal", [True, False])
def test_two_part_conv_matches_jax(rng, equal):
    """conv_set_1's form, a 3x3 over a two-part concat [256, 128], at
    equal part scales (the raw partials summed before the shift) and
    unequal ones, both roundings, a slope of 0.125."""
    x1 = rng.integers(-128, 128, (1, 4, 4, 256), dtype=np.int8)
    x2 = rng.integers(-128, 128, (1, 4, 4, 128), dtype=np.int8)
    w = rng.integers(-60, 60, (3, 3, 384, 32), dtype=np.int8)
    b = rng.integers(-100, 100, (32,)).astype(np.int32)
    sa2 = 4 if equal else 2
    for rounding in ("nearest", "floor"):
        kw = dict(sw=7, sb=6, sa_out=3, retune=9, padding=1, leaky=True,
                  rounding=rounding, sa_in=None)
        want = jfp.int_conv_requant(
            [(jnp.asarray(x1), 4), (jnp.asarray(x2), sa2)], jnp.asarray(w),
            jnp.asarray(b), **kw)
        got = tfp.int_conv_requant(
            [(torch.tensor(x1), 4), (torch.tensor(x2), sa2)],
            torch.tensor(w), torch.tensor(b), **kw)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
