"""The port's yolo_v2 (the darknet19 backbone, ``reorg``, the float
model, its PTQ pipeline, integer engine and detect fn) against the JAX
package, on the CPU at 64², mask config (C6 2x2, the passthrough 4x4 ->
2x2).

Weights: ``convert.yolo_v2_seeded_fused_params(0, 35)`` (BN-fused), and for
per-channel sw the same with each output channel scaled by 2^-u, u drawn
from {0, 1, 2, 3} (so that a per-channel sw holds several values); the
float forward also in the BN form, with random BN stats. Both pipelines
take the same fused floats (``fold_bn=False``), so no BN fold is
involved, and the JAX integer model is carried over
(``int8_yolo_v2_from_numpy``) for the forwards.

Held exactly: ``reorg``, the PTQ tables and int8 weights, the int8 head
(scalar and per-channel sw, NHWC and s2d input, both roundings: yolo_v2
has no upsample), detected classes and valid slots. Boxes and scores
within atol = rtol = 1e-5, the float head within 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import yolo_tpu.quant.int8_models as jim
from yolo_tpu.config import get_config
from yolo_tpu.models import yolo_v2 as jv2
from yolo_tpu.ops import blocks as jblocks
from yolo_tpu.quant import fixed_point as jfp
from yolo_tpu_torch.config import get_config as t_get_config
from yolo_tpu_torch.models.yolo_v2 import YOLOv2
from yolo_tpu_torch.ops import blocks
from yolo_tpu_torch.quant import convert as C
from yolo_tpu_torch.quant import fixed_point as tfp
from yolo_tpu_torch.quant import int8_models as tim
from yolo_tpu_torch.quant.generic import tap_count

torch.set_num_threads(1)

SIZE, PRED_OUT = 64, 35
TOL = dict(atol=1e-5, rtol=1e-5)
# the per-forward launches on the card, by route (scalar and per-channel
# sw): the entry conv, the one-part wgmma 3x3s, convsets_2.0 on their
# two-part form, the 1x1s
V2_ROUTES = {"entry": 1, "conv3x3": 13, "parts": 1, "conv1x1": 8}


def cfgs():
    return (get_config("yolo_v2", "mask", input_size=(SIZE, SIZE)),
            t_get_config("yolo_v2", "mask", input_size=(SIZE, SIZE)))


def images(n=2, seed=1):
    return np.random.default_rng(seed).random((n, SIZE, SIZE, 3),
                                              dtype=np.float32)


def per_channel_params(seed=3):
    """The seeded fused tree with each conv's output channels scaled by
    2^-u, u in {0, 1, 2, 3}."""
    rng = np.random.default_rng(seed)
    tree = C.yolo_v2_seeded_fused_params(0, PRED_OUT)
    for layer in tim.flat_v2_params(tree).values():
        u = rng.integers(0, 4, layer["w"].shape[-1])
        layer["w"] *= np.exp2(-u).astype(np.float32)
    return tree


def bn_form(tree, seed=7):
    """The tree with every conv but the preds in the BN form, its stats
    random (as the JAX package's quantization tests draw them)."""
    rng = np.random.default_rng(seed)
    flat = tim.flat_v2_params(tree)
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
    """{'scalar' | 'per_channel': dict(params, mj (the JAX Int8YoloV2 as
    numpy), mt (the port's model of the JAX one's fields), pt (the port's
    model of the same floats))}. 'scalar': both whole pipelines;
    'per_channel': both packages' ``quantize_yolo_v2`` on the per-channel
    floats with the JAX scalar pipeline's calibration (the per-channel
    pipeline itself is held in ``tests/test_torch_tiny_yolo_v3.py``)."""
    cfg, tcfg = cfgs()
    seen = {}
    real = jim.quantize_yolo_v2

    def spy(fused, states, agg, **kw):
        seen.update(states=jax.device_get(states), maxima=list(agg))
        return real(fused, states, agg, **kw)

    params = C.yolo_v2_seeded_fused_params(0, PRED_OUT)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jim, "quantize_yolo_v2", spy)
        mj = jax.device_get(jim.quantize_pipeline_yolo_v2(
            jtree(params), cfg, [images()], fold_bn=False))
    pt = tim.quantize_pipeline_yolo_v2(
        C.yolo_v2_from_params(params, device="cpu"), tcfg, [images()],
        fold_bn=False)
    pc_params = per_channel_params()
    mj_pc = jax.device_get(real(jtree(pc_params), seen["states"],
                                seen["maxima"], per_channel=True))
    states = [{k: torch.as_tensor(np.array(v)) for k, v in st.items()}
              for st in seen["states"]]
    pt_pc = tim.quantize_yolo_v2(C.yolo_v2_from_params(pc_params,
                                                       device="cpu"),
                                 states, seen["maxima"], per_channel=True)
    out = {}
    for key, p, m, own in (("scalar", params, mj, pt),
                           ("per_channel", pc_params, mj_pc, pt_pc)):
        out[key] = dict(params=p, mj=m, pt=own, mt=C.int8_yolo_v2_from_numpy(
            m.w_q, m.b_q, m.sw, m.sb, m.sa, m.retune, device="cpu"))
    return out


@pytest.mark.parametrize("dtype", [np.float32, np.int8])
def test_reorg_matches_jax(rng, dtype):
    """Asymmetric data (every value distinct in float): channel blocks in
    (row, col) window order, each holding the original channels; NHWC and
    the float model's NCHW form."""
    if dtype == np.int8:
        x = rng.integers(-128, 128, (2, 6, 4, 5), dtype=np.int8)
    else:
        x = rng.permutation(2 * 6 * 4 * 5).astype(np.float32).reshape(
            2, 6, 4, 5)
    want = np.asarray(jblocks.reorg(jnp.asarray(x), 2))
    assert want.shape == (2, 3, 2, 20)
    np.testing.assert_array_equal(blocks.reorg(torch.tensor(x), 2).numpy(),
                                  want)
    nchw = blocks.reorg(torch.tensor(x).permute(0, 3, 1, 2), 2, nchw=True)
    np.testing.assert_array_equal(nchw.permute(0, 2, 3, 1).numpy(), want)
    # block (row 1, col 0) of output pixel (0, 0) is input pixel (1, 0)
    np.testing.assert_array_equal(want[:, 0, 0, 10:15], x[:, 1, 0, :])


def test_float_forward_matches_jax():
    """The BN-form float model (random BN stats) against the JAX forward
    (the fused form's floats meet the JAX ones in the PTQ tests)."""
    cfg, _ = cfgs()
    x = images()
    tree = bn_form(C.yolo_v2_seeded_fused_params(0, PRED_OUT))
    want = jax.jit(lambda p, x: jv2.forward(p, x, cfg))(jtree(tree),
                                                       jnp.asarray(x))
    model = C.yolo_v2_from_params(tree, device="cpu")
    assert model.route_layer.bn is not None and model.pred.bn is None
    with torch.no_grad():
        got = model(torch.tensor(x))
    assert len(got) == 1
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-4, atol=1e-5)


def test_module_tree_round_trip():
    tree = C.yolo_v2_seeded_fused_params(0, PRED_OUT)
    back = C.module_to_params(C.yolo_v2_from_params(tree, device="cpu"))
    for name, layer in tim.flat_v2_params(tree).items():
        got = tim.flat_v2_params(back)[name]
        np.testing.assert_array_equal(got["w"], layer["w"])
        np.testing.assert_array_equal(got["b"], layer["b"])


def test_taps_fire_in_conv_call_order():
    """One tap per conv (the input's first), in V2_CONV_ORDER: each tap's
    activation has its conv's output channels."""
    model = YOLOv2(PRED_OUT, batch_norm=False, device="cpu",
                       generator=torch.Generator().manual_seed(0))
    seen = []

    def tap(act):
        seen.append(act.shape[1])
        return act

    with torch.no_grad(), blocks.quantization_context(tap):
        model(torch.rand(1, SIZE, SIZE, 3))
    flat = tim.flat_v2_params(C.module_to_params(model))
    want = [flat[n]["w"].shape[-1] for n in tim.V2_CONV_ORDER]
    assert seen == want and tap_count(model) == 1 + len(want)


@pytest.mark.parametrize("key", ["scalar", "per_channel"])
def test_ptq_tables_equal_jax(runs, key):
    """The port's model of the same fused floats: every sa, sw, sb,
    retune and int8 weight of the JAX package's."""
    r = runs[key]
    mj, pt = r["mj"], r["pt"]
    assert pt.per_channel == (key == "per_channel")
    if key == "per_channel":
        assert len(np.unique(np.asarray(pt.sw["conv_5.0"]))) > 1
    assert pt.sa == {k: int(v) for k, v in mj.sa.items()}
    assert pt.retune == {k: int(v) for k, v in mj.retune.items()}
    assert pt.sb == {k: int(v) for k, v in mj.sb.items()}
    for name in tim.V2_CONV_ORDER:
        np.testing.assert_array_equal(np.asarray(pt.sw[name]),
                                      np.asarray(mj.sw[name]))
        np.testing.assert_array_equal(pt.w_q[name].numpy(), mj.w_q[name])
        np.testing.assert_array_equal(pt.b_q[name].numpy(), mj.b_q[name])


def jax_heads(mj, x_q, rounding, input_s2d):
    heads = jim.int8_yolo_v2_forward(mj, jnp.asarray(x_q), rounding,
                                     input_s2d=input_s2d)
    return [np.asarray(h) for h in heads]


CASES = [("scalar", "nhwc", "nearest"), ("scalar", "s2d", "nearest"),
         ("per_channel", "nhwc", "nearest"), ("scalar", "nhwc", "floor"),
         ("scalar", "s2d", "floor"), ("per_channel", "nhwc", "floor")]


@pytest.mark.parametrize("key,layout,rounding", CASES)
def test_int8_head_bit_exact(runs, key, layout, rounding):
    """The port's forward on the JAX model's integers: the head equal."""
    r = runs[key]
    mj, mt = r["mj"], r["mt"]
    x_q = np.asarray(jfp.quantize_input(jnp.asarray(images()),
                                        int(mj.sa["in"])))
    if layout == "s2d":
        x_q = jfp.s2d_input_np(x_q)
    want = jax_heads(mj, x_q, rounding, layout == "s2d")
    got = tim.int8_yolo_v2_forward(mt, torch.tensor(x_q), rounding,
                                   input_s2d=layout == "s2d")
    assert len(got) == len(want) == 1
    np.testing.assert_array_equal(got[0].numpy(), want[0])


def jax_detections(heads, cfg):
    """The JAX package's decode and NMS (``detector.predict``,
    ``nms.batched_postprocess``) of given heads, jitted over the heads: the
    JAX detect fn's tail without its 23 convs' constants to compile."""
    from yolo_tpu import detector as D
    from yolo_tpu.ops import nms as jnms

    class Heads:
        STRIDES = (32,)

        @staticmethod
        def forward(p, x, cfg, train=False):
            return p

    def tail(hs):
        boxes, probs = D.predict(Heads, hs, None, cfg)
        return jnms.batched_postprocess(boxes, probs, cfg.conf_thresh,
                                        cfg.nms_thresh, cfg.pre_nms_top_k,
                                        cfg.top_k)

    return jax.device_get(jax.jit(tail)([jnp.asarray(h) for h in heads]))


@pytest.mark.parametrize("key,layout", [("scalar", "nhwc"),
                                        ("scalar", "s2d"),
                                        ("per_channel", "nhwc")])
def test_detections_equal_jax(runs, key, layout):
    """The port's detect fn (float images; with s2d, int8 input in the s2d
    layout) against the JAX package's decode and NMS of the JAX head:
    classes and valid exact, boxes and scores within 1e-5."""
    cfg, tcfg = cfgs()
    mj, mt = runs[key]["mj"], runs[key]["mt"]
    s2d = layout == "s2d"
    x_q = np.asarray(jfp.quantize_input(jnp.asarray(images()),
                                        int(mj.sa["in"])))
    x = jfp.s2d_input_np(x_q) if s2d else images()
    want = jax_detections(jax_heads(mj, x_q, "nearest", False), cfg)
    got = tim.make_int8_yolo_v2_detect_fn(mt, tcfg, input_s2d=s2d,
                                          device="cpu")(x)
    assert int(want[3].sum()) > 0
    for g, w in zip(got, want):
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g.numpy(), w, **TOL)
        else:
            np.testing.assert_array_equal(g.numpy(), w)


def test_makers_refuse(runs):
    """mesh; per-channel with input_s2d (forward too). A per-channel model
    is no longer refused on the card: every conv has a per-column route
    (convsets_2.0 ran the mma.sync conv, which takes a scalar sw only),
    and the refusal that named it is gone."""
    _, tcfg = cfgs()
    mt, pc = runs["scalar"]["mt"], runs["per_channel"]["mt"]
    with pytest.raises(ValueError, match="mesh"):
        tim.make_int8_yolo_v2_detect_fn(mt, tcfg, mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="plain conv path"):
        tim.make_int8_yolo_v2_detect_fn(pc, tcfg, input_s2d=True, device="cpu")
    with pytest.raises(ValueError, match="plain conv path"):
        tim.int8_yolo_v2_forward(pc, torch.zeros((1, 35, 35, 12), dtype=torch
                                              .int8), input_s2d=True)
    assert pc.per_channel
    assert all(pc.conv_route(n) is not None for n in pc.CONV_ORDER)
    assert not hasattr(tim, "_check_card_routes")


@pytest.mark.parametrize("key", ["scalar", "per_channel"])
def test_card_routes_and_packing(runs, key):
    """Per forward (scalar and per-channel sw): the entry conv, 13 wgmma
    3x3s, convsets_2.0 on their two-part form, 8 wgmma 1x1s, none on the
    mma.sync conv; ``pack`` packs each routed conv once (K2's s2d form at
    a scalar sw) and, per-channel, each conv's shift tables (one per input
    scale of its parts, both roundings); the scales the forward passes
    are ``conv_sas``; a forward on the packed model equals the unpacked
    one."""
    from yolo_tpu_torch.kernels import int8_conv as K

    ref = runs[key]["mt"]
    mt = ref.to("cpu")
    routes = {n: mt.conv_route(n) for n in mt.CONV_ORDER}
    assert {r: list(routes.values()).count(r) for r in set(
        routes.values())} == V2_ROUTES
    assert routes["convsets_2.0"] == "parts"
    K.reset_conv3x3_pack_count()
    K.reset_conv3x3_parts_pack_count()
    K.reset_pool_s2d_pack_count()
    K.reset_shift_table_count()
    mt.pack()
    assert K.conv3x3_pack_count() == 13
    assert K.conv3x3_parts_pack_count() == 1
    assert K.pool_s2d_pack_count() == (key == "scalar")
    assert sorted(mt.packed) == sorted(mt.CONV_ORDER)
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
            got = tim.int8_yolo_v2_forward(mt, x, input_s2d=s2d)
        finally:
            del mt.conv
        for a, b in zip(got, tim.int8_yolo_v2_forward(ref, x,
                                                      input_s2d=s2d)):
            assert torch.equal(a, b)
    assert sorted(seen) == sorted(mt.CONV_ORDER)
    assert all(seen[n] == mt.conv_sas(n) for n in seen)


@pytest.mark.parametrize("equal", [True, False])
def test_two_part_conv_matches_jax(rng, equal):
    """convsets_2.0's form, a 3x3 over a two-part concat [256, 1024], at
    equal part scales (the raw partials summed before the shift) and
    unequal ones, both roundings, a slope of 0.125."""
    x1 = rng.integers(-128, 128, (1, 3, 3, 256), dtype=np.int8)
    x2 = rng.integers(-128, 128, (1, 3, 3, 1024), dtype=np.int8)
    w = rng.integers(-60, 60, (3, 3, 1280, 16), dtype=np.int8)
    b = rng.integers(-100, 100, (16,)).astype(np.int32)
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
