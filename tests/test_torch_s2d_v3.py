"""yolo_v3's space-to-depth execution forms, ``input_s2d``, the ``limit``
hook and yolo_v3_spp in the port, against the JAX package on the CPU.

- ``int8_conv_stride2_s2d``, ``s2d_entry_from_input`` and its inverse,
  ``int8_entry_pair_s2d`` (both ``pre_s2d`` modes, leaky pairs),
  ``int_maxpool`` and ``int_spp`` on numpy-seeded int8 inputs, both
  roundings: ``np.array_equal``.
- The whole integer forward at 64² on the JAX ``quantize_pipeline_yolo_v3``
  model of ``seeded_fused_params(0, 21)`` (``fold_bn=False``), for
  ``s2d`` in {False, "entry", "stride2", True} and for ``input_s2d``,
  each against the JAX forward in the same mode; ``limit`` at cut points
  inside a residual block, at the entry pair (where the JAX package's
  fused pair ignores it) and after a concat, list for list.
- yolo_v3_spp: its program, the port's float YOLOv3SPP taps in the JAX
  forward's order, its PTQ tables equal to the JAX package's on the same
  floats, its integer forward and its detections.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import yolo_tpu.quant.int8_yolo_v3 as jv3
from yolo_tpu.config import get_config
from yolo_tpu.models import yolo_v3_spp as jspp
from yolo_tpu.ops import blocks as jblocks
from yolo_tpu.quant import fixed_point as jfp
from yolo_tpu_torch.config import get_config as t_get_config
from yolo_tpu_torch.ops import blocks
from yolo_tpu_torch.quant import convert as C
from yolo_tpu_torch.quant import fixed_point as tfp
from yolo_tpu_torch.quant import int8_yolo_v3 as tv3

torch.set_num_threads(1)

SIZE, PRED_OUT = 64, 21
ROUNDINGS = ["nearest", "floor"]
TOL = dict(atol=1e-5, rtol=1e-5)


def _i8(rng, shape):
    return rng.integers(-128, 128, shape).astype(np.int8)


def _j(x):
    return jnp.asarray(x)


def _t(x):
    return torch.tensor(np.asarray(x))


def _calib():
    return [np.random.default_rng(1).random((2, SIZE, SIZE, 3),
                                            dtype=np.float32)]


def _build(spp: bool):
    """(JAX Int8YoloV3, the port's from its numpy arrays, the fused tree,
    int8 input [1, 64, 64, 3])."""
    name = "yolo_v3_spp" if spp else "yolo_v3"
    cfg = get_config(name, "mask", input_size=(SIZE, SIZE))
    tree = tv3.seeded_fused_params(0, PRED_OUT, spp=spp)
    m = jv3.quantize_pipeline_yolo_v3(
        jax.tree_util.tree_map(jnp.asarray, tree), cfg, _calib(), spp=spp,
        fold_bn=False)
    mn = jax.device_get(m)
    tm = C.int8_yolo_v3_from_numpy(mn.w_q, mn.b_q, mn.sw, mn.sb, mn.sa_in,
                                   mn.tap_sa, mn.retune, spp=spp,
                                   device="cpu")
    x_q = np.asarray(jfp.quantize_input(_j(_calib()[0][:1]), m.sa_in))
    return m, tm, tree, x_q


@pytest.fixture(scope="module")
def v3():
    return _build(spp=False)


@pytest.fixture(scope="module")
def spp():
    return _build(spp=True)


def _assert_list_equal(want, got):
    assert len(want) == len(got)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ---------------------------------------------------------------------------
# The ops.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rounding", ROUNDINGS)
@pytest.mark.parametrize("leaky", [True, 0.1, False])
def test_int8_conv_stride2_s2d_matches_jax(rng, rounding, leaky):
    x = _i8(rng, (2, 10, 14, 32))
    w = _i8(rng, (3, 3, 32, 24))
    b = rng.integers(-128, 128, (24,)).astype(np.int32)
    kw = dict(sw=-8, sb=-6, sa_in=4, sa_out=3, retune=9, leaky=leaky,
              rounding=rounding)
    want = jfp.int8_conv_stride2_s2d(_j(x), _j(w), _j(b), **kw)
    got = tfp.int8_conv_stride2_s2d(_t(x), _t(w), _t(b), **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # and the plain stride-2 conv it re-executes
    plain = tfp.int_conv_requant(_t(x), _t(w), _t(b), padding=1, stride=2,
                                 **kw)
    assert torch.equal(got, plain)


@pytest.mark.parametrize("shape", [(2, 12, 18, 3), (1, 6, 4, 32)])
def test_s2d_entry_layouts(rng, shape):
    """The serving layout's slice is the JAX package's, the JAX package's
    odd-aligned blocks of the padded input, and ``nhwc_from_entry_blocks``
    inverts it exactly."""
    x = _i8(rng, shape)
    x2 = tfp.s2d_input(_t(x))
    got = tfp.s2d_entry_from_input(x2)
    want = jfp.s2d_entry_from_input(jfp.s2d_input(_j(x)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    pad1 = jnp.pad(_j(x), ((0, 0), (1, 1), (1, 1), (0, 0)))
    blocks = jfp._s2d_blocks(pad1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(blocks))
    assert torch.equal(tfp.nhwc_from_entry_blocks(got), _t(x))
    assert torch.equal(tfp.nhwc_from_entry_blocks(got.contiguous()), _t(x))


@pytest.mark.parametrize("rounding", ROUNDINGS)
@pytest.mark.parametrize("pre_s2d", [False, True])
@pytest.mark.parametrize("leaky", [(True, True), (0.1, 0.1), (0.1, False)])
def test_int8_entry_pair_s2d_matches_jax(rng, rounding, pre_s2d, leaky):
    x = _i8(rng, (2, 12, 10, 3))
    w1, w2 = _i8(rng, (3, 3, 3, 32)), _i8(rng, (3, 3, 32, 16))
    b1 = rng.integers(-128, 128, (32,)).astype(np.int32)
    b2 = rng.integers(-128, 128, (16,)).astype(np.int32)
    p1 = dict(sw=-8, sb=-6, sa_in=5, sa_out=2, retune=9)
    p2 = dict(sw=-7, sb=-6, sa_in=2, sa_out=3, retune=8)
    xj, xt = _j(x), _t(x)
    if pre_s2d:
        xj = jfp.s2d_entry_from_input(jfp.s2d_input(xj))
        xt = tfp.s2d_entry_from_input(tfp.s2d_input(xt))
    kw = dict(rounding=rounding, pre_s2d=pre_s2d, leaky=leaky)
    want = jfp.int8_entry_pair_s2d(xj, _j(w1), _j(b1), p1, _j(w2), _j(b2),
                                   p2, **kw)
    got = tfp.int8_entry_pair_s2d(xt, _t(w1), _t(b1), p1, _t(w2), _t(b2),
                                  p2, **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the sequential pair of plain convs it re-executes
    y = tfp.int_conv_requant(_t(x), _t(w1), _t(b1), padding=1,
                             leaky=leaky[0], rounding=rounding, **p1)
    assert torch.equal(got, tfp.int_conv_requant(
        y, _t(w2), _t(b2), padding=1, stride=2, leaky=leaky[1],
        rounding=rounding, **p2))


@pytest.mark.parametrize("args", [(2, 2, 0), (3, 1, 1), (5, 1, 2),
                                  (9, 1, 4), (13, 1, 6), (3, 2, 1)])
def test_int_maxpool_matches_jax(rng, args):
    x = _i8(rng, (2, 13, 11, 8))
    x[0, :4, :4] = -128  # windows whose max is INT8_MIN
    np.testing.assert_array_equal(tfp.int_maxpool(_t(x), *args).numpy(),
                                  np.asarray(jfp.int_maxpool(_j(x), *args)))


def test_int_spp_matches_jax(rng):
    x = _i8(rng, (2, 13, 13, 16))
    got = tfp.int_spp(_t(x))
    assert got.shape == (2, 13, 13, 64) and got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jfp.int_spp(_j(x))))


def test_s2d_forms_refuse_a_device_without_a_route(rng):
    """No form drops to the CPU for a tensor elsewhere: a device no kernel
    route takes raises (the card raises for shapes none takes)."""
    x = torch.empty((1, 8, 8, 32), dtype=torch.int8, device="meta")
    w = torch.zeros((3, 3, 32, 16), dtype=torch.int8)
    b = torch.zeros(16, dtype=torch.int32)
    p = dict(sw=-8, sb=-6, sa_in=4, sa_out=3, retune=9)
    with pytest.raises(ValueError, match="meta"):
        tfp.int8_conv_stride2_s2d(x, w, b, **p)
    with pytest.raises(ValueError, match="meta"):
        tfp.int8_entry_pair_s2d(x, w, b, p, w, b, p)


# ---------------------------------------------------------------------------
# The forward.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s2d", [False, "entry", "stride2", True])
def test_forward_matches_jax(v3, s2d):
    m, tm, _, x_q = v3
    want = jv3.int8_yolo_v3_forward(m, _j(x_q), "nearest", s2d=s2d)
    got = tv3.int8_yolo_v3_forward(tm, _t(x_q), "nearest", s2d=s2d)
    _assert_list_equal(want, got)


def test_forward_floor_matches_jax_up_to_the_upsample(v3):
    """Floor rounding, every s2d form (s2d=True): the live tensors just
    before the first ``up`` (the whole backbone and the coarse head's
    convs) bit-exact. Past it the JAX package's own floor-mode results
    depend on how XLA's CPU dot sums the two interpolation products (with
    or without a fused multiply-add, by shape; its jit and eager runs
    differ at 2x2), so a value the float interpolation leaves one ulp
    below an integer floors one level lower there (ROADMAP.md, Queue 3)."""
    m, tm, _, x_q = v3
    up = tv3._program().index(("up",))
    want = jv3.int8_yolo_v3_forward(m, _j(x_q), "floor", s2d=True, limit=up)
    got = tv3.int8_yolo_v3_forward(tm, _t(x_q), "floor", s2d=True, limit=up)
    assert len(got) == 5  # conv_1x1_3's output and the four slots
    _assert_list_equal(want, got)


def test_forward_input_s2d_matches_jax(v3):
    m, tm, _, x_q = v3
    want = jv3.int8_yolo_v3_forward(m, jfp.s2d_input(_j(x_q)), "nearest",
                                    input_s2d=True)
    got = tv3.int8_yolo_v3_forward(tm, tfp.s2d_input(_t(x_q)), "nearest",
                                   input_s2d=True)
    _assert_list_equal(want, got)


# program ops of yolo_v3: 0-1 the entry pair, 2-5 the first residual
# block (push, 1x1, 3x3, res), 109 the c4 concat
@pytest.mark.parametrize("limit,s2d", [
    (1, False), (1, "entry"), (2, "entry"), (3, False), (4, False),
    (5, "entry"), (6, False), (110, False)])
def test_limit_matches_jax(v3, limit, s2d):
    """The live int8 tensors after ``limit`` ops, list for list: at 1 the
    JAX fused pair runs both convs (conv2's output) under s2d="entry" and
    conv1 alone under s2d=False; 3-5 cut the first residual block (its
    input on the stack, then conv1, then conv2 unfolded); 110 holds the
    c4 concat's two parts."""
    m, tm, _, x_q = v3
    assert tv3._program()[109] == ("concat", "c4")
    want = jv3.int8_yolo_v3_forward(m, _j(x_q), s2d=s2d, limit=limit)
    got = tv3.int8_yolo_v3_forward(tm, _t(x_q), s2d=s2d, limit=limit)
    _assert_list_equal(want, got)
    if limit == 1:
        assert got[0].shape[-1] == (64 if s2d else 32)


def test_detect_fn_input_s2d_matches_jax(v3):
    """The detect fn on the s2d serving layout (int8, and float32 laid out
    on the device) against the JAX package's: classes and valid exact,
    boxes and scores allclose; the same as on NHWC input."""
    m, tm, _, x_q = v3
    cfg = get_config("yolo_v3", "mask", input_size=(SIZE, SIZE))
    tcfg = t_get_config("yolo_v3", "mask", input_size=(SIZE, SIZE))
    x2 = np.asarray(jfp.s2d_input(_j(x_q)))
    want = [np.asarray(a) for a in jv3.make_int8_yolo_v3_detect_fn(
        m, cfg, input_s2d=True)(_j(x2))]
    detect = tv3.make_int8_yolo_v3_detect_fn(tm, tcfg, input_s2d=True,
                                             device="cpu")
    nhwc = tv3.make_int8_yolo_v3_detect_fn(tm, tcfg, device="cpu")
    for got in (detect(x2), detect(_calib()[0][:1]), nhwc(x_q)):
        for g, w in zip(got, want):
            if w.dtype.kind == "f":
                np.testing.assert_allclose(g.numpy(), w, **TOL)
            else:
                np.testing.assert_array_equal(g.numpy(), w)
    with pytest.raises(ValueError, match="s2d"):
        detect(x_q)  # NHWC int8 where the s2d layout is expected


def test_per_channel_runs_the_plain_walk(v3, monkeypatch):
    """A per-channel sw takes the plain walk whatever ``s2d`` says (the
    block forms phase-pack C_out), and refuses ``input_s2d``, in the
    forward and in the detect fn."""
    _, tm, _, x_q = v3
    pc = tv3.Int8YoloV3(**{**vars(tm), "sw": [
        np.full(w.shape[-1], s, np.int32) for w, s in zip(tm.w_q, tm.sw)]})
    assert pc.per_channel

    def refuse(*a, **k):
        raise AssertionError("the entry pair ran with a per-channel sw")

    monkeypatch.setattr(tfp, "int8_entry_pair_s2d", refuse)
    monkeypatch.setattr(tfp, "int8_conv_stride2_s2d", refuse)
    got = tv3.int8_yolo_v3_forward(pc, _t(x_q), s2d=True)
    monkeypatch.undo()
    _assert_list_equal(tv3.int8_yolo_v3_forward(tm, _t(x_q), s2d=False),
                       got)
    cfg = t_get_config("yolo_v3", "mask", input_size=(SIZE, SIZE))
    with pytest.raises(ValueError, match="per-channel"):
        tv3.int8_yolo_v3_forward(pc, tfp.s2d_input(_t(x_q)), input_s2d=True)
    with pytest.raises(ValueError, match="per-channel"):
        tv3.make_int8_yolo_v3_detect_fn(pc, cfg, input_s2d=True,
                                        device="cpu")


def test_input_s2d_needs_the_entry_pair(v3):
    _, tm, _, x_q = v3
    prog = list(tm.program)
    prog[1] = ("conv", prog[1][1], 1, 1, prog[1][4])  # no stride-2 conv2
    bad = tv3.Int8YoloV3(**{**vars(tm), "program": prog})
    with pytest.raises(ValueError, match="entry pair"):
        tv3.int8_yolo_v3_forward(bad, tfp.s2d_input(_t(x_q)),
                                 input_s2d=True)


# ---------------------------------------------------------------------------
# yolo_v3_spp.
# ---------------------------------------------------------------------------


def test_spp_program_and_taps_match_the_jax_forward():
    """The spp program is the JAX package's; the port's float YOLOv3SPP
    fires its taps in the JAX yolo_v3_spp forward's order (98: the SPP
    block has none), and its heads have the v3 shapes."""
    from yolo_tpu_torch.models.yolo_v3_spp import YOLOv3SPP

    assert tv3._program(spp=True) == jv3._program(spp=True)
    cfg = get_config("yolo_v3_spp", "mask", input_size=(SIZE, SIZE))

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
            return jspp.forward(p, x, cfg)

    shapes = jax.eval_shape(lambda: jspp.init_params(
        jax.random.PRNGKey(0), cfg, batch_norm=True))
    jax.eval_shape(forward, shapes,
                   jax.ShapeDtypeStruct((1, SIZE, SIZE, 3), jnp.float32))
    model = YOLOv3SPP(PRED_OUT, batch_norm=False, device="cpu",
                      generator=torch.Generator().manual_seed(0))
    with torch.no_grad(), blocks.quantization_context(port):
        outs = model(torch.rand(1, SIZE, SIZE, 3))
    assert port.kinds == rec.kinds and len(rec.kinds) == 98
    program = [op[0] for op in tv3._program(spp=True)
               if op[0] in ("conv", "res")]
    assert port.kinds == program
    assert [tuple(o.shape) for o in outs] == [
        (1, SIZE // s, SIZE // s, PRED_OUT) for s in (8, 16, 32)]


def test_spp_float_forward_matches_jax(spp):
    _, _, tree, _ = spp
    cfg = get_config("yolo_v3_spp", "mask", input_size=(SIZE, SIZE))
    x = _calib()[0][:1]
    want = jax.jit(lambda p, x: jspp.forward(p, x, cfg))(
        jax.tree_util.tree_map(jnp.asarray, tree), x)
    with torch.no_grad():
        got = C.yolo_v3_from_params(tree, device="cpu")(torch.as_tensor(x))
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-5 * np.abs(w).max())


def test_spp_pipeline_tables_equal(spp):
    """The port's ``quantize_pipeline_yolo_v3(spp=True)`` on the floats the
    JAX pipeline quantized (fused, ``fold_bn=False``: no fold, so no
    own-fold rounding tie can move a level): every int8 tensor and table
    equal."""
    m, _, tree, _ = spp
    mj = jax.device_get(m)
    model = C.yolo_v3_from_params(tree, device="cpu")
    assert type(model).__name__ == "YOLOv3SPP"
    mt = tv3.quantize_pipeline_yolo_v3(
        model, t_get_config("yolo_v3_spp", "mask", input_size=(SIZE, SIZE)),
        _calib(), spp=True, fold_bn=False)
    assert mt.spp and mt.sa_in == mj.sa_in
    for field in ("tap_sa", "retune", "sb", "sw"):
        assert list(getattr(mt, field)) == [int(v) for v in
                                            getattr(mj, field)], field
    for i in range(75):
        np.testing.assert_array_equal(mt.w_q[i].numpy(), mj.w_q[i])
        np.testing.assert_array_equal(mt.b_q[i].numpy(), mj.b_q[i])


@pytest.mark.parametrize("s2d", [False, "entry"])
def test_spp_forward_matches_jax(spp, s2d):
    m, tm, _, x_q = spp
    want = jv3.int8_yolo_v3_forward(m, _j(x_q), s2d=s2d)
    got = tv3.int8_yolo_v3_forward(tm, _t(x_q), s2d=s2d)
    _assert_list_equal(want, got)
    # the spp op's output: the live tensors just after it
    at = tv3._program(spp=True).index(("spp",)) + 1
    want = jv3.int8_yolo_v3_forward(m, _j(x_q), s2d=s2d, limit=at)
    got = tv3.int8_yolo_v3_forward(tm, _t(x_q), s2d=s2d, limit=at)
    assert got[0].shape[-1] == 4096
    _assert_list_equal(want, got)


def test_spp_detect_fn_matches_jax(spp):
    m, tm, _, x_q = spp
    cfg = get_config("yolo_v3_spp", "mask", input_size=(SIZE, SIZE))
    tcfg = t_get_config("yolo_v3_spp", "mask", input_size=(SIZE, SIZE))
    x2 = np.asarray(jfp.s2d_input(_j(x_q)))
    want = [np.asarray(a) for a in jv3.make_int8_yolo_v3_detect_fn(
        m, cfg, input_s2d=True)(_j(x2))]
    got = tv3.make_int8_yolo_v3_detect_fn(tm, tcfg, input_s2d=True,
                                          device="cpu")(x2)
    for g, w in zip(got, want):
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g.numpy(), w, **TOL)
        else:
            np.testing.assert_array_equal(g.numpy(), w)
