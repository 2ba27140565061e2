"""slim_yolo_v2 INT8 with per-output-channel weight scales in the port,
against the JAX package at 32²: ``int8_forward``, the detect fn and
``int8_forward_diagnostics`` (head bit-exact, every layer's count equal;
detections with classes / valid exact and boxes / scores allclose, atol =
rtol = 1e-5: float32 sigmoid, exp and softmax in another framework), the
plain wrappers with a per-channel sw, and the per-column shift tables the
kernels read. The model is the ``tests/test_kernels.py`` recipe (random
init from PRNGKey(1), batch norm folded) with each output channel's
weights scaled by 2^-u, u in {0, 1, 2, 3}, so that every layer's sw holds
at least 3 distinct values, quantized by ``quantize_pipeline(...,
per_channel=True)``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolo_tpu.config import get_config
from yolo_tpu.models import slim_yolo_v2
from yolo_tpu.quant import fixed_point as fp
from yolo_tpu.quant.bn_fold import fold_batch_norm
from yolo_tpu.quant.int8_graph import make_int8_detect_fn, quantize_pipeline
from yolo_tpu_torch.config import get_config as t_get_config
from yolo_tpu_torch.kernels import int8_conv as K
from yolo_tpu_torch.quant import fixed_point as tfp
from yolo_tpu_torch.quant.convert import int8_model_from_numpy
from yolo_tpu_torch.quant.int8_graph import (
    make_int8_detect_fn as t_make_int8_detect_fn)
from yolo_tpu_torch.quant.qsim import QUANT_LAYER_NAMES

torch.set_num_threads(1)

SIZE = 32
ROUNDINGS = ["nearest", "floor"]
TOL = dict(atol=1e-5, rtol=1e-5)
# the overflow variant raises every layer's retune by this
RAISED_BY = 7


@pytest.fixture(scope="module")
def models():
    """(JAX Int8Model, port Int8Model on the CPU, float images)."""
    rng = np.random.default_rng(0)
    cfg = get_config("slim_yolo_v2", "mask", input_size=(SIZE, SIZE))
    params = slim_yolo_v2.init_params(jax.random.PRNGKey(1), cfg,
                                      batch_norm=True)
    fused = jax.device_get(fold_batch_norm(params))
    for name in QUANT_LAYER_NAMES:
        w = np.asarray(fused[name]["w"])
        u = rng.integers(0, 4, w.shape[-1])
        fused[name] = {"w": jnp.asarray(w * np.exp2(-u).astype(np.float32)),
                       "b": jnp.asarray(fused[name]["b"])}
    batches = [rng.random((3, SIZE, SIZE, 3), dtype=np.float32)]
    m = quantize_pipeline(fused, cfg, batches, fold_bn=False,
                          per_channel=True)
    mn = jax.device_get(m)
    tm = int8_model_from_numpy(mn.w_q, mn.b_q, mn.sw, mn.sb, mn.sa,
                               mn.retune, device="cpu")
    return m, tm, batches[0]


def _raised(m, cls):
    retune = {k: v + RAISED_BY for k, v in m.retune.items()}
    return cls(m.w_q, m.b_q, m.sw, m.sb, m.sa, retune)


def _x_q(m, images):
    return np.asarray(fp.quantize_input(jnp.asarray(images), m.sa["in"]))


def test_every_layer_has_three_distinct_weight_scales(models):
    _, tm, _ = models
    for name in QUANT_LAYER_NAMES:
        assert np.ndim(tm.sw[name]) == 1
        assert len(tm.sw[name]) == tm.w_q[name].shape[-1]
        assert len(np.unique(tm.sw[name])) >= 3, name
    assert tm.per_channel


@pytest.mark.parametrize("rounding", ROUNDINGS)
def test_head_bit_exact_nhwc(models, rounding):
    m, tm, images = models
    x_q = _x_q(m, images)
    want = np.asarray(fp.int8_forward(m, jnp.asarray(x_q), rounding))
    got = tfp.int8_forward(tm, torch.tensor(x_q), rounding).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("rounding", ROUNDINGS)
def test_detections_match_jax(models, rounding):
    m, tm, images = models
    kw = dict(input_size=(SIZE, SIZE), pre_nms_top_k=64, top_k=20)
    x_q = _x_q(m, images)
    want = jax.device_get(make_int8_detect_fn(
        m, get_config("slim_yolo_v2", "mask", **kw), rounding)(x_q))
    got = t_make_int8_detect_fn(
        tm, t_get_config("slim_yolo_v2", "mask", **kw), rounding,
        device="cpu")(x_q)
    boxes, scores, classes, valid = (t.numpy() for t in got)
    np.testing.assert_array_equal(valid, want[3])
    np.testing.assert_array_equal(classes, want[2])
    np.testing.assert_allclose(boxes, want[0], **TOL)
    np.testing.assert_allclose(scores, want[1], **TOL)


@pytest.mark.parametrize("rounding", ROUNDINGS)
@pytest.mark.parametrize("variant", ["calibrated", "raised_retune"])
def test_diagnostics_match_jax(models, rounding, variant):
    """Head and every layer's overflow count equal to the JAX package's;
    the raised-retune model's counts are nonzero in conv1 (the mma.sync
    conv on NHWC input) and pred (the wgmma conv3x3): at 32² the layers
    between keep their accumulators below int16."""
    m, tm, images = models
    if variant == "raised_retune":
        m, tm = _raised(m, fp.Int8Model), _raised(tm, tfp.Int8Model)
    x_q = _x_q(m, images)
    want_head, want = fp.int8_forward_diagnostics(m, jnp.asarray(x_q),
                                                  rounding)
    head, got = tfp.int8_forward_diagnostics(tm, torch.tensor(x_q),
                                             rounding)
    np.testing.assert_array_equal(head.numpy(), np.asarray(want_head))
    np.testing.assert_array_equal(
        head.numpy(), tfp.int8_forward(tm, torch.tensor(x_q),
                                       rounding).numpy())
    assert set(got) == set(QUANT_LAYER_NAMES)
    for name in QUANT_LAYER_NAMES:
        assert got[name].dtype == torch.int32
        assert int(got[name]) == int(want[name]), name
    if variant == "raised_retune":
        assert int(got["conv1"]) > 0 and int(got["pred"]) > 0


def test_diagnostics_of_a_scalar_model_match_jax(models):
    """The same forward with one sw per layer (the per-channel model's
    largest), where ``_shift`` and not ``_shift_arr`` rounds."""
    m, tm, images = models
    sw = {k: int(np.max(v)) for k, v in tm.sw.items()}
    m1 = _raised(fp.Int8Model(m.w_q, m.b_q, sw, m.sb, m.sa, m.retune),
                 fp.Int8Model)
    tm1 = _raised(tfp.Int8Model(tm.w_q, tm.b_q, sw, tm.sb, tm.sa,
                                tm.retune), tfp.Int8Model)
    x_q = _x_q(m, images)
    want_head, want = fp.int8_forward_diagnostics(m1, jnp.asarray(x_q))
    head, got = tfp.int8_forward_diagnostics(tm1, torch.tensor(x_q))
    np.testing.assert_array_equal(head.numpy(), np.asarray(want_head))
    assert {k: int(v) for k, v in got.items()} == {
        k: int(v) for k, v in want.items()}


def test_packed_model_carries_its_tables(models):
    """``pack_conv3x3`` packs the nine wgmma layers (a per-channel sw
    takes the wgmma routes) and makes every layer's shift table for both
    roundings, once; ``to`` carries them; the CPU forward reads the HWIO
    weights and gives the same head."""
    m, tm, images = models
    K.reset_conv3x3_pack_count()
    K.reset_shift_table_count()
    packed = tm.to("cpu")
    packed.pack_conv3x3()
    assert K.conv3x3_pack_count() == 9
    assert K.shift_table_count() == 2 * len(QUANT_LAYER_NAMES)
    assert set(packed.packed) == set(QUANT_LAYER_NAMES) - {"conv1"}
    assert packed.s2d_packed is None  # K2's s2d form takes no per-channel
    moved = packed.to("cpu")
    for rounding in ROUNDINGS:
        for name in QUANT_LAYER_NAMES:
            i = QUANT_LAYER_NAMES.index(name)
            p = tm.layer_shifts(i, name)
            want = K.acc_shift_codes(p["sw"], p["sa_in"], p["retune"],
                                     rounding, tm.w_q[name].shape[-1])
            got = moved.shift_tables[rounding][name]
            assert got.dtype == torch.int32 and got.shape[0] % 128 == 0
            np.testing.assert_array_equal(got[:len(want)].numpy(), want)
            assert not got[len(want):].any()
    assert K.shift_table_count() == 2 * len(QUANT_LAYER_NAMES)
    x_q = torch.tensor(_x_q(m, images))
    assert torch.equal(tfp.int8_forward(moved, x_q),
                       tfp.int8_forward(tm, x_q))


# ---------------------------------------------------------------------------
# The plain wrappers with a per-channel sw, against int_conv_requant.
# ---------------------------------------------------------------------------


def _conv_case(rng, c_in, c_out, h=10, w=6):
    x = rng.integers(-128, 128, (2, h, w, c_in)).astype(np.int8)
    wq = rng.integers(-60, 70, (3, 3, c_in, c_out)).astype(np.int8)
    b = rng.integers(-100, 100, (c_out,)).astype(np.int32)
    # accumulator shifts sw + 4 - 10 from -1 (a left shift) to 33, and a
    # band around 3 where most values pass int16
    sw = rng.integers(7, 12, c_out).astype(np.int32)
    sw[:3] = [5, 39, 37]
    return x, wq, b, sw


@pytest.mark.parametrize("rounding", ROUNDINGS)
@pytest.mark.parametrize("pool", [False, True])
@pytest.mark.parametrize("c_in,c_out", [(3, 16), (16, 32), (32, 35)])
def test_plain_wrappers_match_int_conv_requant(rounding, pool, c_in, c_out):
    """``int8_conv3x3_requant`` / ``int8_conv3x3_im2col`` on the CPU with a
    per-channel sw == the JAX ``int_conv_requant(padding=1)`` (then its
    int8 2x2 max pool), and their overflow counts == the values outside
    int16 after the JAX shift and bias."""
    rng = np.random.default_rng(c_in + 7 * c_out)
    x, wq, b, sw = _conv_case(rng, c_in, c_out)
    p = dict(sw=sw, sb=6, sa_in=4, sa_out=3, retune=10)
    want = fp.int_conv_requant(jnp.asarray(x), jnp.asarray(wq),
                               jnp.asarray(b), padding=1, leaky=True,
                               rounding=rounding, **p)
    if pool:
        want = jax.lax.reduce_window(want, jnp.int8(-128), jax.lax.max,
                                     (1, 2, 2, 1), (1, 2, 2, 1), "VALID")
    acc = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(wq), (1, 1), ((1, 1), (1, 1)),
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32)
    acc = (fp._shift(acc, sw + 4 - 10, rounding, jnp)
           + fp._shift(jnp.asarray(b), 6 - 10, rounding, jnp))
    want_n = int(jnp.sum((acc > 32767) | (acc < -32768)))
    n = torch.zeros(1, dtype=torch.int32)
    kw = dict(p, leaky=True, rounding=rounding, overflow=n)
    xt, wt, bt = (torch.tensor(a) for a in (x, wq, b))
    got = (K.int8_conv3x3_im2col(xt, wt, bt, pool=True, **kw) if pool
           else K.int8_conv3x3_requant(xt, wt, bt, **kw))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(n) == want_n > 0


def test_s2d_wrapper_refuses_per_channel_sw():
    x = torch.zeros((1, 7, 7, 12), dtype=torch.int8)
    w = torch.zeros((3, 3, 3, 16), dtype=torch.int8)
    b = torch.zeros(16, dtype=torch.int32)
    with pytest.raises(ValueError, match="per-channel"):
        K.int8_conv3x3_pool_s2d(x, w, b, c_in=3, sw=np.full(16, 8), sb=7,
                                sa_in=4, sa_out=4, retune=11)


# ---------------------------------------------------------------------------
# The per-column shift tables.
# ---------------------------------------------------------------------------


def test_table_entries_follow_shift_arr():
    """Per-channel: a shift of 31 or more is entry 32 under nearest (0),
    31 under floor (v >> 31, as 32 is); 32 or more clamps to 32, -32 or
    less to -32 (a left shift to 0). A scalar sw keeps ``_shift``'s 31."""
    sw = np.array([6, 7, 36, 37, 40, -30, -26, 10], np.int32)
    codes = {r: K.acc_shift_codes(sw, 4, 10, r, 8) for r in ROUNDINGS}
    np.testing.assert_array_equal(codes["nearest"],
                                  [0, 1, 30, 32, 32, -32, -32, 4])
    np.testing.assert_array_equal(codes["floor"],
                                  [0, 1, 30, 31, 32, -32, -32, 4])
    for rounding in ROUNDINGS:
        np.testing.assert_array_equal(
            K.acc_shift_codes(37, 4, 10, rounding, 3), [31, 31, 31])
        np.testing.assert_array_equal(
            K.acc_shift_codes(50, 4, 10, rounding, 2), [32, 32])
    with pytest.raises(ValueError, match="rounding"):
        K.acc_shift_codes(sw, 4, 10, "up", 8)


def test_short_form_selection():
    """The short form takes entries in [0, 31] only: a per-channel 31 is
    short under floor, not under nearest (entry 32); a left shift is
    never short."""
    assert K.short_columns(K.acc_shift_codes(np.array([6, 30, 36]), 4, 10,
                                             "floor", 3))
    assert not K.short_columns(K.acc_shift_codes(np.array([6, 30, 37]), 4,
                                                 10, "nearest", 3))
    assert K.short_columns(K.acc_shift_codes(np.array([6, 30, 36]), 4, 10,
                                             "nearest", 3))
    assert not K.short_columns(K.acc_shift_codes(np.array([5, 8]), 4, 10,
                                                 "nearest", 2))


def test_table_is_padded_to_whole_tiles():
    for c_out, length in ((35, 128), (128, 128), (129, 256), (16, 128)):
        t = K.acc_shift_table(np.full(c_out, 9, np.int32), 4, 10, "nearest",
                              c_out, "cpu")
        assert t.dtype == torch.int32 and t.shape == (length,)
        assert (t[:c_out] == 3).all() and not t[c_out:].any()


def _kernel_shift(v, c, nearest, short):
    """The kernels' per-column shift of int32 ``v`` by table entry ``c``,
    in numpy: ``column_shift`` + ``Shift::apply`` of
    ``csrc/int8_wgmma_conv.cuh``."""
    v = v.astype(np.int64)
    if short:
        l, r, m = 0, c, -1
    else:
        l, r = min(max(-c, 0), 31), min(max(c, 0), 31)
        m = 0 if c <= -32 or (nearest and c >= 32) else -1
    a = ((1 << r) >> 1) if nearest else 0
    n = -1 if a else 0
    t = n & np.where(v < 0, -1, 0)
    u = ((v << l) + a + t) & 0xFFFFFFFF          # unsigned 32-bit wrap
    s = np.where(u >= 2 ** 31, u - 2 ** 32, u)   # back to int32
    return ((s >> r) & m).astype(np.int32)


@pytest.mark.parametrize("rounding", ROUNDINGS)
def test_kernel_shift_of_each_entry_equals_shift_arr(rounding):
    """Every table entry, decoded as the kernels decode it, shifts like
    ``fixed_point._shift_arr`` of the per-channel shift it stands for (and,
    in the short form, like it wherever the short form is taken)."""
    rng = np.random.default_rng(3)
    v = np.concatenate([rng.integers(-2 ** 31, 2 ** 31, 4000),
                        rng.integers(-2 ** 16, 2 ** 16, 4000),
                        [0, 1, -1, 2 ** 31 - 1, -2 ** 31, 2 ** 30,
                         -2 ** 30]]).astype(np.int32)
    nearest = rounding == "nearest"
    for s in list(range(-40, 41)):
        (c,) = K.acc_shift_codes(np.array([s]), 0, 0, rounding, 1)
        want = tfp._shift_arr(torch.tensor(v), np.array([s]),
                              rounding).numpy()
        got = _kernel_shift(v, int(c), nearest, short=False)
        np.testing.assert_array_equal(got, want, err_msg=f"shift {s}")
        if K.short_columns([c]):
            np.testing.assert_array_equal(
                _kernel_shift(v, int(c), nearest, short=True), want)
