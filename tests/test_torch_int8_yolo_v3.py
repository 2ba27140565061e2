"""The port's yolo_v3 INT8 slice against the JAX package: the program, the
generic integer ops (plain versions of the general conv kernel), the whole
integer forward bit-exact at 64² in both roundings on the Int8YoloV3 that
the JAX ``quantize_pipeline_yolo_v3`` builds from PRNGKey(0) (the recipe of
tests/test_int8_yolo_v3.py), and the detections: classes and valid exact,
boxes and scores allclose (atol = rtol = 1e-5: float32 sigmoid, exp and
softmax in another framework)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolo_tpu.config import get_config
from yolo_tpu.models import yolo_v3
from yolo_tpu.ops import blocks as jblocks
from yolo_tpu.quant import fixed_point as fp
from yolo_tpu.quant import quantize as jq
from yolo_tpu.quant.bn_fold import fold_batch_norm
from yolo_tpu.quant.int8_yolo_v3 import (
    _program, int8_yolo_v3_forward, make_int8_yolo_v3_detect_fn,
    quantize_pipeline_yolo_v3)
from yolo_tpu_torch.config import get_config as t_get_config
from yolo_tpu_torch.ops import blocks as tblocks
from yolo_tpu_torch.quant import fixed_point as tfp
from yolo_tpu_torch.quant import int8_yolo_v3 as tv3
from yolo_tpu_torch.quant.convert import (
    int8_yolo_v3_from_numpy, load_int8_yolo_v3_npz, save_int8_yolo_v3_npz)
from yolo_tpu_torch.quant.quantize import quantize_pow2_np

torch.set_num_threads(1)

SIZE = 64
TOL = dict(atol=1e-5, rtol=1e-5)
ROUNDINGS = ["nearest", "floor"]


@pytest.fixture(scope="module")
def models():
    """(JAX Int8YoloV3, the port's on the CPU, int8 input [2, 64, 64, 3])."""
    rng = np.random.default_rng(0)
    cfg = get_config("yolo_v3", "mask", input_size=(SIZE, SIZE))
    params = yolo_v3.init_params(jax.random.PRNGKey(0), cfg,
                                 batch_norm=True)
    calib = [rng.random((2, SIZE, SIZE, 3), dtype=np.float32)]
    m = quantize_pipeline_yolo_v3(params, cfg, calib)
    mn = jax.device_get(m)
    tm = int8_yolo_v3_from_numpy(mn.w_q, mn.b_q, mn.sw, mn.sb, mn.sa_in,
                                 mn.tap_sa, mn.retune, device="cpu")
    x_q = np.asarray(fp.quantize_input(jnp.asarray(calib[0]), m.sa_in))
    return m, tm, x_q


def test_program_matches_jax():
    ops = tv3._program()
    assert ops == _program(spp=False)
    assert len([o for o in ops if o[0] == "conv"]) == 75
    assert len([o for o in ops if o[0] == "res"]) == 23
    spp = tv3._program(spp=True)
    assert spp == _program(spp=True)
    assert spp.count(("spp",)) == 1 and len(spp) == len(ops) + 1


def test_seeded_params_have_the_fused_tree_layout():
    """The golden recipe's float params: the tree, shapes and dtypes of
    fold_batch_norm(yolo_v3.init_params(...)) for the mask config."""
    cfg = get_config("yolo_v3", "mask")
    want = fold_batch_norm(yolo_v3.init_params(jax.random.PRNGKey(0), cfg))
    got = tv3.seeded_fused_params(0, 21)
    assert (jax.tree_util.tree_structure(got)
            == jax.tree_util.tree_structure(want))
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        assert a.shape == b.shape and a.dtype == b.dtype


@pytest.mark.parametrize("channel_axis", [None, -1])
def test_quantize_pow2_np_matches_jax(rng, channel_axis):
    t = (rng.standard_normal((3, 3, 8, 16)) * 0.05).astype(np.float32)
    t[..., 3] = 0.0
    got = quantize_pow2_np(t, 8, channel_axis=channel_axis)
    want = jq.quantize_pow2_np(t, 8, channel_axis=channel_axis)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(want[1]))


def _conv_case(rng, k, c_in, c_out, per_channel):
    w = rng.integers(-30, 40, (k, k, c_in, c_out)).astype(np.int8)
    b = rng.integers(-100, 100, (c_out,)).astype(np.int32)
    sw = rng.integers(6, 10, c_out).astype(np.int32) if per_channel else 8
    return w, b, sw


@pytest.mark.parametrize("rounding", ROUNDINGS)
@pytest.mark.parametrize("k,stride,padding,leaky,per_channel", [
    (3, 1, 1, 0.1, False), (3, 2, 1, 0.1, False), (1, 1, 0, True, False),
    (1, 1, 0, False, False), (3, 2, 1, True, True), (1, 1, 1, 0.1, True),
    (3, 1, 0, 0.125, False)])
def test_int_conv_requant_matches_jax(rng, rounding, k, stride, padding,
                                      leaky, per_channel):
    x = rng.integers(-128, 128, (2, 7, 6, 12)).astype(np.int8)
    w, b, sw = _conv_case(rng, k, 12, 20, per_channel)
    kw = dict(sw=sw, sb=7, sa_in=4, sa_out=3, retune=11, padding=padding,
              stride=stride, leaky=leaky, rounding=rounding)
    want = np.asarray(fp.int_conv_requant(jnp.asarray(x), jnp.asarray(w),
                                          jnp.asarray(b), **kw))
    got = tfp.int_conv_requant(torch.tensor(x), torch.tensor(w),
                               torch.tensor(b), **kw)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("rounding", ROUNDINGS)
@pytest.mark.parametrize("sas,per_channel", [
    ((4, 6), False), ((5, 5), False), ((7, 3), True)])
def test_int_conv_requant_two_parts_matches_jax(rng, rounding, sas,
                                                per_channel):
    """A concat input: each part's partial shifted on its own (parts of
    equal scale summed raw first), not one conv over the concat."""
    x0 = rng.integers(-128, 128, (2, 5, 6, 16)).astype(np.int8)
    x1 = rng.integers(-128, 128, (2, 5, 6, 8)).astype(np.int8)
    w, b, sw = _conv_case(rng, 1, 24, 20, per_channel)
    kw = dict(sw=sw, sb=7, sa_in=None, sa_out=4, retune=11, leaky=True,
              rounding=rounding)
    want = np.asarray(fp.int_conv_requant(
        [(jnp.asarray(x0), sas[0]), (jnp.asarray(x1), sas[1])],
        jnp.asarray(w), jnp.asarray(b), **kw))
    got = tfp.int_conv_requant(
        [(torch.tensor(x0), sas[0]), (torch.tensor(x1), sas[1])],
        torch.tensor(w), torch.tensor(b), **kw)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("rounding", ROUNDINGS)
def test_int_conv_requant_residual_matches_jax(rng, rounding):
    x = rng.integers(-128, 128, (2, 6, 6, 8)).astype(np.int8)
    r = rng.integers(-128, 128, (2, 6, 6, 16)).astype(np.int8)
    w, b, _ = _conv_case(rng, 3, 8, 16, False)
    kw = dict(sw=8, sb=7, sa_in=4, sa_out=3, retune=11, padding=1,
              leaky=0.1, rounding=rounding, sa_res=4)
    want = np.asarray(fp.int_conv_requant(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
        residual=(jnp.asarray(r), 5), **kw))
    got = tfp.int_conv_requant(torch.tensor(x), torch.tensor(w),
                               torch.tensor(b), residual=(torch.tensor(r), 5),
                               **kw)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("rounding", ROUNDINGS)
@pytest.mark.parametrize("sas", [(4, 6, 4), (6, 4, 7), (5, 5, 3)])
def test_int_add_requant_matches_jax(rng, rounding, sas):
    a = rng.integers(-128, 128, (2, 4, 4, 8)).astype(np.int8)
    b = rng.integers(-128, 128, (2, 4, 4, 8)).astype(np.int8)
    sa_a, sa_b, sa_out = sas
    want = np.asarray(fp.int_add_requant(jnp.asarray(a), sa_a,
                                         jnp.asarray(b), sa_b, sa_out,
                                         rounding))
    got = tfp.int_add_requant(torch.tensor(a), sa_a, torch.tensor(b), sa_b,
                              sa_out, rounding)
    np.testing.assert_array_equal(got.numpy(), want)


def _upsample_inputs(rng, n):
    const = np.broadcast_to(rng.integers(-128, 128, (2, 1, 1, 8)),
                            (2, n, n, 8))
    ramp = (np.arange(n)[None, :, None, None] * 3
            + np.arange(n)[None, None, :, None] * 5 + np.arange(8) - 60)
    rand = rng.integers(-128, 128, (2, n, n, 8))
    return [np.clip(a, -128, 127).astype(np.int8)
            for a in (const, np.broadcast_to(ramp, (2, n, n, 8)), rand)]


@pytest.mark.parametrize("n,rounding", [
    (2, "nearest"), (4, "nearest"), (13, "nearest"), (26, "nearest"),
    (4, "floor"), (5, "floor"), (13, "floor")])
def test_int_upsample2x_ac_matches_jax(rng, rounding, n):
    """floor is the sharp case: with equal neighbours the float32
    interpolation can land one ulp under an integer. The port computes
    both products and their sum in float32, unfused; XLA's CPU einsum
    fuses the multiply-add at some sizes (n = 2, 3, 25-32 and 64 on the
    jaxlib these tests ran with, ROADMAP.md Queue 3) and then floors
    differently at exact-integer points, so floor is held at sizes it
    leaves unfused.
    nearest never meets a tie (2n - 1 is odd) and agrees at every size."""
    for x in _upsample_inputs(rng, n):
        want = np.asarray(fp.int_upsample2x_ac(jnp.asarray(x), rounding))
        got = tfp.int_upsample2x_ac(torch.tensor(x), rounding)
        np.testing.assert_array_equal(got.numpy(), want)


def test_upsample_float_matches_jax(rng):
    x = rng.standard_normal((1, 5, 4, 4)).astype(np.float32)
    want = np.asarray(jblocks.upsample2x_align_corners(jnp.asarray(x)))
    got = tblocks.upsample2x_align_corners(torch.tensor(x)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("rounding", ROUNDINGS)
def test_forward_bit_exact(models, rounding):
    m, tm, x_q = models
    want = int8_yolo_v3_forward(m, jnp.asarray(x_q), rounding, s2d=False)
    got = tv3.int8_yolo_v3_forward(tm, torch.tensor(x_q), rounding)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_detections_match_jax(models):
    m, tm, x_q = models
    kw = dict(input_size=(SIZE, SIZE), pre_nms_top_k=64, top_k=20,
              conf_thresh=0.001)
    want = jax.device_get(make_int8_yolo_v3_detect_fn(
        m, get_config("yolo_v3", "mask", **kw))(x_q))
    got = tv3.make_int8_yolo_v3_detect_fn(
        tm, t_get_config("yolo_v3", "mask", **kw), device="cpu")(x_q)
    boxes, scores, classes, valid = (t.numpy() for t in got)
    np.testing.assert_array_equal(valid, want[3])
    np.testing.assert_array_equal(classes, want[2])
    np.testing.assert_allclose(boxes, want[0], **TOL)
    np.testing.assert_allclose(scores, want[1], **TOL)
    assert valid.any()


def test_float_and_int8_inputs_agree(models, rng):
    _, tm, _ = models
    images = rng.random((1, SIZE, SIZE, 3), dtype=np.float32)
    cfg = t_get_config("yolo_v3", "mask", input_size=(SIZE, SIZE), top_k=10)
    detect = tv3.make_int8_yolo_v3_detect_fn(tm, cfg, device="cpu")
    x_q = tfp.quantize_input(torch.tensor(images), tm.sa_in)
    for a, b in zip(detect(images), detect(x_q)):
        assert torch.equal(a, b)


def test_npz_round_trip(models, tmp_path):
    _, tm, x_q = models
    path = tmp_path / "v3.npz"
    save_int8_yolo_v3_npz(path, tm, note=np.arange(3))
    tm2 = load_int8_yolo_v3_npz(path, device="cpu")
    assert (tm2.sw, tm2.sb, tm2.retune, tm2.tap_sa, tm2.sa_in) == (
        tm.sw, tm.sb, tm.retune, tm.tap_sa, tm.sa_in)
    for a, b in zip(tm.w_q + tm.b_q, tm2.w_q + tm2.b_q):
        assert torch.equal(a, b)


def test_launches_counted_only_on_the_card(models):
    """The CPU walk counts no launch; on the card a forward is 23
    int8_res_block and 29 int8_conv_requant launches (chip_smoke.py)."""
    from yolo_tpu_torch import kernels

    _, tm, x_q = models
    kernels.reset_launch_counts()
    tv3.int8_yolo_v3_forward(tm, torch.tensor(x_q[:1]))
    assert kernels.launch_counts() == {k: 0 for k in kernels.KERNEL_NAMES}
    blocks = [i for i, op in enumerate(tm.program) if op[0] == "push"]
    assert len(blocks) == 23
    assert 75 - 2 * len(blocks) == 29


def test_detect_fn_packs_res_blocks_once(models):
    """The detect fn packs the 23 blocks' weights for the fused kernel
    once, when it takes the model, and only for the card (chip_smoke.py
    checks the 23 there): the CPU route reads the HWIO weights, so on the
    CPU it packs nothing, and a forward never packs."""
    from yolo_tpu_torch.kernels import int8_conv as K

    _, tm, x_q = models
    cfg = t_get_config("yolo_v3", "mask", input_size=(SIZE, SIZE), top_k=10)
    K.reset_res_block_pack_count()
    detect = tv3.make_int8_yolo_v3_detect_fn(tm, cfg, device="cpu")
    assert K.res_block_pack_count() == 0
    detect(x_q[:1])
    assert K.res_block_pack_count() == 0


def test_pack_res_blocks_packs_every_block(models):
    """``pack_res_blocks`` packs each of the 23 blocks' (1x1, 3x3) weight
    pairs, keyed by the index of its 1x1 conv."""
    from yolo_tpu_torch.kernels import int8_conv as K

    _, tm, _ = models
    m = tm.to("cpu")
    K.reset_res_block_pack_count()
    m.pack_res_blocks()
    assert K.res_block_pack_count() == 23 == len(m.res_packed)
    for i, packed in m.res_packed.items():
        assert m.w_q[i].shape[:2] == (1, 1) and m.w_q[i + 1].shape[:2] == (3, 3)
        w1, w2 = K.unpack_res_block_weights(packed)
        assert torch.equal(w1, m.w_q[i][0, 0]) and torch.equal(w2, m.w_q[i + 1])


def test_to_carries_the_packed_weights(models, rng):
    """A packed model moved with ``to`` keeps both packed dicts, equal
    tensors in their K-major form, so its forward packs nothing."""
    from yolo_tpu_torch.kernels import int8_conv as K

    _, tm, x_q = models
    m = tm.to("cpu")
    m.pack_res_blocks()
    m.pack_conv3x3s()
    moved = m.to("cpu")
    assert sorted(moved.res_packed) == sorted(m.res_packed)
    assert sorted(moved.conv_packed) == sorted(m.conv_packed)
    for i, pair in m.res_packed.items():
        assert all(a is b for a, b in zip(moved.res_packed[i], pair))
    for i, wp in m.conv_packed.items():
        assert moved.conv_packed[i] is wp  # no copy on the same device
    K.reset_res_block_pack_count()
    K.reset_conv3x3_pack_count()
    tv3.int8_yolo_v3_forward(moved, torch.tensor(x_q[:1]))
    assert K.res_block_pack_count() == 0
    assert K.conv3x3_pack_count() == 0


def test_unported_options_raise(models):
    """``mesh`` is the one option not ported (s2d, input_s2d and limit
    are: tests/test_torch_s2d_v3.py); it raises, naming itself."""
    _, tm, x_q = models
    cfg = t_get_config("yolo_v3", "mask", input_size=(SIZE, SIZE))
    with pytest.raises(ValueError, match="mesh.*not ported"):
        tv3.make_int8_yolo_v3_detect_fn(tm, cfg, mesh=object(),
                                        device="cpu")


def test_detect_fn_without_device_needs_cuda(models):
    _, tm, _ = models
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    cfg = t_get_config("yolo_v3", "mask", input_size=(SIZE, SIZE))
    with pytest.raises(RuntimeError, match="CUDA"):
        tv3.make_int8_yolo_v3_detect_fn(tm, cfg)
