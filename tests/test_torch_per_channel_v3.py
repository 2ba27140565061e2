"""Per-channel yolo_v3 in the port against the JAX package, on the CPU.

The model: ``seeded_fused_params_per_channel(0, 21)`` (every conv's output
channels scaled by 2^-u, u in {0..3}, so each conv's sw holds several
values), calibrated by the JAX ``quantize_pipeline_yolo_v3(fold_bn=False,
per_channel=True)`` on 2 seeded 64² images. Held bit-exact: the port's
``quantize_weights(per_channel=True)``, its plain integer walk against
the JAX ``int8_yolo_v3_forward(s2d=False)`` at 64² (nearest) and 128²
(both roundings), a two-part ``int8_conv_requant`` at equal part scales,
and the shift tables ``pack_conv3x3s`` and ``pack_res_blocks`` make; the
detections against the JAX per-channel detect fn: classes and valid exact,
boxes and scores within atol = rtol = 1e-5 (float32 sigmoid, exp and
softmax in another framework).

Floor rounding is held at 128², not at 64²: the reference's floor
upsample depends on the tensor's size (XLA fuses its align-corners
interpolation at n = 2 into another float order, and the 64² net
upsamples a 2x2 map), so at 64² its pred_1 and pred_2 differ from the
port's by a fault of the reference, not of the port.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolo_tpu.config import get_config
from yolo_tpu.quant import fixed_point as fp
from yolo_tpu.quant.int8_yolo_v3 import (
    int8_yolo_v3_forward, make_int8_yolo_v3_detect_fn,
    quantize_pipeline_yolo_v3)
from yolo_tpu_torch.config import get_config as t_get_config
from yolo_tpu_torch.kernels import int8_conv as K
from yolo_tpu_torch.quant import fixed_point as tfp
from yolo_tpu_torch.quant import int8_yolo_v3 as tv3
from yolo_tpu_torch.quant.convert import (
    int8_yolo_v3_from_numpy, int8_yolo_v3_tables, load_int8_yolo_v3_npz,
    save_int8_yolo_v3_npz, weights_sha256)

torch.set_num_threads(1)

SIZE = 64
TOL = dict(atol=1e-5, rtol=1e-5)
# the two concat 1x1s (conv_set_2[0], conv_set_1[0]) in program order
CONCATS = (58, 64)


@pytest.fixture(scope="module")
def models():
    """(the seeded float params, the JAX Int8YoloV3, its numpy fields, the
    port's on the CPU)."""
    cfg = get_config("yolo_v3", "mask", input_size=(SIZE, SIZE))
    fused = tv3.seeded_fused_params_per_channel(0, 21)
    calib = [np.random.default_rng(1).random((2, SIZE, SIZE, 3),
                                             dtype=np.float32)]
    m = quantize_pipeline_yolo_v3(jax.tree_util.tree_map(jnp.asarray, fused),
                                  cfg, calib, fold_bn=False,
                                  per_channel=True)
    mn = jax.device_get(m)
    tm = int8_yolo_v3_from_numpy(mn.w_q, mn.b_q, mn.sw, mn.sb, mn.sa_in,
                                 mn.tap_sa, mn.retune, device="cpu")
    return fused, m, mn, tm


def test_quantize_weights_per_channel_matches_jax(models):
    fused, _, mn, tm = models
    w_q, b_q, sw, sb = tv3.quantize_weights(fused, per_channel=True)
    assert len(w_q) == len(mn.w_q) == 75
    for i in range(75):
        np.testing.assert_array_equal(w_q[i], mn.w_q[i])
        np.testing.assert_array_equal(b_q[i], mn.b_q[i])
        np.testing.assert_array_equal(sw[i], np.asarray(mn.sw[i]))
        assert sw[i].dtype == np.int32 and sw[i].shape == w_q[i].shape[3:]
        assert len(np.unique(sw[i])) >= 2, i
        assert sb[i] == mn.sb[i]
    assert tm.per_channel


@pytest.mark.parametrize("size,rounding", [(64, "nearest"),
                                           (128, "nearest"),
                                           (128, "floor")])
def test_walk_bit_exact_with_jax(models, size, rounding):
    _, m, _, tm = models
    x = np.random.default_rng(size).random((1, size, size, 3),
                                           dtype=np.float32)
    x_q = fp.quantize_input(jnp.asarray(x), m.sa_in)
    want = int8_yolo_v3_forward(m, x_q, rounding, s2d=False)
    got = tv3.int8_yolo_v3_forward(tm, torch.tensor(np.asarray(x_q)),
                                   rounding)
    for g, w, sa in zip(got, want, tm.tap_sa[::-1][:3]):
        np.testing.assert_array_equal(
            torch.round(g * 2.0 ** sa).to(torch.int8).numpy(),
            np.rint(np.asarray(w) * 2.0 ** sa).astype(np.int8))


def test_detections_match_jax(models):
    _, m, _, tm = models
    images = np.random.default_rng(2).random((2, SIZE, SIZE, 3),
                                             dtype=np.float32)
    cfg = get_config("yolo_v3", "mask", input_size=(SIZE, SIZE))
    want = jax.device_get(make_int8_yolo_v3_detect_fn(m, cfg)(
        jnp.asarray(images)))
    detect = tv3.make_int8_yolo_v3_detect_fn(
        tm, t_get_config("yolo_v3", "mask", input_size=(SIZE, SIZE)),
        device="cpu")
    boxes, scores, classes, valid = (t.numpy() for t in detect(images))
    np.testing.assert_array_equal(valid, np.asarray(want[3]))
    np.testing.assert_array_equal(classes, np.asarray(want[2]))
    np.testing.assert_allclose(boxes, np.asarray(want[0]), **TOL)
    np.testing.assert_allclose(scores, np.asarray(want[1]), **TOL)
    assert valid.any()


def _codes(sw, sa_in, retune, rounding):
    """numpy twin of ``acc_shift_codes`` for a per-channel sw: the shift
    sw + sa_in - retune as the entry ``_shift`` reads (``_shift_arr``
    gives 0 from 31 on under nearest: entry 32), clipped to [-32, 32]."""
    s = np.asarray(sw, np.int64) + sa_in - retune
    if rounding == "nearest":
        s = np.where(s >= 31, 32, s)
    return np.clip(s, -32, 32)


def _res_block_scales(m):
    """(index of a residual block's 1x1 conv, the scale of its input, its
    mid scale), from the program."""
    out, sa, ci, ti, i = [], m.sa_in, 0, 0, 0
    while i < len(m.program):
        op = m.program[i]
        if op[0] == "push":
            out.append((ci, sa, m.tap_sa[ti]))
            sa, ci, ti, i = m.tap_sa[ti + 2], ci + 2, ti + 3, i + 4
            continue
        if op[0] == "conv":
            sa, ci, ti = m.tap_sa[ti], ci + 1, ti + 1
        i += 1
    return out


def test_detect_fn_refusals(models):
    """With input_s2d the JAX fn's per-channel message, raised before any
    device is asked for or anything packed. On CUDA the fn serves; what it
    makes there once for K4, ``pack_res_blocks`` makes here: the 23
    blocks' weights and two tables per block in each rounding (92), each
    equal to a numpy twin of ``acc_shift_codes`` at its conv's input
    scale; ``pack_conv3x3s`` then adds its 62 and keeps them."""
    tm = models[3]
    cfg = t_get_config("yolo_v3", "mask", input_size=(SIZE, SIZE))
    K.reset_conv3x3_pack_count()
    for device in ("cpu", "cuda"):
        with pytest.raises(ValueError, match="plain conv path only"):
            tv3.make_int8_yolo_v3_detect_fn(tm, cfg, input_s2d=True,
                                            device=device)
    assert K.conv3x3_pack_count() == 0
    m = dataclasses.replace(tm, res_packed=None, shift_tables=None)
    K.reset_shift_table_count()
    K.reset_res_block_pack_count()
    m.pack_res_blocks()
    assert K.res_block_pack_count() == 23
    assert K.shift_table_count() == 92
    blocks = _res_block_scales(m)
    assert len(blocks) == 23 and sorted(m.res_packed) == [b[0]
                                                          for b in blocks]
    for rounding, tables in m.shift_tables.items():
        assert sorted(tables) == sorted(ci + d for ci, _, _ in blocks
                                        for d in (0, 1))
        for ci, sa, sa_mid in blocks:
            for c, sa_in in ((ci, sa), (ci + 1, sa_mid)):
                (t,) = tables[c]
                c_out = m.w_q[c].shape[3]
                assert t.dtype == torch.int32 and t.shape == (
                    -(-c_out // K.TABLE_ALIGN) * K.TABLE_ALIGN,)
                np.testing.assert_array_equal(
                    t.numpy()[:c_out],
                    _codes(m.sw[c], sa_in, m.retune[c], rounding))
                assert not t.numpy()[c_out:].any()
    m.pack_conv3x3s()
    assert K.shift_table_count() == 92 + 62
    assert all(len(t) == 46 + 29 for t in m.shift_tables.values())


@pytest.mark.parametrize("rounding", ["nearest", "floor"])
def test_two_part_conv_equal_scales_matches_jax(rounding):
    """A per-channel concat 1x1 whose parts share a scale: their raw
    partials summed, one shift per column (one table on the card)."""
    rng = np.random.default_rng(5)
    x0 = rng.integers(-128, 128, (2, 5, 6, 16)).astype(np.int8)
    x1 = rng.integers(-128, 128, (2, 5, 6, 32)).astype(np.int8)
    w = rng.integers(-30, 40, (1, 1, 48, 20)).astype(np.int8)
    b = rng.integers(-100, 100, (20,)).astype(np.int32)
    sw = rng.integers(4, 12, 20).astype(np.int32)
    sw[:3] = [-30, 40, 27]  # shifts <= -32 and >= 31
    kw = dict(sw=sw, sb=7, sa_in=None, sa_out=4, retune=11, leaky=True,
              rounding=rounding)
    want = np.asarray(fp.int_conv_requant(
        [(jnp.asarray(x0), 5), (jnp.asarray(x1), 5)], jnp.asarray(w),
        jnp.asarray(b), **kw))
    got = K.int8_conv_requant(
        [(torch.tensor(x0), 5), (torch.tensor(x1), 5)], torch.tensor(w),
        torch.tensor(b), **kw)
    np.testing.assert_array_equal(got.numpy(), want)


def _kernel_shift(v, code, nearest):
    """numpy twin of the kernels' per-column shift: ``column_shift`` of a
    table entry, then ``Shift::apply`` (``csrc/int8_wgmma_conv.cuh``)."""
    code = np.asarray(code, np.int64)
    r = np.clip(code, 0, 31)
    a = ((1 << r) >> 1) if nearest else np.zeros_like(r)
    n = np.where(a != 0, -1, 0)
    left = np.clip(-code, 0, 31)
    m = np.where((code <= -32) | (nearest & (code >= 32)), 0, -1)
    v = np.asarray(v, np.int64)
    t = n & (v >> 63)
    u = (((v << left) + a + t) & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
    return (u.astype(np.int64) >> r).astype(np.int32) & m.astype(np.int32)


def _part_taps(m):
    """{conv index: the tap index of each of its parts' scales (-1: the
    input)}, for the convs outside the residual blocks, from the
    program."""
    out, slots, stream, parts = {}, {}, -1, None
    ci = ti = i = 0
    while i < len(m.program):
        op = m.program[i]
        if op[0] == "push":
            stream, ci, ti, i = ti + 2, ci + 2, ti + 3, i + 4
            continue
        if op[0] == "conv":
            out[ci] = parts or (stream,)
            stream, ci, ti = ti, ci + 1, ti + 1
        elif op[0] == "save":
            slots[op[1]] = stream
        elif op[0] == "load":
            stream = slots[op[1]]
        parts = (slots[op[1]], stream) if op[0] == "concat" else None
        i += 1
    return out


@pytest.mark.parametrize("scales", ["calibrated", "equal"])
def test_pack_conv3x3s_concat_tables(models, scales):
    """The tables ``pack_conv3x3s`` makes for the two concat 1x1s: parts of
    one scale one table, of two scales one per part, each entry's shift
    (the kernels' ``column_shift``) equal to the JAX package's
    ``_shift_arr`` by sw[c] + sa - retune on values across int32, both
    roundings; the model's calibration gives its concats two scales."""
    tm = models[3]
    taps = _part_taps(tm)
    tap_sa = list(tm.tap_sa)
    for ci in CONCATS:
        if scales == "equal":
            tap_sa[taps[ci][1]] = tap_sa[taps[ci][0]]
    m = dataclasses.replace(tm, tap_sa=tap_sa)
    K.reset_shift_table_count()
    m.pack_conv3x3s()
    assert K.shift_table_count() == 2 * sum(
        len({tap_sa[t] for t in taps[ci]}) for ci in m.shift_tables["nearest"])
    assert set(m.shift_tables["floor"]) == set(taps) and len(taps) == 29
    v = np.random.default_rng(7).integers(-2 ** 31, 2 ** 31, (64, 1),
                                          dtype=np.int64).astype(np.int32)
    for ci in CONCATS:
        sas = [tap_sa[t] for t in taps[ci]]
        assert (sas[0] == sas[1]) == (scales == "equal")
        sw, c_out = np.asarray(m.sw[ci]), m.w_q[ci].shape[-1]
        for rounding, tables in m.shift_tables.items():
            ts = tables[ci]
            assert len(ts) == len(set(sas))
            for t, sa in zip(ts, dict.fromkeys(sas)):
                assert t.dtype == torch.int32
                assert t.shape == (-(-c_out // K.CONV1X1_ALIGN)
                                   * K.CONV1X1_ALIGN,)
                codes = t.numpy()
                assert not codes[c_out:].any()
                s = sw + sa - m.retune[ci]
                np.testing.assert_array_equal(
                    _kernel_shift(v, codes[:c_out], rounding == "nearest"),
                    fp._shift_arr(v, s, rounding, np))


def test_per_channel_npz_round_trip(models, tmp_path):
    tm = models[3]
    tables = int8_yolo_v3_tables(tm)
    assert bool(tables["per_channel"]) and "sw" not in tables
    assert all(tables[f"sw.{i}"].dtype == np.int32 for i in range(75))
    path = tmp_path / "v3_pc.npz"
    save_int8_yolo_v3_npz(path, tm)
    back = load_int8_yolo_v3_npz(path, device="cpu")
    assert back.per_channel
    for a, b in zip(back.sw, tm.sw):
        np.testing.assert_array_equal(a, b)
    assert (back.sb, back.retune, back.tap_sa, back.sa_in) == (
        tm.sb, tm.retune, tm.tap_sa, tm.sa_in)
    for a, b in zip(back.w_q + back.b_q, tm.w_q + tm.b_q):
        assert torch.equal(a, b)


def test_per_channel_recipe_leaves_the_scalar_recipe(models):
    """The scalar recipe still draws the weights the scalar 416² fixture
    checks (its sha256); the per-channel recipe draws each conv's w and b
    as it does, then its own u: the first conv's b equal, its w equal up
    to a power of two in {1, 1/2, 1/4, 1/8} per output channel."""
    scalar = tv3.seeded_fused_params(0, 21)
    pc = models[0]
    with np.load("yolo_tpu_torch/data/yolo_v3_int8_416_golden.npz") as z:
        want_sha = str(z["wb_sha256"])
    w_q, b_q, _, _ = tv3.quantize_weights(scalar)
    assert weights_sha256(w_q, b_q) == want_sha
    first_pc = pc["backbone"]["layer_1"]["entry"][0]
    first = scalar["backbone"]["layer_1"]["entry"][0]
    np.testing.assert_array_equal(first_pc["b"], first["b"])
    ratio = first_pc["w"] / first["w"]
    per_col = ratio[0, 0, 0]
    np.testing.assert_array_equal(ratio, np.broadcast_to(per_col,
                                                         ratio.shape))
    assert set(np.log2(per_col).tolist()) <= {0.0, -1.0, -2.0, -3.0}
