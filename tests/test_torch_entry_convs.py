"""The two thin-input entry convs of ``csrc/int8_entry_conv.cu`` on the CPU:
yolo_v3's C_in = 3 entry conv (``entry_conv3x3_route``) and K2 on the s2d
layout, slim's conv1 (``pool_s2d_wgmma_route``). Their plain routes,
fed HWIO or only packed weights, against the JAX package (XLA's
``fixed_point.int_conv_requant`` for the entry conv; the Pallas
``int8_conv3x3_pool_requant(assembly='s2d')`` in interpret mode and
``fixed_point.int8_conv_pool_s2d_core`` for K2); both pack functions; which
convs the two routes take; that the models pack them once and the
forwards hand them over; and that the CPU detect fns pack nothing.
test_torch_kernels_cuda.py holds the kernels against these plain versions
on the card."""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolo_tpu.kernels import int8_conv as jk
from yolo_tpu.quant import fixed_point as fp
from yolo_tpu_torch.config import get_config
from yolo_tpu_torch.kernels import int8_conv as K
from yolo_tpu_torch.models.slim_yolo_v2 import CONV_LAYERS
from yolo_tpu_torch.quant import fixed_point as tfp
from yolo_tpu_torch.quant import int8_yolo_v3 as tv3
from yolo_tpu_torch.quant.convert import int8_model_from_arrays
from yolo_tpu_torch.quant.int8_graph import make_int8_detect_fn

torch.set_num_threads(1)

ROUNDINGS = ["nearest", "floor"]
SHIFTS = dict(sw=8, sb=7, sa_in=4, sa_out=4, retune=11)
# the epilogue cases: the leaky slopes (the 0.125 shift, darknet's 0.1 as
# a Q16 rational, none), an accumulator shift >= 32, a negative output
# shift (an exact left shift)
CASES = {
    "slope_0.125": dict(SHIFTS, leaky=True),
    "slope_0.1": dict(SHIFTS, leaky=0.1),
    "leaky_off": dict(SHIFTS, leaky=False),
    "acc_shift_ge_32": dict(SHIFTS, sw=40, leaky=0.1),
    # accumulator shift 10, output shift -1: the output spreads unsaturated
    "out_shift_lt_0": dict(SHIFTS, sw=17, sa_out=12, leaky=0.1),
}
# (B, H, W): W * 3 is no multiple of 16 on any of them
IMAGES = [(2, 17, 23), (1, 32, 32), (1, 33, 40)]


def _case(rng, b, h, w, c_in, c_out):
    """int8 input, asymmetric int8 weights, nonzero int8-valued biases."""
    x = rng.integers(-128, 128, (b, h, w, c_in)).astype(np.int8)
    wq = rng.integers(-30, 40, (3, 3, c_in, c_out)).astype(np.int8)
    bq = rng.integers(-100, 100, (c_out,)).astype(np.int32)
    return x, wq, bq


# ---------------------------------------------------------------------------
# The entry conv.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("rounding", ROUNDINGS)
@pytest.mark.parametrize("c_out", [32, 35])
@pytest.mark.parametrize("c_in", [1, 2, 3])
@pytest.mark.parametrize("image", IMAGES, ids=lambda s: "x".join(map(str, s)))
def test_entry_conv_plain_equals_jax(case, rounding, c_in, c_out, image):
    """``int8_conv_requant`` at a routed shape, fed the HWIO weights and
    fed only ``pack_entry_conv_weights``'s, is exactly the JAX
    ``int_conv_requant`` (stride 1, pad 1)."""
    b, h, w = image
    rng = np.random.default_rng(c_in * 100 + c_out)
    x, wq, bq = _case(rng, b, h, w, c_in, c_out)
    kw = dict(CASES[case], rounding=rounding)
    assert K.entry_conv3x3_route(3, 1, 1, 1, c_in, c_out, kw["sw"])
    want = np.asarray(fp.int_conv_requant(
        jnp.asarray(x), jnp.asarray(wq), jnp.asarray(bq), padding=1, **kw))
    hwio = K.int8_conv_requant(torch.tensor(x), torch.tensor(wq),
                               torch.tensor(bq), padding=1, **kw)
    np.testing.assert_array_equal(hwio.numpy(), want)
    packed = K.pack_entry_conv_weights(torch.tensor(wq))
    got = K.int8_conv_requant(torch.tensor(x), None, torch.tensor(bq),
                              padding=1, packed=packed, **kw)
    assert torch.equal(got, hwio)
    if case != "acc_shift_ge_32":  # there the output is the bias alone
        assert len(np.unique(want)) > 10  # the output does spread


@pytest.mark.parametrize("c_in", [1, 2, 3])
def test_entry_pack_round_trip(rng, c_in):
    """[C_out, 32] in (dy, dx, c) order, zero past 9 * C_in, back to
    HWIO exactly; one count per pack."""
    wq = torch.tensor(rng.integers(-128, 128, (3, 3, c_in, 35))
                      .astype(np.int8))
    K.reset_entry_conv_pack_count()
    wp = K.pack_entry_conv_weights(wq)
    assert K.entry_conv_pack_count() == 1
    assert wp.shape == (35, 32) and wp.is_contiguous()
    assert not wp[:, 9 * c_in:].any()
    for dy in range(3):
        for dx in range(3):
            k = (dy * 3 + dx) * c_in
            assert torch.equal(wp[:, k:k + c_in], wq[dy, dx].t())
    assert torch.equal(K.unpack_entry_conv_weights(wp, c_in), wq)
    with pytest.raises(ValueError, match="C_in <= 3"):
        K.pack_entry_conv_weights(torch.zeros((3, 3, 4, 8), dtype=torch.int8))


# ---------------------------------------------------------------------------
# K2 on the s2d layout.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["slope_0.125", "leaky_off",
                                  "out_shift_lt_0"])
@pytest.mark.parametrize("rounding", ROUNDINGS)
@pytest.mark.parametrize("c_in,c_out,h,w", [(3, 16, 12, 10), (3, 32, 8, 14),
                                            (4, 16, 10, 6)])
def test_pool_s2d_plain_equals_pallas(case, rounding, c_in, c_out, h, w):
    """``int8_conv3x3_pool_s2d`` at a routed shape, fed the HWIO weights
    and fed only ``pack_pool_s2d_weights``'s, is exactly the Pallas K2 in
    its s2d assembly (interpret mode) and ``int8_conv_pool_s2d_core``."""
    rng = np.random.default_rng(c_in * 100 + c_out + h)
    x, wq, bq = _case(rng, 2, h, w, c_in, c_out)
    kw = dict(CASES[case], rounding=rounding)
    kw["leaky"] = bool(kw["leaky"])  # K2 takes the 0.125 shift or none
    assert K.pool_s2d_wgmma_route(c_in, c_out, kw["sw"])
    want = np.asarray(jk.int8_conv3x3_pool_requant(
        jnp.asarray(x), jnp.asarray(wq), jnp.asarray(bq), assembly="s2d",
        interpret=True, **kw))
    x2 = tfp.s2d_input_np(x)
    core = np.asarray(fp.int8_conv_pool_s2d_core(
        jnp.asarray(x2), jnp.asarray(wq), jnp.asarray(bq), c_in=c_in, **kw))
    np.testing.assert_array_equal(core, want)
    hwio = K.int8_conv3x3_pool_s2d(torch.tensor(x2), torch.tensor(wq),
                                   torch.tensor(bq), c_in=c_in, **kw)
    np.testing.assert_array_equal(hwio.numpy(), want)
    packed = K.pack_pool_s2d_weights(torch.tensor(wq))
    got = K.int8_conv3x3_pool_s2d(torch.tensor(x2), None, torch.tensor(bq),
                                  c_in=c_in, packed=packed, **kw)
    assert torch.equal(got, hwio)
    assert len(np.unique(want)) > 10


def test_pool_s2d_plain_acc_shift_ge_32_equals_core(rng):
    """An accumulator shift >= 32 (which the Pallas helpers do not guard):
    the plain route against the JAX ``int8_conv_pool_s2d_core``."""
    x, wq, bq = _case(rng, 2, 8, 12, 3, 16)
    x2 = tfp.s2d_input_np(x)
    for rounding in ROUNDINGS:
        kw = dict(SHIFTS, sw=40, rounding=rounding)
        want = np.asarray(fp.int8_conv_pool_s2d_core(
            jnp.asarray(x2), jnp.asarray(wq), jnp.asarray(bq), c_in=3,
            **kw))
        got = K.int8_conv3x3_pool_s2d(
            torch.tensor(x2), None, torch.tensor(bq), c_in=3,
            packed=K.pack_pool_s2d_weights(torch.tensor(wq)), **kw)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("c_in,c_out", [(3, 16), (3, 32), (4, 16), (1, 7),
                                        (2, 20)])
def test_pool_s2d_pack_equals_jax_phase_weights(rng, c_in, c_out):
    """Row p * CP + co, column k of the packed form is the JAX
    ``_s2d_phase_weights`` [2, 2, 4 C_in, 4 C_out] flattened to [16 C_in,
    4 C_out] (column p * C_out + co), transposed; zero past C_out and
    16 * C_in; back to HWIO exactly; one count per pack."""
    wq = rng.integers(-128, 128, (3, 3, c_in, c_out)).astype(np.int8)
    K.reset_pool_s2d_pack_count()
    wp = K.pack_pool_s2d_weights(torch.tensor(wq))
    assert K.pool_s2d_pack_count() == 1
    cp = 16 if c_out <= 16 else 32
    assert wp.shape == (4 * cp, 64) and wp.is_contiguous()
    ref = fp._s2d_phase_weights(wq, c_in, c_out).reshape(16 * c_in,
                                                         4 * c_out)
    got = wp.reshape(4, cp, 64)
    np.testing.assert_array_equal(
        got[:, :c_out, :16 * c_in].reshape(4 * c_out, 16 * c_in).numpy(),
        ref.T)
    assert not got[:, c_out:].any() and not got[:, :, 16 * c_in:].any()
    assert torch.equal(K.unpack_pool_s2d_weights(wp, c_in, c_out),
                       torch.tensor(wq))


def test_pool_s2d_pack_rejects_wide_shapes():
    for shape in ((3, 3, 5, 16), (3, 3, 3, 33), (1, 1, 3, 16)):
        with pytest.raises(ValueError):
            K.pack_pool_s2d_weights(torch.zeros(shape, dtype=torch.int8))


# ---------------------------------------------------------------------------
# Routes, packing and hand-over on the two models.
# ---------------------------------------------------------------------------


def _slim():
    path = (Path(__file__).resolve().parents[1] / "yolo_tpu_torch" / "data"
            / "slim_int8_416_golden.npz")
    with np.load(path) as z:
        return int8_model_from_arrays({k: z[k] for k in z.files},
                                      device="cpu")


def _random_v3(pred_out=21):
    specs = tv3.conv_specs(pred_out)
    return tv3.Int8YoloV3(
        spp=False,
        w_q=[torch.tensor(np.random.default_rng(i).integers(
            -3, 4, (k, k, ci, co)).astype(np.int8))
             for i, (_, k, ci, co) in enumerate(specs)],
        b_q=[torch.zeros(co, dtype=torch.int32) for *_, co in specs],
        sw=[7] * len(specs), sb=[7] * len(specs), sa_in=4,
        tap_sa=[4] * (len(specs) + 23), retune=[10] * len(specs))


def _v3_general_convs():
    """(path, k, stride, padding, parts, C_in, C_out) of the 29 convs that
    ``int8_yolo_v3_forward`` runs through ``int8_conv_requant``."""
    prog, specs = tv3._program(), tv3.conv_specs(21)
    out, ci, i, parts = [], 0, 0, 1
    while i < len(prog):
        op = prog[i]
        if op[0] == "push":
            ci, i = ci + 2, i + 4
            continue
        if op[0] == "conv":
            path, k, c_in, c_out = specs[ci]
            out.append((path, k, op[2], op[3], parts, c_in, c_out))
            ci += 1
        parts = 2 if op[0] == "concat" else 1
        i += 1
    return out


def test_routes_take_exactly_the_two_entry_convs():
    """Of slim's ten layers only conv1 takes K2's wgmma route, and of the
    v3 program's 29 general convs only the C_in = 3 entry conv takes the
    entry conv route; K2's s2d route takes no per-channel sw, the entry
    conv route one of C_out entries (its per-column form), and no v3 conv
    takes two routes."""
    slim = [name for name, c_in, c_out, pool in CONV_LAYERS
            if pool and K.pool_s2d_wgmma_route(c_in, c_out, 7)]
    assert slim == ["conv1"]
    assert not K.pool_s2d_wgmma_route(3, 16, np.full(16, 7))
    convs = _v3_general_convs()
    assert len(convs) == 29
    entry = [c for c in convs if K.entry_conv3x3_route(*c[1:], sw=7)]
    assert [c[0] for c in entry] == [("backbone", "layer_1", "entry", 0)]
    assert entry[0][1:] == (3, 1, 1, 1, 3, 32)
    for c in entry:
        assert not K.conv3x3_wgmma_route(*c[1:6], sw=7)
        assert not K.conv3x3_s2_wgmma_route(*c[1:6], sw=7)
    for k, stride, pad, parts, c_in, c_out in (
            (3, 1, 1, 1, 4, 32), (3, 1, 1, 1, 3, 65), (3, 2, 1, 1, 3, 32),
            (3, 1, 0, 1, 3, 32), (1, 1, 0, 1, 3, 32), (3, 1, 1, 2, 3, 32)):
        assert not K.entry_conv3x3_route(k, stride, pad, parts, c_in, c_out,
                                          7)
    assert K.entry_conv3x3_route(3, 1, 1, 1, 3, 32, np.full(32, 7))
    assert not K.entry_conv3x3_route(3, 1, 1, 1, 3, 32, np.full(31, 7))
    assert not K.entry_conv3x3_route(3, 1, 1, 1, 3, 32,
                                     np.full((2, 32), 7))
    for c_in, c_out in ((5, 16), (3, 33), (16, 32)):
        assert not K.pool_s2d_wgmma_route(c_in, c_out, 7)


def test_slim_pack_conv3x3_packs_conv1_for_k2():
    """``pack_conv3x3`` packs conv1 once for K2 (``s2d_packed``; 10 packs
    with the nine wgmma conv3x3 layers), and ``to`` carries it."""
    m = _slim()
    K.reset_pool_s2d_pack_count()
    K.reset_conv3x3_pack_count()
    m.pack_conv3x3()
    assert K.pool_s2d_pack_count() + K.conv3x3_pack_count() == 10
    assert K.pool_s2d_pack_count() == 1
    w1 = m.w_q["conv1"]
    assert torch.equal(K.unpack_pool_s2d_weights(m.s2d_packed, 3, 16), w1)
    moved = m.to("cpu")
    assert torch.equal(moved.s2d_packed, m.s2d_packed)


def test_int8_forward_hands_the_packed_weights_to_k2(rng, monkeypatch):
    """conv1 on the s2d input gets ``s2d_packed`` from ``int8_forward``,
    so the card's route packs nothing per call; the forward is the same
    integers as on the HWIO weights."""
    m = _slim()
    m.pack_conv3x3()
    seen = []
    plain = K.int8_conv3x3_pool_s2d

    def spy(x2, w_q, b_q, *, packed=None, **kw):
        seen.append(packed)
        return plain(x2, w_q, b_q, packed=packed, **kw)

    monkeypatch.setattr(K, "int8_conv3x3_pool_s2d", spy)
    x = torch.tensor(rng.integers(-128, 128, (1, 32, 32, 3)).astype(np.int8))
    head = tfp.int8_forward(m, tfp.s2d_input(x), input_s2d=True)
    assert len(seen) == 1 and seen[0] is m.s2d_packed
    m.packed = m.s2d_packed = None
    assert torch.equal(tfp.int8_forward(m, tfp.s2d_input(x), input_s2d=True),
                       head)


def test_v3_pack_conv3x3s_packs_the_entry_conv():
    """``pack_conv3x3s`` packs the entry conv once (``entry_packed``)
    beside the 14 wgmma 3x3s, and ``to`` carries it."""
    m = _random_v3()
    K.reset_entry_conv_pack_count()
    K.reset_conv3x3_pack_count()
    m.pack_conv3x3s()
    assert K.entry_conv_pack_count() == 1 == len(m.entry_packed)
    assert K.conv3x3_pack_count() == 14 == len(m.conv_packed)
    (i, wp), = m.entry_packed.items()
    assert i == 0 and wp.shape == (32, 32)
    assert torch.equal(K.unpack_entry_conv_weights(wp, 3), m.w_q[0])
    moved = m.to("cpu")
    assert torch.equal(moved.entry_packed[0], wp)


def test_v3_forward_hands_the_packed_weights_to_the_entry_conv(
        rng, monkeypatch):
    """The entry conv gets its packed weights from ``int8_yolo_v3_forward``
    (no other conv gets the entry form): through ``int8_conv_requant`` on
    the plain walk (``s2d=False``), through ``int8_entry_pair_s2d``, which
    hands them on to ``int8_conv_requant``, with the default fused entry
    pair."""
    m = _random_v3()
    m.pack_conv3x3s()
    seen, pairs = [], []
    plain, plain_pair = K.int8_conv_requant, tfp.int8_entry_pair_s2d

    def spy(x, w_q, b_q, *, packed=None, **kw):
        seen.append((x.shape[-1] if torch.is_tensor(x) else None, packed))
        return plain(x, w_q, b_q, packed=packed, **kw)

    def spy_pair(*args, packed=(None, None), **kw):
        pairs.append(packed)
        return plain_pair(*args, packed=packed, **kw)

    monkeypatch.setattr(K, "int8_conv_requant", spy)
    monkeypatch.setattr(tfp, "int8_entry_pair_s2d", spy_pair)
    x = torch.tensor(rng.integers(-128, 128, (1, 32, 32, 3)).astype(np.int8))
    tv3.int8_yolo_v3_forward(m, x, s2d=False)
    assert seen[0] == (3, m.entry_packed[0])
    assert all(p is not m.entry_packed[0] for _, p in seen[1:])
    seen.clear()
    tv3.int8_yolo_v3_forward(m, x)
    assert len(pairs) == 1 and pairs[0][0] is m.entry_packed[0]
    assert seen[0] == (3, m.entry_packed[0])
    assert all(p is not m.entry_packed[0] for _, p in seen[1:])


def test_cpu_detect_fns_pack_no_entry_conv(rng):
    """The CPU route reads the HWIO weights: neither detect fn packs the
    entry conv or K2, when it takes the model or in a forward."""
    K.reset_entry_conv_pack_count()
    K.reset_pool_s2d_pack_count()
    cfg = get_config("slim_yolo_v2", "mask", input_size=(32, 32), top_k=5)
    x = rng.integers(-128, 128, (1, 32, 32, 3)).astype(np.int8)
    detect = make_int8_detect_fn(_slim(), cfg, input_s2d=True, device="cpu")
    detect(tfp.s2d_input_np(x))
    cfg3 = get_config("yolo_v3", "mask", input_size=(32, 32), top_k=5)
    images = rng.random((1, 32, 32, 3), dtype=np.float32)
    tv3.make_int8_yolo_v3_detect_fn(_random_v3(), cfg3, device="cpu")(images)
    assert K.entry_conv_pack_count() == 0
    assert K.pool_s2d_pack_count() == 0
