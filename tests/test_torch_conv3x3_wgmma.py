"""The wgmma conv3x3 route (``csrc/int8_conv3x3_wgmma.cu``) on the CPU: its
K-major weight form (``pack_conv3x3_weights``) through the plain versions,
against the JAX Pallas ``int8_conv3x3_requant`` in interpret mode (as
tests/test_torch_kernels.py runs it) and against the JAX
``fixed_point.int_conv_requant``; which convs of the two models the route
takes; and that the CPU detect fns pack nothing.
test_torch_kernels_cuda.py holds the kernel against these plain versions
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
from yolo_tpu_torch.quant import int8_yolo_v3 as tv3
from yolo_tpu_torch.quant.convert import int8_model_from_arrays
from yolo_tpu_torch.quant.int8_graph import make_int8_detect_fn

torch.set_num_threads(1)

ROUNDINGS = ["nearest", "floor"]
SHIFTS = dict(sw=8, sb=7, sa_in=4, sa_out=4, retune=11)
# (C_in, C_out, H, W): the widths of slim's conv3_1 / pred and their
# mixes, a square and an odd image
SHAPES = [(32, 35, 8, 8), (32, 64, 9, 7), (64, 35, 9, 7), (64, 64, 8, 8)]


def _case(rng, b, h, w, c_in, c_out):
    """int8 input, asymmetric int8 weights, nonzero int8-valued biases."""
    x = rng.integers(-128, 128, (b, h, w, c_in)).astype(np.int8)
    wq = rng.integers(-30, 40, (3, 3, c_in, c_out)).astype(np.int8)
    bq = rng.integers(-100, 100, (c_out,)).astype(np.int32)
    return x, wq, bq


def _pallas(x, w, b, **kw):
    return np.asarray(jk.int8_conv3x3_requant(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), interpret=True, **kw))


def _packed_plain(x, w, b, **kw):
    """K1's plain route fed only the packed weights."""
    packed = K.pack_conv3x3_weights(torch.tensor(w))
    return K.int8_conv3x3_requant(torch.tensor(x), None, torch.tensor(b),
                                  packed=packed, **kw).numpy()


@pytest.mark.parametrize("c_in,c_out", [(32, 35), (64, 128)])
def test_pack_conv3x3_weights_round_trips(rng, c_in, c_out):
    w = torch.tensor(rng.integers(-30, 40, (3, 3, c_in, c_out))
                     .astype(np.int8))
    K.reset_conv3x3_pack_count()
    wp = K.pack_conv3x3_weights(w)
    assert K.conv3x3_pack_count() == 1
    assert wp.shape == (c_out, 9 * c_in) and wp.is_contiguous()
    # row o, column (dy * 3 + dx) * c_in + ci holds w[dy, dx, ci, o]
    for dy, dx, ci, o in ((0, 0, 0, 0), (2, 1, c_in - 1, 3),
                          (1, 2, 5, c_out - 1)):
        assert wp[o, (dy * 3 + dx) * c_in + ci] == w[dy, dx, ci, o]
    assert torch.equal(K.unpack_conv3x3_weights(wp), w)
    # K4's w2 is the same form, and is not counted as a conv3x3 packing
    w1 = torch.zeros((1, 1, c_out, c_in), dtype=torch.int8)
    assert torch.equal(K.pack_res_block_weights(w1, w)[1], wp)
    assert K.conv3x3_pack_count() == 1
    with pytest.raises(ValueError, match="HWIO"):
        K.pack_conv3x3_weights(w[:1])


@pytest.mark.parametrize("rounding", ROUNDINGS)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "-".join(map(str, s)))
def test_packed_plain_equals_pallas(rng, rounding, shape):
    c_in, c_out, h, w = shape
    x, wq, b = _case(rng, 2, h, w, c_in, c_out)
    kw = dict(SHIFTS, leaky=True, rounding=rounding)
    np.testing.assert_array_equal(_packed_plain(x, wq, b, **kw),
                                  _pallas(x, wq, b, **kw))


@pytest.mark.parametrize("rounding", ROUNDINGS)
@pytest.mark.parametrize("case", ["pred_leaky_off", "out_shift_lt_0"])
def test_packed_plain_equals_pallas_epilogues(rng, rounding, case):
    """slim's pred (256 -> 35 narrowed to 64 -> 35, no activation) and a
    negative output shift (an exact left shift)."""
    x, wq, b = _case(rng, 2, 9, 7, 64, 35)
    kw = dict(SHIFTS, leaky=case != "pred_leaky_off", rounding=rounding)
    if case == "out_shift_lt_0":
        x, wq = x // 16, wq // 8
        kw.update(sa_out=14)
    want = _pallas(x, wq, b, **kw)
    np.testing.assert_array_equal(_packed_plain(x, wq, b, **kw), want)
    if case == "out_shift_lt_0":
        assert want.min() == -128 and want.max() == 127  # values do move


@pytest.mark.parametrize("rounding", ROUNDINGS)
def test_packed_plain_acc_shift_ge_32_follows_fixed_point(rng, rounding):
    """acc_shift = sa_in + sw - retune = 33: the ``fp._shift`` contract (0
    for nearest, v >> 31 for floor), which the Pallas helpers do not
    guard, so the JAX ``int_conv_requant`` is the reference."""
    x, wq, b = _case(rng, 2, 8, 8, 32, 64)
    kw = dict(SHIFTS, sw=40, leaky=True, rounding=rounding)
    want = np.asarray(fp.int_conv_requant(
        jnp.asarray(x), jnp.asarray(wq), jnp.asarray(b), padding=1, **kw))
    np.testing.assert_array_equal(_packed_plain(x, wq, b, **kw), want)


@pytest.mark.parametrize("rounding", ROUNDINGS)
def test_general_conv_packed_plain_equals_jax(rng, rounding):
    """A yolo_v3 head 3x3 (stride 1, pad 1, slope 0.125), narrowed to C_in
    64 -> C_out 128, through ``int8_conv_requant`` fed only the packed
    weights, against the JAX ``fixed_point.int_conv_requant``."""
    x, wq, b = _case(rng, 2, 9, 7, 64, 128)
    kw = dict(sw=7, sb=8, sa_in=3, sa_out=4, retune=10, leaky=True,
              rounding=rounding)
    want = np.asarray(fp.int_conv_requant(
        jnp.asarray(x), jnp.asarray(wq), jnp.asarray(b), padding=1,
        stride=1, **kw))
    packed = K.pack_conv3x3_weights(torch.tensor(wq))
    got = K.int8_conv_requant(torch.tensor(x), None, torch.tensor(b),
                              padding=1, stride=1, packed=packed, **kw)
    np.testing.assert_array_equal(got.numpy(), want)
    hwio = K.int8_conv_requant(torch.tensor(x), torch.tensor(wq),
                               torch.tensor(b), padding=1, **kw)
    assert torch.equal(got, hwio)


def test_route_takes_every_slim_k1_layer():
    """All six layers that run ``int8_conv3x3_requant`` (C_in 32 to 256)
    take the route, with a scalar sw or one of C_out entries; the pooled
    conv1 and conv2 (C_in 3 and 16) would not."""
    layers = CONV_LAYERS + (("pred", 256, 35, False),)
    k1 = [name for name, _, _, pool in layers if not pool]
    assert k1 == ["conv3_1", "conv4_1", "conv5", "conv6", "conv7", "pred"]
    for name, c_in, _, pool in layers:
        want = name in k1 or c_in % 32 == 0
        assert K.conv3x3_wgmma_route(3, 1, 1, 1, c_in, 8) == want, name
    # a per-channel sw is taken where it has one entry per output column
    assert K.conv3x3_wgmma_route(3, 1, 1, 1, 256, np.full(35, 8), c_out=35)
    assert not K.conv3x3_wgmma_route(3, 1, 1, 1, 256, np.full(35, 8),
                                     c_out=36)
    assert not K.conv3x3_wgmma_route(3, 1, 1, 1, 256, np.full(35, 8))
    assert not K.conv3x3_wgmma_route(3, 1, 1, 1, 256, np.full((5, 7), 8),
                                     c_out=35)


def _v3_general_convs():
    """(path, k, stride, padding, parts, C_in) of the 29 convs that
    ``int8_yolo_v3_forward`` runs through ``int8_conv_requant``."""
    prog, specs = tv3._program(), tv3.conv_specs(21)
    out, ci, i, parts = [], 0, 0, 1
    while i < len(prog):
        op = prog[i]
        if op[0] == "push":
            ci, i = ci + 2, i + 4
            continue
        if op[0] == "conv":
            path, k, c_in, _ = specs[ci]
            out.append((path, k, op[2], op[3], parts, c_in))
            ci += 1
        parts = 2 if op[0] == "concat" else 1
        i += 1
    return out


def test_route_takes_the_nine_v3_head_3x3s():
    convs = _v3_general_convs()
    assert len(convs) == 29
    routed = [c[0] for c in convs if K.conv3x3_wgmma_route(*c[1:], sw=7)]
    heads = [(f"conv_set_{s}", j) for s in (3, 2, 1) for j in (1, 3)]
    assert sorted(routed) == sorted(
        heads + [(f"extra_conv_{s}",) for s in (3, 2, 1)])
    kinds = {c[0]: c[1:] for c in convs}
    assert kinds[("backbone", "layer_1", "entry", 0)] == (3, 1, 1, 1, 3)
    for path, (k, stride, pad, parts, c_in) in kinds.items():
        if path not in routed:  # the entry, stride-2, 1x1 and pred convs
            assert c_in == 3 or stride == 2 or k == 1, path
        if parts == 2:
            assert k == 1 and path in (("conv_set_2", 0), ("conv_set_1", 0))


def _zero_v3(pred_out=21):
    specs = tv3.conv_specs(pred_out)
    return tv3.Int8YoloV3(
        spp=False,
        w_q=[torch.zeros((k, k, ci, co), dtype=torch.int8)
             for _, k, ci, co in specs],
        b_q=[torch.zeros(co, dtype=torch.int32) for *_, co in specs],
        sw=[7] * len(specs), sb=[7] * len(specs), sa_in=4,
        tap_sa=[4] * (len(specs) + 23), retune=[10] * len(specs))


def test_v3_pack_conv3x3s_packs_the_nine_head_3x3s():
    """... and the five stride-2 convs of the kernel's stride-2 form: 14 in
    all (test_torch_conv3x3_s2_wgmma.py holds the stride-2 ones)."""
    m = _zero_v3()
    K.reset_conv3x3_pack_count()
    m.pack_conv3x3s()
    assert K.conv3x3_pack_count() == 14 == len(m.conv_packed)
    paths = [p for p, *_ in tv3.conv_specs(21)]
    heads = [i for i in m.conv_packed if paths[i][0] != "backbone"]
    assert len(heads) == 9
    assert {paths[i][0] for i in heads} == {
        "conv_set_3", "conv_set_2", "conv_set_1", "extra_conv_3",
        "extra_conv_2", "extra_conv_1"}
    for i, wp in m.conv_packed.items():
        assert torch.equal(K.unpack_conv3x3_weights(wp), m.w_q[i])


def _slim():
    path = (Path(__file__).resolve().parents[1] / "yolo_tpu_torch" / "data"
            / "slim_int8_416_golden.npz")
    with np.load(path) as z:
        return int8_model_from_arrays({k: z[k] for k in z.files},
                                      device="cpu")


def test_slim_pack_conv3x3_packs_the_six_k1_layers():
    """... and the three K3 layers of the kernel's pooled form: 9 in all
    (test_torch_conv3x3_pool_wgmma.py holds the K3 ones)."""
    m = _slim()
    K.reset_conv3x3_pack_count()
    m.pack_conv3x3()
    assert K.conv3x3_pack_count() == 9
    assert sorted(m.packed) == sorted(
        ["conv3_1", "conv4_1", "conv5", "conv6", "conv7", "pred",
         "conv2", "conv3_2", "conv4_2"])
    moved = m.to("cpu")
    assert sorted(moved.packed) == sorted(m.packed)
    assert all(torch.equal(moved.packed[k], m.packed[k]) for k in m.packed)


def test_cpu_detect_fns_pack_nothing(rng):
    """The CPU route reads the HWIO weights: neither detect fn packs, when
    it takes the model or in a forward."""
    cfg = get_config("slim_yolo_v2", "mask", input_size=(32, 32), top_k=5)
    images = rng.random((1, 32, 32, 3), dtype=np.float32)
    K.reset_conv3x3_pack_count()
    K.reset_res_block_pack_count()
    detect = make_int8_detect_fn(_slim(), cfg, device="cpu")
    detect(images)
    cfg3 = get_config("yolo_v3", "mask", input_size=(32, 32), top_k=5)
    tv3.make_int8_yolo_v3_detect_fn(_zero_v3(), cfg3, device="cpu")(images)
    assert K.conv3x3_pack_count() == 0
    assert K.res_block_pack_count() == 0
