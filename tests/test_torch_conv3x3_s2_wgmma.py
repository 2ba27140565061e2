"""The wgmma conv3x3 kernel's stride-2 form (``csrc/int8_conv3x3_wgmma.cu``,
yolo_v3's five downsampling convs on the card: ``conv3x3_s2_wgmma_route``)
on the CPU: its packed weights through the plain stride-2 conv, against
the JAX ``fixed_point.int_conv_requant`` (XLA's integer conv, no Pallas
kernel) on odd and even images; which v3 convs the route takes; that
``Int8YoloV3.pack_conv3x3s`` packs them beside the head's 3x3s and that
``int8_yolo_v3_forward`` hands them over; and that the CPU detect fn
packs nothing. test_torch_kernels_cuda.py holds the kernel against these
plain versions on the card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolo_tpu.quant import fixed_point as fp
from yolo_tpu_torch.config import get_config
from yolo_tpu_torch.kernels import int8_conv as K
from yolo_tpu_torch.quant import fixed_point as tfp
from yolo_tpu_torch.quant import int8_yolo_v3 as tv3

torch.set_num_threads(1)

ROUNDINGS = ["nearest", "floor"]
SHIFTS = dict(sw=8, sb=7, sa_in=4, sa_out=4, retune=11)
# (C_in, C_out, H, W): darknet53's first two downsampling widths on an even
# and an odd image, and C_out 35 (one masked 64-column tile) on an odd one
SHAPES = [(32, 64, 8, 8), (64, 128, 9, 7), (32, 35, 7, 9)]
# the epilogue cases: the darknet slope 0.1 (Q16), no activation, a
# negative output shift (an exact left shift), an accumulator shift >= 32
CASES = {
    "slope_0.1": dict(SHIFTS, leaky=0.1),
    "leaky_off": dict(SHIFTS, leaky=False),
    "out_shift_lt_0": dict(SHIFTS, sa_out=14, leaky=0.1),
    "acc_shift_ge_32": dict(SHIFTS, sw=40, leaky=0.1),
}


# darknet53's downsampling convs: layer_1's second entry conv (after the
# C_in = 3 one), the only entry conv of layers 2-5
S2_PATHS = [("backbone", "layer_1", "entry", 1)] + [
    ("backbone", f"layer_{i}", "entry", 0) for i in range(2, 6)]


def _case(rng, b, h, w, c_in, c_out):
    """int8 input, asymmetric int8 weights, nonzero int8-valued biases."""
    x = rng.integers(-128, 128, (b, h, w, c_in)).astype(np.int8)
    wq = rng.integers(-30, 40, (3, 3, c_in, c_out)).astype(np.int8)
    bq = rng.integers(-100, 100, (c_out,)).astype(np.int32)
    return x, wq, bq


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("rounding", ROUNDINGS)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "-".join(map(str, s)))
def test_packed_plain_equals_jax(rng, case, rounding, shape):
    """``int8_conv_requant`` at stride 2, pad 1, fed only the packed
    weights, is exactly the JAX ``int_conv_requant``."""
    c_in, c_out, h, w = shape
    x, wq, b = _case(rng, 2, h, w, c_in, c_out)
    if case == "out_shift_lt_0":
        x, wq = x // 16, wq // 8
    kw = dict(CASES[case], rounding=rounding)
    want = np.asarray(fp.int_conv_requant(
        jnp.asarray(x), jnp.asarray(wq), jnp.asarray(b), padding=1,
        stride=2, **kw))
    assert want.shape == (2, (h + 1) // 2, (w + 1) // 2, c_out)
    packed = K.pack_conv3x3_weights(torch.tensor(wq))
    got = K.int8_conv_requant(torch.tensor(x), None, torch.tensor(b),
                              padding=1, stride=2, packed=packed, **kw)
    np.testing.assert_array_equal(got.numpy(), want)
    hwio = K.int8_conv_requant(torch.tensor(x), torch.tensor(wq),
                               torch.tensor(b), padding=1, stride=2, **kw)
    assert torch.equal(got, hwio)
    assert len(np.unique(want)) > 10  # the output does spread


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


def test_route_takes_the_five_v3_stride2_convs():
    """Exactly darknet53's five downsampling convs (C_in 32 to 512) take
    the stride-2 route, and no conv takes both routes."""
    convs = _v3_general_convs()
    s2 = [c for c in convs if K.conv3x3_s2_wgmma_route(*c[1:], sw=7)]
    assert [c[0] for c in s2] == S2_PATHS
    assert [c[5] for c in s2] == [32, 64, 128, 256, 512]
    assert all(c[1:5] == (3, 2, 1, 1) for c in s2)
    s1 = [c for c in convs if K.conv3x3_wgmma_route(*c[1:], sw=7)]
    assert len(s1) == 9 and not set(map(tuple, s1)) & set(map(tuple, s2))
    for k, stride, pad, parts, c_in in ((3, 2, 1, 1, 48), (3, 2, 0, 1, 32),
                                        (1, 2, 1, 1, 32), (3, 2, 1, 2, 64),
                                        (3, 1, 1, 1, 64), (3, 2, 1, 1, 3)):
        assert not K.conv3x3_s2_wgmma_route(k, stride, pad, parts, c_in, 7)
    assert not K.conv3x3_s2_wgmma_route(3, 2, 1, 1, 64, np.full(128, 7))


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


def test_v3_pack_conv3x3s_packs_the_stride2_convs():
    """14 packed at setup: the head's nine 3x3s and the five stride-2
    convs, each round-tripping to its HWIO weights."""
    m = _random_v3()
    K.reset_conv3x3_pack_count()
    m.pack_conv3x3s()
    assert K.conv3x3_pack_count() == 14 == len(m.conv_packed)
    paths = [p for p, *_ in tv3.conv_specs(21)]
    s2 = {i for i in m.conv_packed if paths[i][0] == "backbone"}
    assert [paths[i] for i in sorted(s2)] == S2_PATHS
    for i, wp in m.conv_packed.items():
        c_in = m.w_q[i].shape[2]
        assert wp.shape == (m.w_q[i].shape[3], 9 * c_in)
        assert torch.equal(K.unpack_conv3x3_weights(wp, c_in), m.w_q[i])


def test_v3_forward_hands_the_packed_weights_to_the_stride2_convs(
        rng, monkeypatch):
    """Each stride-2 conv gets its packed weights from
    ``int8_yolo_v3_forward``, so the card's route packs nothing per call:
    on the plain walk (``s2d=False``) all five through
    ``int8_conv_requant``; with the default fused entry pair the first
    through ``int8_entry_pair_s2d``, which hands them on to
    ``int8_conv_requant``."""
    m = _random_v3()
    m.pack_conv3x3s()
    seen, pairs = [], []
    plain, plain_pair = K.int8_conv_requant, tfp.int8_entry_pair_s2d

    def spy(x, w_q, b_q, *, packed=None, stride=1, **kw):
        if stride == 2:
            seen.append((x.shape, packed))
        return plain(x, w_q, b_q, packed=packed, stride=stride, **kw)

    def spy_pair(*args, packed=(None, None), **kw):
        pairs.append(packed)
        return plain_pair(*args, packed=packed, **kw)

    monkeypatch.setattr(K, "int8_conv_requant", spy)
    monkeypatch.setattr(tfp, "int8_entry_pair_s2d", spy_pair)
    x = torch.tensor(rng.integers(-128, 128, (1, 32, 32, 3)).astype(np.int8))
    tv3.int8_yolo_v3_forward(m, x, s2d=False)
    paths = [p for p, *_ in tv3.conv_specs(21)]
    want = [m.conv_packed[i] for i in sorted(m.conv_packed)
            if paths[i][0] == "backbone"]
    assert [s[-1] for s, _ in seen] == [32, 64, 128, 256, 512]
    assert [s[1] for s, _ in seen] == [32, 16, 8, 4, 2]
    assert all(p is q for (_, p), q in zip(seen, want))
    assert pairs == []
    seen.clear()
    tv3.int8_yolo_v3_forward(m, x)
    assert [s[-1] for s, _ in seen] == [32, 64, 128, 256, 512]
    assert all(p is q for (_, p), q in zip(seen, want))
    assert len(pairs) == 1 and pairs[0][1] is want[0]


def test_cpu_v3_detect_fn_packs_nothing(rng):
    """The CPU route reads the HWIO weights: the v3 detect fn packs
    nothing, when it takes the model or in a forward."""
    cfg = get_config("yolo_v3", "mask", input_size=(32, 32), top_k=5)
    images = rng.random((1, 32, 32, 3), dtype=np.float32)
    K.reset_conv3x3_pack_count()
    detect = tv3.make_int8_yolo_v3_detect_fn(_random_v3(), cfg, device="cpu")
    assert K.conv3x3_pack_count() == 0
    detect(images)
    assert K.conv3x3_pack_count() == 0


def test_stride2_plain_output_size_on_odd_images(rng):
    """(H + 1) // 2 x (W + 1) // 2 outputs, as XLA's padding-1 stride-2
    conv gives, for odd and even sizes down to 1 x 1."""
    for h, w in ((1, 1), (2, 3), (5, 4), (13, 13)):
        x, wq, b = _case(rng, 1, h, w, 32, 8)
        got = K.int8_conv_requant(torch.tensor(x), torch.tensor(wq),
                                  torch.tensor(b), padding=1, stride=2,
                                  **SHIFTS)
        assert got.shape == (1, (h + 1) // 2, (w + 1) // 2, 8)
        assert tfp.INT8_MIN <= int(got.min()) <= int(got.max()) <= 127
