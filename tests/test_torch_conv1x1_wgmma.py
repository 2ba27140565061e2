"""The wgmma 1x1 kernel (``csrc/int8_conv1x1_wgmma.cu``, yolo_v3's fourteen
1x1 convs on the card: ``conv1x1_wgmma_route``) on the CPU: its packed
weights through the plain conv, against the JAX
``fixed_point.int_conv_requant`` (XLA's integer conv, no Pallas kernel)
for one part and for two-part concats at equal and at distinct part
scales, C_out 21, every slope and shift form and both roundings; which v3
convs the route takes; that ``Int8YoloV3.pack_conv3x3s`` packs the
fourteen once, that ``to`` carries them and ``int8_yolo_v3_forward``
hands them over; and that the CPU detect fn packs nothing.
test_torch_kernels_cuda.py holds the kernel against these plain versions
on the card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolo_tpu.quant import fixed_point as fp
from yolo_tpu_torch.config import get_config
from yolo_tpu_torch.kernels import int8_conv as K
from yolo_tpu_torch.quant import int8_yolo_v3 as tv3

torch.set_num_threads(1)

ROUNDINGS = ["nearest", "floor"]
SHIFTS = dict(sw=8, sb=7, sa_out=4, retune=11)
# (C_in parts, C_out, H, W, part scales): one part; a concat whose parts
# share a scale (one accumulator) and one whose parts do not (each
# partial shifted on its own); C_out 21, the preds' width
SHAPES = {
    "one_part": ((32,), 64, 5, 7, (4,)),
    "concat_equal": ((48, 16), 24, 4, 5, (4, 4)),
    "concat_distinct": ((32, 64), 40, 3, 6, (4, 6)),
    "pred_c21": ((64,), 21, 3, 3, (3,)),
}
# the epilogue cases: the head's slope 0.125, the darknet slope 0.1 (Q16),
# no activation (the preds), a negative output shift, an accumulator
# shift >= 32
CASES = {
    "leaky_true": dict(SHIFTS, leaky=True),
    "slope_0.1": dict(SHIFTS, leaky=0.1),
    "leaky_off": dict(SHIFTS, leaky=False),
    "out_shift_lt_0": dict(SHIFTS, sa_out=14, leaky=True),
    "acc_shift_ge_32": dict(SHIFTS, sw=40, leaky=True),
}
# yolo_v3's fourteen 1x1s, in program order
V3_1X1_PATHS = [("conv_set_3", 0), ("conv_set_3", 2), ("conv_set_3", 4),
                ("conv_1x1_3",), ("conv_set_2", 0), ("conv_set_2", 2),
                ("conv_set_2", 4), ("conv_1x1_2",), ("conv_set_1", 0),
                ("conv_set_1", 2), ("conv_set_1", 4), ("pred_3",),
                ("pred_2",), ("pred_1",)]


def _case(rng, cins, c_out, h, w, b=2):
    """int8 parts, asymmetric int8 1x1 weights, nonzero biases."""
    xs = [rng.integers(-128, 128, (b, h, w, c)).astype(np.int8)
          for c in cins]
    wq = rng.integers(-30, 40, (1, 1, sum(cins), c_out)).astype(np.int8)
    bq = rng.integers(-100, 100, (c_out,)).astype(np.int32)
    return xs, wq, bq


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("rounding", ROUNDINGS)
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_packed_plain_equals_jax(rng, case, rounding, shape):
    """``int8_conv_requant`` on a 1x1, fed only the packed weights, is
    exactly the JAX ``int_conv_requant``, concat inputs included."""
    cins, c_out, h, w, sas = SHAPES[shape]
    xs, wq, b = _case(rng, cins, c_out, h, w)
    if case == "out_shift_lt_0":
        xs, wq = [x // 16 for x in xs], wq // 8
    kw = dict(CASES[case], rounding=rounding)
    parts = list(zip(xs, sas))
    want = np.asarray(fp.int_conv_requant(
        [(jnp.asarray(x), sa) for x, sa in parts] if len(xs) == 2
        else jnp.asarray(xs[0]), jnp.asarray(wq), jnp.asarray(b),
        sa_in=sas[0], **kw))
    assert want.shape == (2, h, w, c_out)
    tparts = [(torch.tensor(x), sa) for x, sa in parts]
    packed = K.pack_conv1x1_weights(torch.tensor(wq))
    got = K.int8_conv_requant(tparts, None, torch.tensor(b), sa_in=None,
                              packed=packed, **kw)
    np.testing.assert_array_equal(got.numpy(), want)
    hwio = K.int8_conv_requant(tparts, torch.tensor(wq), torch.tensor(b),
                               sa_in=None, **kw)
    assert torch.equal(got, hwio)
    # the output does spread (where the inputs are not scaled down to keep
    # a left shift in range, and where the accumulator is not shifted out)
    if case not in ("acc_shift_ge_32", "out_shift_lt_0"):
        assert len(np.unique(want)) > 10


@pytest.mark.parametrize("c_in,c_out", [(16, 24), (1024, 512), (768, 256),
                                        (256, 21)])
def test_pack_round_trips(rng, c_in, c_out):
    """The packed form is [C_out, C_in], K-major and contiguous, and
    unpacks to the HWIO weights."""
    w = torch.tensor(rng.integers(-128, 128, (1, 1, c_in, c_out))
                     .astype(np.int8))
    K.reset_conv1x1_pack_count()
    wp = K.pack_conv1x1_weights(w)
    assert K.conv1x1_pack_count() == 1
    assert wp.shape == (c_out, c_in) and wp.is_contiguous()
    assert torch.equal(wp[:, 5 % c_in], w[0, 0, 5 % c_in])
    assert torch.equal(K.unpack_conv1x1_weights(wp), w)
    with pytest.raises(ValueError, match="1x1 weights"):
        K.pack_conv1x1_weights(w.expand(3, 3, c_in, c_out))


def test_packed_forms_tell_their_kernel_size():
    """A packed weight tensor alone says whether it is a 1x1's (one column
    per input channel), the entry conv's or a wgmma 3x3's."""
    w1 = torch.ones((1, 1, 32, 8), dtype=torch.int8)
    w3 = torch.ones((3, 3, 32, 8), dtype=torch.int8)
    we = torch.ones((3, 3, 3, 8), dtype=torch.int8)
    for w, packed, c_in in ((w1, K.pack_conv1x1_weights(w1), 32),
                            (w3, K.pack_conv3x3_weights(w3), 32),
                            (we, K.pack_entry_conv_weights(we), 3)):
        assert K._kernel_size(None, packed, c_in) == w.shape[0]
        assert K._kernel_size(w, packed, c_in) == w.shape[0]
        assert torch.equal(K._hwio(None, packed, c_in), w)


def test_plain_conv_reads_packed_weights(rng):
    """``int8_conv_requant_plain`` given only the packed weights equals it
    given the HWIO ones, for a concat input."""
    xs, wq, b = _case(rng, (16, 32), 24, 4, 3)
    parts = [(torch.tensor(x), sa) for x, sa in zip(xs, (5, 3))]
    kw = dict(SHIFTS, leaky=0.1, rounding="nearest", sa_in=None)
    want = K.int8_conv_requant_plain(parts, torch.tensor(wq),
                                     torch.tensor(b), **kw)
    got = K.int8_conv_requant_plain(
        parts, None, torch.tensor(b),
        packed=K.pack_conv1x1_weights(torch.tensor(wq)), **kw)
    assert torch.equal(got, want)


def _v3_general_convs():
    """(path, k, stride, padding, C_in parts) of the 29 convs that
    ``int8_yolo_v3_forward`` runs through ``int8_conv_requant``."""
    prog, specs = tv3._program(), tv3.conv_specs(21)
    out, ci, i, c, slots, cins = [], 0, 0, 3, {}, None
    while i < len(prog):
        op = prog[i]
        if op[0] == "push":
            ci, i = ci + 2, i + 4
            continue
        if op[0] == "conv":
            path, k, c_in, c_out = specs[ci]
            out.append((path, k, op[2], op[3], cins or (c_in,)))
            c, ci = c_out, ci + 1
        elif op[0] == "save":
            slots[op[1]] = c
        elif op[0] == "load":
            c = slots[op[1]]
        cins = (slots[op[1]], c) if op[0] == "concat" else None
        i += 1
    return out


def test_route_takes_exactly_the_fourteen_v3_1x1s():
    """The fourteen 1x1s (the two concats as 512 + 256 and 256 + 128) take
    the route; no other v3 conv does, and no conv takes it beside another
    wgmma route."""
    convs = _v3_general_convs()
    assert len(convs) == 29
    taken = [c for c in convs
             if K.conv1x1_wgmma_route(*c[1:4], len(c[4]), c[4], 7)]
    assert [c[0] for c in taken] == V3_1X1_PATHS
    assert [c[4] for c in taken if len(c[4]) == 2] == [(512, 256),
                                                       (256, 128)]
    for path, k, stride, pad, cins in taken:
        shape = (k, stride, pad, len(cins), cins[0], 7)
        assert not (K.conv3x3_wgmma_route(*shape)
                    or K.conv3x3_s2_wgmma_route(*shape)
                    or K.entry_conv3x3_route(*shape[:5], 32, 7))
    for k, stride, pad, cins in ((1, 1, 1, (16,)), (1, 2, 0, (64,)),
                                 (3, 1, 1, (64,)), (1, 1, 0, (24,)),
                                 (1, 1, 0, (512, 8)), (1, 1, 0, (16,) * 3),
                                 (1, 1, 0, (2048, 2064)), (1, 1, 0, ())):
        assert not K.conv1x1_wgmma_route(k, stride, pad, len(cins), cins, 7)
    assert K.conv1x1_wgmma_route(1, 1, 0, 2, (2048, 2048), 7)
    assert not K.conv1x1_wgmma_route(1, 1, 0, 1, (64,), np.full(8, 7))


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


def test_v3_pack_conv3x3s_packs_the_fourteen_1x1s():
    """14 packed once at setup, beside the 14 wgmma 3x3s and the entry
    conv, each round-tripping to its HWIO weights; ``to`` carries them."""
    m = _random_v3()
    K.reset_conv1x1_pack_count()
    K.reset_conv3x3_pack_count()
    m.pack_conv3x3s()
    assert K.conv1x1_pack_count() == 14 == len(m.conv1x1_packed)
    assert K.conv3x3_pack_count() == 14 and len(m.entry_packed) == 1
    paths = [p for p, *_ in tv3.conv_specs(21)]
    assert [paths[i] for i in sorted(m.conv1x1_packed)] == V3_1X1_PATHS
    for i, wp in m.conv1x1_packed.items():
        assert wp.shape == (m.w_q[i].shape[3], m.w_q[i].shape[2])
        assert torch.equal(K.unpack_conv1x1_weights(wp), m.w_q[i])
        assert m.packed_weights(i) is wp
    moved = m.to("cpu")
    assert sorted(moved.conv1x1_packed) == sorted(m.conv1x1_packed)
    assert all(moved.conv1x1_packed[i] is wp  # no copy on the same device
               for i, wp in m.conv1x1_packed.items())
    assert K.conv1x1_pack_count() == 14
    assert tv3.Int8YoloV3(**{**vars(m), "conv1x1_packed": None}
                          ).to("cpu").conv1x1_packed is None


def test_v3_forward_hands_the_packed_weights_to_the_1x1s(rng, monkeypatch):
    """Each 1x1 gets its packed weights from ``int8_yolo_v3_forward`` (the
    concats as two parts), so the card's route packs nothing per call."""
    m = _random_v3()
    m.pack_conv3x3s()
    seen = []
    plain = K.int8_conv_requant

    def spy(x, w_q, b_q, *, packed=None, **kw):
        if w_q.shape[0] == 1:
            parts = x if isinstance(x, list) else [(x, None)]
            seen.append(([t.shape[-1] for t, _ in parts], packed))
        return plain(x, w_q, b_q, packed=packed, **kw)

    monkeypatch.setattr(K, "int8_conv_requant", spy)
    x = torch.tensor(rng.integers(-128, 128, (1, 32, 32, 3)).astype(np.int8))
    K.reset_conv1x1_pack_count()
    tv3.int8_yolo_v3_forward(m, x)
    assert K.conv1x1_pack_count() == 0
    want = [m.conv1x1_packed[i] for i in sorted(m.conv1x1_packed)]
    assert len(seen) == 14
    assert all(p is q for (_, p), q in zip(seen, want))
    assert [c for c, _ in seen if len(c) == 2] == [[512, 256], [256, 128]]


def test_cpu_v3_detect_fn_packs_no_1x1(rng):
    """The CPU route reads the HWIO weights: the v3 detect fn packs no
    1x1, when it takes the model or in a forward."""
    cfg = get_config("yolo_v3", "mask", input_size=(32, 32), top_k=5)
    images = rng.random((1, 32, 32, 3), dtype=np.float32)
    K.reset_conv1x1_pack_count()
    detect = tv3.make_int8_yolo_v3_detect_fn(_random_v3(), cfg, device="cpu")
    assert K.conv1x1_pack_count() == 0
    detect(images)
    assert K.conv1x1_pack_count() == 0
