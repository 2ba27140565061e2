"""The wgmma conv3x3's slab walk (``csrc/int8_conv3x3_wgmma.cu``, SLAB) on
the CPU, against the JAX package: a torch emulation of the kernel's K
walk over halo slabs of 128 channels, each slab's nine taps before the
next slab's, int32 partials summed in (slab, tap, channel) order from the
packed weights through the kernel's column map (``kcol``: no other
packing), and in a two-part split part 0's partial shifted to the retune
scale once its last slab is done; then the requant chain. Held to the
JAX package's ``fixed_point.int_conv_requant`` at batch 1: yolo_v2's
13² convs ([1,024] and [256, 1,024], cut to C_out 64) and odd 9² planes,
one input scale and two (the split), both roundings, scalar and
per-channel sw (each output channel's float weights scaled by 2^-u before
quantization, so that a walk reading the wrong table entry fails). Also
that the slab walk left the weight packing and the routes as they were.
The kernel itself runs on the card only
(``tests/test_torch_kernels_cuda.py``, ``chip_smoke.py``).

Inputs from ``np.random.default_rng``; every comparison is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolo_tpu.quant import fixed_point as jfp
from yolo_tpu.quant import quantize as jq
from yolo_tpu_torch.kernels import int8_conv as K
from yolo_tpu_torch.quant import fixed_point as fp

torch.set_num_threads(1)

SL = 128  # channels of a halo slab (SLAB_C in csrc/int8_wgmma_conv.cuh)
ROUNDINGS = ["nearest", "floor"]
# (H = W, parts' C_in, C_out): convsets_1.x and convsets_2.0 at 13² with
# C_out cut to 64, and odd 9² planes
SHAPES = [(13, (1024,), 64), (13, (256, 1024), 64), (9, (1024,), 64),
          (9, (128, 1024), 64)]


def kcol(v, s, cins):
    """The packed K column of channel v of slab s's (tap, channel) walk
    (v = tap * SL + channel), as the kernel's producer computes it: a slab
    lies in one part, whose (dy, dx, c) block starts at packed column 9
    C_in0 for part 1."""
    ck = sum(cins)
    if len(cins) == 1:
        return v // SL * ck + s * SL + v % SL
    p1 = s * SL >= cins[0]
    c0 = cins[0] if p1 else 0
    return 9 * c0 + v // SL * (cins[1] if p1 else cins[0]) + s * SL - c0 \
        + v % SL


def slab_partials(x, wp, cins):
    """The kernel's raw int32 partials of each part (two-part: part 0's
    slabs, part 1's slabs): per slab, the halo's nine taps x 128 channels
    (zero outside the image: the pad) against the packed weight columns
    ``kcol`` maps them to, summed slab by slab in int64 and held to int32's
    range, as the kernel's int32 accumulator holds them."""
    b, h, w, ck = x.shape
    xp = torch.nn.functional.pad(x.to(torch.float64), (0, 0, 1, 1, 1, 1))
    wf = wp.to(torch.float64)
    parts = [torch.zeros((b, h, w, wp.shape[0]), dtype=torch.int64)
             for _ in cins]
    seen = []
    for s in range(ck // SL):
        cols = [kcol(v, s, cins) for v in range(9 * SL)]
        seen += cols
        # (tap, channel) of the slab: taps dy, dx outside, channels inside
        a = torch.cat([xp[:, dy:dy + h, dx:dx + w, s * SL:(s + 1) * SL]
                       for dy in range(3) for dx in range(3)], dim=-1)
        p = torch.matmul(a, wf[:, cols].T).to(torch.int64)
        parts[int(s * SL >= cins[0])] += p
    assert sorted(seen) == list(range(9 * ck))  # each column once
    for p in parts:
        assert p.abs().max() < 2 ** 31
    return [p.to(torch.int32) for p in parts]


def column_shift(p, codes, rounding):
    """Each column shifted by its shift-table entry, as the kernel's
    ``column_shift`` applies it (``fixed_point._shift`` of the entry)."""
    out = torch.empty_like(p)
    for u in np.unique(codes):
        cols = torch.as_tensor(np.flatnonzero(codes == u))
        out[..., cols] = fp._shift(p[..., cols], int(u), rounding)
    return out


def slab_walk(xs, sas, w, b, *, sw, sb, sa_out, retune, leaky, rounding):
    """The slab walk's output: its partials, one accumulator where the
    parts take one shift (raw partials summed) or part 0's shifted at the
    part boundary beside part 1's (split), each by its column's table
    entry (``acc_shift_codes``), then the chain after the accumulator
    shift."""
    cins = [x.shape[-1] for x in xs]
    wp = (K.pack_conv3x3_weights(w) if len(cins) == 1
          else K.pack_conv3x3_parts_weights(w, cins))
    parts = slab_partials(torch.cat(xs, dim=-1), wp, cins)
    c_out = w.shape[-1]
    if len(set(sas)) == 1:
        parts, sas = [sum(parts)], sas[:1]
    acc = sum(column_shift(p, K.acc_shift_codes(sw, sa, retune, rounding,
                                                c_out), rounding)
              for p, sa in zip(parts, sas))
    bias = K._bias_at_retune(b, sb, retune, rounding)
    return fp._requant(acc, bias, acc_shift=0, out_shift=retune - sa_out,
                       leaky=leaky, rounding=rounding)


def pc_weights(rng, shape):
    """int8 HWIO weights and their per-channel sw, quantized by the JAX
    package from floats whose output channels are scaled by 2^-u."""
    w = rng.uniform(-0.2, 0.3, shape).astype(np.float32)
    w *= np.exp2(-rng.integers(0, 4, shape[-1])).astype(np.float32)
    w_q, sw = jq.quantize_pow2_np(w, 8, channel_axis=-1)
    sw = np.asarray(sw, np.int32)
    assert len(np.unique(sw)) > 1
    return np.clip(w_q, -128, 127).astype(np.int8), sw


@pytest.mark.parametrize("rounding", ROUNDINGS)
@pytest.mark.parametrize("sw_kind", ["scalar", "per_channel"])
@pytest.mark.parametrize(
    "shape,scales",
    [(s, k) for s in SHAPES for k in ("one", "split")[:len(s[1])]],
    ids=lambda v: (v if isinstance(v, str) else
                   f"{v[0]}-{'+'.join(map(str, v[1]))}"))
def test_slab_walk_matches_jax(shape, scales, sw_kind, rounding):
    """The emulated slab walk == the JAX package's ``int_conv_requant``
    over the same parts at batch 1: one input scale (the raw partials
    summed) or, with two parts, two (the split)."""
    h, cins, c_out = shape
    rng = np.random.default_rng(h * 7 + sum(cins))
    xs = [rng.integers(-128, 128, (1, h, h, c), dtype=np.int8)
          for c in cins]
    if sw_kind == "scalar":
        w = rng.integers(-40, 50, (3, 3, sum(cins), c_out), dtype=np.int8)
        sw = 9
    else:
        w, sw = pc_weights(rng, (3, 3, sum(cins), c_out))
    b = rng.integers(-100, 100, (c_out,)).astype(np.int32)
    sas = [4, 4 if scales == "one" else 2][:len(cins)]
    kw = dict(sw=sw, sb=6, sa_out=2, retune=9, leaky=0.1, rounding=rounding)
    want = jfp.int_conv_requant(
        [(jnp.asarray(x), sa) for x, sa in zip(xs, sas)], jnp.asarray(w),
        jnp.asarray(b), sa_in=None, padding=1, **kw)
    got = slab_walk([torch.tensor(x) for x in xs], sas, torch.tensor(w),
                    torch.tensor(b), **kw)
    assert len(np.unique(np.asarray(want))) > 8  # not a clamped plane
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("cins", [(1024,), (256, 1024), (128, 1024)])
def test_slab_columns_follow_the_packing(cins):
    """The walk reads the packing as it is: slab s's tap t, channel c is
    packed column t C + s 128 + c of its part's (dy, dx, c) block, part
    1's block after part 0's 9 C_in0 columns."""
    for s in range(sum(cins) // SL):
        p1 = len(cins) == 2 and s * SL >= cins[0]
        base, c, c0 = ((9 * cins[0], cins[1], cins[0]) if p1
                       else (0, cins[0], 0))
        for t in (0, 4, 8):
            for ch in (0, 77, SL - 1):
                assert kcol(t * SL + ch, s, cins) == (base + t * c + s * SL
                                                      - c0 + ch)


@pytest.mark.parametrize("cins", [(1024,), (256, 1024), (96, 1024)])
def test_packing_unchanged(rng, cins):
    """``pack_conv3x3_weights`` / ``pack_conv3x3_parts_weights`` as before
    the slab walk: OHWI, [C_out, 9 C_in], each part's block in turn."""
    c_out = 16
    w = torch.tensor(rng.integers(-128, 128, (3, 3, sum(cins), c_out),
                                  dtype=np.int8))

    def ohwi(t):
        return t.permute(3, 0, 1, 2).reshape(c_out, -1)

    if len(cins) == 1:
        wp = K.pack_conv3x3_weights(w)
        assert torch.equal(wp, ohwi(w))
    else:
        wp = K.pack_conv3x3_parts_weights(w, cins)
        assert torch.equal(wp, torch.cat([ohwi(w[:, :, :cins[0]]),
                                          ohwi(w[:, :, cins[0]:])], dim=1))
    assert wp.shape == (c_out, 9 * sum(cins)) and wp.is_contiguous()


@pytest.mark.parametrize("args,kw,want", [
    ((3, 1, 1, 1, 1024, 7), dict(c_out=1024), True),
    ((3, 1, 1, 2, 256, 7), dict(c_out=1024, cins=(256, 1024)), True),
    ((3, 1, 1, 2, 96, 7), dict(c_out=64, cins=(96, 1024)), True),
    ((3, 1, 1, 2, 128, np.zeros(64, np.int32)),
     dict(c_out=64, cins=(128, 1024)), True),
    ((3, 2, 1, 1, 1024, 7), dict(c_out=1024), False),
    ((3, 1, 1, 1, 1000, 7), dict(c_out=1024), False),
], ids=str)
def test_routes_unchanged(args, kw, want):
    """The deep convs keep their routes: the slab walk is a plan of the
    same kernel, not a route of its own (stride 2 and C_in % 32 != 0 take
    other kernels)."""
    assert K.conv3x3_wgmma_route(*args, **kw) is want


@pytest.mark.parametrize("rounding", ROUNDINGS)
def test_plain_route_unchanged_at_the_deep_convs(rounding):
    """On the CPU the deep convs still run the plain version: the two-part
    conv from its packed weights equals the emulated walk (and so the JAX
    package), split and per-channel."""
    rng = np.random.default_rng(5)
    cins, c_out = (256, 1024), 32
    xs = [torch.tensor(rng.integers(-128, 128, (1, 9, 9, c), dtype=np.int8))
          for c in cins]
    w, sw = pc_weights(rng, (3, 3, sum(cins), c_out))
    b = torch.tensor(rng.integers(-100, 100, (c_out,)).astype(np.int32))
    kw = dict(sw=sw, sb=6, sa_out=2, retune=9, leaky=True,
              rounding=rounding)
    wp = K.pack_conv3x3_parts_weights(torch.tensor(w), cins)
    got = K.int8_conv_requant(list(zip(xs, (4, 2))), None, b, packed=wp,
                              sa_in=None, padding=1, **kw)
    want = slab_walk(xs, [4, 2], torch.tensor(w), b, **kw)
    assert torch.equal(got, want)
