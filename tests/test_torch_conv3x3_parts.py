"""The two-part form of the wgmma conv3x3 kernel's surroundings and tiny's
fused conv_2 + pool, on the CPU against the JAX package: the parts'
weight packing (``pack_conv3x3_parts_weights``) and its inverse, the
route table for one and two parts by channel counts and sw shape, the
general conv over two parts given only the packed weights, and conv_2
with its pool as one ``int8_conv3x3_im2col(pool=True)`` call at slope
0.1 against the JAX package's conv then ``int_maxpool``. The kernel
itself runs on the card only (``tests/test_torch_kernels_cuda.py``,
``chip_smoke.py``).

Inputs from ``np.random.default_rng``; asymmetric weights; per-channel
sw tables of several values (each output channel's float weights scaled
by 2^-u, u in {0..3}, before quantization), so that a kernel reading
only sw[0] would fail. Every comparison is exact (integers).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolo_tpu.quant import fixed_point as jfp
from yolo_tpu.quant import quantize as jq
from yolo_tpu_torch.kernels import int8_conv as K

torch.set_num_threads(1)

ROUNDINGS = ["nearest", "floor"]


def pc_weights(rng, shape):
    """int8 HWIO weights and their per-channel sw, quantized by the JAX
    package from floats whose output channels are scaled by 2^-u."""
    w = rng.uniform(-0.2, 0.3, shape).astype(np.float32)
    w *= np.exp2(-rng.integers(0, 4, shape[-1])).astype(np.float32)
    w_q, sw = jq.quantize_pow2_np(w, 8, channel_axis=-1)
    sw = np.asarray(sw, np.int32)
    assert len(np.unique(sw)) > 1
    return np.clip(w_q, -128, 127).astype(np.int8), sw


@pytest.mark.parametrize("cins", [(256, 128), (32, 96), (64, 64)])
def test_parts_pack_round_trips(rng, cins):
    """[C_out, 9 C_in0 + 9 C_in1]: part 0's (dy, dx, c) block, then part
    1's; the unpack gives the HWIO weights back."""
    c_out = 35
    w = torch.tensor(rng.integers(-128, 128, (3, 3, sum(cins), c_out),
                                  dtype=np.int8))
    K.reset_conv3x3_parts_pack_count()
    wp = K.pack_conv3x3_parts_weights(w, cins)
    assert K.conv3x3_parts_pack_count() == 1
    assert wp.shape == (c_out, 9 * sum(cins)) and wp.is_contiguous()
    k0 = 9 * cins[0]
    assert torch.equal(wp[:, :k0], K.pack_conv3x3_weights(w[:, :, :cins[0]]))
    assert torch.equal(wp[:, k0:], K.pack_conv3x3_weights(w[:, :, cins[0]:]))
    # tap (dy, dx) = (1, 2), channel c of part 1
    dy, dx, c = 1, 2, cins[1] - 1
    assert torch.equal(wp[:, k0 + (dy * 3 + dx) * cins[1] + c],
                       w[dy, dx, cins[0] + c])
    assert torch.equal(K.unpack_conv3x3_parts_weights(wp, cins), w)
    assert torch.equal(K._hwio_parts(wp, cins), w)


@pytest.mark.parametrize("cins,w_shape", [
    ((48, 16), (3, 3, 64, 8)), ((256, 128), (3, 3, 256, 8)),
    ((256,), (3, 3, 256, 8)), ((32, 32), (1, 1, 64, 8))])
def test_parts_pack_refuses(cins, w_shape):
    with pytest.raises(ValueError, match="two-part 3x3 weights"):
        K.pack_conv3x3_parts_weights(torch.zeros(w_shape, dtype=torch.int8),
                                     cins)


PC = np.zeros(35, np.int32)  # a per-channel sw of 35 entries


@pytest.mark.parametrize("args,kw,want", [
    ((3, 1, 1, 1, 32, 7), {}, True),
    ((3, 1, 1, 1, 16, 7), {}, False),
    ((3, 1, 1, 1, 64, PC), dict(c_out=35), True),
    ((3, 1, 1, 1, 64, PC), dict(c_out=36), False),
    ((3, 1, 1, 2, 256, 7), dict(cins=(256, 128)), True),
    ((3, 1, 1, 2, 256, PC), dict(c_out=35, cins=(256, 1024)), True),
    ((3, 1, 1, 2, 256, PC), dict(c_out=34, cins=(256, 1024)), False),
    ((3, 1, 1, 2, 256, 7), {}, False),  # two parts need their channels
    ((3, 1, 1, 2, 48, 7), dict(cins=(48, 16)), False),
    ((3, 1, 1, 2, 256, 7), dict(cins=(256, 100)), False),
    ((3, 1, 1, 2, 256, 7), dict(cins=(128, 256)), False),  # c_in: part 0
    ((3, 1, 1, 3, 32, 7), dict(cins=(32, 32, 32)), False),
    ((3, 2, 1, 2, 256, 7), dict(cins=(256, 128)), False),
    ((1, 1, 0, 2, 256, 7), dict(cins=(256, 128)), False),
    ((3, 1, 0, 2, 256, 7), dict(cins=(256, 128)), False),
], ids=lambda v: str(v) if not isinstance(v, np.ndarray) else "pc")
def test_route_table(args, kw, want):
    """One part of C_in % 32 == 0 or two (each % 32 == 0, their channels
    given), a 3x3 at stride 1, pad 1, a scalar sw or one of C_out
    entries."""
    assert K.conv3x3_wgmma_route(*args, **kw) is want


@pytest.mark.parametrize("rounding", ROUNDINGS)
@pytest.mark.parametrize("sw_kind", ["scalar", "per_channel"])
@pytest.mark.parametrize("sas", [(4, 4), (4, 2)], ids=["equal", "unequal"])
def test_two_part_conv_from_packed_weights_matches_jax(rng, sas, sw_kind,
                                                       rounding):
    """The general conv over two parts given only the parts' packed
    weights (the plain route on the CPU): the JAX package's
    ``int_conv_requant`` over the same parts, at equal part scales (the
    raw partials summed before one shift) and unequal ones (each shifted
    on its own), slope 0.1."""
    cins, c_out = (64, 32), 40
    xs = [rng.integers(-128, 128, (2, 6, 7, c), dtype=np.int8)
          for c in cins]
    if sw_kind == "scalar":
        w = rng.integers(-60, 70, (3, 3, sum(cins), c_out), dtype=np.int8)
        sw = 7
    else:
        w, sw = pc_weights(rng, (3, 3, sum(cins), c_out))
    b = rng.integers(-100, 100, (c_out,)).astype(np.int32)
    kw = dict(sw=sw, sb=6, sa_in=None, sa_out=3, retune=9, padding=1,
              leaky=0.1, rounding=rounding)
    want = jfp.int_conv_requant(
        [(jnp.asarray(x), sa) for x, sa in zip(xs, sas)], jnp.asarray(w),
        jnp.asarray(b), **kw)
    wp = K.pack_conv3x3_parts_weights(torch.tensor(w), cins)
    got = K.int8_conv_requant(
        [(torch.tensor(x), sa) for x, sa in zip(xs, sas)], None,
        torch.tensor(b), packed=wp, **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_two_part_launch_checks_before_the_card():
    """The two-part form's launcher refuses parts no route takes (48 +
    16 channels run the mma.sync conv) and a per-channel sw of the wrong
    length, before it needs the built kernels."""
    x0 = torch.zeros((1, 4, 4, 48), dtype=torch.int8)
    x1 = torch.zeros((1, 4, 4, 16), dtype=torch.int8)
    w = torch.zeros((3, 3, 64, 8), dtype=torch.int8)
    b = torch.zeros(8, dtype=torch.int32)
    kw = dict(sb=0, sa_out=0, retune=0, leaky=True, rounding="nearest")
    with pytest.raises(ValueError, match="two parts of C_in % 32"):
        K._launch_conv3x3_parts_wgmma([(x0, 1), (x1, 1)], None, b,
                                      torch.zeros((8, 576),
                                                  dtype=torch.int8),
                                      sw=7, **kw)
    x0 = torch.zeros((1, 4, 4, 32), dtype=torch.int8)
    x1 = torch.zeros((1, 4, 4, 32), dtype=torch.int8)
    with pytest.raises(ValueError, match="two parts of C_in % 32"):
        K._launch_conv3x3_parts_wgmma([(x0, 1), (x1, 1)], w, b, None,
                                      sw=np.zeros(7, np.int32), **kw)


@pytest.mark.parametrize("rounding", ROUNDINGS)
@pytest.mark.parametrize("sw_kind", ["scalar", "per_channel"])
def test_fused_conv2_pool_matches_jax(rng, sw_kind, rounding):
    """tiny_yolo_v3's conv_2 (3x3, 16 -> 32, slope 0.1) and its 2x2/2
    pool as one ``int8_conv3x3_im2col(pool=True)`` call (the pooled form
    on the card; its plain version here) at 64²: the JAX package's
    ``int_conv_requant`` then ``int_maxpool``. The per-channel sw holds
    several values: the same call at sw[0] for every channel differs."""
    x = rng.integers(-128, 128, (2, 64, 64, 16), dtype=np.int8)
    if sw_kind == "scalar":
        w = rng.integers(-90, 120, (3, 3, 16, 32), dtype=np.int8)
        sw = 8
    else:
        w, sw = pc_weights(rng, (3, 3, 16, 32))
    b = rng.integers(-100, 100, (32,)).astype(np.int32)
    kw = dict(sw=sw, sb=6, sa_in=4, sa_out=3, retune=10, leaky=0.1,
              rounding=rounding)
    want = np.asarray(jfp.int_maxpool(jfp.int_conv_requant(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), padding=1, **kw)))
    got = K.int8_conv3x3_im2col(torch.tensor(x), torch.tensor(w),
                                torch.tensor(b), pool=True, **kw)
    assert got.shape == (2, 32, 32, 32)
    np.testing.assert_array_equal(got.numpy(), want)
    wp = K.pack_conv3x3_weights(torch.tensor(w))
    packed = K.int8_conv3x3_im2col(torch.tensor(x), None, torch.tensor(b),
                                   pool=True, packed=wp, **kw)
    np.testing.assert_array_equal(packed.numpy(), want)
    if sw_kind == "per_channel":
        first = K.int8_conv3x3_im2col(torch.tensor(x), torch.tensor(w),
                                      torch.tensor(b), pool=True,
                                      **dict(kw, sw=int(sw[0])))
        assert not np.array_equal(first.numpy(), want)


def test_fused_pool_plain_checks_the_slope():
    x = torch.zeros((1, 4, 4, 16), dtype=torch.int8)
    w = torch.zeros((3, 3, 16, 8), dtype=torch.int8)
    b = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="slope must lie in"):
        K.int8_conv3x3_im2col_plain(x, w, b, sw=1, sb=0, sa_in=0, sa_out=0,
                                    retune=0, leaky=1.5, pool=True)
