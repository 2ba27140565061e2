"""The fused residual-block kernel's plain version (K4) against the JAX
package: against the Pallas ``int8_res_block`` in interpret mode at its
hard-wired slope 0.125 (the shapes of tests/test_kernels.py), and against
the JAX ``int_conv_requant`` chain at the darknet53 slope 0.1, which the
Pallas kernel does not take, also with a per-channel sw in both convs;
plus the int8 GEMM probe's plain version (K5).
test_torch_kernels_cuda.py holds the CUDA kernels against these plain
versions on the card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolo_tpu.kernels.int8_conv import int8_res_block as jax_res_block
from yolo_tpu.quant import fixed_point as fp
from yolo_tpu_torch.kernels import int8_conv as K
from yolo_tpu_torch.kernels.int8_gemm import int8_gemm

torch.set_num_threads(1)

ROUNDINGS = ["nearest", "floor"]
P1 = dict(sw=8, sb=7, sa_in=4, sa_out=3, retune=11)
P2 = dict(sw=7, sb=8, sa_in=3, sa_out=4, retune=10)


def _block(rng, b, h, w, c, cmid):
    """int8 input, asymmetric int8 weights, nonzero int8-valued biases."""
    x = rng.integers(-128, 128, (b, h, w, c)).astype(np.int8)
    w1 = rng.integers(-30, 40, (1, 1, c, cmid)).astype(np.int8)
    b1 = rng.integers(-100, 100, (cmid,)).astype(np.int32)
    w2 = rng.integers(-30, 40, (3, 3, cmid, c)).astype(np.int8)
    b2 = rng.integers(-100, 100, (c,)).astype(np.int32)
    return x, w1, b1, w2, b2


def _jax_chain(x, w1, b1, w2, b2, p1, p2, sa_res, leaky, rounding):
    y1 = fp.int_conv_requant(jnp.asarray(x), jnp.asarray(w1),
                             jnp.asarray(b1), padding=0, leaky=leaky,
                             rounding=rounding, **p1)
    return np.asarray(fp.int_conv_requant(
        y1, jnp.asarray(w2), jnp.asarray(b2), padding=1, leaky=leaky,
        rounding=rounding, sa_res=sa_res,
        residual=None if sa_res is None else (jnp.asarray(x), p1["sa_in"]),
        **p2))


@pytest.mark.parametrize("rounding", ROUNDINGS)
@pytest.mark.parametrize("sa_res", [None, 3])
def test_plain_equals_pallas_res_block(rng, rounding, sa_res):
    x, w1, b1, w2, b2 = _block(rng, 2, 8, 6, 16, 8)
    want = np.asarray(jax_res_block(
        *map(jnp.asarray, (x, w1, b1)), P1, *map(jnp.asarray, (w2, b2)), P2,
        sa_res=sa_res, rounding=rounding, interpret=True))
    got = K.int8_res_block(*map(torch.tensor, (x, w1, b1)), P1,
                           *map(torch.tensor, (w2, b2)), P2, sa_res=sa_res,
                           leaky=True, rounding=rounding)
    np.testing.assert_array_equal(got.numpy(), want)


def test_plain_equals_pallas_res_block_tiled_shape(rng):
    """The shape and tables of tests/test_kernels.py's tiling test."""
    x, w1, b1, w2, b2 = _block(rng, 4, 12, 9, 8, 8)
    p2 = dict(P2, sa_out=5)
    want = np.asarray(jax_res_block(
        *map(jnp.asarray, (x, w1, b1)), P1, *map(jnp.asarray, (w2, b2)), p2,
        sa_res=4, row_tile=4, batch_tile=1, interpret=True))
    got = K.int8_res_block(*map(torch.tensor, (x, w1, b1)), P1,
                           *map(torch.tensor, (w2, b2)), p2, sa_res=4)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("rounding", ROUNDINGS)
@pytest.mark.parametrize("sa_res", [None, 3])
@pytest.mark.parametrize("leaky", [0.1, False])
def test_plain_equals_jax_chain(rng, rounding, sa_res, leaky):
    """Slope 0.1 (the Q16 rational of the v3 engine's backbone) and no
    activation, as the chain the v3 engine runs for a block."""
    x, w1, b1, w2, b2 = _block(rng, 2, 7, 5, 16, 8)
    want = _jax_chain(x, w1, b1, w2, b2, P1, P2, sa_res, leaky, rounding)
    got = K.int8_res_block(*map(torch.tensor, (x, w1, b1)), P1,
                           *map(torch.tensor, (w2, b2)), P2, sa_res=sa_res,
                           leaky=leaky, rounding=rounding)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("rounding", ROUNDINGS)
@pytest.mark.parametrize("sa_res", [None, 3])
@pytest.mark.parametrize("leaky", [0.1, True])
def test_per_channel_sw_equals_jax_chain(rounding, sa_res, leaky):
    """A per-channel sw1 (C_mid long) and sw2 (C long) on the CPU route
    against the chain the JAX walk runs for a per-channel block (the
    Pallas K4 takes one shift per conv): ``fp.int_conv_requant`` (1x1),
    then ``fp.int_conv_requant(residual=, sa_res=)`` (3x3), at the darknet
    slope 0.1 and at 0.125, with entries whose shift codes sw + sa_in -
    retune are >= 31 and <= -32 (``_shift_arr``'s semantics)."""
    rng = np.random.default_rng(11)
    x, w1, b1, w2, b2 = _block(rng, 2, 6, 7, 64, 32)
    # codes sw - 7 in both convs: 0..4, then 31, 38, -32, -40, -1
    sw1 = rng.integers(7, 12, 32).astype(np.int32)
    sw2 = rng.integers(7, 12, 64).astype(np.int32)
    sw1[:5] = sw2[-5:] = [38, 45, -25, -33, 6]
    p1, p2 = dict(P1, sw=sw1), dict(P2, sw=sw2)
    want = _jax_chain(x, w1, b1, w2, b2, p1, p2, sa_res, leaky, rounding)
    got = K.int8_res_block(*map(torch.tensor, (x, w1, b1)), p1,
                           *map(torch.tensor, (w2, b2)), p2, sa_res=sa_res,
                           leaky=leaky, rounding=rounding)
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(np.unique(want)) > 8


def test_plain_res_shift_ge_32_follows_fixed_point(rng):
    """An accumulator shift >= 32 follows fp._shift (0 for nearest), where
    the Pallas kernel's helpers have no guard."""
    x, w1, b1, w2, b2 = _block(rng, 1, 4, 4, 16, 8)
    p1 = dict(P1, sw=40)
    want = _jax_chain(x, w1, b1, w2, b2, p1, P2, 3, 0.1, "nearest")
    got = K.int8_res_block(*map(torch.tensor, (x, w1, b1)), p1,
                           *map(torch.tensor, (w2, b2)), P2, sa_res=3,
                           leaky=0.1)
    np.testing.assert_array_equal(got.numpy(), want)


def test_res_block_bad_arguments_raise(rng):
    args = list(map(torch.tensor, _block(rng, 1, 4, 4, 16, 8)))
    with pytest.raises(ValueError, match="sa_in"):
        K.int8_res_block(*args[:3], P1, *args[3:], dict(P2, sa_in=9))
    with pytest.raises(ValueError, match="leaky"):
        K.int8_res_block(*args[:3], P1, *args[3:], P2, leaky="0.1")
    with pytest.raises(ValueError, match="rounding"):
        K.int8_res_block(*args[:3], P1, *args[3:], P2, rounding="up")


@pytest.mark.parametrize("m,k,n", [(33, 64, 40), (7, 13, 5), (128, 96, 64)])
def test_gemm_plain_is_exact(rng, m, k, n):
    a = rng.integers(-128, 128, (m, k)).astype(np.int8)
    b = rng.integers(-128, 128, (k, n)).astype(np.int8)
    got = int8_gemm(torch.tensor(a), torch.tensor(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  a.astype(np.int64) @ b.astype(np.int64))
