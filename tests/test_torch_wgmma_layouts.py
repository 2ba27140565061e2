"""The K-major operand forms the Hopper kernels read (``csrc/int8_wgmma.cuh``:
8-bit wgmma takes no transposed operand), held against the JAX package on
the CPU: K4's packed weights (``pack_res_block_weights``) through the plain
block, against the JAX ``int_conv_requant`` chain and the Pallas
``int8_res_block`` in interpret mode; K5's K-major B and its zero padding
on K, against ``jax.lax.dot_general``; and the share of rows K4's
per-stage tiles use.
test_torch_kernels_cuda.py holds the kernels themselves against these
plain versions on the card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolo_tpu.kernels.int8_conv import int8_res_block as jax_res_block
from yolo_tpu.quant import fixed_point as fp
from yolo_tpu_torch.kernels import int8_conv as K
from yolo_tpu_torch.kernels import int8_gemm as G

torch.set_num_threads(1)

ROUNDINGS = ["nearest", "floor"]
P1 = dict(sw=8, sb=7, sa_in=4, sa_out=3, retune=11)
P2 = dict(sw=7, sb=8, sa_in=3, sa_out=4, retune=10)


def _block(rng, b, h, w, c, cmid):
    x = rng.integers(-128, 128, (b, h, w, c)).astype(np.int8)
    w1 = rng.integers(-30, 40, (1, 1, c, cmid)).astype(np.int8)
    b1 = rng.integers(-100, 100, (cmid,)).astype(np.int32)
    w2 = rng.integers(-30, 40, (3, 3, cmid, c)).astype(np.int8)
    b2 = rng.integers(-100, 100, (c,)).astype(np.int32)
    return x, w1, b1, w2, b2


@pytest.mark.parametrize("c,cmid,w1_rank", [(16, 8, 2), (64, 32, 4)])
def test_pack_res_block_weights_round_trips(rng, c, cmid, w1_rank):
    _, w1, _, w2, _ = _block(rng, 1, 1, 1, c, cmid)
    w1 = w1.reshape(c, cmid) if w1_rank == 2 else w1
    w1p, w2p = K.pack_res_block_weights(torch.tensor(w1), torch.tensor(w2))
    assert w1p.shape == (cmid, c) and w2p.shape == (c, 9 * cmid)
    assert w1p.is_contiguous() and w2p.is_contiguous()
    np.testing.assert_array_equal(w1p.numpy(), w1.reshape(c, cmid).T)
    # row o, column (dy * 3 + dx) * cmid + ci holds w2[dy, dx, ci, o]
    np.testing.assert_array_equal(
        w2p.numpy().reshape(c, 3, 3, cmid), w2.transpose(3, 0, 1, 2))
    u1, u2 = K.unpack_res_block_weights((w1p, w2p))
    np.testing.assert_array_equal(u1.numpy(), w1.reshape(c, cmid))
    np.testing.assert_array_equal(u2.numpy(), w2)


def _jax_chain(x, w1, b1, w2, b2, sa_res, leaky, rounding):
    y1 = fp.int_conv_requant(jnp.asarray(x), jnp.asarray(w1),
                             jnp.asarray(b1), padding=0, leaky=leaky,
                             rounding=rounding, **P1)
    return np.asarray(fp.int_conv_requant(
        y1, jnp.asarray(w2), jnp.asarray(b2), padding=1, leaky=leaky,
        rounding=rounding, sa_res=sa_res,
        residual=None if sa_res is None else (jnp.asarray(x), P1["sa_in"]),
        **P2))


@pytest.mark.parametrize("rounding", ROUNDINGS)
@pytest.mark.parametrize("sa_res", [None, 3])
@pytest.mark.parametrize("leaky", [0.1, 0.125])
def test_plain_block_fed_packed_weights_equals_jax_chain(rng, rounding,
                                                         sa_res, leaky):
    x, w1, b1, w2, b2 = _block(rng, 2, 7, 5, 16, 8)
    want = _jax_chain(x, w1, b1, w2, b2, sa_res, leaky, rounding)
    packed = K.pack_res_block_weights(torch.tensor(w1), torch.tensor(w2))
    got = K.int8_res_block(torch.tensor(x), None, torch.tensor(b1), P1,
                           None, torch.tensor(b2), P2, sa_res=sa_res,
                           leaky=leaky, rounding=rounding, packed=packed)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("rounding", ROUNDINGS)
@pytest.mark.parametrize("sa_res", [None, 3])
def test_plain_block_fed_packed_weights_equals_pallas(rng, rounding, sa_res):
    """Slope 0.125 (``leaky=True``), the Pallas kernel's own."""
    x, w1, b1, w2, b2 = _block(rng, 2, 8, 6, 16, 8)
    want = np.asarray(jax_res_block(
        *map(jnp.asarray, (x, w1, b1)), P1, *map(jnp.asarray, (w2, b2)), P2,
        sa_res=sa_res, rounding=rounding, interpret=True))
    packed = K.pack_res_block_weights(torch.tensor(w1), torch.tensor(w2))
    got = K.int8_res_block(torch.tensor(x), None, torch.tensor(b1), P1,
                           None, torch.tensor(b2), P2, sa_res=sa_res,
                           leaky=True, rounding=rounding, packed=packed)
    np.testing.assert_array_equal(got.numpy(), want)


def test_plain_block_packs_nothing(rng):
    """The CPU route computes from whichever form it is handed."""
    x, w1, b1, w2, b2 = map(torch.tensor, _block(rng, 1, 4, 4, 16, 8))
    packed = K.pack_res_block_weights(w1, w2)
    K.reset_res_block_pack_count()
    a = K.int8_res_block(x, None, b1, P1, None, b2, P2, packed=packed)
    b = K.int8_res_block(x, w1, b1, P1, w2, b2, P2)
    assert torch.equal(a, b)
    assert K.res_block_pack_count() == 0


@pytest.mark.parametrize("m,k,n", [(33, 13, 40), (7, 72, 5), (20, 200, 9)])
@pytest.mark.parametrize("layout", ["kn", "k_major"])
def test_gemm_plain_equals_dot_general(rng, m, k, n, layout):
    a = rng.integers(-128, 128, (m, k)).astype(np.int8)
    b = rng.integers(-128, 128, (k, n)).astype(np.int8)
    want = np.asarray(jax.lax.dot_general(
        jnp.asarray(a), jnp.asarray(b), (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32))
    tb = (torch.tensor(b) if layout == "kn"
          else torch.tensor(np.ascontiguousarray(b.T)).t())
    # the kernel's B: a K-major b goes in as it is, a [K, N] one is copied
    bt = G.k_major(tb)
    assert bt.is_contiguous() and bt.shape == (n, k)
    assert (bt.data_ptr() == tb.data_ptr()) == (layout == "k_major")
    got = G.int8_gemm(torch.tensor(a), tb)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("k", [1, 13, 16, 33])
def test_k_padding_is_exact(rng, k):
    a = torch.tensor(rng.integers(-128, 128, (9, k)).astype(np.int8))
    b = torch.tensor(rng.integers(-128, 128, (k, 11)).astype(np.int8))
    ap, bp = G.pad_k(a), G.pad_k(G.k_major(b))
    kp = -(-k // 16) * 16
    assert ap.shape == (9, kp) and bp.shape == (11, kp)
    assert not ap[:, k:].any() and not bp[:, k:].any()
    assert torch.equal(ap[:, :k], a) and torch.equal(bp[:, :k], b.t())
    if k % 16 == 0:
        assert ap is a
    assert torch.equal(G.int8_gemm_plain(ap, bp.t()),
                       G.int8_gemm_plain(a, b))


# K4's tile and halo rows per 1x1 TMA box at the five darknet53 stages,
# by (H, W, C_mid), as its CUDA source picks them (test_torch_kernels_cuda.py
# checks that on the card)
STAGE_TILES = {
    (208, 208, 32): (26, 26, 4),
    (104, 104, 64): (26, 26, 4),
    (52, 52, 128): (26, 26, 4),
    (26, 26, 256): (26, 13, 8),
    (13, 13, 512): (13, 13, 8),
}


@pytest.mark.parametrize("stage", sorted(STAGE_TILES))
def test_stage_tiles_keep_85_percent_of_rows(stage):
    h, w, _ = stage
    th, tw, r1 = STAGE_TILES[stage]
    assert h % th == 0 and w % tw == 0  # no edge tiles at the stage
    assert min(K.res_block_row_shares(th, tw, r1)) >= 0.85


def test_plain_block_takes_hwio_weights_over_packed(rng):
    """Given both forms, the CPU route reads the HWIO weights."""
    x, w1, b1, w2, b2 = map(torch.tensor, _block(rng, 1, 4, 4, 16, 8))
    other = K.pack_res_block_weights(torch.zeros_like(w1),
                                     torch.zeros_like(w2))
    got = K.int8_res_block(x, w1, b1, P1, w2, b2, P2, packed=other)
    assert torch.equal(got, K.int8_res_block(x, w1, b1, P1, w2, b2, P2))
    assert not torch.equal(got, K.int8_res_block(x, None, b1, P1, None, b2,
                                                 P2, packed=other))
