"""Each CUDA kernel of yolo_tpu_torch against its plain PyTorch version, on
the card. Imports neither jax nor yolo_tpu, so it also runs where only
the port is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Without a CUDA device every test here skips."""

import numpy as np
import pytest
import torch

from yolo_tpu_torch.kernels import int8_conv as K
from yolo_tpu_torch.quant import fixed_point as tfp

ROUNDINGS = ["nearest", "floor"]
SHIFTS = dict(sw=8, sb=7, sa_in=4, sa_out=4, retune=11)

CASES = [
    # (form, B, H, W, C_in, C_out)
    ("requant", 2, 13, 11, 32, 64),
    ("requant", 2, 6, 6, 256, 35),
    ("requant", 1, 5, 7, 5, 70),
    ("requant", 1, 4, 4, 16, 200),
    ("im2col", 2, 8, 10, 16, 32),
    ("im2col", 1, 7, 9, 64, 128),
    ("im2col_pool", 2, 8, 10, 16, 32),
    ("im2col_pool", 2, 12, 8, 3, 16),
    ("im2col_pool", 1, 6, 10, 128, 128),
    ("stride2", 2, 8, 12, 3, 16),
    ("s2d", 2, 16, 12, 3, 16),
    ("s2d", 2, 8, 8, 8, 24),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _run(form, x, w, b, c_in, kw):
    if form == "requant":
        return K.int8_conv3x3_requant(x, w, b, **kw)
    if form in ("im2col", "im2col_pool"):
        return K.int8_conv3x3_im2col(x, w, b, pool=form == "im2col_pool",
                                     **kw)
    if form == "stride2":
        return K.int8_conv3x3_pool_requant(x, w, b, **kw)
    return K.int8_conv3x3_pool_s2d(x, w, b, c_in=c_in, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("rounding", ROUNDINGS)
@pytest.mark.parametrize("shifts", [SHIFTS, dict(SHIFTS, sw=40),
                                    dict(SHIFTS, sa_out=14)],
                         ids=["plain", "acc_shift_ge_32", "out_shift_lt_0"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_cuda_kernel_equals_plain(cuda, rounding, shifts, case):
    form, bsz, h, w_, c_in, c_out = case
    rng = np.random.default_rng(0)
    x = rng.integers(-128, 128, (bsz, h, w_, c_in)).astype(np.int8)
    w = rng.integers(-30, 40, (3, 3, c_in, c_out)).astype(np.int8)
    b = rng.integers(-100, 100, (c_out,)).astype(np.int32)
    if form == "s2d":
        x = tfp.s2d_input_np(x)
    kw = dict(shifts, leaky=c_out != 35, rounding=rounding)
    cpu = [torch.tensor(a) for a in (x, w, b)]
    want = _run(form, *cpu, c_in, kw)
    K.reset_launch_counts()
    got = _run(form, *(t.to(cuda) for t in cpu), c_in, kw)
    torch.cuda.synchronize()
    assert sum(K.launch_counts().values()) == 1
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_cuda_rejects_misaligned_input(cuda):
    x = torch.zeros(1 + 2 * 4 * 4 * 16, dtype=torch.int8, device=cuda)
    x = x[1:].view(2, 4, 4, 16)
    w = torch.zeros((3, 3, 16, 16), dtype=torch.int8, device=cuda)
    b = torch.zeros(16, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="aligned"):
        K.int8_conv3x3_requant(x, w, b, **SHIFTS)


@pytest.mark.cuda
def test_cuda_byte_gather_takes_unaligned_input(cuda):
    # C_in % 16 != 0 gathers byte by byte, so any offset will do
    rng = np.random.default_rng(1)
    x = torch.tensor(rng.integers(-128, 128, (2, 6, 6, 3)).astype(np.int8))
    w = torch.tensor(rng.integers(-30, 40, (3, 3, 3, 16)).astype(np.int8))
    b = torch.tensor(rng.integers(-100, 100, (16,)).astype(np.int32))
    want = K.int8_conv3x3_requant(x, w, b, **SHIFTS)
    xc = torch.zeros(1 + x.numel(), dtype=torch.int8, device=cuda)
    xc = xc[1:].view(x.shape)
    xc.copy_(x)
    got = K.int8_conv3x3_requant(xc, w.to(cuda), b.to(cuda), **SHIFTS)
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["requant", "im2col_pool", "stride2", "s2d"])
def test_cuda_empty_batch_counts_no_launch(cuda, form):
    c_in = 16
    x = torch.zeros((0, 8, 8, c_in), dtype=torch.int8, device=cuda)
    if form == "s2d":
        x = torch.zeros((0, 7, 7, 4 * c_in), dtype=torch.int8, device=cuda)
    w = torch.zeros((3, 3, c_in, 16), dtype=torch.int8, device=cuda)
    b = torch.zeros(16, dtype=torch.int32, device=cuda)
    K.reset_launch_counts()
    out = _run(form, x, w, b, c_in, SHIFTS)
    assert out.shape[0] == 0
    assert K.launch_counts() == {k: 0 for k in K.KERNEL_NAMES}


# ---------------------------------------------------------------------------
# yolo_v3: the fused residual block (K4), the general conv, the GEMM (K5).
# ---------------------------------------------------------------------------

from yolo_tpu_torch.kernels import int8_gemm as G  # noqa: E402

P1 = dict(sw=8, sb=7, sa_in=4, sa_out=3, retune=11)
P2 = dict(sw=7, sb=8, sa_in=3, sa_out=4, retune=10)

RES_CASES = [
    # (B, H, W, C, C_mid): small images (one tile), all three kernel forms
    # (BN1, BN2) = (32, 64), (64, 128), (128, 128), and the 13 x 13 C 1024
    # stage whose y1 takes 119 KB of shared memory
    (2, 5, 7, 64, 32),
    (1, 18, 17, 64, 32),
    (2, 6, 6, 128, 64),
    (1, 13, 13, 1024, 512),
]

STAGE_CASES = [
    # (B, H, W, C, C_mid): the five darknet53 stages at 416^2 (their
    # tiles divide the image), then 104^2, 52^2 and 26^2-like stages
    # whose tiles leave edge tiles
    (1, 208, 208, 64, 32),
    (1, 104, 104, 128, 64),
    (1, 52, 52, 256, 128),
    (1, 26, 26, 512, 256),
    (2, 13, 13, 1024, 512),
    (1, 100, 98, 128, 64),
    (1, 50, 55, 256, 128),
    (1, 27, 25, 512, 256),
]


def _res_args(case, seed=0):
    b, h, w, c, cmid = case
    rng = np.random.default_rng(seed)
    return [torch.tensor(a) for a in (
        rng.integers(-128, 128, (b, h, w, c)).astype(np.int8),
        rng.integers(-30, 40, (1, 1, c, cmid)).astype(np.int8),
        rng.integers(-100, 100, (cmid,)).astype(np.int32),
        rng.integers(-30, 40, (3, 3, cmid, c)).astype(np.int8),
        rng.integers(-100, 100, (c,)).astype(np.int32))]


@pytest.mark.cuda
@pytest.mark.parametrize("rounding", ROUNDINGS)
@pytest.mark.parametrize("leaky", [0.1, True])
@pytest.mark.parametrize("sa_res", [None, 3])
@pytest.mark.parametrize("case", RES_CASES, ids=lambda c: "-".join(map(str, c)))
def test_cuda_res_block_equals_plain(cuda, rounding, leaky, sa_res, case):
    x, w1, b1, w2, b2 = _res_args(case)
    kw = dict(sa_res=sa_res, leaky=leaky, rounding=rounding)
    want = K.int8_res_block(x, w1, b1, P1, w2, b2, P2, **kw)
    K.reset_launch_counts()
    got = K.int8_res_block(*(t.to(cuda) for t in (x, w1, b1)), P1,
                           *(t.to(cuda) for t in (w2, b2)), P2, **kw)
    torch.cuda.synchronize()
    assert K.launch_counts()["int8_res_block"] == 1
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["hwio", "packed"])
@pytest.mark.parametrize("case", STAGE_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_cuda_res_block_stages_equal_plain(cuda, form, case):
    x, w1, b1, w2, b2 = _res_args(case, seed=1)
    kw = dict(sa_res=3, leaky=0.1)
    want = K.int8_res_block(x, w1, b1, P1, w2, b2, P2, **kw)
    x, w1, b1, w2, b2 = (t.to(cuda) for t in (x, w1, b1, w2, b2))
    if form == "packed":
        packed = K.pack_res_block_weights(w1, w2)
        K.reset_res_block_pack_count()
        got = K.int8_res_block(x, None, b1, P1, None, b2, P2, packed=packed,
                               **kw)
    else:
        K.reset_res_block_pack_count()
        got = K.int8_res_block(x, w1, b1, P1, w2, b2, P2, **kw)
    torch.cuda.synchronize()
    assert K.res_block_pack_count() == (form == "hwio")
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_cuda_res_block_acc_shift_ge_32(cuda):
    x, w1, b1, w2, b2 = _res_args(RES_CASES[0])
    for p1, p2 in ((dict(P1, sw=40), P2), (P1, dict(P2, sw=40))):
        want = K.int8_res_block(x, w1, b1, p1, w2, b2, p2, sa_res=3,
                                leaky=0.1)
        got = K.int8_res_block(*(t.to(cuda) for t in (x, w1, b1)), p1,
                               *(t.to(cuda) for t in (w2, b2)), p2,
                               sa_res=3, leaky=0.1)
        assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("rounding", ROUNDINGS)
@pytest.mark.parametrize("p1,p2", [
    (P1, dict(P2, sa_out=14)),          # conv2's output shift < 0
    (dict(P1, sa_out=-30, sw=8), dict(P2, sa_in=-30)),  # conv1's >= 32
    (P1, dict(P2, sw=40))], ids=["out2_lt_0", "out1_ge_32", "acc2_ge_32"])
def test_cuda_res_block_general_shifts(cuda, rounding, p1, p2):
    """Shifts outside [0, 31] take the kernel's general shift form."""
    x, w1, b1, w2, b2 = _res_args((2, 9, 7, 128, 64), seed=3)
    kw = dict(sa_res=3, leaky=0.1, rounding=rounding)
    want = K.int8_res_block(x, w1, b1, p1, w2, b2, p2, **kw)
    got = K.int8_res_block(*(t.to(cuda) for t in (x, w1, b1)), p1,
                           *(t.to(cuda) for t in (w2, b2)), p2, **kw)
    assert torch.equal(got.cpu(), want)


CONV_CASES = [
    # (k, stride, padding, C_in parts, C_out, H, W, leaky)
    (3, 1, 1, (3,), 32, 9, 8, 0.1),
    (3, 2, 1, (32,), 64, 9, 10, 0.1),
    (3, 2, 1, (64,), 128, 8, 8, 0.1),
    (1, 1, 0, (1024,), 512, 3, 3, True),
    (3, 1, 1, (512,), 1024, 3, 2, True),
    (1, 1, 0, (512, 256), 256, 4, 5, True),
    (1, 1, 0, (256, 128), 128, 5, 4, True),
    (1, 1, 0, (256,), 21, 5, 5, False),
    (1, 1, 1, (16,), 24, 4, 4, 0.125),
    (3, 1, 0, (5,), 70, 6, 7, False),
]


def _conv_args(case, seed=0):
    k, _, _, cins, c_out, h, w, _ = case
    rng = np.random.default_rng(seed)
    xs = [torch.tensor(rng.integers(-128, 128, (2, h, w, c)).astype(np.int8))
          for c in cins]
    wq = torch.tensor(rng.integers(-30, 40, (k, k, sum(cins), c_out))
                      .astype(np.int8))
    b = torch.tensor(rng.integers(-100, 100, (c_out,)).astype(np.int32))
    return xs, wq, b


def _parts_on(xs, sas, dev):
    if len(xs) == 1:
        return xs[0].to(dev)
    return [(x.to(dev), sa) for x, sa in zip(xs, sas)]


@pytest.mark.cuda
@pytest.mark.parametrize("rounding", ROUNDINGS)
@pytest.mark.parametrize("shifts", [dict(SHIFTS), dict(SHIFTS, sw=40),
                                    dict(SHIFTS, sa_out=14)],
                         ids=["plain", "acc_shift_ge_32", "out_shift_lt_0"])
@pytest.mark.parametrize("case", CONV_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_cuda_conv_requant_equals_plain(cuda, rounding, shifts, case):
    k, stride, pad, cins, _, _, _, leaky = case
    xs, wq, b = _conv_args(case)
    kw = dict(shifts, padding=pad, stride=stride, leaky=leaky,
              rounding=rounding)
    for sas in ((4, 6), (5, 5)) if len(cins) == 2 else ((4,),):
        want = K.int8_conv_requant(_parts_on(xs, sas, "cpu"), wq, b, **kw)
        K.reset_launch_counts()
        got = K.int8_conv_requant(_parts_on(xs, sas, cuda), wq.to(cuda),
                                  b.to(cuda), **kw)
        torch.cuda.synchronize()
        assert K.launch_counts()["int8_conv_requant"] == 1
        assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["kn", "k_major"])
@pytest.mark.parametrize("m,k,n", [(128, 64, 64), (1000, 200, 100),
                                   (333, 72, 98), (7, 9, 33),
                                   (256, 4096, 256), (130, 136, 257),
                                   (129, 1000, 300)])
def test_cuda_gemm_equals_plain(cuda, m, k, n, layout):
    """M, N, K off the 128 x 256 x 128 tile, K % 16 != 0 among them (the
    wrapper pads K), b as [K, N] (copied K-major) and K-major (as is)."""
    rng = np.random.default_rng(2)
    a = torch.tensor(rng.integers(-128, 128, (m, k)).astype(np.int8))
    b = torch.tensor(rng.integers(-128, 128, (k, n)).astype(np.int8))
    want = G.int8_gemm(a, b)
    bd = b.to(cuda)
    if layout == "k_major":
        bd = bd.t().contiguous().t()
    K.reset_launch_counts()
    got = G.int8_gemm(a.to(cuda), bd)
    torch.cuda.synchronize()
    assert K.launch_counts()["int8_gemm"] == 1
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_cuda_gemm_more_than_65535_row_tiles(cuda):
    """M past 65,535 tiles of 128 rows (the cap of a grid's y dimension)."""
    m, k, n = 65535 * 128 + 3, 16, 9
    gen = torch.Generator(device=cuda).manual_seed(0)
    a = torch.randint(-128, 128, (m, k), generator=gen, device=cuda,
                      dtype=torch.int32).to(torch.int8)
    b = torch.randint(-128, 128, (k, n), generator=gen, device=cuda,
                      dtype=torch.int32).to(torch.int8)
    assert torch.equal(G.int8_gemm(a, b), G.int8_gemm_plain(a, b))


@pytest.mark.cuda
def test_cuda_per_channel_sw_raises(cuda):
    """A per-channel sw on every routed CONV_CASES shape equals the plain
    version (the per-column forms); the mma.sync-only shapes (the padded
    1x1, the unpadded 3x3 of C_in 5) still raise. K4 with a per-channel
    sw in one conv equals its plain version on its per-column C entry;
    one of the wrong length raises."""
    for case in CONV_CASES:
        k, stride, pad, cins, c_out, _, _, leaky = case
        xs, wq, b = _conv_args(case)
        sw = np.random.default_rng(c_out).integers(6, 11, c_out).astype(
            np.int32)
        kw = dict(SHIFTS, sw=sw, padding=pad, stride=stride, leaky=leaky)
        parts = [(x, sa) for x, sa in zip(xs, (4, 6))]
        if pad != (k == 3):
            with pytest.raises(ValueError, match="per-channel"):
                K.int8_conv_requant([(x.to(cuda), sa) for x, sa in parts],
                                    wq.to(cuda), b.to(cuda), **kw)
            continue
        want = K.int8_conv_requant(parts, wq, b, **kw)
        K.reset_launch_counts()
        got = K.int8_conv_requant([(x.to(cuda), sa) for x, sa in parts],
                                  wq.to(cuda), b.to(cuda), **kw)
        torch.cuda.synchronize()
        (entry, n), = K.launch_counts_by_entry()["int8_conv_requant"].items()
        assert "_cols_" in entry and n == 1, entry
        assert torch.equal(got.cpu(), want)
    args = _res_args(RES_CASES[0])
    x, w1, b1, w2, b2 = (t.to(cuda) for t in args)
    p1 = dict(P1, sw=np.arange(32, dtype=np.int32) % 5 + 6)
    want = K.int8_res_block(*args[:3], p1, *args[3:], P2, sa_res=3)
    K.reset_launch_counts()
    got = K.int8_res_block(x, w1, b1, p1, w2, b2, P2, sa_res=3)
    torch.cuda.synchronize()
    assert K.launch_counts_by_entry() == {
        "int8_res_block": {K.RES_BLOCK_COLS_ENTRY: 1}}
    assert torch.equal(got.cpu(), want)
    with pytest.raises(ValueError, match="per-channel"):
        K.int8_res_block(x, w1, b1, dict(P1, sw=np.full(31, 8, np.int32)),
                         w2, b2, P2)


@pytest.mark.cuda
def test_cuda_unknown_slope_type_raises(cuda):
    xs, wq, b = _conv_args(CONV_CASES[3])
    with pytest.raises(ValueError, match="leaky"):
        K.int8_conv_requant(xs[0].to(cuda), wq.to(cuda), b.to(cuda),
                            leaky="0.1", **SHIFTS)
    x, w1, b1, w2, b2 = (t.to(cuda) for t in _res_args(RES_CASES[0]))
    with pytest.raises(ValueError, match="leaky"):
        K.int8_res_block(x, w1, b1, P1, w2, b2, P2, leaky=[0.1])


@pytest.mark.cuda
def test_cuda_v3_kernels_reject_misaligned_input(cuda):
    def misaligned(t):
        buf = torch.zeros(1 + t.numel(), dtype=t.dtype, device=cuda)
        out = buf[1:].view(t.shape)
        out.copy_(t)
        return out

    xs, wq, b = _conv_args(CONV_CASES[3])
    with pytest.raises(ValueError, match="aligned"):
        K.int8_conv_requant(misaligned(xs[0]), wq.to(cuda), b.to(cuda),
                            **SHIFTS)
    x, w1, b1, w2, b2 = _res_args(RES_CASES[0])
    with pytest.raises(ValueError, match="aligned"):
        K.int8_res_block(misaligned(x), w1.to(cuda), b1.to(cuda), P1,
                         w2.to(cuda), b2.to(cuda), P2)
    a = torch.zeros((64, 64), dtype=torch.int8)
    with pytest.raises(ValueError, match="aligned"):
        G.int8_gemm(misaligned(a), a.to(cuda))


@pytest.mark.cuda
def test_cuda_res_block_rejects_too_wide_mid_channels(cuda):
    """A y1 tile that cannot fit in shared memory, even at 1 x 1 pixels,
    raises before launch."""
    c, cmid = 32768, 16384
    x = torch.zeros((1, 4, 4, c), dtype=torch.int8, device=cuda)
    one = torch.zeros(1, dtype=torch.int8, device=cuda)
    packed = (one.expand(cmid, c), one.expand(c, 9 * cmid))
    b1 = torch.zeros(cmid, dtype=torch.int32, device=cuda)
    b2 = torch.zeros(c, dtype=torch.int32, device=cuda)
    K.reset_launch_counts()
    with pytest.raises(ValueError, match="too wide"):
        K.int8_res_block(x, None, b1, P1, None, b2, P2, packed=packed)
    assert K.launch_counts()["int8_res_block"] == 0


# (tile_h, tile_w, halo rows per 1x1 TMA box) K4 takes at the five
# darknet53 stages, by (H, W, C, C_mid) (test_torch_wgmma_layouts.py checks
# that they keep >= 85% of the 64-row wgmma steps on pixels)
STAGE_TILES = {
    (208, 208, 64, 32): (26, 26, 4),
    (104, 104, 128, 64): (26, 26, 4),
    (52, 52, 256, 128): (26, 26, 4),
    (26, 26, 512, 256): (26, 13, 8),
    (13, 13, 1024, 512): (13, 13, 8),
}


@pytest.mark.cuda
@pytest.mark.parametrize("stage", sorted(STAGE_TILES),
                         ids=lambda s: "-".join(map(str, s)))
def test_cuda_res_block_layout_at_stages(cuda, stage):
    lay = K.res_block_layout(*stage)
    assert (lay.tile_h, lay.tile_w, lay.halo_rows_per_box) == \
        STAGE_TILES[stage]
    assert lay.ring_stages >= 3 and lay.smem_bytes <= 232448
    # the byte-bound 208^2 C 64 stage runs two blocks per SM
    assert lay.blocks_per_sm == (2 if stage[0] == 208 else 1)


@pytest.mark.cuda
def test_cuda_res_block_tile_shrinks_to_fit(cuda):
    """Past the stages' widths the tile narrows, then shortens, until y1
    fits, and the kernel still equals its plain version there."""
    lay = K.res_block_layout(40, 40, 2048, 1024)
    assert (lay.tile_h, lay.tile_w) == (26, 2)
    lay = K.res_block_layout(26, 26, 4096, 4096)
    assert (lay.tile_h, lay.tile_w) == (7, 1)
    # a 9 x 3 tile (edge tiles one pixel wide), weights of 37.7 MB
    assert K.res_block_layout(9, 10, 2048, 2048)[:2] == (9, 3)
    x, w1, b1, w2, b2 = _res_args((1, 9, 10, 2048, 2048), seed=4)
    kw = dict(sa_res=3, leaky=0.1)
    want = K.int8_res_block(x, w1, b1, P1, w2, b2, P2, **kw)
    got = K.int8_res_block(*(t.to(cuda) for t in (x, w1, b1)), P1,
                           *(t.to(cuda) for t in (w2, b2)), P2, **kw)
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_cuda_res_block_rejects_narrow_channels(cuda):
    x, w1, b1, w2, b2 = (t.to(cuda) for t in _res_args((1, 4, 4, 64, 32)))
    with pytest.raises(ValueError, match="C % 64"):
        K.int8_res_block(x[..., :48].contiguous(), w1[..., :48, :], b1, P1,
                         w2[..., :48], b2[:48], P2)


# ---------------------------------------------------------------------------
# The wgmma conv3x3 (stride 1, pad 1, C_in % 32 == 0): K1 and the general
# conv's 3x3s (conv3x3_wgmma_route).
# ---------------------------------------------------------------------------

WGMMA_ENTRY = "yolo_int8_conv3x3_wgmma"
# (B, H, W, C_in, C_out): the eight shapes the serving paths route there
# (slim's conv3_1, conv4_1, conv5, conv6 = conv7, pred; the yolo_v3 head's
# three), then shapes whose tiles leave edge tiles, and other widths
WGMMA_SHAPES = [
    (2, 104, 104, 32, 64),
    (2, 52, 52, 64, 128),
    (2, 26, 26, 128, 256),
    (2, 26, 26, 256, 256),
    (2, 26, 26, 256, 35),
    (2, 52, 52, 128, 256),
    (2, 26, 26, 256, 512),
    (2, 13, 13, 512, 1024),
    (1, 27, 27, 256, 256),
    (1, 50, 50, 128, 256),
    (1, 100, 100, 32, 64),
    (2, 27, 25, 512, 35),
    (2, 9, 7, 96, 200),
    (2, 5, 6, 32, 1),
]


def _conv3x3_args(case, seed=0):
    b, h, w, c_in, c_out = case
    rng = np.random.default_rng(seed)
    return [torch.tensor(a) for a in (
        rng.integers(-128, 128, (b, h, w, c_in)).astype(np.int8),
        rng.integers(-30, 40, (3, 3, c_in, c_out)).astype(np.int8),
        rng.integers(-100, 100, (c_out,)).astype(np.int32))]


@pytest.mark.cuda
@pytest.mark.parametrize("wrapper", ["int8_conv3x3_requant",
                                     "int8_conv_requant"])
@pytest.mark.parametrize("case", WGMMA_SHAPES,
                         ids=lambda c: "-".join(map(str, c)))
def test_cuda_conv3x3_wgmma_equals_plain(cuda, wrapper, case):
    x, wq, b = _conv3x3_args(case)
    kw = dict(SHIFTS, leaky=case[-1] != 35)
    fn = getattr(K, wrapper)
    if wrapper == "int8_conv_requant":
        kw.update(padding=1, stride=1, leaky=0.125 if kw["leaky"] else 0.1)
    want = fn(x, wq, b, **kw)
    packed = K.pack_conv3x3_weights(wq.to(cuda))
    K.reset_launch_counts()
    K.reset_conv3x3_pack_count()
    got = fn(x.to(cuda), None, b.to(cuda), packed=packed, **kw)
    torch.cuda.synchronize()
    assert K.launch_counts_by_entry() == {wrapper: {WGMMA_ENTRY: 1}}
    assert K.conv3x3_pack_count() == 0
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("rounding", ROUNDINGS)
@pytest.mark.parametrize("shifts", [dict(SHIFTS, sw=40),
                                    dict(SHIFTS, sa_out=14),
                                    dict(SHIFTS, sa_out=-22)],
                         ids=["acc_shift_33", "out_shift_lt_0",
                              "out_shift_ge_32"])
@pytest.mark.parametrize("case", [(2, 13, 11, 32, 128), (2, 9, 7, 64, 35)],
                         ids=lambda c: "-".join(map(str, c)))
def test_cuda_conv3x3_wgmma_general_shifts(cuda, rounding, shifts, case):
    """Shifts outside [0, 31] take the kernel's general shift form; HWIO
    weights are packed for the call."""
    x, wq, b = _conv3x3_args(case, seed=5)
    kw = dict(shifts, rounding=rounding)
    want = K.int8_conv3x3_requant(x, wq, b, **kw)
    K.reset_launch_counts()
    K.reset_conv3x3_pack_count()
    got = K.int8_conv3x3_requant(*(t.to(cuda) for t in (x, wq, b)), **kw)
    torch.cuda.synchronize()
    assert K.launch_counts_by_entry() == {
        "int8_conv3x3_requant": {WGMMA_ENTRY: 1}}
    assert K.conv3x3_pack_count() == 1
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_cuda_conv3x3_narrow_channels_take_mma_sync(cuda):
    """C_in % 32 != 0 (here 16 and 48) stays on the mma.sync kernel."""
    for c_in, c_out in ((16, 32), (48, 64)):
        x, wq, b = _conv3x3_args((2, 7, 9, c_in, c_out), seed=6)
        assert not K.conv3x3_wgmma_route(3, 1, 1, 1, c_in, SHIFTS["sw"])
        want = K.int8_conv3x3_requant(x, wq, b, **SHIFTS)
        K.reset_launch_counts()
        got = K.int8_conv3x3_requant(*(t.to(cuda) for t in (x, wq, b)),
                                     **SHIFTS)
        got2 = K.int8_conv_requant(*(t.to(cuda) for t in (x, wq, b)),
                                   padding=1, **SHIFTS)
        torch.cuda.synchronize()
        assert K.launch_counts_by_entry() == {
            "int8_conv3x3_requant": {"yolo_int8_conv3x3_requant": 1},
            "int8_conv_requant": {"yolo_int8_conv_requant": 1}}
        assert torch.equal(got.cpu(), want) and torch.equal(got2.cpu(), want)


@pytest.mark.cuda
def test_cuda_conv3x3_wgmma_rejects_misaligned_input(cuda):
    x, wq, b = _conv3x3_args((1, 4, 4, 32, 64))
    buf = torch.zeros(1 + x.numel(), dtype=torch.int8, device=cuda)
    xm = buf[1:].view(x.shape)
    xm.copy_(x)
    K.reset_launch_counts()
    with pytest.raises(ValueError, match="aligned"):
        K.int8_conv3x3_requant(xm, wq.to(cuda), b.to(cuda), **SHIFTS)
    with pytest.raises(ValueError, match="aligned"):
        K.int8_conv_requant(xm, wq.to(cuda), b.to(cuda), padding=1,
                            **SHIFTS)
    assert K.launch_counts_by_entry() == {}


# (tile_h, tile_w, ring stages, blocks per SM, BN) the kernel takes at the
# nine routed shapes, by (H, W, C_in, C_out): yolo_v2's convsets_1.x
# (13², 1024 -> 1024) on the slab walk, a whole image over 128-channel
# slabs; the others on the tile walk, a halo of all C_in channels
WGMMA_TILES = {
    (104, 104, 32, 64): (26, 26, 4, 2, 64),
    (52, 52, 64, 128): (26, 26, 4, 1, 128),
    (26, 26, 128, 256): (26, 26, 3, 1, 128),
    (26, 26, 256, 256): (26, 13, 3, 1, 128),
    (26, 26, 256, 35): (26, 13, 3, 1, 64),
    (52, 52, 128, 256): (26, 26, 3, 1, 128),
    (26, 26, 256, 512): (26, 13, 3, 1, 128),
    (13, 13, 512, 1024): (13, 13, 3, 1, 128),
    (13, 13, 1024, 1024): (13, 13, 4, 1, 128),
}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", sorted(WGMMA_TILES),
                         ids=lambda s: "-".join(map(str, s)))
def test_cuda_conv3x3_wgmma_layout_at_routed_shapes(cuda, shape):
    lay = K.conv3x3_wgmma_layout(*shape)
    assert (lay.tile_h, lay.tile_w, lay.ring_stages, lay.blocks_per_sm,
            lay.bn) == WGMMA_TILES[shape]
    assert lay.consumer_warpgroups == (3 if lay.bn == 128 else 2)
    assert lay.smem_bytes <= 232448
    assert lay.tile_pixels == lay.tile_h * lay.tile_w
    assert lay.tile_pixels / lay.mma_rows >= 0.85
    assert lay.halo_channels == (128 if shape[2] >= 1024 else shape[2])


@pytest.mark.cuda
@pytest.mark.parametrize("batch,groups", [(128, 1), (64, 2), (1, 4)])
def test_cuda_conv3x3_slab_layout_fills_the_sms(cuda, batch, groups):
    """The slab walk splits an image's 8 weight tiles over blocks where
    the batch leaves SMs idle (132 on an H100): batch 128 one block per
    image, 64 two, 1 four; the tile walk's layouts keep one."""
    if torch.cuda.get_device_properties(cuda).multi_processor_count != 132:
        pytest.skip("the groups pinned here are an H100 SXM's (132 SMs)")
    lay = K.conv3x3_wgmma_layout(13, 13, 1024, 1024, batch)
    assert (lay.tile_h, lay.tile_w, lay.halo_channels) == (13, 13, 128)
    assert lay.groups == groups
    assert K.conv3x3_wgmma_layout(13, 13, 512, 1024, batch).groups == 1


# (B, H, C_in, C_out): the slab walk at convsets_1.x's 1024 -> 1024 and
# at C_out 35 (the 64-column tile), odd 9² and 7² planes whose weight
# tiles split over 2 blocks (384: unevenly), and the served batch 64
SLAB_SHAPES = [(2, 13, 1024, 1024), (3, 13, 1024, 35), (1, 9, 1024, 384),
               (2, 7, 1024, 256), (64, 13, 1024, 1024)]


@pytest.mark.cuda
@pytest.mark.parametrize("rounding", ROUNDINGS)
@pytest.mark.parametrize("sw_kind", ["scalar", "per_column"])
@pytest.mark.parametrize("case", SLAB_SHAPES,
                         ids=lambda c: "-".join(map(str, c)))
def test_cuda_conv3x3_slab_walk_equals_plain(cuda, rounding, sw_kind, case):
    """The slab walk (the launches of ``yolo_int8_conv3x3_wgmma``, per
    column ``..._cols_wgmma``, counted with ``SLAB_WALK``) == the plain
    version."""
    bsz, h, c_in, c_out = case
    x, wq, b = (t.to(cuda) for t in _conv3x3_args((bsz, h, h, c_in, c_out),
                                                  seed=c_out))
    # accumulator shifts around 7 (C_in 1024 spreads the sums to ~2^17);
    # per column 5 to 9
    sw = (14 if sw_kind == "scalar" else
          (14 + np.arange(c_out) % 5 - 2).astype(np.int32))
    kw = dict(SHIFTS, sw=sw, leaky=0.1, rounding=rounding)
    want = K.int8_conv_requant_plain(x, wq, b, padding=1, **kw)
    packed = K.pack_conv3x3_weights(wq)
    K.reset_launch_counts()
    got = K.int8_conv_requant(x, None, b, packed=packed, padding=1, **kw)
    torch.cuda.synchronize()
    entry = (K.COLS_WGMMA_ENTRY if sw_kind == "per_column"
             else K.WGMMA_ENTRY)
    assert K.launch_counts_by_entry() == {
        "int8_conv_requant": {entry + K.SLAB_WALK: 1}}
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# The wgmma conv3x3's pooled form (conv3x3 + 2x2/2 max pool, C_in % 32 == 0
# or C_in == 16): K3 (conv3x3_pool_wgmma_route).
# ---------------------------------------------------------------------------

POOL_ENTRY = "yolo_int8_conv3x3_pool_wgmma"
# (B, H, W, C_in, C_out): the three shapes slim's serving path routes there
# (conv2, conv3_2, conv4_2), then shapes whose even tiles leave edge tiles,
# and other widths (C_out not a multiple of 16, past one 128-column tile)
POOL_SHAPES = [
    (2, 208, 208, 16, 32),
    (2, 104, 104, 64, 64),
    (2, 52, 52, 128, 128),
    (2, 30, 30, 64, 64),
    (2, 54, 54, 128, 128),
    (2, 100, 100, 16, 32),
    (2, 30, 64, 64, 64),
    (1, 10, 14, 32, 35),
    (2, 6, 8, 96, 200),
    (1, 4, 2, 16, 16),
]


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["hwio", "packed"])
@pytest.mark.parametrize("case", POOL_SHAPES,
                         ids=lambda c: "-".join(map(str, c)))
def test_cuda_conv3x3_pool_wgmma_equals_plain(cuda, form, case):
    x, wq, b = _conv3x3_args(case, seed=7)
    kw = dict(SHIFTS, leaky=case[-1] != 35, pool=True)
    want = K.int8_conv3x3_im2col(x, wq, b, **kw)
    packed = K.pack_conv3x3_weights(wq.to(cuda))
    K.reset_launch_counts()
    K.reset_conv3x3_pack_count()
    if form == "packed":
        got = K.int8_conv3x3_im2col(x.to(cuda), None, b.to(cuda),
                                    packed=packed, **kw)
    else:
        got = K.int8_conv3x3_im2col(*(t.to(cuda) for t in (x, wq, b)), **kw)
    torch.cuda.synchronize()
    assert K.launch_counts_by_entry() == {
        "int8_conv3x3_im2col": {POOL_ENTRY: 1}}
    assert K.conv3x3_pack_count() == (form == "hwio")
    assert got.shape == (case[0], case[1] // 2, case[2] // 2, case[4])
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("rounding", ROUNDINGS)
@pytest.mark.parametrize("shifts", [dict(SHIFTS), dict(SHIFTS, sw=40),
                                    dict(SHIFTS, sa_out=14),
                                    dict(SHIFTS, sa_out=-22)],
                         ids=["plain", "acc_shift_33", "out_shift_lt_0",
                              "out_shift_ge_32"])
@pytest.mark.parametrize("case", [(2, 14, 10, 16, 32), (2, 12, 18, 64, 128)],
                         ids=lambda c: "-".join(map(str, c)))
def test_cuda_conv3x3_pool_wgmma_shifts(cuda, rounding, shifts, case):
    """Both roundings; shifts outside [0, 31] take the kernel's general
    shift form."""
    x, wq, b = _conv3x3_args(case, seed=8)
    kw = dict(shifts, rounding=rounding, pool=True)
    want = K.int8_conv3x3_im2col(x, wq, b, **kw)
    K.reset_launch_counts()
    got = K.int8_conv3x3_im2col(*(t.to(cuda) for t in (x, wq, b)), **kw)
    torch.cuda.synchronize()
    assert K.launch_counts_by_entry() == {
        "int8_conv3x3_im2col": {POOL_ENTRY: 1}}
    assert torch.equal(got.cpu(), want)


# (tile_h, tile_w, ring stages, blocks per SM, BN) the pooled form takes at
# slim's three K3 shapes, by (H, W, C_in, C_out): each tile as large as
# lets its form's blocks per SM reside (conv3_2's 26 x 26 would not fit
# two)
POOL_TILES = {
    (208, 208, 16, 32): (26, 26, 3, 3, 32),
    (104, 104, 64, 64): (26, 14, 4, 2, 64),
    (52, 52, 128, 128): (26, 26, 3, 1, 128),
}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [
    *POOL_TILES, (30, 30, 64, 64), (54, 54, 128, 128), (100, 100, 16, 32),
    (52, 52, 512, 128), (26, 26, 1024, 256)],
    ids=lambda s: "-".join(map(str, s)))
def test_cuda_conv3x3_pool_wgmma_tiles_are_even(cuda, shape):
    """Whole 2x2 windows in every tile, edge tiles included; wide channels
    halve the tile to even sizes."""
    lay = K.conv3x3_pool_wgmma_layout(*shape)
    h, w = shape[:2]
    assert lay.tile_h % 2 == 0 and lay.tile_w % 2 == 0
    assert (h % lay.tile_h) % 2 == 0 and (w % lay.tile_w) % 2 == 0
    if shape in POOL_TILES:
        assert (lay.tile_h, lay.tile_w, lay.ring_stages, lay.blocks_per_sm,
                lay.bn) == POOL_TILES[shape]
        assert lay.tile_pixels / lay.mma_rows >= 0.85
    assert lay.bn == (128 if shape[3] % 128 == 0 else 32 if shape[3] <= 32
                      else 64)
    assert lay.smem_bytes <= 232448


@pytest.mark.cuda
def test_cuda_conv3x3_pool_wgmma_rejects_bad_input(cuda):
    """A misaligned input and an odd image raise before launch."""
    x, wq, b = _conv3x3_args((1, 4, 4, 32, 64))
    buf = torch.zeros(1 + x.numel(), dtype=torch.int8, device=cuda)
    xm = buf[1:].view(x.shape)
    xm.copy_(x)
    K.reset_launch_counts()
    with pytest.raises(ValueError, match="aligned"):
        K.int8_conv3x3_im2col(xm, wq.to(cuda), b.to(cuda), pool=True,
                              **SHIFTS)
    with pytest.raises(ValueError, match="even"):
        K.int8_conv3x3_im2col(x[:, :3].contiguous().to(cuda), wq.to(cuda),
                              b.to(cuda), pool=True, **SHIFTS)
    with pytest.raises(ValueError, match="even"):
        K.conv3x3_pool_wgmma_layout(5, 4, 32, 64)
    assert K.launch_counts_by_entry() == {}


# ---------------------------------------------------------------------------
# The wgmma conv3x3's stride-2 form (3x3, stride 2, pad 1, C_in % 32 == 0):
# darknet53's five downsampling convs (conv3x3_s2_wgmma_route).
# ---------------------------------------------------------------------------

S2_ENTRY = "yolo_int8_conv3x3_s2_wgmma"
# (B, H, W, C_in, C_out): the five shapes yolo_v3's serving path routes
# there (the last two over halo slabs of 128 channels), then odd images
# whose tiles leave edge tiles (53^2 C_in 256 over slabs), and other widths
# (C_out 35 in one masked 64-column tile, 200 past one 128-column tile)
S2_SHAPES = [
    (2, 416, 416, 32, 64),
    (2, 208, 208, 64, 128),
    (2, 104, 104, 128, 256),
    (2, 52, 52, 256, 512),
    (2, 26, 26, 512, 1024),
    (2, 27, 27, 256, 512),
    (2, 53, 53, 256, 512),
    (2, 53, 53, 64, 128),
    (2, 101, 101, 32, 64),
    (2, 13, 13, 512, 1024),
    (2, 9, 7, 32, 35),
    (1, 13, 11, 96, 200),
    (2, 26, 25, 512, 200),
    (1, 1, 1, 32, 1),
]


def _s2(x, wq, b, **kw):
    return K.int8_conv_requant(x, wq, b, padding=1, stride=2, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["hwio", "packed"])
@pytest.mark.parametrize("case", S2_SHAPES,
                         ids=lambda c: "-".join(map(str, c)))
def test_cuda_conv3x3_s2_wgmma_equals_plain(cuda, form, case):
    x, wq, b = _conv3x3_args(case, seed=9)
    kw = dict(SHIFTS, leaky=0.1 if case[-1] != 35 else False)
    want = _s2(x, wq, b, **kw)
    packed = K.pack_conv3x3_weights(wq.to(cuda))
    K.reset_launch_counts()
    K.reset_conv3x3_pack_count()
    if form == "packed":
        got = _s2(x.to(cuda), None, b.to(cuda), packed=packed, **kw)
    else:
        got = _s2(*(t.to(cuda) for t in (x, wq, b)), **kw)
    torch.cuda.synchronize()
    assert K.launch_counts_by_entry() == {"int8_conv_requant": {S2_ENTRY: 1}}
    assert K.conv3x3_pack_count() == (form == "hwio")
    assert got.shape == (case[0], (case[1] + 1) // 2, (case[2] + 1) // 2,
                         case[4])
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("leaky", [0.1, True, False])
@pytest.mark.parametrize("rounding", ROUNDINGS)
@pytest.mark.parametrize("shifts", [dict(SHIFTS), dict(SHIFTS, sw=40),
                                    dict(SHIFTS, sa_out=14),
                                    dict(SHIFTS, sa_out=-22)],
                         ids=["plain", "acc_shift_33", "out_shift_lt_0",
                              "out_shift_ge_32"])
@pytest.mark.parametrize("case", [(2, 15, 13, 32, 64), (2, 26, 26, 512, 128)],
                         ids=lambda c: "-".join(map(str, c)))
def test_cuda_conv3x3_s2_wgmma_epilogues(cuda, leaky, rounding, shifts,
                                         case):
    """Both roundings and every slope; shifts outside [0, 31] take the
    kernel's general shift form (the second case copies its halo in four
    slabs of 128 channels)."""
    x, wq, b = _conv3x3_args(case, seed=10)
    kw = dict(shifts, rounding=rounding, leaky=leaky)
    want = _s2(x, wq, b, **kw)
    K.reset_launch_counts()
    got = _s2(*(t.to(cuda) for t in (x, wq, b)), **kw)
    torch.cuda.synchronize()
    assert K.launch_counts_by_entry() == {"int8_conv_requant": {S2_ENTRY: 1}}
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_cuda_conv3x3_s2_other_shapes_take_mma_sync(cuda):
    """A stride-2 conv the form does not take (C_in 48; pad 0) stays on the
    mma.sync conv kernel, and the form itself raises on it."""
    for c_in, pad in ((48, 1), (32, 0)):
        x, wq, b = _conv3x3_args((2, 9, 8, c_in, 64), seed=11)
        assert not K.conv3x3_s2_wgmma_route(3, 2, pad, 1, c_in, SHIFTS["sw"])
        want = K.int8_conv_requant(x, wq, b, padding=pad, stride=2, **SHIFTS)
        K.reset_launch_counts()
        got = K.int8_conv_requant(*(t.to(cuda) for t in (x, wq, b)),
                                  padding=pad, stride=2, **SHIFTS)
        torch.cuda.synchronize()
        assert K.launch_counts_by_entry() == {
            "int8_conv_requant": {"yolo_int8_conv_requant": 1}}
        assert torch.equal(got.cpu(), want)
    x, wq, b = _conv3x3_args((2, 9, 8, 48, 64), seed=11)
    with pytest.raises(ValueError, match="C_in % 32"):
        K._launch_conv3x3_wgmma("int8_conv_requant", x.to(cuda),
                                wq.to(cuda), b.to(cuda), None, leaky=True,
                                rounding="nearest", form="s2", **SHIFTS)
    with pytest.raises(ValueError, match="stride-2"):
        K.conv3x3_s2_wgmma_layout(9, 8, 48, 64)


@pytest.mark.cuda
def test_cuda_conv3x3_s2_wgmma_raises_not_falls_back(cuda):
    """A routed stride-2 conv with a misaligned input raises: it never
    drops back to the mma.sync kernel."""
    x, wq, b = _conv3x3_args((1, 8, 8, 32, 64))
    buf = torch.zeros(1 + x.numel(), dtype=torch.int8, device=cuda)
    xm = buf[1:].view(x.shape)
    xm.copy_(x)
    K.reset_launch_counts()
    with pytest.raises(ValueError, match="aligned"):
        _s2(xm, wq.to(cuda), b.to(cuda), **SHIFTS)
    assert K.launch_counts_by_entry() == {}


# (tile_h, tile_w, ring stages, blocks per SM, BN, halo channels) the
# stride-2 form takes at the five routed shapes, by (H, W, C_in, C_out)
S2_TILES = {
    (416, 416, 32, 64): (16, 16, 3, 2, 64, 32),
    (208, 208, 64, 128): (9, 21, 4, 1, 128, 64),
    (104, 104, 128, 256): (7, 26, 3, 1, 128, 128),
    (52, 52, 256, 512): (13, 13, 3, 1, 128, 128),
    (26, 26, 512, 1024): (13, 13, 3, 1, 128, 128),
}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", sorted(S2_TILES),
                         ids=lambda s: "-".join(map(str, s)))
def test_cuda_conv3x3_s2_wgmma_layout_at_routed_shapes(cuda, shape):
    lay = K.conv3x3_s2_wgmma_layout(*shape)
    assert (lay.tile_h, lay.tile_w, lay.ring_stages, lay.blocks_per_sm,
            lay.bn, lay.halo_channels) == S2_TILES[shape]
    assert lay.consumer_warpgroups == (3 if lay.bn == 128 else 2)
    assert lay.smem_bytes <= 232448
    assert lay.tile_pixels == lay.tile_h * lay.tile_w
    assert lay.tile_pixels / lay.mma_rows >= 0.85


# ---------------------------------------------------------------------------
# The thin-input entry convs (csrc/int8_entry_conv.cu): yolo_v3's C_in = 3
# entry conv (entry_conv3x3_route) and K2 on the s2d layout, slim's conv1
# (pool_s2d_wgmma_route).
# ---------------------------------------------------------------------------

ENTRY_CONV = "yolo_int8_entry_conv3x3_wgmma"
POOL_S2D = "yolo_int8_pool_s2d_wgmma"
# (B, H, W, C_in, C_out): the serving shape (batch 2), odd widths whose
# rows (W * C_in bytes) are no 16-byte multiple, batch 1, three images
# whose row tiles leave a partial tile, width chunks (a row of 1501
# pixels x 64 channels does not fit one block), C_in 1 and 2, C_out 35
# (odd: byte stores) and 64 (the 64-column form), a 1 x 1 image
ENTRY_SHAPES = [
    (2, 416, 416, 3, 32),
    (2, 17, 23, 3, 32),
    (1, 33, 40, 3, 35),
    (1, 32, 32, 2, 32),
    (2, 9, 7, 1, 64),
    (3, 50, 30, 3, 32),
    (1, 3, 1501, 3, 64),
    (1, 1, 1, 3, 32),
]
SHIFT_CASES = [dict(SHIFTS), dict(SHIFTS, sw=40), dict(SHIFTS, sa_out=14),
               dict(SHIFTS, sa_out=-22)]
SHIFT_IDS = ["plain", "acc_shift_33", "out_shift_lt_0", "out_shift_ge_32"]


def _entry(x, wq, b, **kw):
    return K.int8_conv_requant(x, wq, b, padding=1, stride=1, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["hwio", "packed"])
@pytest.mark.parametrize("case", ENTRY_SHAPES,
                         ids=lambda c: "-".join(map(str, c)))
def test_cuda_entry_conv_equals_plain(cuda, form, case):
    x, wq, b = _conv3x3_args(case, seed=12)
    kw = dict(SHIFTS, leaky=0.1)
    want = _entry(x, wq, b, **kw)
    packed = K.pack_entry_conv_weights(wq.to(cuda))
    K.reset_launch_counts()
    K.reset_entry_conv_pack_count()
    if form == "packed":
        got = _entry(x.to(cuda), None, b.to(cuda), packed=packed, **kw)
    else:
        got = _entry(*(t.to(cuda) for t in (x, wq, b)), **kw)
    torch.cuda.synchronize()
    assert K.launch_counts_by_entry() == {"int8_conv_requant": {ENTRY_CONV: 1}}
    assert K.entry_conv_pack_count() == (form == "hwio")
    assert got.shape == case[:3] + (case[4],)
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("leaky", [0.1, True, False])
@pytest.mark.parametrize("rounding", ROUNDINGS)
@pytest.mark.parametrize("shifts", SHIFT_CASES, ids=SHIFT_IDS)
@pytest.mark.parametrize("case", [(2, 17, 23, 3, 32), (1, 12, 31, 2, 35)],
                         ids=lambda c: "-".join(map(str, c)))
def test_cuda_entry_conv_epilogues(cuda, leaky, rounding, shifts, case):
    """Both roundings and every slope; shifts outside [0, 31] take the
    kernel's general shift form."""
    x, wq, b = _conv3x3_args(case, seed=13)
    kw = dict(shifts, rounding=rounding, leaky=leaky)
    want = _entry(x, wq, b, **kw)
    K.reset_launch_counts()
    got = _entry(*(t.to(cuda) for t in (x, wq, b)), **kw)
    torch.cuda.synchronize()
    assert K.launch_counts_by_entry() == {"int8_conv_requant": {ENTRY_CONV: 1}}
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_cuda_entry_conv_raises_not_falls_back(cuda):
    """A routed entry conv with a misaligned input raises: it never drops
    back to the mma.sync kernel; the kernel itself raises on C_in 4."""
    x, wq, b = _conv3x3_args((1, 8, 9, 3, 32))
    buf = torch.zeros(1 + x.numel(), dtype=torch.int8, device=cuda)
    xm = buf[1:].view(x.shape)
    xm.copy_(x)
    K.reset_launch_counts()
    with pytest.raises(ValueError, match="aligned"):
        _entry(xm, wq.to(cuda), b.to(cuda), **SHIFTS)
    x4, w4, b4 = (t.to(cuda) for t in _conv3x3_args((1, 8, 9, 4, 32)))
    with pytest.raises(ValueError, match="C_in <= 3"):
        K._launch_entry_conv3x3(x4, None, b4, torch.zeros(
            (32, 32), dtype=torch.int8, device=cuda), leaky=True,
            rounding="nearest", **SHIFTS)
    with pytest.raises(ValueError, match="entry conv"):
        K.entry_conv3x3_layout(8, 9, 4, 32)
    assert K.launch_counts_by_entry() == {}


@pytest.mark.cuda
def test_cuda_entry_conv_layout(cuda):
    """Whole rows where one fits: at the serving shape 4 x 416 tiles sized
    for two blocks per SM; a row too wide for a block is cut in halves."""
    lay = K.entry_conv3x3_layout(416, 416, 3, 32)
    assert (lay.tile_h, lay.tile_w, lay.bn, lay.warpgroups) == (4, 416, 32, 2)
    assert lay.blocks_per_sm >= 2
    assert lay.smem_bytes * lay.blocks_per_sm <= 233472
    assert lay.in_pitch % 16 == 416 * 3 % 16
    assert lay.out_pitch % 16 == 416 * 32 % 16
    wide = K.entry_conv3x3_layout(3, 1501, 3, 64)
    assert (wide.tile_w, wide.bn) == (751, 64)
    assert K.entry_conv3x3_layout(17, 23, 3, 35).tile_w == 23


# (B, H, W, C_in, C_out) of K2's wgmma kernel on the s2d layout of an H x W
# image: the serving shape (batch 2; s2d row pitch 211 x 12 = 2,532 bytes,
# no 16-byte multiple), odd pooled widths, C_in 4 and 2, C_out 32 (the
# 128-column form), 20 and 7, three images whose row tiles leave a partial
# tile, width chunks, a 2 x 2 image
POOL_S2D_SHAPES = [
    (2, 416, 416, 3, 16),
    (2, 14, 10, 3, 32),
    (1, 6, 18, 4, 20),
    (2, 4, 10, 2, 7),
    (3, 38, 26, 3, 16),
    (1, 4, 6002, 3, 32),
    (1, 2, 2, 1, 16),
]


def _s2d_args(case, seed):
    x, wq, b = _conv3x3_args(case, seed=seed)
    return torch.tensor(tfp.s2d_input_np(x.numpy())), wq, b


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["hwio", "packed"])
@pytest.mark.parametrize("case", POOL_S2D_SHAPES,
                         ids=lambda c: "-".join(map(str, c)))
def test_cuda_pool_s2d_wgmma_equals_plain(cuda, form, case):
    x2, wq, b = _s2d_args(case, seed=14)
    c_in = case[3]
    kw = dict(SHIFTS, c_in=c_in)
    want = K.int8_conv3x3_pool_s2d(x2, wq, b, **kw)
    packed = K.pack_pool_s2d_weights(wq.to(cuda))
    K.reset_launch_counts()
    K.reset_pool_s2d_pack_count()
    if form == "packed":
        got = K.int8_conv3x3_pool_s2d(x2.to(cuda), None, b.to(cuda),
                                      packed=packed, **kw)
    else:
        got = K.int8_conv3x3_pool_s2d(*(t.to(cuda) for t in (x2, wq, b)),
                                      **kw)
    torch.cuda.synchronize()
    assert K.launch_counts_by_entry() == {
        "int8_conv3x3_pool_requant": {POOL_S2D: 1}}
    assert K.pool_s2d_pack_count() == (form == "hwio")
    assert got.shape == (case[0], case[1] // 2, case[2] // 2, case[4])
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("leaky", [True, False])
@pytest.mark.parametrize("rounding", ROUNDINGS)
@pytest.mark.parametrize("shifts", SHIFT_CASES, ids=SHIFT_IDS)
@pytest.mark.parametrize("case", [(2, 16, 22, 3, 16), (1, 10, 14, 4, 32)],
                         ids=lambda c: "-".join(map(str, c)))
def test_cuda_pool_s2d_wgmma_epilogues(cuda, leaky, rounding, shifts, case):
    """Both roundings, both activations; shifts outside [0, 31] take the
    kernel's general shift form."""
    x2, wq, b = _s2d_args(case, seed=15)
    kw = dict(shifts, c_in=case[3], rounding=rounding, leaky=leaky)
    want = K.int8_conv3x3_pool_s2d(x2, wq, b, **kw)
    K.reset_launch_counts()
    got = K.int8_conv3x3_pool_s2d(*(t.to(cuda) for t in (x2, wq, b)), **kw)
    torch.cuda.synchronize()
    assert K.launch_counts_by_entry() == {
        "int8_conv3x3_pool_requant": {POOL_S2D: 1}}
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_cuda_pool_s2d_assembly_takes_the_wgmma_kernel(cuda):
    """``int8_conv3x3_pool_requant(assembly='s2d')`` lays the input out
    and runs the same kernel."""
    x, wq, b = _conv3x3_args((2, 12, 18, 3, 16), seed=16)
    want = K.int8_conv3x3_pool_requant(x, wq, b, assembly="s2d", **SHIFTS)
    K.reset_launch_counts()
    got = K.int8_conv3x3_pool_requant(*(t.to(cuda) for t in (x, wq, b)),
                                      assembly="s2d", **SHIFTS)
    torch.cuda.synchronize()
    assert K.launch_counts_by_entry() == {
        "int8_conv3x3_pool_requant": {POOL_S2D: 1}}
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_cuda_pool_s2d_other_shapes_take_mma_sync(cuda):
    """C_in 8 or C_out 48 stays on the mma.sync pool_s2d kernel, and the
    wgmma kernel itself raises on them; a misaligned routed input raises
    rather than falling back."""
    for c_in, c_out in ((8, 24), (3, 48)):
        x2, wq, b = _s2d_args((2, 8, 10, c_in, c_out), seed=17)
        assert not K.pool_s2d_wgmma_route(c_in, c_out, SHIFTS["sw"])
        want = K.int8_conv3x3_pool_s2d(x2, wq, b, c_in=c_in, **SHIFTS)
        K.reset_launch_counts()
        got = K.int8_conv3x3_pool_s2d(*(t.to(cuda) for t in (x2, wq, b)),
                                      c_in=c_in, **SHIFTS)
        torch.cuda.synchronize()
        assert K.launch_counts_by_entry() == {
            "int8_conv3x3_pool_requant": {"yolo_int8_conv3x3_requant": 1}}
        assert torch.equal(got.cpu(), want)
        with pytest.raises(ValueError, match="C_in <= 4"):
            K._launch_pool_s2d_wgmma(x2.to(cuda), wq.to(cuda), b.to(cuda),
                                     None, c_in=c_in, leaky=True,
                                     rounding="nearest", **SHIFTS)
    with pytest.raises(ValueError, match="pooled s2d"):
        K.pool_s2d_wgmma_layout(8, 10, 8, 24)
    x2, wq, b = _s2d_args((1, 8, 8, 3, 16), seed=17)
    buf = torch.zeros(1 + x2.numel(), dtype=torch.int8, device=cuda)
    xm = buf[1:].view(x2.shape)
    xm.copy_(x2)
    K.reset_launch_counts()
    with pytest.raises(ValueError, match="aligned"):
        K.int8_conv3x3_pool_s2d(xm, wq.to(cuda), b.to(cuda), c_in=3,
                                **SHIFTS)
    assert K.launch_counts_by_entry() == {}


@pytest.mark.cuda
def test_cuda_pool_s2d_wgmma_layout(cuda):
    """At slim's conv1 (416^2 -> 208^2 pooled): 9 x 208 tiles, three
    blocks per SM, 4 phases x 16 columns; pitches keep the global rows'
    alignment."""
    lay = K.pool_s2d_wgmma_layout(416, 416, 3, 16)
    assert (lay.tile_h, lay.tile_w, lay.blocks_per_sm, lay.bn,
            lay.warpgroups) == (9, 208, 3, 64, 2)
    assert lay.smem_bytes * lay.blocks_per_sm <= 233472
    assert lay.in_pitch % 16 == 211 * 12 % 16
    assert lay.out_pitch % 16 == 208 * 16 % 16
    assert K.pool_s2d_wgmma_layout(14, 10, 3, 32).bn == 128
    assert K.pool_s2d_wgmma_layout(4, 6002, 3, 32).tile_w == 1501


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["entry", "pool_s2d"])
def test_cuda_thin_kernels_empty_batch_count_no_launch(cuda, kernel):
    K.reset_launch_counts()
    b = torch.zeros(16, dtype=torch.int32, device=cuda)
    w = torch.zeros((3, 3, 3, 16), dtype=torch.int8, device=cuda)
    if kernel == "entry":
        out = _entry(torch.zeros((0, 8, 8, 3), dtype=torch.int8,
                                 device=cuda), w, b, **SHIFTS)
    else:
        out = K.int8_conv3x3_pool_s2d(
            torch.zeros((0, 7, 7, 12), dtype=torch.int8, device=cuda), w, b,
            c_in=3, **SHIFTS)
    assert out.shape[0] == 0
    assert K.launch_counts() == {k: 0 for k in K.KERNEL_NAMES}


# ---------------------------------------------------------------------------
# The wgmma 1x1 kernel (csrc/int8_conv1x1_wgmma.cu): yolo_v3's fourteen 1x1s.
# ---------------------------------------------------------------------------

CONV1X1_ENTRY = "yolo_int8_conv1x1_wgmma"
# (B, H, W, C_in parts, C_out): M off the 64-row tile, C_out 21, 24, 35 and
# 300 (a ragged second column tile), parts of C_in 16, 48 and 80, concats,
# a 4096-channel K (the most the weights' residence takes: 32 columns)
CONV1X1_SHAPES = [
    (1, 7, 9, (16,), 24),
    (2, 5, 5, (48,), 21),
    (1, 11, 13, (80,), 35),
    (2, 9, 7, (48, 80), 64),
    (1, 3, 3, (16, 16), 21),
    (1, 10, 10, (256,), 300),
    (2, 13, 13, (512, 256), 256),
    (1, 6, 6, (2048, 2048), 64),
]


def _conv1x1_args(case, seed=0):
    b, h, w, cins, c_out = case
    rng = np.random.default_rng(seed)
    xs = [torch.tensor(rng.integers(-128, 128, (b, h, w, c)).astype(np.int8))
          for c in cins]
    wq = torch.tensor(rng.integers(-30, 40, (1, 1, sum(cins), c_out))
                      .astype(np.int8))
    bias = torch.tensor(rng.integers(-100, 100, (c_out,)).astype(np.int32))
    return xs, wq, bias


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["hwio", "packed"])
@pytest.mark.parametrize("sas", [(4, 6), (5, 5)], ids=["distinct", "equal"])
@pytest.mark.parametrize("case", CONV1X1_SHAPES,
                         ids=lambda c: "-".join(map(str, c)))
def test_cuda_conv1x1_wgmma_equals_plain(cuda, form, sas, case):
    """The wgmma 1x1 kernel == the plain conv at its edge shapes, from HWIO
    and from packed weights, a concat's parts at distinct and at equal
    scales; one launch, on its C entry."""
    xs, wq, b = _conv1x1_args(case)
    kw = dict(SHIFTS, leaky=True, rounding="nearest", sa_in=None)
    want = K.int8_conv_requant(_parts_on(xs, sas, "cpu") if len(xs) == 2
                               else [(xs[0], sas[0])], wq, b, **kw)
    parts = [(x.to(cuda), sa) for x, sa in zip(xs, sas)]
    packed = K.pack_conv1x1_weights(wq.to(cuda))
    K.reset_launch_counts()
    got = (K.int8_conv_requant(parts, None, b.to(cuda), packed=packed, **kw)
           if form == "packed" else
           K.int8_conv_requant(parts, wq.to(cuda), b.to(cuda), **kw))
    torch.cuda.synchronize()
    assert K.launch_counts_by_entry() == {
        "int8_conv_requant": {CONV1X1_ENTRY: 1}}
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("leaky", [True, 0.1, False])
@pytest.mark.parametrize("rounding", ROUNDINGS)
@pytest.mark.parametrize("shifts", [dict(SHIFTS), dict(SHIFTS, sw=40),
                                    dict(SHIFTS, sa_out=14)],
                         ids=["plain", "acc_shift_ge_32", "out_shift_lt_0"])
@pytest.mark.parametrize("case", [(2, 9, 7, (64,), 128),
                                  (1, 6, 5, (32, 48), 21)],
                         ids=lambda c: "-".join(map(str, c)))
def test_cuda_conv1x1_wgmma_epilogues(cuda, leaky, rounding, shifts, case):
    """Every slope (0.125, Q16 0.1, none), both roundings and both shift
    forms (the general one: acc_shift >= 32, out_shift < 0), one part and
    a concat at distinct scales."""
    xs, wq, b = _conv1x1_args(case, seed=3)
    kw = dict(shifts, leaky=leaky, rounding=rounding, sa_in=None)
    sas = (4, 6)[:len(xs)]
    want = K.int8_conv_requant(list(zip(xs, sas)), wq, b, **kw)
    K.reset_launch_counts()
    got = K.int8_conv_requant([(x.to(cuda), sa) for x, sa in zip(xs, sas)],
                              wq.to(cuda), b.to(cuda), **kw)
    torch.cuda.synchronize()
    assert K.launch_counts_by_entry() == {
        "int8_conv_requant": {CONV1X1_ENTRY: 1}}
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("rounding", ROUNDINGS)
@pytest.mark.parametrize("shifts", [dict(SHIFTS), dict(SHIFTS, sw=40),
                                    dict(SHIFTS, sa_out=14)],
                         ids=["plain", "acc_shift_ge_32", "out_shift_lt_0"])
@pytest.mark.parametrize("case", [c for c in CONV_CASES if c[0] == 1],
                         ids=lambda c: "-".join(map(str, c)))
def test_cuda_mma_sync_conv_1x1_equals_plain(cuda, rounding, shifts, case):
    """CONV_CASES' 1x1s and two-part concats on the mma.sync conv kernel
    (``_launch_conv_requant``), which int8_conv_requant no longer routes
    them to: its 1x1 and two-part paths stay held to the plain version."""
    _, stride, pad, cins, _, _, _, leaky = case
    xs, wq, b = _conv_args(case)
    kw = {k: v for k, v in shifts.items() if k != "sa_in"}
    kw.update(padding=pad, stride=stride, leaky=leaky, rounding=rounding)
    for sas in ((4, 6), (5, 5)) if len(cins) == 2 else ((4,),):
        want = K.int8_conv_requant(list(zip(xs, sas)), wq, b, sa_in=None,
                                   **kw)
        K.reset_launch_counts()
        got = K._launch_conv_requant(
            [(x.to(cuda), sa) for x, sa in zip(xs, sas)], wq.to(cuda),
            b.to(cuda), **kw)
        torch.cuda.synchronize()
        assert K.launch_counts_by_entry() == {
            "int8_conv_requant": {"yolo_int8_conv_requant": 1}}
        assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_cuda_conv1x1_routes(cuda):
    """CONV_CASES' stride-1 pad-0 1x1s and concats take the wgmma 1x1
    kernel; the padded 1x1 stays on the mma.sync kernel."""
    for case in CONV_CASES:
        k, stride, pad, cins, _, _, _, leaky = case
        if k != 1:
            continue
        xs, wq, b = _conv_args(case)
        K.reset_launch_counts()
        K.int8_conv_requant(_parts_on(xs, (4, 6), cuda), wq.to(cuda),
                            b.to(cuda), padding=pad, stride=stride,
                            leaky=leaky, **SHIFTS)
        torch.cuda.synchronize()
        entry = CONV1X1_ENTRY if pad == 0 else "yolo_int8_conv_requant"
        assert K.launch_counts_by_entry() == {"int8_conv_requant": {entry: 1}}


@pytest.mark.cuda
def test_cuda_conv1x1_wgmma_raises_not_falls_back(cuda):
    """A routed 1x1 with a misaligned part raises, and the kernel's
    launcher raises on what it does not take (C_in 24, 4224 channels):
    nothing drops back to the mma.sync kernel."""
    xs, wq, b = _conv1x1_args((1, 4, 4, (32, 16), 24))
    buf = torch.zeros(1 + xs[1].numel(), dtype=torch.int8, device=cuda)
    xm = buf[1:].view(xs[1].shape)
    xm.copy_(xs[1])
    K.reset_launch_counts()
    with pytest.raises(ValueError, match="aligned"):
        K.int8_conv_requant([(xs[0].to(cuda), 4), (xm, 6)], wq.to(cuda),
                            b.to(cuda), **SHIFTS)
    for cins in ((24,), (2048, 2176)):
        xs, wq, b = _conv1x1_args((1, 2, 2, cins, 8))
        with pytest.raises(ValueError, match="1x1 wgmma kernel"):
            K._launch_conv1x1_wgmma(
                [(x.to(cuda), 4) for x in xs], wq.to(cuda), b.to(cuda),
                None, leaky=True, rounding="nearest",
                **{k: v for k, v in SHIFTS.items() if k != "sa_in"})
    with pytest.raises(ValueError, match="1x1 wgmma kernel"):
        K.conv1x1_wgmma_layout(64, 24, 0, 8, False)
    assert K.launch_counts_by_entry() == {}


@pytest.mark.cuda
def test_cuda_conv1x1_wgmma_empty_batch_counts_no_launch(cuda):
    K.reset_launch_counts()
    out = K.int8_conv_requant(
        torch.zeros((0, 4, 4, 32), dtype=torch.int8, device=cuda),
        torch.zeros((1, 1, 32, 8), dtype=torch.int8, device=cuda),
        torch.zeros(8, dtype=torch.int32, device=cuda), **SHIFTS)
    assert out.shape == (0, 4, 4, 8)
    assert K.launch_counts() == {k: 0 for k in K.KERNEL_NAMES}


# (BN, column tiles) the kernel takes at the v3 1x1s at batch 128, by
# (M, C_in parts, C_out); the concats' parts take two shifts, as served
CONV1X1_TILES = {
    (21632, (1024,), 512): (128, 4),
    (21632, (512,), 256): (256, 1),
    (86528, (512, 256), 256): (128, 2),
    (86528, (512,), 256): (256, 1),
    (86528, (256,), 128): (128, 1),
    (346112, (256, 128), 128): (128, 1),
    (346112, (256,), 128): (128, 1),
    (21632, (1024,), 21): (32, 1),
}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", sorted(CONV1X1_TILES),
                         ids=lambda s: "-".join(map(str, s)))
def test_cuda_conv1x1_wgmma_layout_at_v3_shapes(cuda, shape):
    """The column tile covers C_out where the resident weights fit, the
    rings keep 4 stages each, one block per SM, a grid of one block per
    SM."""
    m, cins, c_out = shape
    lay = K.conv1x1_wgmma_layout(m, cins[0], cins[1] if len(cins) == 2
                                 else 0, c_out, len(cins) == 2)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert (lay.bn, lay.n_tiles) == CONV1X1_TILES[shape]
    assert lay.tile_m == 64 and lay.blocks_per_sm == 1
    assert lay.ring_stages == 4 and lay.smem_bytes <= 232448
    assert lay.grid == sms // lay.n_tiles * lay.n_tiles
    assert lay.weight_bytes == lay.bn * sum(-(-c // 128) * 128 for c in cins)


# ---------------------------------------------------------------------------
# Per-channel sw and overflow counting: the wgmma conv3x3's per-column and
# counting forms (stride 1 and pooled), those of the NHWC form of K2's
# kernel (conv1) and the mma.sync conv's shift table.
# ---------------------------------------------------------------------------

# slim's NHWC layers (B, H, C_in, C_out, pool): conv1 (the NHWC form of
# K2's wgmma kernel), the three pooled wgmma layers and the six stride-1
# ones (pred: 35)
PC_SHAPES = [(1, 416, 3, 16, True), (2, 208, 16, 32, True),
             (2, 104, 64, 64, True), (2, 52, 128, 128, True),
             (2, 104, 32, 64, False), (2, 52, 64, 128, False),
             (2, 26, 128, 256, False), (2, 26, 256, 256, False),
             (2, 26, 256, 35, False)]
PC_KW = dict(sb=7, sa_in=4, sa_out=4, retune=11)


def _pc_sw(rng, c_in, c_out, case):
    """A per-channel sw: accumulator shifts around the one that spreads
    the int8 output; "mixed" with -1, 33, 31 and -40 among them, "short"
    all in [0, 30], "count" 4 lower (many values pass int16)."""
    base = max(0, round(np.log2(np.sqrt(9 * c_in) * 74 * 35 / 4096)))
    s = base + rng.integers(-2, 3, c_out)
    if case == "count":
        s -= 4
    if case == "mixed":
        s[:4] = [-1, 33, 31, -40][:c_out]
    if case == "short":
        s = np.clip(s, 0, 30)
    return (s - PC_KW["sa_in"] + PC_KW["retune"]).astype(np.int32)


def _pc_run(x, w, b, pool, kw, **extra):
    if pool:
        return K.int8_conv3x3_im2col(x, w, b, pool=True, **kw, **extra)
    return K.int8_conv3x3_requant(x, w, b, **kw, **extra)


@pytest.mark.cuda
@pytest.mark.parametrize("rounding", ROUNDINGS)
@pytest.mark.parametrize("case", ["mixed", "short", "count",
                                  "count_scalar"])
@pytest.mark.parametrize("shape", PC_SHAPES,
                         ids=lambda s: "-".join(map(str, s)))
def test_cuda_per_column_forms_equal_plain(cuda, rounding, case, shape):
    """Output (and, counting, the count: equal and nonzero) of the
    per-column and counting forms == the plain version's, on the C entry
    the route names."""
    bsz, h, c_in, c_out, pool = shape
    rng = np.random.default_rng(c_in * c_out)
    x, w, b = _conv3x3_args((bsz, h, h, c_in, c_out), seed=c_in)
    sw = _pc_sw(rng, c_in, c_out, "count" if case == "count_scalar"
                else case)
    kw = dict(PC_KW, sw=int(sw[0]) if case == "count_scalar" else sw,
              leaky=c_out != 35, rounding=rounding)
    counting = case.startswith("count")
    n_want = torch.zeros(1, dtype=torch.int32) if counting else None
    want = _pc_run(x, w, b, pool, kw, overflow=n_want)
    n = torch.zeros(1, dtype=torch.int32, device=cuda) if counting else None
    K.reset_launch_counts()
    got = _pc_run(x.to(cuda), w.to(cuda), b.to(cuda), pool, kw, overflow=n)
    torch.cuda.synchronize()
    (entries,) = K.launch_counts_by_entry().values()
    want_entry = ({False: K.POOL_NHWC_COLS_ENTRY,
                   True: K.POOL_NHWC_COUNT_ENTRY}[counting] if c_in == 3 else
                  {(False, False): K.COLS_WGMMA_ENTRY,
                   (True, False): K.POOL_COLS_WGMMA_ENTRY,
                   (False, True): K.COUNT_WGMMA_ENTRY,
                   (True, True): K.POOL_COUNT_WGMMA_ENTRY}[pool, counting])
    assert entries == {want_entry: 1}
    assert torch.equal(got.cpu(), want)
    if counting:
        assert int(n) == int(n_want) > 0


@pytest.mark.cuda
def test_cuda_per_column_forms_take_a_model_table(cuda):
    """The table ``acc_shift_table`` makes once is read as given (no table
    made per call), and a table or counter of the wrong kind raises."""
    x, w, b = (t.to(cuda) for t in _conv3x3_args((2, 26, 26, 128, 256)))
    sw = _pc_sw(np.random.default_rng(0), 128, 256, "mixed")
    kw = dict(PC_KW, sw=sw, rounding="nearest")
    table = K.acc_shift_table(sw, 4, 11, "nearest", 256, cuda)
    K.reset_shift_table_count()
    got = K.int8_conv3x3_requant(x, w, b, shifts=table, **kw)
    assert K.shift_table_count() == 0
    assert torch.equal(got.cpu(), K.int8_conv3x3_requant_plain(
        x.cpu(), w.cpu(), b.cpu(), **kw))
    with pytest.raises(ValueError, match="shift table"):
        K.int8_conv3x3_requant(x, w, b, shifts=table[:128], **kw)
    with pytest.raises(ValueError, match="shift table"):
        K.int8_conv3x3_requant(x, w, b, shifts=table.cpu(), **kw)
    with pytest.raises(ValueError, match="overflow counter"):
        K.int8_conv3x3_requant(x, w, b, **kw,
                               overflow=torch.zeros(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="C_out"):
        K.int8_conv3x3_requant(x, w, b, **dict(kw, sw=sw[:255]))


@pytest.mark.cuda
def test_cuda_other_routes_refuse_per_channel_sw(cuda):
    """The s2d layout and the general conv's mma.sync kernel keep one shift
    per layer (a stride-2 3x3 of C_in 16, a 3x3 of pad 0); the stride-2
    and stride-1 wgmma routes take a per-channel sw on their per-column
    forms."""
    x, w, b = (t.to(cuda) for t in _conv3x3_args((1, 14, 14, 32, 64)))
    sw = np.full(64, 12, np.int32)
    for stride, entry in ((2, K.S2_COLS_WGMMA_ENTRY),
                          (1, K.COLS_WGMMA_ENTRY)):
        kw = dict(PC_KW, sw=sw, padding=1, stride=stride)
        K.reset_launch_counts()
        got = K.int8_conv_requant(x, w, b, **kw)
        assert K.launch_counts_by_entry() == {
            "int8_conv_requant": {entry: 1}}
        assert torch.equal(got.cpu(), K.int8_conv_requant(
            x.cpu(), w.cpu(), b.cpu(), **kw))
    with pytest.raises(ValueError, match="per-channel"):
        K.int8_conv_requant(x[..., :16].contiguous(), w[:, :, :16], b,
                            padding=1, stride=2, **PC_KW, sw=sw)
    with pytest.raises(ValueError, match="per-channel"):
        K.int8_conv_requant(x, w, b, padding=0, stride=1, **PC_KW, sw=sw)
    x3 = torch.zeros((1, 10, 10, 12), dtype=torch.int8, device=cuda)
    w3 = torch.zeros((3, 3, 3, 16), dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="per-channel"):
        K.int8_conv3x3_pool_s2d(x3, w3, b[:16], c_in=3, **PC_KW,
                                sw=np.full(16, 12, np.int32))


# ---------------------------------------------------------------------------
# The NHWC form of K2's wgmma kernel (csrc/int8_entry_conv.cu): conv3x3 + 2x2
# pool of C_in <= 4 on NHWC input, slim's conv1 (pool_nhwc_wgmma_route), in
# its scalar, per-column and counting forms.
# ---------------------------------------------------------------------------

POOL_NHWC_ENTRIES = {"scalar": K.POOL_NHWC_WGMMA_ENTRY,
                     "cols": K.POOL_NHWC_COLS_ENTRY,
                     "count": K.POOL_NHWC_COUNT_ENTRY,
                     "count_scalar": K.POOL_NHWC_COUNT_ENTRY}
# (B, H, W, C_in, C_out): slim's conv1 at batch 1, 8 and 256; NHWC rows of
# W * C_in bytes that are no 16-byte multiple (8 x 10, 12 x 22, 14 x 10),
# C_in 1, 2 and 4, C_out 1, 7, 20 and 32 (the 128-column form), row tiles
# that leave a partial tile, width chunks (a 6002-pixel row does not fit
# one block), a 2 x 2 image
POOL_NHWC_SHAPES = [
    (1, 416, 416, 3, 16),
    (8, 416, 416, 3, 16),
    (256, 416, 416, 3, 16),
    (2, 8, 10, 3, 16),
    (2, 12, 22, 3, 32),
    (3, 38, 26, 3, 16),
    (1, 6, 14, 1, 1),
    (2, 10, 6, 2, 7),
    (1, 8, 18, 4, 32),
    (2, 14, 10, 3, 20),
    (1, 4, 6002, 3, 32),
    (1, 2, 2, 1, 16),
]


def _pool_nhwc_kw(form, c_in, c_out, seed):
    """Shifts of one form: the scalar sw of SHIFTS; per-column sw with
    shifts -1, 33, 31 and -40 among them ("cols"); 4 lower, so that many
    values pass int16 ("count"); a scalar sw 4 lower, counted
    ("count_scalar")."""
    rng = np.random.default_rng(seed)
    if form == "scalar":
        return dict(SHIFTS)
    sw = _pc_sw(rng, c_in, c_out, "mixed" if form == "cols" else "count")
    return dict(PC_KW, sw=int(sw[0]) if form == "count_scalar" else sw)


@pytest.mark.cuda
@pytest.mark.parametrize("form", sorted(POOL_NHWC_ENTRIES))
@pytest.mark.parametrize("case", POOL_NHWC_SHAPES,
                         ids=lambda c: "-".join(map(str, c)))
def test_cuda_pool_nhwc_wgmma_equals_plain(cuda, form, case):
    """Each form == the plain pooled conv (output, and counting: the count,
    equal, and nonzero at 416^2), on its C entry, from packed weights, at
    batch 1, 8 and 256 of 416^2 and at edge shapes; the plain version runs
    on the card."""
    bsz, h, w, c_in, c_out = case
    x, wq, b = (t.to(cuda) for t in _conv3x3_args(case, seed=18))
    kw = dict(_pool_nhwc_kw(form, c_in, c_out, c_in * c_out), leaky=True,
              rounding="nearest")
    counting = form.startswith("count")
    n_want = (torch.zeros(1, dtype=torch.int32, device=cuda) if counting
              else None)
    want = K.int8_conv3x3_im2col_plain(x, wq, b, pool=True, overflow=n_want,
                                       **kw)
    packed = K.pack_pool_nhwc_weights(wq)
    n = torch.zeros(1, dtype=torch.int32, device=cuda) if counting else None
    K.reset_launch_counts()
    K.reset_pool_nhwc_pack_count()
    got = K.int8_conv3x3_im2col(x, None, b, pool=True, packed=packed,
                                overflow=n, **kw)
    torch.cuda.synchronize()
    assert K.launch_counts_by_entry() == {
        "int8_conv3x3_im2col": {POOL_NHWC_ENTRIES[form]: 1}}
    assert K.pool_nhwc_pack_count() == 0
    assert got.shape == (bsz, h // 2, w // 2, c_out)
    assert torch.equal(got, want)
    if counting:
        assert int(n) == int(n_want)
        if h == 416:
            assert int(n) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("leaky", [True, False])
@pytest.mark.parametrize("rounding", ROUNDINGS)
@pytest.mark.parametrize("shifts", SHIFT_CASES, ids=SHIFT_IDS)
@pytest.mark.parametrize("case", [(2, 12, 22, 3, 16), (1, 10, 14, 4, 32),
                                  (2, 8, 10, 1, 7)],
                         ids=lambda c: "-".join(map(str, c)))
def test_cuda_pool_nhwc_wgmma_epilogues(cuda, leaky, rounding, shifts, case):
    """The scalar form in both roundings, both activations; shifts outside
    [0, 31] take the kernel's general shift form; HWIO weights are packed
    for the call."""
    x, wq, b = _conv3x3_args(case, seed=19)
    kw = dict(shifts, rounding=rounding, leaky=leaky)
    want = K.int8_conv3x3_im2col(x, wq, b, pool=True, **kw)
    K.reset_launch_counts()
    K.reset_pool_nhwc_pack_count()
    got = K.int8_conv3x3_im2col(*(t.to(cuda) for t in (x, wq, b)), pool=True,
                                **kw)
    torch.cuda.synchronize()
    assert K.launch_counts_by_entry() == {
        "int8_conv3x3_im2col": {K.POOL_NHWC_WGMMA_ENTRY: 1}}
    assert K.pool_nhwc_pack_count() == 1
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("leaky", [True, False])
@pytest.mark.parametrize("rounding", ROUNDINGS)
@pytest.mark.parametrize("form", ["cols", "count"])
@pytest.mark.parametrize("case", [(2, 12, 22, 3, 16), (1, 10, 14, 4, 32),
                                  (2, 8, 10, 2, 7)],
                         ids=lambda c: "-".join(map(str, c)))
def test_cuda_pool_nhwc_wgmma_column_epilogues(cuda, leaky, rounding, form,
                                               case):
    """The per-column and counting forms in both roundings, both
    activations, with per-column shifts outside [0, 31]; counts equal."""
    x, wq, b = _conv3x3_args(case, seed=20)
    kw = dict(_pool_nhwc_kw(form, case[3], case[4], 7), rounding=rounding,
              leaky=leaky)
    n_want = torch.zeros(1, dtype=torch.int32) if form == "count" else None
    want = K.int8_conv3x3_im2col(x, wq, b, pool=True, overflow=n_want, **kw)
    n = (torch.zeros(1, dtype=torch.int32, device=cuda) if form == "count"
         else None)
    K.reset_launch_counts()
    got = K.int8_conv3x3_im2col(*(t.to(cuda) for t in (x, wq, b)), pool=True,
                                overflow=n, **kw)
    torch.cuda.synchronize()
    assert K.launch_counts_by_entry() == {
        "int8_conv3x3_im2col": {POOL_NHWC_ENTRIES[form]: 1}}
    assert torch.equal(got.cpu(), want)
    if form == "count":
        assert int(n) == int(n_want)


@pytest.mark.cuda
def test_cuda_pool_nhwc_stride2_assembly_takes_the_wgmma_kernel(cuda):
    """``int8_conv3x3_pool_requant(assembly='stride2')`` at C_in <= 4 runs
    the same kernel on the NHWC input."""
    x, wq, b = _conv3x3_args((2, 12, 18, 3, 16), seed=21)
    want = K.int8_conv3x3_pool_requant(x, wq, b, assembly="stride2",
                                       **SHIFTS)
    K.reset_launch_counts()
    got = K.int8_conv3x3_pool_requant(*(t.to(cuda) for t in (x, wq, b)),
                                      assembly="stride2", **SHIFTS)
    torch.cuda.synchronize()
    assert K.launch_counts_by_entry() == {
        "int8_conv3x3_pool_requant": {K.POOL_NHWC_WGMMA_ENTRY: 1}}
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_cuda_pool_nhwc_wgmma_raises_not_falls_back(cuda):
    """A routed pooled conv with a misaligned input raises: it never drops
    back to the mma.sync conv; the launcher raises on C_in 5 and C_out 48,
    the layout on an odd image. C_in 8 stays on the mma.sync conv."""
    x, wq, b = _conv3x3_args((1, 8, 10, 3, 16))
    buf = torch.zeros(1 + x.numel(), dtype=torch.int8, device=cuda)
    xm = buf[1:].view(x.shape)
    xm.copy_(x)
    K.reset_launch_counts()
    with pytest.raises(ValueError, match="aligned"):
        K.int8_conv3x3_im2col(xm, wq.to(cuda), b.to(cuda), pool=True,
                              **SHIFTS)
    for c_in, c_out in ((5, 16), (3, 48)):
        x5, w5, b5 = (t.to(cuda) for t in _conv3x3_args((1, 8, 10, c_in,
                                                         c_out)))
        with pytest.raises(ValueError, match="C_in <= 4"):
            K._launch_pool_nhwc_wgmma("int8_conv3x3_im2col", x5, w5, b5,
                                      None, leaky=True, rounding="nearest",
                                      **SHIFTS)
    with pytest.raises(ValueError, match="pooled NHWC"):
        K.pool_nhwc_wgmma_layout(9, 10, 3, 16)
    assert K.launch_counts_by_entry() == {}
    x8, w8, b8 = _conv3x3_args((2, 8, 10, 8, 16), seed=22)
    want = K.int8_conv3x3_im2col(x8, w8, b8, pool=True, **SHIFTS)
    got = K.int8_conv3x3_im2col(*(t.to(cuda) for t in (x8, w8, b8)),
                                pool=True, **SHIFTS)
    torch.cuda.synchronize()
    assert K.launch_counts_by_entry() == {
        "int8_conv3x3_im2col": {K.MMA_SYNC_ENTRY: 1}}
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_cuda_pool_nhwc_wgmma_empty_batch_counts_no_launch(cuda):
    K.reset_launch_counts()
    out = K.int8_conv3x3_im2col(
        torch.zeros((0, 8, 8, 3), dtype=torch.int8, device=cuda),
        torch.zeros((3, 3, 3, 16), dtype=torch.int8, device=cuda),
        torch.zeros(16, dtype=torch.int32, device=cuda), pool=True, **SHIFTS)
    assert out.shape == (0, 4, 4, 16)
    assert K.launch_counts() == {k: 0 for k in K.KERNEL_NAMES}


@pytest.mark.cuda
def test_cuda_pool_nhwc_wgmma_layout(cuda):
    """At slim's conv1 on NHWC input (416^2 -> 208^2 pooled): 9 x 208
    pooled tiles of 20 input rows, three blocks per SM, 4 phases x 16
    columns; the pitches keep the global rows' alignment; a row too wide
    for a block is cut in halves."""
    lay = K.pool_nhwc_wgmma_layout(416, 416, 3, 16)
    assert (lay.tile_h, lay.tile_w, lay.blocks_per_sm, lay.bn,
            lay.warpgroups) == (9, 208, 3, 64, 2)
    assert lay.smem_bytes * lay.blocks_per_sm <= 233472
    assert lay.in_pitch % 16 == 416 * 3 % 16
    assert lay.in_pitch >= 418 * 3 + 48
    assert lay.out_pitch % 16 == 208 * 16 % 16
    odd = K.pool_nhwc_wgmma_layout(12, 22, 3, 32)
    assert odd.bn == 128 and odd.in_pitch % 16 == 22 * 3 % 16
    assert K.pool_nhwc_wgmma_layout(4, 6002, 3, 32).tile_w == 1501


# ---------------------------------------------------------------------------
# Per-channel yolo_v3 (int8_conv_requant with a per-channel sw): the
# per-column forms of the wgmma conv3x3's stride-2 form, the entry conv and
# the 1x1 GEMM, and the stride-1 form the head's 3x3s take.
# ---------------------------------------------------------------------------

# each route's per-column C entry
PCV3_ENTRY = {"s1": K.COLS_WGMMA_ENTRY, "s2": K.S2_COLS_WGMMA_ENTRY,
              "entry": K.ENTRY_CONV_COLS_ENTRY,
              "1x1": K.CONV1X1_COLS_ENTRY}
# (route, B, H, W, C_in parts, C_out): odd H and W, C_out below a tile and
# not a multiple of it (21, as the preds have), the 64- and 128-column
# forms, a stride-2 halo over 128-channel slabs (27^2 C_in 256), the
# entry conv's 32- and 64-column forms, the 1x1's ragged second column
# tile (300) and concats (each at equal and at different part scales)
PCV3_CASES = [
    ("s2", 2, 13, 11, (32,), 64),
    ("s2", 1, 9, 15, (64,), 21),
    ("s2", 2, 27, 27, (256,), 512),
    ("s2", 1, 7, 7, (512,), 1024),
    ("s1", 2, 9, 7, (64,), 21),
    ("s1", 1, 13, 13, (512,), 1024),
    ("entry", 2, 17, 23, (3,), 32),
    ("entry", 1, 9, 13, (3,), 21),
    ("entry", 1, 8, 40, (2,), 64),
    ("1x1", 2, 7, 9, (64,), 21),
    ("1x1", 1, 11, 13, (256,), 300),
    ("1x1", 2, 13, 13, (1024,), 512),
    ("1x1", 2, 9, 7, (48, 80), 64),
    ("1x1", 2, 13, 13, (512, 256), 256),
    ("1x1", 1, 10, 10, (256, 128), 128),
]


def _pcv3_args(case, sw_case, seed=0):
    route, bsz, h, w, cins, c_out = case
    rng = np.random.default_rng(seed + c_out + sum(cins))
    k = 1 if route == "1x1" else 3
    xs = [torch.tensor(rng.integers(-128, 128, (bsz, h, w, c))
                       .astype(np.int8)) for c in cins]
    wq = torch.tensor(rng.integers(-30, 40, (k, k, sum(cins), c_out))
                      .astype(np.int8))
    b = torch.tensor(rng.integers(-100, 100, (c_out,)).astype(np.int32))
    sw = _pc_sw(rng, sum(cins) * k * k // 9 or 1, c_out, sw_case)
    kw = dict(PC_KW, sw=sw, sa_in=None, padding=k // 2,
              stride=2 if route == "s2" else 1)
    return xs, wq, b, kw


@pytest.mark.cuda
@pytest.mark.parametrize("rounding", ROUNDINGS)
@pytest.mark.parametrize("sw_case", ["mixed", "short"])
@pytest.mark.parametrize("case", PCV3_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_cuda_v3_per_column_forms_equal_plain(cuda, rounding, sw_case, case):
    """int8_conv_requant with a per-channel sw on each per-column form ==
    the plain version: shift codes >= 31 and <= -32 ("mixed") and all in
    [0, 30] (the short form, "short"), both roundings, slopes 0.1, 0.125
    and none; one launch, on the route's per-column C entry."""
    xs, wq, b, kw = _pcv3_args(case, sw_case)
    route, *_, cins, c_out = case
    leaky = {21: False, 64: 0.1}.get(c_out, True)
    for sas in ((4, 6), (5, 5)) if len(cins) == 2 else ((4,),):
        kwr = dict(kw, leaky=leaky, rounding=rounding)
        want = K.int8_conv_requant(list(zip(xs, sas)), wq, b, **kwr)
        K.reset_launch_counts()
        got = K.int8_conv_requant([(x.to(cuda), sa) for x, sa in zip(xs, sas)],
                                  wq.to(cuda), b.to(cuda), **kwr)
        torch.cuda.synchronize()
        assert K.launch_counts_by_entry() == {
            "int8_conv_requant": {PCV3_ENTRY[route]: 1}}
        assert torch.equal(got.cpu(), want), sas


@pytest.mark.cuda
@pytest.mark.parametrize("case", [c for c in PCV3_CASES
                                  if c[0] in ("entry", "1x1")],
                         ids=lambda c: "-".join(map(str, c)))
def test_cuda_v3_per_column_forms_take_model_tables(cuda, case):
    """The tables ``conv_shift_tables`` makes once (a 1x1's 256-aligned)
    and packed weights are read as given: no table is made per call; a
    concat at different part scales takes a table per part, one at equal
    scales one; a wrong count or a short table raises."""
    xs, wq, b, kw = _pcv3_args(case, "mixed", seed=1)
    route, *_, cins, c_out = case
    align = K.CONV1X1_ALIGN if route == "1x1" else K.TABLE_ALIGN
    packed = (K.pack_conv1x1_weights(wq.to(cuda)) if route == "1x1"
              else K.pack_entry_conv_weights(wq.to(cuda)))
    for sas in ((4, 6), (5, 5)) if len(cins) == 2 else ((4,),):
        tables = K.conv_shift_tables(kw["sw"], sas, kw["retune"], "nearest",
                                     c_out, cuda, align)
        assert len(tables) == len(set(sas))
        parts = [(x.to(cuda), sa) for x, sa in zip(xs, sas)]
        K.reset_shift_table_count()
        got = K.int8_conv_requant(parts, None, b.to(cuda), packed=packed,
                                  shifts=tables, **kw)
        assert K.shift_table_count() == 0
        assert torch.equal(got.cpu(), K.int8_conv_requant(
            list(zip(xs, sas)), wq, b, **kw))
        with pytest.raises(ValueError, match="shift table"):
            K.int8_conv_requant(parts, None, b.to(cuda), packed=packed,
                                shifts=tables * 2, **kw)
    if route == "1x1" and c_out % 256:
        short = K.conv_shift_tables(kw["sw"], (4,) * len(cins), kw["retune"],
                                    "nearest", c_out, cuda)
        with pytest.raises(ValueError, match="shift table"):
            K.int8_conv_requant([(x.to(cuda), 4) for x in xs], None,
                                b.to(cuda), packed=packed, shifts=short, **kw)


# ---------------------------------------------------------------------------
# K4's per-column form: a per-channel sw in both convs of a residual block
# (per-channel yolo_v3's 23 blocks).
# ---------------------------------------------------------------------------

# (B, H, W, C, C_mid): each (BN1, BN2) form, (32, 64), (64, 128) and
# (128, 128), at odd H and W in one tile and with edge tiles (tiles of up
# to 26 x 26)
RES_COLS_CASES = [
    (2, 9, 7, 64, 32),
    (1, 31, 29, 64, 32),
    (2, 11, 13, 128, 64),
    (1, 29, 27, 128, 64),
    (1, 15, 17, 256, 128),
    (1, 27, 25, 512, 256),
]


def _res_pc_sw(rng, depth, c_out, p, case):
    """A per-channel sw of one of K4's convs (``p`` its scales):
    accumulator shifts around the one that spreads an int8 output of
    ``depth`` products; "mixed" with -1, 33, 31 and -40 among them (the
    general shift form), "short" all in [0, 30]."""
    base = max(0, round(np.log2(np.sqrt(depth) * 74 * 35 / 4096)))
    s = base + rng.integers(-2, 3, c_out)
    if case == "mixed":
        s[:4] = [-1, 33, 31, -40]
    else:
        s = np.clip(s, 0, 30)
    return (s - p["sa_in"] + p["retune"]).astype(np.int32)


def _res_pc_params(case, sw_case):
    c, cmid = case[3:]
    rng = np.random.default_rng(c + cmid)
    return (dict(P1, sw=_res_pc_sw(rng, c, cmid, P1, sw_case)),
            dict(P2, sw=_res_pc_sw(rng, 9 * cmid, c, P2, sw_case)))


@pytest.mark.cuda
@pytest.mark.parametrize("tables", ["model", "per_call"])
@pytest.mark.parametrize("sw_case", ["mixed", "short"])
@pytest.mark.parametrize("sa_res", [None, 3])
@pytest.mark.parametrize("rounding", ROUNDINGS)
@pytest.mark.parametrize("case", RES_COLS_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_cuda_res_block_per_column_equals_plain(cuda, rounding, sa_res,
                                                sw_case, tables, case):
    """K4 with a per-channel sw in both convs == the plain version, at
    shift codes >= 31 and <= -32 ("mixed") and all in [0, 30] (the short
    form): one launch, on its per-column C entry, on the tables
    ``acc_shift_table`` makes once and the packed weights (as
    ``pack_res_blocks`` leaves them; no table made in the call), or on
    tables the wrapper makes for the call (two)."""
    x, w1, b1, w2, b2 = _res_args(case, seed=4)
    c, cmid = case[3:]
    p1, p2 = _res_pc_params(case, sw_case)
    kw = dict(sa_res=sa_res, leaky=0.1, rounding=rounding)
    want = K.int8_res_block(x, w1, b1, p1, w2, b2, p2, **kw)
    x, w1, b1, w2, b2 = (t.to(cuda) for t in (x, w1, b1, w2, b2))
    extra = {}
    if tables == "model":
        extra = dict(packed=K.pack_res_block_weights(w1, w2), shifts=tuple(
            K.acc_shift_table(p["sw"], p["sa_in"], p["retune"], rounding,
                              n, cuda) for p, n in ((p1, cmid), (p2, c))))
        w1 = w2 = None
    K.reset_launch_counts()
    K.reset_shift_table_count()
    got = K.int8_res_block(x, w1, b1, p1, w2, b2, p2, **kw, **extra)
    torch.cuda.synchronize()
    assert K.launch_counts_by_entry() == {
        "int8_res_block": {K.RES_BLOCK_COLS_ENTRY: 1}}
    assert K.shift_table_count() == (2 if tables == "per_call" else 0)
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_cuda_res_block_per_column_checks_tables(cuda):
    """Tables that are too short for a conv's channels, of another type or
    not two raise before any launch."""
    case = RES_COLS_CASES[2]
    x, w1, b1, w2, b2 = (t.to(cuda) for t in _res_args(case))
    p1, p2 = _res_pc_params(case, "short")
    good = [K.acc_shift_table(p["sw"], p["sa_in"], p["retune"], "nearest",
                              n, cuda) for p, n in ((p1, 64), (p2, 128))]
    K.reset_launch_counts()
    for shifts in ((good[0][:32], good[1]), (good[0], good[1].long()),
                   (good[0],), (*good, good[1])):
        with pytest.raises(ValueError, match="shift table"):
            K.int8_res_block(x, w1, b1, p1, w2, b2, p2, shifts=shifts)
    assert K.launch_counts()["int8_res_block"] == 0


@pytest.mark.cuda
def test_cuda_per_channel_v3_detect_fn_serves(cuda):
    """The per-channel yolo_v3 fixture's model (weights rebuilt from its
    seed) served on CUDA at 64², batch 2: the heads equal the plain CPU
    walk's, the detect fn's outputs its CPU detect fn's; per forward 23
    launches on K4's per-column entry and 29 on the per-column entries of
    int8_conv_requant (9 stride-1, 5 stride-2, 1 entry conv, 14 1x1s),
    the 92 + 62 tables made when the fn took the model, none per call."""
    from pathlib import Path

    from yolo_tpu_torch.config import get_config
    from yolo_tpu_torch.quant import int8_yolo_v3 as tv3
    from yolo_tpu_torch.quant.convert import int8_yolo_v3_from_seed

    path = (Path(__file__).resolve().parents[1] / "yolo_tpu_torch" / "data"
            / "yolo_v3_int8_pc_416_golden.npz")
    with np.load(path) as z:
        m = int8_yolo_v3_from_seed({k: z[k] for k in z.files}, device="cpu")
    cfg = get_config("yolo_v3", "mask", input_size=(64, 64))
    images = np.random.default_rng(3).random((2, 64, 64, 3),
                                             dtype=np.float32)
    x_q = tfp.quantize_input(torch.tensor(images), m.sa_in)
    want = tv3.int8_yolo_v3_forward(m, x_q)
    K.reset_shift_table_count()
    detect = tv3.make_int8_yolo_v3_detect_fn(m, cfg, device="cuda")
    assert K.shift_table_count() == 92 + 62
    m_dev = m.to(cuda)
    m_dev.pack_res_blocks()
    m_dev.pack_conv3x3s()
    K.reset_launch_counts()
    K.reset_shift_table_count()
    got = tv3.int8_yolo_v3_forward(m_dev, x_q.to(cuda))
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    assert K.launch_counts_by_entry() == {
        "int8_res_block": {K.RES_BLOCK_COLS_ENTRY: 23},
        "int8_conv_requant": {PCV3_ENTRY["s1"]: 9, PCV3_ENTRY["s2"]: 5,
                              PCV3_ENTRY["entry"]: 1, PCV3_ENTRY["1x1"]: 14}}
    assert K.shift_table_count() == 0
    cpu = tv3.make_int8_yolo_v3_detect_fn(m, cfg, device="cpu")(images)
    for g, w in zip(detect(images), cpu):
        if g.dtype.is_floating_point:
            np.testing.assert_allclose(g.cpu().numpy(), w.numpy(),
                                       atol=1e-5, rtol=1e-5)
        else:
            assert torch.equal(g.cpu(), w)


# ---------------------------------------------------------------------------
# yolo_v3's serving forms on the card: the s2d execution forms and the
# ``limit`` hook, scalar and per-channel.
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def v3_fixtures():
    """{kind: (the CPU model, the CUDA model, packed)} for the scalar and
    per-channel yolo_v3 fixtures (weights rebuilt from their seeds), and
    int8 input [2, 64, 64, 3] at each one's scale."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from pathlib import Path

    from yolo_tpu_torch.quant.convert import int8_yolo_v3_from_seed

    data = Path(__file__).resolve().parents[1] / "yolo_tpu_torch" / "data"
    images = torch.tensor(np.random.default_rng(4).random(
        (2, 64, 64, 3), dtype=np.float32))
    out = {}
    for kind, name in (("scalar", "yolo_v3_int8_416_golden.npz"),
                       ("per_channel", "yolo_v3_int8_pc_416_golden.npz")):
        with np.load(data / name) as z:
            m = int8_yolo_v3_from_seed({k: z[k] for k in z.files},
                                       device="cpu")
        m_dev = m.to(torch.device("cuda"))
        m_dev.pack_res_blocks()
        m_dev.pack_conv3x3s()
        out[kind] = (m, m_dev, tfp.quantize_input(images, m.sa_in))
    return out


def _equal_lists(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["scalar", "per_channel"])
@pytest.mark.parametrize("s2d", ["entry", "stride2", True])
def test_cuda_v3_s2d_forms_equal_the_plain_walk(v3_fixtures, s2d, kind):
    """The v3 forward on the card in each s2d mode: heads equal to the same
    call with s2d=False on the card and to the CPU walk in that mode, with
    the plain walk's launches on each entry (the forms run the kernels of
    the convs they re-execute); scalar also on the s2d serving layout."""
    from yolo_tpu_torch.quant import int8_yolo_v3 as tv3

    m, m_dev, x_q = v3_fixtures[kind]
    want = tv3.int8_yolo_v3_forward(m, x_q, s2d=s2d)
    K.reset_launch_counts()
    plain = tv3.int8_yolo_v3_forward(m_dev, x_q.cuda(), s2d=False)
    plain_counts = K.launch_counts_by_entry()
    K.reset_launch_counts()
    got = tv3.int8_yolo_v3_forward(m_dev, x_q.cuda(), s2d=s2d)
    torch.cuda.synchronize()
    assert K.launch_counts_by_entry() == plain_counts
    _equal_lists(got, want)
    _equal_lists(plain, want)
    if kind == "scalar":
        got = tv3.int8_yolo_v3_forward(m_dev, tfp.s2d_input(x_q.cuda()),
                                       s2d=s2d, input_s2d=True)
        _equal_lists(got, want)


# program ops of yolo_v3: 0-1 the entry pair, 2-5 the first residual
# block (push, 1x1, 3x3, res), 78-81 a residual block of layer_4, 109 the
# c4 concat
@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["scalar", "per_channel"])
@pytest.mark.parametrize("limit,s2d", [
    (1, False), (1, "entry"), (4, False), (5, "entry"), (5, True),
    (80, False), (110, "entry")])
def test_cuda_v3_limit_equals_the_cpu_walk(v3_fixtures, limit, s2d, kind):
    """``limit`` on the card: the live int8 tensors, list for list, equal
    to the CPU walk's. 4, 5 and 80 cut a residual block, whose convs run
    one by one on int8_conv_requant's kernels (per-channel: on tables made
    per call); every whole block before the cut on K4."""
    from yolo_tpu_torch.quant import int8_yolo_v3 as tv3

    m, m_dev, x_q = v3_fixtures[kind]
    prog = m.program
    assert [op[0] for op in prog[78:82]] == ["push", "conv", "conv", "res"]
    blocks = convs = i = 0
    while i < limit:
        if prog[i][0] == "push" and i + 4 <= limit:
            blocks, i = blocks + 1, i + 4
            continue
        convs += prog[i][0] == "conv"
        i += 1
    if limit == 1 and s2d and kind == "scalar":
        convs = 2  # the fused entry pair does not look at limit
    want = tv3.int8_yolo_v3_forward(m, x_q, s2d=s2d, limit=limit)
    K.reset_launch_counts()
    got = tv3.int8_yolo_v3_forward(m_dev, x_q.cuda(), s2d=s2d, limit=limit)
    torch.cuda.synchronize()
    _equal_lists(got, want)
    counts = K.launch_counts()
    assert counts.get("int8_res_block", 0) == blocks
    assert counts.get("int8_conv_requant", 0) == convs


# ---------------------------------------------------------------------------
# tiny_yolo_v3 and yolo_v2 on the card: the convs that ran the mma.sync
# general conv until the two-part and pooled wgmma routes took them, K2 at
# the darknet slope, the whole forwards.
# ---------------------------------------------------------------------------

# (B, H, parts' C_in, C_out): tiny's conv_set_1 [256, 128] at 26², yolo_v2's
# convsets_2.0 [256, 1024] at 13² (C_out cut to 64), tiny's conv_2 (one
# part, C_in 16, with its pool) at 52², and a two-part 3x3 of 48 + 16
# channels, which no wgmma route takes: the mma.sync conv's
MMA_SYNC_CASES = [(2, 26, (256, 128), 256), (2, 13, (256, 1024), 64),
                  (2, 52, (16,), 32), (2, 11, (48, 16), 24)]


@pytest.mark.cuda
@pytest.mark.parametrize("rounding", ROUNDINGS)
@pytest.mark.parametrize("sw_kind", ["scalar", "per_column"])
@pytest.mark.parametrize("scales", ["equal", "unequal"])
@pytest.mark.parametrize("case", MMA_SYNC_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_cuda_tiny_v2_mma_sync_convs_equal_plain(cuda, rounding, scales,
                                                 sw_kind, case):
    """The three convs that ran the mma.sync general conv, now on the
    wgmma conv3x3 kernel: the two-part 3x3s on its two-part form
    (``yolo_int8_conv3x3_parts_wgmma``, per column
    ``..._parts_cols_wgmma``) at equal part scales (the raw partials
    summed before one shift) and unequal ones (two shifts, two tables),
    conv_2 with its pool on its pooled form at the darknet slope 0.1; a
    two-part 3x3 of 48 + 16 channels still on the mma.sync conv, which
    refuses a per-channel sw."""
    bsz, h, cins, c_out = case
    rng = np.random.default_rng(sum(cins))
    xs = [torch.tensor(rng.integers(-128, 128, (bsz, h, h, c)).astype(
        np.int8)) for c in cins]
    w = torch.tensor(rng.integers(-40, 50, (3, 3, sum(cins), c_out)).astype(
        np.int8))
    b = torch.tensor(rng.integers(-100, 100, (c_out,)).astype(np.int32))
    sas = [4, 4 if scales == "equal" else 2][:len(cins)]
    sw = (7 if sw_kind == "scalar" else
          (7 + rng.integers(-2, 3, c_out)).astype(np.int32))
    kw = dict(sw=sw, sb=6, sa_in=sas[0], sa_out=2, retune=9,
              leaky=0.1 if len(cins) == 1 else True, rounding=rounding)
    cols = sw_kind == "per_column"
    if len(cins) == 1:
        if scales == "unequal":
            kw["sa_in"] = 2
        want = K.int8_conv3x3_im2col(xs[0], w, b, pool=True, **kw)
        K.reset_launch_counts()
        got = K.int8_conv3x3_im2col(xs[0].to(cuda), w.to(cuda), b.to(cuda),
                                    pool=True, **kw)
        entry = ("int8_conv3x3_im2col", K.POOL_COLS_WGMMA_ENTRY if cols
                 else K.POOL_WGMMA_ENTRY)
    else:
        x = list(zip(xs, sas))
        kw["padding"] = 1
        want = K.int8_conv_requant(x, w, b, **kw)
        dev_x = [(t.to(cuda), sa) for t, sa in x]
        K.reset_launch_counts()
        if cins[0] % 32 and cols:
            with pytest.raises(ValueError, match="must be a scalar"):
                K.int8_conv_requant(dev_x, w.to(cuda), b.to(cuda), **kw)
            return
        got = K.int8_conv_requant(dev_x, w.to(cuda), b.to(cuda), **kw)
        # [256, 1024]: the two-part form's slab walk
        entry = ("int8_conv_requant",
                 "yolo_int8_conv_requant" if cins[0] % 32 else
                 (K.PARTS_COLS_WGMMA_ENTRY if cols else K.PARTS_WGMMA_ENTRY)
                 + (K.SLAB_WALK if sum(cins) >= 1024 else ""))
    torch.cuda.synchronize()
    assert K.launch_counts_by_entry() == {entry[0]: {entry[1]: 1}}
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("split", [False, True])
def test_cuda_conv3x3_parts_layout(cuda, split):
    """The two-part form's layout at the served shapes: one scale on the
    128-column tile, two scales (a split) on the 64-column one (its second
    accumulator), one block per SM; conv_set_1 on the tile walk (a halo
    of both parts, 3 warpgroups, or 2 at 64 columns), convsets_2.0 on the
    slab walk (a whole 13 x 13 image over 128-channel slabs, 3 warpgroups
    at either width: >= 85% of the M rows on pixels), and [96, 1024] (a
    part of no whole slabs) on the tile walk of before."""
    tiny = K.conv3x3_parts_wgmma_layout(26, 26, 256, 128, 256, split)
    v2 = K.conv3x3_parts_wgmma_layout(13, 13, 256, 1024, 1024, split)
    odd = K.conv3x3_parts_wgmma_layout(13, 13, 96, 1024, 1024, split)
    for lay, c in ((tiny, 384), (v2, 128), (odd, 1120)):
        assert lay.split == split and lay.halo_channels == c
        assert lay.blocks_per_sm == 1
        assert lay.bn == (64 if split else 128)
        # the slab walk's M step: three warpgroups at either width
        assert lay.consumer_warpgroups == (2 if split and lay != v2 else 3)
    assert (v2.tile_h, v2.tile_w) == (13, 13)
    assert v2.tile_pixels / v2.mma_rows >= 0.85
    assert (odd.tile_h, odd.tile_w) != (13, 13) and odd.groups == 1
    with pytest.raises(ValueError, match="two-part form takes no"):
        K.conv3x3_parts_wgmma_layout(13, 13, 48, 16, 64, split)


@pytest.mark.cuda
@pytest.mark.parametrize("rounding", ROUNDINGS)
@pytest.mark.parametrize("c_out", [16, 32])
def test_cuda_pool_s2d_wgmma_takes_the_darknet_slope(cuda, rounding, c_out):
    """K2's wgmma kernel at slope 0.1 (the Q16 rational), as tiny's conv_1
    (3 -> 16) and yolo_v2's conv_1.0 (3 -> 32) run it on the s2d layout."""
    rng = np.random.default_rng(c_out)
    x = tfp.s2d_input_np(rng.integers(-128, 128, (2, 20, 24, 3)).astype(
        np.int8))
    w = torch.tensor(rng.integers(-60, 70, (3, 3, 3, c_out)).astype(np.int8))
    b = torch.tensor(rng.integers(-100, 100, (c_out,)).astype(np.int32))
    kw = dict(SHIFTS, c_in=3, leaky=0.1, rounding=rounding)
    want = K.int8_conv3x3_pool_s2d(torch.tensor(x), w, b, **kw)
    K.reset_launch_counts()
    got = K.int8_conv3x3_pool_s2d(torch.tensor(x).to(cuda), w.to(cuda),
                                  b.to(cuda), **kw)
    torch.cuda.synchronize()
    assert K.launch_counts_by_entry() == {
        "int8_conv3x3_pool_requant": {"yolo_int8_pool_s2d_wgmma": 1}}
    assert torch.equal(got.cpu(), want)


# version -> (fixture, from seed, forward, maker, per-forward launches by
# wrapper and C entry at a scalar sw on NHWC input, the per-channel
# fixture); the 3x3s of C_in >= 1024 on the slab walk (tiny's conv_set_2,
# yolo_v2's convsets_1.x and convsets_2.0)
TINY_V2 = {
    "tiny_yolo_v3": ("tiny_yolo_v3_int8_416_golden.npz", "int8_tiny_from_seed",
                     "int8_tiny_forward", "make_int8_tiny_detect_fn",
                     {"int8_conv_requant": {
                         "yolo_int8_entry_conv3x3_wgmma": 1,
                         "yolo_int8_conv3x3_wgmma": 6,
                         "yolo_int8_conv3x3_wgmma.slab": 1,
                         "yolo_int8_conv3x3_parts_wgmma": 1,
                         "yolo_int8_conv1x1_wgmma": 3},
                      "int8_conv3x3_im2col": {
                          "yolo_int8_conv3x3_pool_wgmma": 1}},
                     "tiny_yolo_v3_int8_pc_416_golden.npz"),
    "yolo_v2": ("yolo_v2_int8_416_golden.npz", "int8_yolo_v2_from_seed",
                "int8_yolo_v2_forward", "make_int8_yolo_v2_detect_fn",
                {"int8_conv_requant": {
                    "yolo_int8_entry_conv3x3_wgmma": 1,
                    "yolo_int8_conv3x3_wgmma": 11,
                    "yolo_int8_conv3x3_wgmma.slab": 2,
                    "yolo_int8_conv3x3_parts_wgmma.slab": 1,
                    "yolo_int8_conv1x1_wgmma": 8}},
                "yolo_v2_int8_pc_416_golden.npz"),
}
# the per-column C entry of each scalar one
PER_COLUMN = {"yolo_int8_entry_conv3x3_wgmma":
              "yolo_int8_entry_conv3x3_cols_wgmma",
              "yolo_int8_conv3x3_wgmma": "yolo_int8_conv3x3_cols_wgmma",
              "yolo_int8_conv3x3_parts_wgmma":
              "yolo_int8_conv3x3_parts_cols_wgmma",
              "yolo_int8_conv3x3_wgmma.slab":
              "yolo_int8_conv3x3_cols_wgmma.slab",
              "yolo_int8_conv3x3_parts_wgmma.slab":
              "yolo_int8_conv3x3_parts_cols_wgmma.slab",
              "yolo_int8_conv1x1_wgmma": "yolo_int8_conv1x1_cols_wgmma",
              "yolo_int8_conv3x3_pool_wgmma":
              "yolo_int8_conv3x3_pool_cols_wgmma"}


@pytest.fixture(scope="module")
def tiny_v2_fixtures():
    """{version: (the CPU model, the CUDA model, packed)} for the
    tiny_yolo_v3 and yolo_v2 fixtures (weights rebuilt from their seeds),
    and int8 input [2, 64, 64, 3] at each one's scale."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from pathlib import Path

    from yolo_tpu_torch.quant import convert

    data = Path(__file__).resolve().parents[1] / "yolo_tpu_torch" / "data"
    images = torch.tensor(np.random.default_rng(4).random(
        (2, 64, 64, 3), dtype=np.float32))
    out = {}
    for version, (name, from_seed, *_) in TINY_V2.items():
        with np.load(data / name) as z:
            m = getattr(convert, from_seed)({k: z[k] for k in z.files},
                                            device="cpu")
        m_dev = m.to(torch.device("cuda"))
        m_dev.pack()
        out[version] = (m, m_dev, tfp.quantize_input(images, m.sa["in"]))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("rounding", ROUNDINGS)
@pytest.mark.parametrize("layout", ["nhwc", "s2d"])
@pytest.mark.parametrize("version", list(TINY_V2))
def test_cuda_tiny_v2_forward_equals_the_cpu_walk(tiny_v2_fixtures, version,
                                                  layout, rounding):
    """The forward on the card, packed weights: heads equal to the CPU
    walk's, with the per-forward launches of the route table (the entry
    conv on NHWC input; on s2d input conv 1 and its pool once on K2's
    wgmma kernel instead) and no pack."""
    from yolo_tpu_torch.quant import int8_models as tim

    m, m_dev, x_q = tiny_v2_fixtures[version]
    forward, routes = getattr(tim, TINY_V2[version][2]), TINY_V2[version][4]
    s2d = layout == "s2d"
    x = tfp.s2d_input(x_q) if s2d else x_q
    want = forward(m, x, rounding, input_s2d=s2d)
    K.reset_launch_counts()
    K.reset_conv3x3_pack_count()
    K.reset_conv3x3_parts_pack_count()
    got = forward(m_dev, x.cuda(), rounding, input_s2d=s2d)
    torch.cuda.synchronize()
    _equal_lists(got, want)
    entries = K.launch_counts_by_entry()
    want_entries = {k: dict(v) for k, v in routes.items()}
    if s2d:
        del want_entries["int8_conv_requant"]["yolo_int8_entry_conv3x3_wgmma"]
        want_entries["int8_conv3x3_pool_requant"] = {
            "yolo_int8_pool_s2d_wgmma": 1}
    assert entries == want_entries
    assert K.conv3x3_pack_count() == K.conv3x3_parts_pack_count() == 0


@pytest.mark.cuda
@pytest.mark.parametrize("version", list(TINY_V2))
def test_cuda_tiny_v2_detect_fn_refuses_per_channel(tiny_v2_fixtures,
                                                    version):
    """A per-channel model is served on the card (the maker refused it
    while conv_2 and the concat convs ran the mma.sync conv): the
    per-channel fixture's detect fn on the card equals the CPU walk's,
    every conv on the per-column form of its kernel, shift tables made
    when the detect fn took the model and none per forward."""
    from pathlib import Path

    from yolo_tpu_torch.config import get_config
    from yolo_tpu_torch.quant import convert
    from yolo_tpu_torch.quant import int8_models as tim

    name, from_seed, forward, maker, routes, pc_name = TINY_V2[version]
    data = Path(__file__).resolve().parents[1] / "yolo_tpu_torch" / "data"
    with np.load(data / pc_name) as z:
        m = getattr(convert, from_seed)({k: z[k] for k in z.files},
                                        device="cpu")
    assert m.per_channel
    cfg = get_config(version, "mask", input_size=(64, 64))
    images = np.random.default_rng(4).random((2, 64, 64, 3),
                                             dtype=np.float32)
    want = getattr(tim, maker)(m, cfg, device="cpu")(images)
    K.reset_shift_table_count()
    detect = getattr(tim, maker)(m, cfg).captured.fn  # eager, not captured
    assert K.shift_table_count() > 0
    K.reset_shift_table_count()
    K.reset_launch_counts()
    got = detect(torch.from_numpy(images).cuda())
    torch.cuda.synchronize()
    assert K.shift_table_count() == 0
    assert K.launch_counts_by_entry() == {
        **{wrapper: {PER_COLUMN[e]: n for e, n in by_entry.items()}
           for wrapper, by_entry in routes.items()},
        "greedy_nms_keep": {"yolo_nms_greedy": 1}}
    np.testing.assert_array_equal(got[3].cpu().numpy(), want[3].numpy())
    np.testing.assert_array_equal(got[2].cpu().numpy(), want[2].numpy())
    np.testing.assert_allclose(got[0].cpu().numpy(), want[0].numpy(),
                               atol=1e-5, rtol=1e-5)
    m_dev = m.to(torch.device("cuda"))
    m_dev.pack()
    x_q = tfp.quantize_input(torch.tensor(images), m.sa["in"])
    _equal_lists(getattr(tim, forward)(m_dev, x_q.cuda()),
                 getattr(tim, forward)(m, x_q))


# ---------------------------------------------------------------------------
# The greedy NMS kernel, the launch op, captured detect fns and artifacts.
# ---------------------------------------------------------------------------


def _nms_case(b, k, kind, seed=0):
    from yolo_tpu_torch.ops import nms  # noqa: F401 (registers the op)

    g = torch.Generator().manual_seed(seed)
    if kind == "chain":  # each box overlaps only its neighbours
        x1 = torch.arange(k, dtype=torch.float32) * 0.6
        z = torch.zeros(k)
        boxes = torch.stack([x1, z, x1 + 1.0, z + 1.0], -1).expand(b, k, 4)
        cls = torch.zeros((b, k), dtype=torch.int32)
        valid = torch.ones((b, k), dtype=torch.bool)
    else:
        xy = torch.rand((b, k, 2), generator=g) * 0.8
        wh = torch.rand((b, k, 2), generator=g) * 0.3 + 0.01
        if kind == "ties":  # equal boxes, equal IoUs
            xy, wh = (xy * 8).round() / 8, (wh * 8).round() / 8 + 0.125
        boxes = torch.cat([xy, xy + wh], -1)
        cls = torch.randint(0, 3, (b, k), generator=g, dtype=torch.int32)
        valid = torch.rand((b, k), generator=g) > 0.2
    return boxes.contiguous(), cls, valid


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 128, 256])
@pytest.mark.parametrize("k", [128, 512, 1024])
@pytest.mark.parametrize("kind,thresh", [("rand", 0.45), ("ties", 0.3),
                                         ("ties", 0.7), ("chain", 0.2)])
def test_cuda_nms_kernel_equals_plain(cuda, b, k, kind, thresh):
    """The kernel's keep mask is the plain fixpoint's (the CPU op's
    function, run on the card: the CPU takes minutes for K sweeps of 256
    images of 1024 candidates; for one image also the CPU op's), bit for
    bit: thresholds not exact in float32, tied boxes, and the chain that
    needs about K sweeps (greedy keeps every other box)."""
    from yolo_tpu_torch.ops import nms

    boxes, cls, valid = _nms_case(b, k, kind)
    dev = [t.to(cuda) for t in (boxes, cls, valid)]
    want = nms.greedy_nms_keep_plain(*dev, thresh).cpu()
    if b == 1:
        assert torch.equal(nms.greedy_nms_keep(boxes, cls, valid, thresh),
                           want)
    K.reset_launch_counts()
    got = nms.greedy_nms_keep(*dev, thresh)
    torch.cuda.synchronize()
    assert K.launch_counts_by_entry() == {
        "greedy_nms_keep": {"yolo_nms_greedy": 1}}
    assert torch.equal(got.cpu(), want)
    if kind == "chain":
        assert torch.equal(want[0], torch.arange(k) % 2 == 0)


@pytest.mark.cuda
def test_cuda_nms_kernel_refuses_more_than_1024(cuda):
    from yolo_tpu_torch.ops import nms

    boxes, cls, valid = (t.to(cuda) for t in _nms_case(1, 1025, "rand"))
    with pytest.raises(ValueError, match="1024"):
        nms.greedy_nms_keep(boxes, cls, valid, 0.5)


@pytest.mark.cuda
def test_cuda_opcheck_nms_and_launch_ops(cuda):
    from yolo_tpu_torch.kernels import _launch_op
    from yolo_tpu_torch.ops import nms

    boxes, cls, valid = (t.to(cuda) for t in _nms_case(4, 96, "rand"))
    torch.library.opcheck(nms.greedy_nms_keep, (boxes, cls, valid, 0.45))
    a = torch.randint(-128, 128, (64, 32), dtype=torch.int8, device=cuda)
    bt = torch.randint(-128, 128, (48, 32), dtype=torch.int8, device=cuda)
    out = torch.empty((64, 48), dtype=torch.int32, device=cuda)
    args = ("int8_gemm", "yolo_int8_gemm", [a, bt], [out], [0, 1, -1],
            [64, 48, 32], [16, 16, 8], "a\nb\nout")
    torch.library.opcheck(_launch_op, args)
    _launch_op(*args)
    assert torch.equal(out, G.int8_gemm_plain(a, bt.t()))


def _golden(name):
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "yolo_tpu_torch" / "data"
    with np.load(path / name) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.cuda
@pytest.mark.parametrize("version", ["slim_yolo_v2", "yolo_v3"])
def test_cuda_captured_detect_equals_eager(cuda, version):
    """The detect fn captured in a CUDA graph gives its eager form's
    (``captured.fn``) detections; its replays launch through no wrapper,
    and the launches derived for them are the eager call's (slim on the
    s2d layout, yolo_v3 on NHWC)."""
    from yolo_tpu_torch.config import get_config
    from yolo_tpu_torch.quant import convert
    from yolo_tpu_torch.quant import int8_yolo_v3 as tv3
    from yolo_tpu_torch.quant.int8_graph import make_int8_detect_fn
    from yolo_tpu_torch.utils import capture

    cfg = get_config(version, "mask", input_size=(416, 416),
                     pre_nms_top_k=128)
    if version == "slim_yolo_v2":
        m = convert.int8_model_from_arrays(
            _golden("slim_int8_416_golden.npz"), device="cuda")
        x = torch.randint(-128, 128, (8, 211, 211, 12), dtype=torch.int8,
                          device=cuda)

        def make():
            return make_int8_detect_fn(m, cfg, input_s2d=True)
    else:
        m = convert.int8_yolo_v3_from_seed(
            _golden("yolo_v3_int8_416_golden.npz"), device="cuda")
        x = torch.randint(-128, 128, (4, 416, 416, 3), dtype=torch.int8,
                          device=cuda)

        def make():
            return tv3.make_int8_yolo_v3_detect_fn(m, cfg)
    eager, graphed = make().captured.fn, make()
    K.reset_launch_counts()
    want = eager(x)
    torch.cuda.synchronize()
    once = K.launch_counts_by_entry()
    K.reset_launch_counts()
    graphed(x)  # two warm-up calls, the capture, a replay
    assert K.launch_counts_by_entry() == {
        w: {e: 2 * n for e, n in by.items()} for w, by in once.items()}
    K.reset_launch_counts()
    capture.reset_replayed_launches()
    for _ in range(3):
        got = graphed(x)
    torch.cuda.synchronize()
    assert len(graphed.captured.graphs) == 1
    assert K.launch_counts_by_entry() == {}
    assert capture.replayed_launches() == {
        w: {e: 3 * n for e, n in by.items()} for w, by in once.items()}
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_exported_slim_artifact_equals_live(cuda, tmp_path):
    from yolo_tpu_torch.config import get_config
    from yolo_tpu_torch.quant import convert
    from yolo_tpu_torch.quant.int8_graph import make_int8_detect_fn
    from yolo_tpu_torch.serving.export import load_artifact, save_artifact

    cfg = get_config("slim_yolo_v2", "mask", input_size=(416, 416),
                     pre_nms_top_k=128)
    m = convert.int8_model_from_arrays(_golden("slim_int8_416_golden.npz"),
                                       device="cuda")
    live = make_int8_detect_fn(m, cfg, input_s2d=True)
    x = torch.randint(-128, 128, (8, 211, 211, 12), dtype=torch.int8,
                      device=cuda)
    path = save_artifact(live, x, str(tmp_path / "slim.pt2"),
                         meta={"input": "s2d"})
    serve, meta = load_artifact(path, with_meta=True)
    assert meta == {"input": "s2d"} and serve.device.type == "cuda"
    for a, b in zip(serve(x), live(x)):
        assert torch.equal(a, b)
    for a, b in zip(load_artifact(path).captured.fn(x), live(x)):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_float_detector_captured(cuda):
    """The float Detector on the card: captured equal to eager, float32
    close to the CPU's (cuDNN sums in another order), bf16 served."""
    from yolo_tpu_torch.config import get_config
    from yolo_tpu_torch.detector import Detector
    from yolo_tpu_torch.quant.convert import module_to_params

    cfg = get_config("yolo_v3", "mask", input_size=(64, 64))
    det = Detector(cfg).init_params(torch.Generator().manual_seed(0))
    eager = det.detect_fn().captured.fn
    params = module_to_params(det.model)
    cpu = Detector(cfg, device="cpu").load_params(params)
    x = np.random.default_rng(0).random((2, 64, 64, 3), dtype=np.float32)
    for a, b in zip(det.detect(x), eager(torch.from_numpy(x).to(cuda))):
        assert torch.equal(a, b)
    boxes, probs = det.predict(x)
    want = cpu.predict(x)
    np.testing.assert_allclose(boxes.cpu().numpy(), want[0].numpy(),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(probs.cpu().numpy(), want[1].numpy(),
                               rtol=1e-4, atol=1e-4)
    bf = Detector(cfg, dtype=torch.bfloat16).load_params(params)
    assert bf.detect(x)[0].dtype == torch.float32


@pytest.mark.cuda
def test_cuda_eval_cli_int8_equals_the_cpu(cuda, monkeypatch, capsys):
    """``cli.eval -q`` for slim at 32² on the card (its PTQ there, the
    hand-written kernels, captured) scores what the CPU route scores: each
    image's detections as many, boxes and scores within 1e-5 of the image
    size (rtol 1e-5), the mAP and class APs within 1e-9."""
    from yolo_tpu_torch.cli import eval as teval

    made = []
    base = teval.VOCEvaluator

    class Recording(base):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    monkeypatch.setattr(teval, "VOCEvaluator", Recording)
    argv = ["-d", "synthetic", "-q", "--input_size", "32", "32",
            "--batch_size", "8"]
    got = teval.evaluate(teval.parse_args(argv))
    want = teval.evaluate(teval.parse_args(argv + ["--device", "cpu"]))
    assert abs(got - want) <= 1e-9
    card, cpu = made
    np.testing.assert_allclose(card.class_aps, cpu.class_aps, rtol=0,
                               atol=1e-9)
    n = 0
    for cls_a, cls_b in zip(card.raw[0], cpu.raw[0]):
        for a, b in zip(cls_a, cls_b):
            assert a.shape == b.shape
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=32 * 1e-5)
            n += len(a)
    assert n > 0
    assert capsys.readouterr().out.count("Mean AP") == 2


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in tree:
            yield from _leaves(tree[k], f"{path}.{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}.{i}")
    else:
        yield path, tree


@pytest.mark.cuda
def test_cuda_training_batch_equals_the_cpu(cuda):
    """One training batch of slim_yolo_v2 at 416² on the card (four
    synthetic-hard images through ``SSDAugmentation`` in uint8 and
    ``BatchLoader``, ``build_targets``, ``loss_fn``, ``backward()``)
    equals the CPU route in float64 on the same images (the card's
    normalized floats) and seeded weights (float32 sums over a 416²
    batch round off by ~1e-3 of a leaf's largest value on the CPU), the
    CPU's forward taking the card's branches (``blocks.branch_context``:
    each leaky's sign, each pool's argmax; float32 rounding breaks
    near-ties and exact ties apart on two devices, and a branch taken
    otherwise moves the gradients by far more than rounding). Every
    branch the CPU would take otherwise lies within 1e-4 of the layer's
    largest |x|; the loss components within rtol 1e-4; every gradient
    leaf finite, not all zero, its max abs error within 1e-3 of its
    largest |g|; the new BN running stats within rtol 1e-4, atol 1e-5."""
    from yolo_tpu_torch.config import get_config
    from yolo_tpu_torch.data import (BatchLoader, SSDAugmentation,
                                     SyntheticDetection)
    from yolo_tpu_torch.detector import normalize_u8
    from yolo_tpu_torch.models.slim_yolo_v2 import SlimYOLOv2
    from yolo_tpu_torch.ops import blocks
    from yolo_tpu_torch.quant.convert import module_to_params
    from yolo_tpu_torch.train.targets import build_targets
    from yolo_tpu_torch.train.trainer import TrainConfig, loss_fn

    size = (416, 416)
    cfg = get_config("slim_yolo_v2", "mask", input_size=size)
    ds = SyntheticDetection(size=size, length=4, hard=True, transform=(
        SSDAugmentation(size, seed=0, normalize=False)))
    images, targets = next(iter(BatchLoader(ds, 4, num_workers=2,
                                            workers="thread")))
    gt = build_targets(cfg, targets)
    x = torch.as_tensor(images).to(cuda)
    runs, choices = [], None
    for dev, dtype, inputs in ((cuda, torch.float32, x),
                               ("cpu", torch.float64,
                                normalize_u8(x).cpu().double())):
        model = SlimYOLOv2(35, device=dev,
                           generator=torch.Generator().manual_seed(0))
        with blocks.branch_context(choices) as branches:
            total, parts = loss_fn(model.to(dtype), cfg, TrainConfig(),
                                   inputs, gt)
        total.backward()
        choices = branches.choices
        runs.append(({k: v.item() for k, v in parts.items()},
                     list(_leaves(module_to_params(model, grads=True))),
                     list(_leaves(module_to_params(model)))))
    for kind, n, margin, scale in branches.flips:
        assert margin <= 1e-4 * scale, (kind, n, margin, scale)
    (loss, grads, stats), (loss_cpu, grads_cpu, stats_cpu) = runs
    for k, want in loss_cpu.items():
        assert np.isfinite(loss[k])
        np.testing.assert_allclose(loss[k], want, rtol=1e-4)
    nonzero = 0
    for (path, want), (_, got) in zip(grads_cpu, grads):
        assert np.isfinite(got).all(), path
        scale = np.abs(want).max()
        if scale > 0:
            nonzero += 1
            err = np.abs(got - want).max()
            assert err <= 1e-3 * scale, (path, err / scale)
    assert nonzero == 9 * 3 + 2  # 9 convs' w, gamma, beta; pred's w, b
    for (path, want), (_, got) in zip(stats_cpu, stats):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5,
                                   err_msg=path)
