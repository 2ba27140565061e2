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
    # (B, H, W, C, C_mid): edge tiles, both phase-1 tile widths, and the
    # 13 x 13 C 1024 stage whose y1 takes 115 KB of shared memory
    (2, 5, 7, 64, 32),
    (1, 18, 17, 64, 32),
    (2, 6, 6, 128, 64),
    (1, 13, 13, 1024, 512),
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
def test_cuda_res_block_acc_shift_ge_32(cuda):
    x, w1, b1, w2, b2 = _res_args(RES_CASES[0])
    for p1, p2 in ((dict(P1, sw=40), P2), (P1, dict(P2, sw=40))):
        want = K.int8_res_block(x, w1, b1, p1, w2, b2, p2, sa_res=3,
                                leaky=0.1)
        got = K.int8_res_block(*(t.to(cuda) for t in (x, w1, b1)), p1,
                               *(t.to(cuda) for t in (w2, b2)), p2,
                               sa_res=3, leaky=0.1)
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
@pytest.mark.parametrize("m,k,n", [(128, 64, 64), (1000, 200, 100),
                                   (333, 72, 98), (7, 9, 33),
                                   (256, 4096, 256)])
def test_cuda_gemm_equals_plain(cuda, m, k, n):
    rng = np.random.default_rng(2)
    a = torch.tensor(rng.integers(-128, 128, (m, k)).astype(np.int8))
    b = torch.tensor(rng.integers(-128, 128, (k, n)).astype(np.int8))
    want = G.int8_gemm(a, b)
    K.reset_launch_counts()
    got = G.int8_gemm(a.to(cuda), b.to(cuda))
    torch.cuda.synchronize()
    assert K.launch_counts()["int8_gemm"] == 1
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_cuda_per_channel_sw_raises(cuda):
    xs, wq, b = _conv_args(CONV_CASES[3])
    sw = np.full(wq.shape[-1], 8, np.int32)
    with pytest.raises(ValueError, match="per-channel"):
        K.int8_conv_requant(xs[0].to(cuda), wq.to(cuda), b.to(cuda),
                            **dict(SHIFTS, sw=sw))
    x, w1, b1, w2, b2 = (t.to(cuda) for t in _res_args(RES_CASES[0]))
    with pytest.raises(ValueError, match="per-channel"):
        K.int8_res_block(x, w1, b1, dict(P1, sw=np.full(32, 8, np.int32)),
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
def test_cuda_res_block_rejects_narrow_channels(cuda):
    x, w1, b1, w2, b2 = (t.to(cuda) for t in _res_args((1, 4, 4, 64, 32)))
    with pytest.raises(ValueError, match="C % 64"):
        K.int8_res_block(x[..., :48].contiguous(), w1[..., :48, :], b1, P1,
                         w2[..., :48], b2[:48], P2)
