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
