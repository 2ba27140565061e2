"""Bare int8 GEMM: the CUDA kernel and its plain PyTorch version
(counterpart of ``pallas_gemm`` in ``scripts/bench_int8_ceiling.py``, the
JAX package's int8 ceiling probe, K5).

``int8_gemm(a, b)``: int8 [M, K] x int8 [K, N] -> int32 [M, N]. On a CUDA
tensor it launches ``csrc/int8_gemm.cu`` (wgmma fed by a TMA ring, the
main loop of ``csrc/int8_wgmma.cuh``) and counts the launch in
``launch_counts()``; on a CPU tensor it runs the plain version, an exact
int64 matmul. The kernel takes both operands K-major: a ``b`` whose
``b.t()`` is contiguous (the column-major layout ``torch._int_mm`` takes)
goes in as it is, any other ``b`` as a K-major copy; where K % 16 != 0
both are zero-padded on K (TMA's rows are 16-byte multiples; the zeros add
nothing). ``torch._int_mm`` is the library yardstick beside it in
``chip_smoke.py``; the port never calls it.
"""

from __future__ import annotations

import torch

from yolo_tpu_torch.kernels import launch, route


def int8_gemm_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int8 matmul: products and sums in int64 (float64 on CUDA,
    exact while K * 128 * 128 < 2^53), wrapped to int32 as the kernel's
    int32 accumulator wraps."""
    if a.device.type == "cuda":
        acc = torch.matmul(a.to(torch.float64), b.to(torch.float64)
                           ).to(torch.int64)
    else:
        acc = torch.matmul(a.to(torch.int64), b.to(torch.int64))
    return acc.to(torch.int32)


def pad_k(t: torch.Tensor, multiple: int = 16) -> torch.Tensor:
    """``t`` [R, K] zero-padded on K to a multiple of ``multiple`` (``t``
    itself where K already is one)."""
    extra = -t.shape[-1] % multiple
    return torch.nn.functional.pad(t, (0, extra)) if extra else t


def k_major(b: torch.Tensor) -> torch.Tensor:
    """B [K, N] as the contiguous [N, K] the kernel reads: ``b.t()`` itself
    when it is contiguous, else a copy."""
    bt = b.t()
    return bt if bt.is_contiguous() else bt.contiguous()


def _launch_gemm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise ValueError("int8_gemm takes int8 operands")
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"int8_gemm takes [M, K] x [K, N], got "
                         f"{list(a.shape)} x {list(b.shape)}")
    if b.device != a.device:
        raise ValueError("int8_gemm operands must share a device")
    m, k = a.shape
    n = b.shape[1]
    if k == 0 or max(m, n, k) > 2 ** 31 - 256:
        raise ValueError(f"int8_gemm cannot take M, N, K = {m}, {n}, {k}")
    a, bt = pad_k(a.contiguous()), pad_k(k_major(b))
    if a.data_ptr() % 16 or bt.data_ptr() % 16:
        raise ValueError("a and b must be 16-byte aligned (TMA)")
    out = torch.empty((m, n), dtype=torch.int32, device=a.device)
    if out.numel() == 0:
        return out
    if out.data_ptr() % 8:
        raise ValueError("the output allocation is not 8-byte aligned")
    launch("int8_gemm", "yolo_int8_gemm", a.device, a.data_ptr(),
           bt.data_ptr(), out.data_ptr(), m, n, a.shape[1])
    return out


def int8_gemm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 [M, K] x int8 [K, N] -> int32 [M, N]."""
    if route(a) == "plain":
        return int8_gemm_plain(a, b)
    return _launch_gemm(a, b)
