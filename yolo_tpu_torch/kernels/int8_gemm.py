"""Bare int8 GEMM: the CUDA kernel and its plain PyTorch version
(counterpart of ``pallas_gemm`` in ``scripts/bench_int8_ceiling.py``, the
JAX package's int8 ceiling probe, K5).

``int8_gemm(a, b)``: int8 [M, K] x int8 [K, N] -> int32 [M, N]. On a CUDA
tensor it launches ``csrc/int8_gemm.cu`` (the conv kernels' tile main
loop, so the probe measures their ceiling) and counts the launch in
``launch_counts()``; on a CPU tensor it runs the plain version, an exact
int64 matmul. ``torch._int_mm`` is the library yardstick beside it in
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


def _launch_gemm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise ValueError("int8_gemm takes int8 operands")
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"int8_gemm takes [M, K] x [K, N], got "
                         f"{list(a.shape)} x {list(b.shape)}")
    if b.device != a.device:
        raise ValueError("int8_gemm operands must share a device")
    a, b = a.contiguous(), b.contiguous()
    m, k = a.shape
    n = b.shape[1]
    if k == 0 or max(m, n, k) >= 2 ** 31 or m * k >= 2 ** 62:
        raise ValueError(f"int8_gemm cannot take M, N, K = {m}, {n}, {k}")
    if (k % 16 == 0 and a.data_ptr() % 16) or b.data_ptr() % 4:
        raise ValueError("a must be 16-byte aligned (K % 16 == 0) and b "
                         "4-byte aligned")
    out = torch.empty((m, n), dtype=torch.int32, device=a.device)
    if out.numel() == 0:
        return out
    if out.data_ptr() % 8:
        raise ValueError("the output allocation is not 8-byte aligned")
    launch("int8_gemm", "yolo_int8_gemm", a.device, a.data_ptr(),
           b.data_ptr(), out.data_ptr(), m, n, k)
    return out


def int8_gemm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 [M, K] x int8 [K, N] -> int32 [M, N]."""
    if route(a) == "plain":
        return int8_gemm_plain(a, b)
    return _launch_gemm(a, b)
