"""Hand-written CUDA kernels of the port (sources under ``csrc/``).

Every wrapper given a CUDA tensor launches its kernel on the current
stream and, once the launch has succeeded, adds one to its count in
``launch_counts()``; given a CPU tensor it runs its plain PyTorch version
and counts nothing. Anything else raises."""

from __future__ import annotations

import ctypes

import torch

KERNEL_NAMES = ("int8_conv3x3_requant", "int8_conv3x3_pool_requant",
                "int8_conv3x3_im2col", "int8_res_block", "int8_conv_requant",
                "int8_gemm")
# kernel launches since the last reset, by wrapper name
_LAUNCHES = dict.fromkeys(KERNEL_NAMES, 0)


def launch_counts() -> dict:
    """{kernel name: launches since the last reset}."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for name in KERNEL_NAMES:
        _LAUNCHES[name] = 0


def route(x: torch.Tensor) -> str:
    """'plain' for a CPU tensor, 'cuda' for a CUDA one; raises otherwise."""
    if x.device.type == "cpu":
        return "plain"
    if x.device.type == "cuda":
        return "cuda"
    raise ValueError(f"no int8 kernel for device {x.device}")


def launch(name: str, fn: str, dev: torch.device, *args) -> None:
    """Call the library's C function ``fn`` with ``args`` (ints and device
    pointers) and the current stream of ``dev``; raise if the launch failed,
    else count it under ``name``."""
    from yolo_tpu_torch.kernels import build

    lib = build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(lib, fn)(*args, ctypes.c_void_p(stream))
    if rc != 0:
        msg = lib.yolo_int8_error_string(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg}")
    _LAUNCHES[name] += 1
