"""Hand-written CUDA kernels of the port (sources under ``csrc/``).

Every wrapper given a CUDA tensor launches its kernel on the current
stream and, once the launch has succeeded, adds one to its count in
``launch_counts()``; given a CPU tensor it runs its plain PyTorch version
and counts nothing. Anything else raises.

Every launch goes through one custom op, ``yolo_tpu_torch::launch``
(``launch`` below): it takes the kernel's tensors, not their addresses,
so ``torch.export`` can trace a wrapper (a FakeTensor has no address)
and a CUDA graph can record it. The op reads the addresses, checks their
alignment, calls the C entry and counts the launch in its real
implementation; its fake implementation does nothing. It writes only the
tensors that the wrapper allocated and names as written."""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence

import torch

KERNEL_NAMES = ("int8_conv3x3_requant", "int8_conv3x3_pool_requant",
                "int8_conv3x3_im2col", "int8_res_block", "int8_conv_requant",
                "int8_gemm", "greedy_nms_keep")
# kernel launches since the last reset, by wrapper name, and by wrapper
# name and the C entry it launched
_LAUNCHES = dict.fromkeys(KERNEL_NAMES, 0)
_ENTRIES: dict = {}


def launch_counts() -> dict:
    """{kernel name: launches since the last reset}."""
    return dict(_LAUNCHES)


def launch_counts_by_entry() -> dict:
    """{kernel name: {C entry launched: launches since the last reset}},
    e.g. how many of ``int8_conv_requant``'s launches ran the wgmma
    conv3x3 (``yolo_int8_conv3x3_wgmma``) and how many the mma.sync conv
    (``yolo_int8_conv_requant``); names without a launch are left out."""
    out: dict = {}
    for (name, fn), n in _ENTRIES.items():
        out.setdefault(name, {})[fn] = n
    return out


def reset_launch_counts() -> None:
    for name in KERNEL_NAMES:
        _LAUNCHES[name] = 0
    _ENTRIES.clear()


def entry_counts() -> dict:
    """{(kernel name, C entry): launches since the last reset}: what
    ``restore_entry_counts`` sets back (a CUDA graph's capture runs
    nothing, so its wrapper calls are taken back out)."""
    return dict(_ENTRIES)


def restore_entry_counts(counts: dict) -> None:
    """Set the counts back to ``counts`` (an earlier ``entry_counts()``)."""
    reset_launch_counts()
    for (name, fn), n in counts.items():
        _LAUNCHES[name] += n
        _ENTRIES[(name, fn)] = n


def route(x: torch.Tensor) -> str:
    """'plain' for a CPU tensor, 'cuda' for a CUDA one; raises otherwise."""
    if x.device.type == "cpu":
        return "plain"
    if x.device.type == "cuda":
        return "cuda"
    raise ValueError(f"no int8 kernel for device {x.device}")


@torch.library.custom_op("yolo_tpu_torch::launch", mutates_args=("outs",))
def _launch_op(name: str, fn: str, ins: List[Optional[torch.Tensor]],
               outs: List[torch.Tensor], slots: List[int], ints: List[int],
               align: List[int], what: str) -> None:
    """Call the C entry ``fn`` with the addresses of its pointer
    arguments, in C order ``slots`` (``i >= 0``: ``ins[i]``, 0 where it is
    None; ``-1 - j``: ``outs[j]``, which the kernel writes), then ``ints``
    and the current stream; ``align[p]``: the bytes pointer ``p`` must be
    aligned to (line ``p`` of ``what`` names it in the error). Raises if
    the launch failed, else counts it under ``name``."""
    ptrs = []
    for slot, a, label in zip(slots, align, what.split("\n")):
        t = ins[slot] if slot >= 0 else outs[-1 - slot]
        addr = 0 if t is None else t.data_ptr()
        if addr % a:
            raise ValueError(f"{label} must be {a}-byte aligned")
        ptrs.append(addr)
    from yolo_tpu_torch.kernels import build

    dev = next(t.device for t in (*outs, *ins) if t is not None)
    lib = build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(lib, fn)(*ptrs, *ints, ctypes.c_void_p(stream))
    if rc != 0:
        msg = lib.yolo_int8_error_string(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg}")
    _LAUNCHES[name] += 1
    _ENTRIES[(name, fn)] = _ENTRIES.get((name, fn), 0) + 1


@_launch_op.register_fake
def _(name, fn, ins, outs, slots, ints, align, what) -> None:
    return None


def launch(name: str, fn: str, *args, writes: Sequence = (),
           align: Sequence = ()) -> None:
    """Launch the library's C entry ``fn`` on the current stream, counting
    it under ``name``: ``args`` in C order, each tensor (or None, a null
    pointer) a pointer argument, each int an int; ``writes``: the tensors
    among ``args`` the kernel writes (the ones the wrapper allocated);
    ``align``: (label, tensor, bytes) for each address to check. A None
    in ``writes`` or as the tensor of an ``align`` entry is passed over."""
    writes = [t for t in writes if t is not None]
    ins: list = []
    outs: list = []
    slots, ints, aligns, labels = [], [], [], []
    for i, a in enumerate(args):
        if isinstance(a, bool) or not (a is None
                                       or isinstance(a, torch.Tensor)):
            ints.append(int(a))
            continue
        if ints:
            raise ValueError(f"{fn}: pointer argument {i} after an int")
        if a is not None and any(a is t for t in writes):
            outs.append(a)
            slots.append(-len(outs))
        else:
            ins.append(a)
            slots.append(len(ins) - 1)
        need = [(lbl, n) for lbl, t, n in align if a is not None and t is a]
        aligns.append(max([n for _, n in need], default=1))
        labels.append(need[0][0] if need else f"pointer argument {i}")
    if len(outs) != len(writes):
        raise ValueError(f"{fn}: every written tensor must be an argument")
    _launch_op(name, fn, ins, outs, slots, ints, aligns, "\n".join(labels))
