#!/usr/bin/env python3
"""Time versions of yolo_tpu_torch's CUDA kernel sources against each other
in one process, on one CUDA card:

    python3 scripts/torch_kernel_ab.py SPEC.json [--groups s1,res,s2,thin,one,pc,nhwc,pcv3,resc]

SPEC.json maps a version's name to ``[csrc dir, [[file, old, new], ...]]``:
the kernel sources of that directory ("" for this checkout's own, or e.g.
the ``yolo_tpu_torch/kernels/csrc`` of a parent commit unpacked with
``git archive``), each ``old`` text replaced by ``new`` in ``file`` (it
must occur). Each version is compiled with nvcc for sm_90a (the kernel
sources with ``-Xptxas -v``, whose registers and spills are printed) and
linked into a library of its own. Then the main-path shapes of each group
are timed on every version in turn (ABBA order, twice):

- ``s1``: the wgmma conv3x3 at slim's six K1 layers and three K3 layers
  (batch 256) and the yolo_v3 head's three 3x3 shapes (batch 128);
- ``res``: K4 at darknet53's five stage shapes (batch 128);
- ``s2``: the wgmma conv3x3's stride-2 form at darknet53's five
  downsampling convs (batch 128);
- ``thin``: the two thin-input entry convs, yolo_v3's C_in = 3 entry conv
  (batch 128) and K2 on slim's s2d input (batch 256), each on its wgmma
  kernel (``csrc/int8_entry_conv.cu``) and on the mma.sync kernel it
  replaced (through the private launchers ``_launch_conv_requant`` and
  ``_launch(..., s2d=True)``), so a parent without the wgmma entries still
  times the mma.sync ones;
- ``one``: yolo_v3's ten distinct 1x1 shapes (batch 128; the concat convs
  as two parts at two scales, as the served model has them), each on the
  wgmma 1x1 kernel (``csrc/int8_conv1x1_wgmma.cu``) and on the mma.sync
  kernel it replaced (``_launch_conv_requant``);
- ``pc``: slim with per-channel sw (batch 256, NHWC): the wgmma conv3x3's
  per-column forms at the six K1 layers and the three K3 layers (the
  shapes of ``s1``, where the scalar forms are timed), its counting forms
  (``int8_forward_diagnostics``) at the same shapes, and conv1 (C_in 3,
  pooled) on the mma.sync conv with its shift table and with a scalar sw;
- ``nhwc``: slim's conv1 on NHWC input (batch 256, 416², 3 -> 16,
  pooled) on the NHWC form of K2's wgmma kernel (``csrc/
  int8_entry_conv.cu``) in its scalar, per-column and counting forms,
  beside the mma.sync conv it replaced (scalar sw and shift table,
  through the private launcher ``_launch``) and K2 on the s2d layout of
  the same images;
- ``pcv3``: yolo_v3 with per-channel sw (batch 128, 416²): every distinct
  conv shape outside the residual blocks (the entry conv, the five
  stride-2 convs, the head's three 3x3 shapes, the ten 1x1 shapes)
  through ``int8_conv_requant`` in the per-column form of its kernel
  (``_pc``) beside its scalar form at the same shape, the two concat 1x1s
  also with their parts at one scale (``_eq``: one accumulator; else two
  scales, a split);
- ``resc``: K4 at darknet53's five stage shapes (batch 128) in its scalar
  form and in its per-column form (``_pc``: a per-channel sw in both
  convs, of three values by column around the scalar sw, on tables made
  once, as ``pack_res_blocks`` makes them; the short shift form, as the
  per-channel fixture's blocks take it).

Each time is the median over 5 CUDA-event pairs around 20 back-to-back
launches, per launch: the card's time, with the wrappers' host work
overlapped, so it reads the host's time (~0.1 ms) where a kernel takes
less. Each shape's ``kernel_ms`` is the port's kernels alone: the
device time that ``torch.profiler`` records for them over 20 launches,
per launch recorded (``kernels_recorded``: CUPTI may drop some; the
small PyTorch kernels of a wrapper's bias set-up are left out). Every output is checked equal to the first version's. A
version without a kernel's C entry (an older tree) skips its shapes, and
so does one whose mma.sync conv3x3 entry predates its shift table.
Prints the card's name and power limit, one JSON line per shape (each
version's times and their median, and the shape's launches per v3 or
slim forward) and per group the sums of the medians and their sums per
forward (each median times its launches per forward).
The versions run through this checkout's wrappers, so they must share
their C interface."""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from yolo_tpu_torch.kernels import build  # noqa: E402
from yolo_tpu_torch.kernels import int8_conv as K  # noqa: E402
from yolo_tpu_torch.quant import fixed_point as fp  # noqa: E402

VERBOSE = ("int8_conv3x3_wgmma.cu", "int8_res_block.cu",
           "int8_entry_conv.cu", "int8_conv1x1_wgmma.cu", "int8_conv.cu",
           "int8_conv_general.cu")
# the 1x1 shapes of the ``one`` group: (name, H, C_in parts, C_out,
# launches per v3 forward)
ONE_BY_ONE = [("c13_1024_512", 13, (1024,), 512, 3),
              ("c13_512_256", 13, (512,), 256, 1),
              ("pred13", 13, (1024,), 21, 1),
              ("cat26", 26, (512, 256), 256, 1),
              ("c26_512_256", 26, (512,), 256, 2),
              ("c26_256_128", 26, (256,), 128, 1),
              ("pred26", 26, (512,), 21, 1),
              ("cat52", 52, (256, 128), 128, 1),
              ("c52_256_128", 52, (256,), 128, 2),
              ("pred52", 52, (256,), 21, 1)]
# slim's layers with per-channel sw: (name, H, C_in, C_out, form of the
# wgmma conv3x3, launches per forward)
PC_LAYERS = [("conv3_1", 104, 32, 64, "conv", 1),
             ("conv4_1", 52, 64, 128, "conv", 1),
             ("conv5", 26, 128, 256, "conv", 1),
             ("conv6", 26, 256, 256, "conv", 2),
             ("pred", 26, 256, 35, "conv", 1),
             ("conv2", 208, 16, 32, "pool", 1),
             ("conv3_2", 104, 64, 64, "pool", 1),
             ("conv4_2", 52, 128, 128, "pool", 1)]
SHAPES = {
    # (name, batch, H, C_in, C_out, form); K4: C_in = C, C_out = C_mid
    "s1": [("conv3_1", 256, 104, 32, 64, "conv"),
           ("conv4_1", 256, 52, 64, 128, "conv"),
           ("conv5", 256, 26, 128, 256, "conv"),
           ("conv6", 256, 26, 256, 256, "conv"),
           ("pred", 256, 26, 256, 35, "conv"),
           ("conv2", 256, 208, 16, 32, "pool"),
           ("conv3_2", 256, 104, 64, 64, "pool"),
           ("conv4_2", 256, 52, 128, 128, "pool"),
           ("head52", 128, 52, 128, 256, "conv"),
           ("head26", 128, 26, 256, 512, "conv"),
           ("head13", 128, 13, 512, 1024, "conv")],
    "res": [("res208", 128, 208, 64, 32, "res"),
            ("res104", 128, 104, 128, 64, "res"),
            ("res52", 128, 52, 256, 128, "res"),
            ("res26", 128, 26, 512, 256, "res"),
            ("res13", 128, 13, 1024, 512, "res")],
    "s2": [("s2_416", 128, 416, 32, 64, "s2"),
           ("s2_208", 128, 208, 64, 128, "s2"),
           ("s2_104", 128, 104, 128, 256, "s2"),
           ("s2_52", 128, 52, 256, 512, "s2"),
           ("s2_26", 128, 26, 512, 1024, "s2")],
    "thin": [("entry416", 128, 416, 3, 32, "entry"),
             ("entry416_mma", 128, 416, 3, 32, "entry_mma"),
             ("k2_416", 256, 416, 3, 16, "k2"),
             ("k2_416_mma", 256, 416, 3, 16, "k2_mma")],
    # the 1x1s: C_in the tuple of a conv's parts
    "one": [(name + sfx, 128, h, cins, c_out, form)
            for name, h, cins, c_out, _ in ONE_BY_ONE
            for sfx, form in (("", "one"), ("_mma", "one_mma"))],
    "pc": [(f"{name}_{kind}", 256, h, c_in, c_out, f"{form}_{kind}")
           for kind in ("pc", "count")
           for name, h, c_in, c_out, form, _ in PC_LAYERS]
          + [("conv1_pc", 256, 416, 3, 16, "mma_pc"),
             ("conv1_scalar", 256, 416, 3, 16, "mma_scalar")],
    # per-channel yolo_v3: each shape's scalar form, then its per-column
    # form (_pc); the concats also at one part scale (_eq)
    "pcv3": [(name + sfx, 128, h, c_in, c_out, form + fsfx)
             for name, h, c_in, c_out, form in (
                 [("entry416", 416, 3, 32, "entry"),
                  ("s2_416", 416, 32, 64, "s2"),
                  ("s2_208", 208, 64, 128, "s2"),
                  ("s2_104", 104, 128, 256, "s2"),
                  ("s2_52", 52, 256, 512, "s2"),
                  ("s2_26", 26, 512, 1024, "s2"),
                  ("head52", 52, 128, 256, "v3s1"),
                  ("head26", 26, 256, 512, "v3s1"),
                  ("head13", 13, 512, 1024, "v3s1")]
                 + [(n, h, cins, c_out, "one")
                    for n, h, cins, c_out, _ in ONE_BY_ONE]
                 + [(n + "_eq", h, cins, c_out, "one_eq")
                    for n, h, cins, c_out, _ in ONE_BY_ONE
                    if len(cins) == 2])
             for sfx, fsfx in (("", ""), ("_pc", "_pc"))],
    # K4 at each stage: scalar, then per-column (_pc)
    "resc": [(name + sfx, b, h, c, cmid, form + sfx)
             for name, b, h, c, cmid, form in [
                 ("res208", 128, 208, 64, 32, "res"),
                 ("res104", 128, 104, 128, 64, "res"),
                 ("res52", 128, 52, 256, 128, "res"),
                 ("res26", 128, 26, 512, 256, "res"),
                 ("res13", 128, 13, 1024, 512, "res")]
             for sfx in ("", "_pc")],
    "nhwc": [("conv1_nhwc", 256, 416, 3, 16, "nhwc"),
             ("conv1_nhwc_pc", 256, 416, 3, 16, "nhwc_pc"),
             ("conv1_nhwc_count", 256, 416, 3, 16, "nhwc_count"),
             ("conv1_mma", 256, 416, 3, 16, "mma_scalar"),
             ("conv1_mma_pc", 256, 416, 3, 16, "mma_pc"),
             ("k2_416", 256, 416, 3, 16, "k2")],
}
PER_FORWARD = {name + sfx: n for name, *_, n in ONE_BY_ONE
               for sfx in ("", "_mma")}
PER_FORWARD.update({f"{name}_{kind}": n
                    for name, *_, n in PC_LAYERS for kind in ("pc", "count")})
PER_FORWARD.update({f"{name}{sfx}": n for name, *_, n in ONE_BY_ONE
                    for sfx in ("_pc", "_eq", "_eq_pc")})
PER_FORWARD.update({f"head{h}{sfx}": 3 for h in (52, 26, 13)
                    for sfx in ("", "_pc")})
# darknet53's residual blocks per stage
PER_FORWARD.update({f"res{h}{sfx}": n for h, n in ((208, 1), (104, 2),
                                                   (52, 8), (26, 8), (13, 4))
                    for sfx in ("", "_pc")})
# the C entry each form launches
ENTRY = {"conv": "yolo_int8_conv3x3_wgmma",
         "pool": "yolo_int8_conv3x3_pool_wgmma",
         "s2": "yolo_int8_conv3x3_s2_wgmma",
         "res": "yolo_int8_res_block",
         "res_pc": "yolo_int8_res_block_cols_wgmma",
         "entry": "yolo_int8_entry_conv3x3_wgmma",
         "entry_mma": "yolo_int8_conv_requant",
         "k2": "yolo_int8_pool_s2d_wgmma",
         "k2_mma": "yolo_int8_conv3x3_requant",
         "one": "yolo_int8_conv1x1_wgmma",
         "one_mma": "yolo_int8_conv_requant",
         "conv_pc": "yolo_int8_conv3x3_cols_wgmma",
         "pool_pc": "yolo_int8_conv3x3_pool_cols_wgmma",
         "conv_count": "yolo_int8_conv3x3_count_wgmma",
         "pool_count": "yolo_int8_conv3x3_pool_count_wgmma",
         "mma_pc": "yolo_int8_conv3x3_requant",
         "mma_scalar": "yolo_int8_conv3x3_requant",
         "nhwc": "yolo_int8_pool_nhwc_wgmma",
         "nhwc_pc": "yolo_int8_pool_nhwc_cols_wgmma",
         "nhwc_count": "yolo_int8_pool_nhwc_count_wgmma",
         "v3s1": "yolo_int8_conv3x3_wgmma",
         "one_eq": "yolo_int8_conv1x1_wgmma",
         "entry_pc": "yolo_int8_entry_conv3x3_cols_wgmma",
         "s2_pc": "yolo_int8_conv3x3_s2_cols_wgmma",
         "v3s1_pc": "yolo_int8_conv3x3_cols_wgmma",
         "one_pc": "yolo_int8_conv1x1_cols_wgmma",
         "one_eq_pc": "yolo_int8_conv1x1_cols_wgmma"}
# the forms whose C entry took its shift table and counter with the
# per-column forms: a version without those (an older tree) has the entry
# but another interface, and skips them
NEEDS = dict.fromkeys(("k2_mma", "mma_pc", "mma_scalar"),
                      "yolo_int8_conv3x3_cols_wgmma")


class Library:
    """A version's library, its functions typed as this checkout's are."""

    def __init__(self, path: Path, ref: ctypes.CDLL):
        self.lib, self.ref = ctypes.CDLL(str(path)), ref

    def has(self, name: str) -> bool:
        return hasattr(self.lib, name)

    def __getattr__(self, name):
        f, r = getattr(self.lib, name), getattr(self.ref, name)
        f.argtypes, f.restype = r.argtypes, r.restype
        return f


def build_versions(spec: dict, root: Path) -> dict:
    nvcc = build._nvcc()
    shutil.rmtree(root, ignore_errors=True)
    jobs = []
    for name, (src, edits) in spec.items():
        d = root / name
        shutil.copytree(ROOT / src if src else build.CSRC, d)
        for fn, old, new in edits:
            f = d / fn
            text = f.read_text()
            if old not in text:
                raise ValueError(f"{name}: {fn} has no {old[:60]!r}")
            f.write_text(text.replace(old, new))
        jobs += [(name, s) for s in sorted(d.glob("*.cu"))]

    def compile_one(job):
        name, src = job
        flags = ["-Xptxas", "-v"] if src.name in VERBOSE else []
        r = subprocess.run([nvcc, *build.NVCC_FLAGS, *flags, "-c", str(src),
                            "-o", str(src.with_suffix(".o"))],
                           capture_output=True, text=True)
        if r.returncode:
            raise RuntimeError(f"nvcc failed on {name}/{src.name}:\n"
                               f"{r.stderr}")
        return name, src.name, r.stderr

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(jobs)) as pool:
        for name, src, err in pool.map(compile_one, jobs):
            if src in VERBOSE:
                print_ptxas(name, src, err)
    ref = build.load()
    libs = {}
    for name in spec:
        d = root / name
        subprocess.run([nvcc, "-shared", *build.NVCC_FLAGS,
                        *map(str, sorted(d.glob("*.o"))), "-o",
                        str(d / "lib.so")], check=True)
        libs[name] = Library(d / "lib.so", ref)
    print(json.dumps({"built_s": round(time.perf_counter() - t0, 1)}),
          flush=True)
    return libs


def print_ptxas(name: str, src: str, err: str) -> None:
    """Registers and spills of each kernel instantiation."""
    fun = frame = None
    for line in err.splitlines():
        if "Compiling entry function" in line:
            fun = line.split("'")[1]
        elif "stack frame" in line:
            frame = line.split(":")[-1].strip()
        elif "Used" in line and fun:
            print(json.dumps({"version": name, "source": src, "kernel": fun,
                              "ptxas": line.split(":")[-1].strip(),
                              "frame": frame}), flush=True)
            fun = None


def time_ms(fn, reps: int = 5, n: int = 20, warmup: int = 3) -> float:
    """Median over `reps` event pairs of the time per launch of `n`
    back-to-back launches."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / n)
    return statistics.median(times)


def is_port_kernel(name: str) -> bool:
    """The port's kernels live in anonymous namespaces of its sources."""
    return "anonymous namespace" in name or "_GLOBAL__N_" in name


def kernel_ms(fn, n: int = 20, warmup: int = 3):
    """Device time per launch of the port's kernel in ``fn`` (one per
    call), from ``torch.profiler`` over ``n`` calls: (the mean over the
    launches it recorded, their number). CUPTI may drop records, at times
    all of a window's: up to three windows are tried; raises where none
    kept a record, or one kept more than n."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        total_us, count = 0.0, 0
        for e in prof.key_averages():
            if is_port_kernel(e.key):
                t = getattr(e, "device_time_total", None)
                total_us += e.cuda_time_total if t is None else t
                count += e.count
        if count > n:
            raise RuntimeError(f"the profiler saw {count} port kernels in "
                               f"{n} calls")
        if count:
            return total_us / count / 1e3, count
    raise RuntimeError(f"the profiler saw no port kernel in three windows "
                       f"of {n} calls")


def shape_fn(gen, b, h, c_in, c_out, form):
    """The wrapper call of one shape on random inputs."""
    def ri(shape, lo, hi, dtype):
        return torch.randint(lo, hi, shape, generator=gen, dtype=torch.int32,
                             device="cuda").to(dtype)

    if form.startswith("one"):
        # two parts at two scales: their partials take two shifts (_eq:
        # one scale, one accumulator)
        step = 0 if "_eq" in form else 2
        parts = [(ri((b, h, h, c), -128, 128, torch.int8), 4 + step * p)
                 for p, c in enumerate(c_in)]
        w = ri((1, 1, sum(c_in), c_out), -90, 120, torch.int8)
        bias = ri((c_out,), -100, 100, torch.int32)
        kw = dict(sw=11, sb=8, sa_out=4, retune=10, leaky=c_out != 21,
                  rounding="nearest")
        if form == "one_mma":
            return lambda: K._launch_conv_requant(parts, w, bias, padding=0,
                                                  stride=1, **kw)
        packed = K.pack_conv1x1_weights(w)
        extra = {}
        if form.endswith("_pc"):
            kw["sw"] = pc_sw(10, c_out)
            extra["shifts"] = K.conv_shift_tables(
                kw["sw"], [sa for _, sa in parts], kw["retune"], "nearest",
                c_out, w.device, K.CONV1X1_ALIGN)
        return lambda: K.int8_conv_requant(parts, None, bias, sa_in=None,
                                           packed=packed, **kw, **extra)
    x = ri((b, h, h, c_in), -128, 128, torch.int8)
    if form in ("res", "res_pc"):
        w1 = ri((1, 1, c_in, c_out), -90, 120, torch.int8)
        w2 = ri((3, 3, c_out, c_in), -90, 120, torch.int8)
        b1 = ri((c_out,), -100, 100, torch.int32)
        b2 = ri((c_in,), -100, 100, torch.int32)
        packed = K.pack_res_block_weights(w1, w2)
        p1 = dict(sw=9, sb=8, sa_in=4, sa_out=4, retune=10)
        p2 = dict(sw=12, sb=8, sa_in=4, sa_out=5, retune=10)
        shifts = None
        if form == "res_pc":
            p1, p2 = dict(p1, sw=pc_sw(8, c_out)), dict(p2, sw=pc_sw(11, c_in))
            shifts = tuple(K.acc_shift_table(p["sw"], p["sa_in"],
                                             p["retune"], "nearest", n,
                                             x.device)
                           for p, n in ((p1, c_out), (p2, c_in)))
        return lambda: K.int8_res_block(x, None, b1, p1, None, b2, p2,
                                        sa_res=3, leaky=0.1, packed=packed,
                                        shifts=shifts)
    w = ri((3, 3, c_in, c_out), -90, 120, torch.int8)
    bias = ri((c_out,), -100, 100, torch.int32)
    kw = dict(sw=12, sb=8, sa_in=4, sa_out=4, retune=10, rounding="nearest")
    if form in ("conv_pc", "pool_pc", "conv_count", "pool_count", "mma_pc",
                "mma_scalar", "nhwc", "nhwc_pc", "nhwc_count"):
        return pc_fn(x, w, bias, kw, form)
    if form in ("entry_pc", "s2_pc", "v3s1", "v3s1_pc"):
        return v3_pc_fn(x, w, bias, kw, form)
    if form in ("entry", "entry_mma"):
        if form == "entry_mma":
            return lambda: K._launch_conv_requant(
                [(x, kw["sa_in"])], w, bias, padding=1, stride=1, leaky=0.1,
                **{k: v for k, v in kw.items() if k != "sa_in"})
        packed = K.pack_entry_conv_weights(w)
        return lambda: K.int8_conv_requant(x, None, bias, packed=packed,
                                           padding=1, stride=1, leaky=0.1,
                                           **kw)
    if form in ("k2", "k2_mma"):
        x2 = fp.s2d_input(x).contiguous()
        if form == "k2_mma":
            return lambda: K._launch("int8_conv3x3_pool_requant", x2, w,
                                     bias, h=h, w=h, c_in=c_in, pool=True,
                                     s2d=True, leaky=True, **kw)
        packed = K.pack_pool_s2d_weights(w)
        return lambda: K.int8_conv3x3_pool_s2d(x2, None, bias, c_in=c_in,
                                               packed=packed, leaky=True,
                                               **kw)
    packed = K.pack_conv3x3_weights(w)
    if form == "s2":
        return lambda: K.int8_conv_requant(x, None, bias, packed=packed,
                                           padding=1, stride=2, leaky=0.1,
                                           **kw)
    if form == "pool":
        return lambda: K.int8_conv3x3_im2col(x, None, bias, pool=True,
                                             packed=packed, leaky=True, **kw)
    return lambda: K.int8_conv3x3_requant(x, None, bias, packed=packed,
                                          leaky=True, **kw)


def pc_sw(base, c_out):
    """A per-channel sw of three values, base .. base + 2, by column."""
    return (base + torch.arange(c_out) % 3).numpy().astype("int32")


def v3_pc_fn(x, w, bias, kw, form):
    """A per-channel yolo_v3 3x3's ``int8_conv_requant`` call (the entry
    conv, a stride-2 conv, a head 3x3) on its per-column form, from the
    table a packed model holds, the sw three values around the scalar
    forms' 12 (the short form); ``v3s1`` the head 3x3 with the scalar
    sw."""
    c_out = w.shape[-1]
    entry = form.startswith("entry")
    packed = (K.pack_entry_conv_weights(w) if entry
              else K.pack_conv3x3_weights(w))
    extra = {}
    if form.endswith("_pc"):
        kw = dict(kw, sw=pc_sw(11, c_out))
        extra["shifts"] = K.conv_shift_tables(
            kw["sw"], [kw["sa_in"]], kw["retune"], kw["rounding"], c_out,
            x.device)
    leaky = 0.1 if form.startswith(("entry", "s2")) else True
    stride = 2 if form.startswith("s2") else 1
    return lambda: K.int8_conv_requant(x, None, bias, packed=packed,
                                       padding=1, stride=stride, leaky=leaky,
                                       **kw, **extra)


def pc_fn(x, w, bias, kw, form):
    """A per-channel slim layer's wrapper call: a per-column sw of three
    values around the scalar forms' 12 (accumulator shifts 5-7, the short
    form), from the shift table a packed model holds; counting into one
    int32 for the ``count`` forms; ``mma_scalar`` and ``nhwc`` with the
    scalar sw. conv1 (C_in 3) runs on the NHWC form of K2's kernel
    (``nhwc*``) or on the mma.sync conv (``mma*``)."""
    pool = form.startswith(("pool", "mma", "nhwc"))
    c_out = w.shape[-1]
    scalar = form in ("mma_scalar", "nhwc")
    if not scalar:
        kw = dict(kw, sw=(11 + torch.arange(c_out) % 3).numpy().astype(
            "int32"))
    table = K.acc_shift_table(kw["sw"], kw["sa_in"], kw["retune"],
                              kw["rounding"], c_out, x.device)
    counter = (torch.zeros(1, dtype=torch.int32, device=x.device)
               if form.endswith("count") else None)
    extra = dict(shifts=None if scalar else table, overflow=counter)
    if form.startswith("mma"):
        h, wd = x.shape[1:3]
        return lambda: K._launch("int8_conv3x3_im2col", x, w, bias, h=h,
                                 w=wd, c_in=x.shape[-1], pool=True,
                                 s2d=False, leaky=True, **extra, **kw)
    if form.startswith("nhwc"):
        packed = K.pack_pool_nhwc_weights(w)
        return lambda: K.int8_conv3x3_im2col(x, None, bias, pool=True,
                                             packed=packed, leaky=True,
                                             **extra, **kw)
    packed = K.pack_conv3x3_weights(w)
    if pool:
        return lambda: K.int8_conv3x3_im2col(x, None, bias, pool=True,
                                             packed=packed, leaky=True,
                                             **extra, **kw)
    return lambda: K.int8_conv3x3_requant(x, None, bias, packed=packed,
                                          leaky=c_out != 35, **extra, **kw)


def use(lib) -> None:
    build._lib = lib
    for layout in (K.conv3x3_wgmma_layout, K.conv3x3_pool_wgmma_layout,
                   K.conv3x3_s2_wgmma_layout, K.res_block_layout,
                   K.entry_conv3x3_layout, K.pool_s2d_wgmma_layout,
                   K.pool_nhwc_wgmma_layout, K.conv1x1_wgmma_layout):
        layout.cache_clear()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("spec", help="JSON: name -> [csrc dir, edits]")
    ap.add_argument("--groups", default="s1,res,s2,thin")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_kernel_ab: no CUDA card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    spec = json.loads(Path(args.spec).read_text())
    libs = build_versions(spec, build.BUILD_ROOT / "ab")
    gen = torch.Generator(device="cuda").manual_seed(0)
    totals: dict = {}
    per_forward: dict = {}
    kernel_per_forward: dict = {}
    for group in args.groups.split(","):
        for name, b, h, c_in, c_out, form in SHAPES[group]:
            names = [v for v in libs if libs[v].has(ENTRY[form])
                     and libs[v].has(NEEDS.get(form, ENTRY[form]))]
            fn = shape_fn(gen, b, h, c_in, c_out, form)
            times: dict = {}
            ktimes: dict = {}
            kseen: dict = {}
            ref = None
            for v in (names + names[::-1]) * 2:
                use(libs[v])
                out = fn()
                ref = out if ref is None else ref
                if not torch.equal(out, ref):
                    raise AssertionError(f"{v} differs at {name}")
                times.setdefault(v, []).append(round(time_ms(fn), 4))
                t, seen = kernel_ms(fn)
                ktimes.setdefault(v, []).append(round(t, 4))
                kseen.setdefault(v, []).append(seen)
            med = {v: statistics.median(t) for v, t in times.items()}
            kmed = {v: statistics.median(t) for v, t in ktimes.items()}
            n = PER_FORWARD.get(name, 1)
            for v, t in med.items():
                totals.setdefault(group, {}).setdefault(v, 0.0)
                totals[group][v] += t
                per_forward.setdefault(group, {}).setdefault(v, 0.0)
                per_forward[group][v] += n * t
                kernel_per_forward.setdefault(group, {}).setdefault(v, 0.0)
                kernel_per_forward[group][v] += n * kmed[v]
            print(json.dumps({"shape": name, "group": group,
                              "batch_h_cin_cout": [b, h, c_in, c_out],
                              "per_forward": n, "median_ms": med,
                              "kernel_ms": kmed, "ms": times,
                              "kernel_ms_runs": ktimes,
                              "kernels_recorded": kseen}), flush=True)
            del fn, ref, out
            torch.cuda.empty_cache()
    print(json.dumps({"sum_of_medians_ms": totals,
                      "per_forward_ms": per_forward,
                      "kernel_per_forward_ms": kernel_per_forward}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
