"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into one
shared library with a plain C interface, loaded with ``ctypes``. The
build happens at first use, into ``build/kernels/<hash>/`` at the root
of the checkout (listed in ``.gitignore``), keyed by a hash of the
sources (``*.cu`` and the shared ``*.cuh``) and flags, so a fresh
checkout builds everything it runs. Nothing is linked beyond what nvcc
links by default: the TMA descriptors of ``int8_wgmma.cuh`` are encoded
with ``cuTensorMapEncodeTiled``, looked up at run time in ``libcuda``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_lib = None
# seconds each source took to compile in this process's build, by file name
compile_seconds: dict = {}


def sources():
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources() + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_ROOT / _digest() / "libyolo_tpu_torch_kernels.so"


def build() -> Path:
    """Compile the sources if this hash has no library yet; returns its
    path. One nvcc per source, all started together, then one link."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        objs = [Path(tmp) / (src.stem + ".o") for src in sources()]

        def compile_one(pair):
            src, obj = pair
            t0 = time.perf_counter()
            subprocess.run([nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                           check=True, capture_output=True, text=True)
            compile_seconds[src.name] = round(time.perf_counter() - t0, 1)

        try:
            with ThreadPoolExecutor(max_workers=len(objs)) as pool:
                list(pool.map(compile_one, zip(sources(), objs)))
            tmp_lib = Path(tmp) / out.name
            subprocess.run([nvcc, "-shared", *NVCC_FLAGS,
                            *map(str, objs), "-o", str(tmp_lib)],
                           check=True, capture_output=True, text=True)
        except subprocess.CalledProcessError as e:
            raise RuntimeError(f"nvcc failed:\n{e.stderr}") from e
        os.replace(tmp_lib, out)
    return out


def load() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        vp, i = ctypes.c_void_p, ctypes.c_int
        for fn, argtypes in (
                ("yolo_int8_conv3x3_requant", [vp] * 6 + [i] * 11 + [vp]),
                ("yolo_int8_conv_requant", [vp] * 6 + [i] * 15 + [vp]),
                ("yolo_int8_res_block", [vp] * 6 + [i] * 15 + [vp]),
                ("yolo_int8_gemm", [vp] * 3 + [i] * 3 + [vp]),
                ("yolo_int8_res_block_info", [i] * 4 + [vp]),
                ("yolo_int8_res_block_cols_wgmma",
                 [vp] * 8 + [i] * 14 + [vp]),
                ("yolo_int8_conv3x3_wgmma", [vp] * 4 + [i] * 9 + [vp]),
                ("yolo_int8_conv3x3_wgmma_info", [i] * 5 + [vp]),
                ("yolo_int8_conv3x3_pool_wgmma", [vp] * 4 + [i] * 9 + [vp]),
                ("yolo_int8_conv3x3_pool_wgmma_info", [i] * 4 + [vp]),
                ("yolo_int8_conv3x3_s2_wgmma", [vp] * 4 + [i] * 9 + [vp]),
                ("yolo_int8_conv3x3_s2_wgmma_info", [i] * 4 + [vp]),
                ("yolo_int8_conv3x3_s2_cols_wgmma",
                 [vp] * 5 + [i] * 9 + [vp]),
                ("yolo_int8_conv3x3_cols_wgmma", [vp] * 5 + [i] * 9 + [vp]),
                ("yolo_int8_conv3x3_pool_cols_wgmma",
                 [vp] * 5 + [i] * 9 + [vp]),
                ("yolo_int8_conv3x3_count_wgmma", [vp] * 6 + [i] * 8 + [vp]),
                ("yolo_int8_conv3x3_pool_count_wgmma",
                 [vp] * 6 + [i] * 8 + [vp]),
                ("yolo_int8_conv3x3_parts_wgmma", [vp] * 5 + [i] * 11 + [vp]),
                ("yolo_int8_conv3x3_parts_cols_wgmma",
                 [vp] * 7 + [i] * 11 + [vp]),
                ("yolo_int8_conv3x3_parts_wgmma_info", [i] * 7 + [vp]),
                ("yolo_int8_entry_conv3x3_wgmma", [vp] * 4 + [i] * 9 + [vp]),
                ("yolo_int8_entry_conv3x3_wgmma_info", [i] * 4 + [vp]),
                ("yolo_int8_entry_conv3x3_cols_wgmma",
                 [vp] * 5 + [i] * 9 + [vp]),
                ("yolo_int8_pool_s2d_wgmma", [vp] * 4 + [i] * 9 + [vp]),
                ("yolo_int8_pool_s2d_wgmma_info", [i] * 4 + [vp]),
                ("yolo_int8_pool_nhwc_wgmma", [vp] * 4 + [i] * 9 + [vp]),
                ("yolo_int8_pool_nhwc_cols_wgmma",
                 [vp] * 5 + [i] * 9 + [vp]),
                ("yolo_int8_pool_nhwc_count_wgmma",
                 [vp] * 6 + [i] * 8 + [vp]),
                ("yolo_int8_pool_nhwc_wgmma_info", [i] * 4 + [vp]),
                ("yolo_int8_conv1x1_wgmma", [vp] * 5 + [i] * 9 + [vp]),
                ("yolo_int8_conv1x1_wgmma_info", [i] * 5 + [vp]),
                ("yolo_int8_conv1x1_cols_wgmma", [vp] * 7 + [i] * 9 + [vp]),
                ("yolo_nms_greedy", [vp] * 4 + [i] * 3 + [vp])):
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = i
        lib.yolo_int8_error_string.argtypes = [i]
        lib.yolo_int8_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib
