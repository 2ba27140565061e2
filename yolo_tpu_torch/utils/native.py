"""ctypes bindings for the native C++ host preprocessing
(``native/preprocess.cpp``; counterpart of ``yolo_tpu/utils/native.py``'s
``load``, ``available`` and ``preprocess_batch``; the augmentation binding
waits for training).

The library is built on first use by ``native/Makefile`` (g++; importing
this module builds nothing), as ``native/libyolo_tpu_torch_native.so``:
the port's own copy of the JAX package's ``libyolo_tpu_native.so``, made
under a temporary name and renamed into place, so that no process ever
maps a library another process is writing. Where the toolchain or the
library is missing, ``available()`` is False and callers use the numpy
transforms of ``yolo_tpu_torch.data.transforms``.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import List, Optional, Tuple

import numpy as np

from yolo_tpu_torch.config import BGR_MEAN, BGR_STD

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "native")
_LIB_NAME = "libyolo_tpu_torch_native.so"
_LIB_PATH = os.path.join(_NATIVE_DIR, _LIB_NAME)
# the library's yolo_tpu_version() this binding needs
_ABI_VERSION = 4

_lib = None


def _build() -> bool:
    tmp = f"{_LIB_NAME}.{os.getpid()}.tmp"
    try:
        subprocess.run(["make", "-C", _NATIVE_DIR, f"TARGET={tmp}"],
                       check=True, capture_output=True)
        os.replace(os.path.join(_NATIVE_DIR, tmp), _LIB_PATH)
        return True
    except (OSError, subprocess.CalledProcessError):
        return False


def _open() -> Optional[ctypes.CDLL]:
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return None
    lib.yolo_tpu_version.restype = ctypes.c_int
    return lib


def load() -> Optional[ctypes.CDLL]:
    """The native library (built if needed, rebuilt once if older than
    ``_ABI_VERSION``), or None."""
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_LIB_PATH) and not _build():
        return None
    lib = _open()
    if lib is not None and lib.yolo_tpu_version() < _ABI_VERSION:
        lib = _open() if _build() else None
    if lib is None or lib.yolo_tpu_version() < _ABI_VERSION:
        return None
    common = [
        ctypes.POINTER(ctypes.c_void_p),                  # frames
        ctypes.POINTER(ctypes.c_int),                     # ihs
        ctypes.POINTER(ctypes.c_int),                     # iws
        ctypes.c_int, ctypes.c_int, ctypes.c_int,         # n, oh, ow
        ctypes.POINTER(ctypes.c_float),                   # mean
        ctypes.POINTER(ctypes.c_float),                   # std
        ctypes.c_int,                                     # to_rgb
    ]
    lib.yolo_tpu_preprocess_batch.argtypes = common + [
        ctypes.c_void_p, ctypes.c_void_p,                 # out f32 / i8
        ctypes.c_float,                                   # act_scale
    ]
    lib.yolo_tpu_preprocess_batch_s2d.argtypes = common + [
        ctypes.c_void_p,                                  # out i8 (s2d)
        ctypes.c_float,                                   # act_scale
    ]
    _lib = lib
    return _lib


def available() -> bool:
    return load() is not None


def preprocess_batch(frames: List[np.ndarray], size: Tuple[int, int],
                     mean=BGR_MEAN, std=BGR_STD, rgb: bool = True,
                     int8_scale: Optional[float] = None,
                     layout: str = "nhwc", out: Optional[np.ndarray] = None):
    """Fused resize + normalize (+ quantize) of a list of u8 BGR frames.

    Returns float32 [N, h, w, 3] (RGB order) or, with ``int8_scale`` (the
    activation scale 2^sa_in), int8 [N, h, w, 3]. With ``layout='s2d'``
    (needs ``int8_scale``) the int8 output is the padded space-to-depth
    serving layout [N, h/2+3, w/2+3, 12] (``fixed_point.s2d_input``).
    ``out``: a C-contiguous array of that shape and dtype to write into
    (e.g. pinned host memory), else a new one; the s2d layout's padding
    ring is never written, so an ``out`` for it must hold zeros there
    (it keeps them from call to call)."""
    lib = load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    if layout not in ("nhwc", "s2d"):
        raise ValueError(f"unknown layout {layout!r}")
    if layout == "s2d" and int8_scale is None:
        raise ValueError("layout='s2d' requires int8_scale")
    n = len(frames)
    oh, ow = size
    if layout == "s2d":
        shape, dtype = (n, (oh + 6) // 2, (ow + 6) // 2, 12), np.int8
    else:
        shape = (n, oh, ow, 3)
        dtype = np.float32 if int8_scale is None else np.int8
    if out is None:
        # the s2d layout's pad blocks are never written: start from zeros
        out = (np.zeros if layout == "s2d" else np.empty)(shape, dtype)
    elif (out.shape != shape or out.dtype != dtype
          or not out.flags["C_CONTIGUOUS"]):
        raise ValueError(f"out must be a C-contiguous {np.dtype(dtype)} "
                         f"array of shape {shape}, got {out.dtype} "
                         f"{out.shape}")
    frames = [np.ascontiguousarray(f, dtype=np.uint8) for f in frames]
    ptrs = (ctypes.c_void_p * n)(
        *[f.ctypes.data_as(ctypes.c_void_p).value for f in frames])
    ihs = (ctypes.c_int * n)(*[f.shape[0] for f in frames])
    iws = (ctypes.c_int * n)(*[f.shape[1] for f in frames])
    mean_c = (ctypes.c_float * 3)(*mean)
    std_c = (ctypes.c_float * 3)(*std)
    frame_args = (ctypes.cast(ptrs, ctypes.POINTER(ctypes.c_void_p)), ihs,
                  iws, n, oh, ow, mean_c, std_c, int(rgb))
    out_p = out.ctypes.data_as(ctypes.c_void_p)
    if layout == "s2d":
        lib.yolo_tpu_preprocess_batch_s2d(*frame_args, out_p,
                                          float(int8_scale))
    elif int8_scale is None:
        lib.yolo_tpu_preprocess_batch(*frame_args, out_p, None, 0.0)
    else:
        lib.yolo_tpu_preprocess_batch(*frame_args, None, out_p,
                                      float(int8_scale))
    return out
