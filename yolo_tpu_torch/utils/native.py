"""ctypes bindings for the native C++ host preprocessing
(``native/preprocess.cpp``) and train-time augmentation
(``native/augment.cpp``); counterpart of ``yolo_tpu/utils/native.py``.

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
import threading
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
_LOAD_LOCK = threading.Lock()


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
    ``_ABI_VERSION``), or None. Thread-safe: the first calls from a
    loader's worker threads wait for one build (concurrent builds would
    share one temporary file, and a thread that saw none would fall back
    to numpy pixels while the others ran native ones)."""
    global _lib
    if _lib is not None:
        return _lib
    with _LOAD_LOCK:
        if _lib is None:
            _lib = _load_locked()
    return _lib


def _load_locked() -> Optional[ctypes.CDLL]:
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
    lib.yolo_tpu_augment_one.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int,      # src, h, w
        ctypes.c_int, ctypes.c_float,                     # bright
        ctypes.c_int, ctypes.c_int, ctypes.c_float,       # contrast
        ctypes.c_int, ctypes.c_float,                     # sat
        ctypes.c_int, ctypes.c_float,                     # hue
        ctypes.c_int, ctypes.c_int,                       # eh, ew
        ctypes.c_int, ctypes.c_int,                       # top, left
        ctypes.c_int, ctypes.c_int,                       # cx0, cy0
        ctypes.c_int, ctypes.c_int,                       # cx1, cy1
        ctypes.c_int, ctypes.c_int, ctypes.c_int,         # mirror, oh, ow
        ctypes.POINTER(ctypes.c_float),                   # mean
        ctypes.POINTER(ctypes.c_float),                   # std
        ctypes.c_int, ctypes.c_int,                       # to_rgb, u8_out
        ctypes.c_void_p, ctypes.c_void_p,                 # out f32 / u8
    ]
    lib.yolo_tpu_augment_one.restype = None
    return lib


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


def augment_one(image_u8: np.ndarray, pp: dict, ep, rect, mirror: bool,
                size, mean, std, rgb: bool = True,
                u8_out: bool = False) -> np.ndarray:
    """The SSD augmentation's pixel work in one native pass
    (``native/augment.cpp``, ``yolo_tpu_augment_one``): photometric ->
    expand -> crop -> mirror -> bilinear resize -> normalize (or round to
    uint8), no intermediate canvas. ``pp`` / ``ep`` / ``rect`` come from
    ``data.transforms``' ``draw_*`` helpers (every random draw stays in
    numpy). Returns float32 normalized [oh, ow, 3], or uint8 with
    ``u8_out``."""
    lib = load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    image_u8 = np.ascontiguousarray(image_u8, dtype=np.uint8)
    if image_u8.ndim != 3 or image_u8.shape[2] != 3:
        raise ValueError(f"image must be [H, W, 3] BGR, got "
                         f"{image_u8.shape}")
    h, w = image_u8.shape[:2]
    eh, ew, top, left = (h, w, 0, 0) if ep is None else ep
    cx0, cy0, cx1, cy1 = (0, 0, ew, eh) if rect is None else \
        (int(rect[0]), int(rect[1]), int(rect[2]), int(rect[3]))
    oh, ow = size
    mean_c = (ctypes.c_float * 3)(*np.asarray(mean, np.float32))
    std_c = (ctypes.c_float * 3)(*np.asarray(std, np.float32))
    contrast = pp.get("contrast")
    out = np.empty((oh, ow, 3), np.uint8 if u8_out else np.float32)
    out_p = out.ctypes.data_as(ctypes.c_void_p)
    lib.yolo_tpu_augment_one(
        image_u8.ctypes.data_as(ctypes.c_void_p), h, w,
        int(pp["bright"] is not None), float(pp["bright"] or 0.0),
        int(pp["contrast_first"]),
        int(contrast is not None), float(contrast or 0.0),
        int(pp["sat"] is not None), float(pp["sat"] or 0.0),
        int(pp["hue"] is not None), float(pp["hue"] or 0.0),
        eh, ew, top, left, cx0, cy0, cx1, cy1,
        int(mirror), oh, ow, mean_c, std_c, int(rgb), int(u8_out),
        None if u8_out else out_p, out_p if u8_out else None)
    return out
