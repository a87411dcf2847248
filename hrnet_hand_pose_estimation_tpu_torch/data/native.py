"""ctypes bindings for the host-pipeline library of the repo's
``native/fastops.cpp``: batch normalisation of uint8 images and Gaussian
heatmap stamping, OpenMP-parallel over the batch.

Port of the JAX package's ``data/native.py:66-105``.  The port compiles the
library itself, once, into ``build/native/libfastops.so`` beside the package
(``g++ -O3 -march=native -fopenmp``; ``build/`` is not tracked), and never
into ``native/``.  Without a compiler, or with ``HANDPOSE_NO_NATIVE`` set,
both functions run numpy with the JAX package's fallback arithmetic.  This
is host code: no device kernel stands behind it.  No module of the port
calls it yet: the loaders stamp targets with ``ops/targets`` in numpy and
the card normalises the images.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np

from ..ops.targets import gaussian_targets_np
from .transforms import IMAGENET_MEAN, IMAGENET_STD

_REPO = Path(__file__).resolve().parents[2]
SOURCE = _REPO / "native" / "fastops.cpp"
BUILD_DIR = _REPO / "build" / "native"
LIB_PATH = BUILD_DIR / "libfastops.so"

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _build() -> Optional[Path]:
    """Compile the library into ``build/native/``; the object is written
    under a temporary name and renamed, so concurrent builds cannot leave a
    torn file."""
    if not SOURCE.is_file():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", "-O3", "-march=native", "-fopenmp", "-shared", "-fPIC",
                        str(SOURCE), "-o", tmp], check=True, capture_output=True, timeout=120)
        os.replace(tmp, LIB_PATH)
    except (OSError, subprocess.SubprocessError):
        return None
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return LIB_PATH


def load_library() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    if os.environ.get("HANDPOSE_NO_NATIVE"):
        return None
    so = LIB_PATH if LIB_PATH.is_file() else _build()
    if so is None:
        return None
    try:
        lib = ctypes.CDLL(str(so))
    except OSError:
        return None
    lib.normalize_collate_u8.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p]
    lib.gaussian_targets.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_float]
    lib.fastops_num_threads.restype = ctypes.c_int
    _LIB = lib
    return _LIB


def normalize_collate(images_u8: np.ndarray) -> np.ndarray:
    """(B, H, W, 3) uint8 -> ImageNet-normalised float32, native when available."""
    if images_u8.dtype != np.uint8 or images_u8.ndim != 4:
        raise ValueError(f"normalize_collate takes (B, H, W, 3) uint8, not "
                         f"{images_u8.dtype} {images_u8.shape}")
    lib = load_library()
    if lib is None:
        return ((images_u8.astype(np.float32) / 255.0) - IMAGENET_MEAN) / IMAGENET_STD
    src = np.ascontiguousarray(images_u8)
    out = np.empty(src.shape, np.float32)
    mean = np.ascontiguousarray(IMAGENET_MEAN)
    std = np.ascontiguousarray(IMAGENET_STD)
    lib.normalize_collate_u8(src.ctypes.data, out.ctypes.data, src.shape[0],
                             int(np.prod(src.shape[1:])), mean.ctypes.data, std.ctypes.data)
    return out


def gaussian_targets_native(joints: np.ndarray, visibility: np.ndarray,
                            output_res: int, sigma: float = 2.0) -> np.ndarray:
    """(B, K, 2), (B, K) -> (B, res, res, K); the numbers of ops/targets."""
    lib = load_library()
    if lib is None:
        return gaussian_targets_np(joints, visibility, output_res, sigma)
    j = np.ascontiguousarray(joints, np.float32)
    v = np.ascontiguousarray(visibility, np.float32)
    b, k = j.shape[:2]
    out = np.empty((b, output_res, output_res, k), np.float32)
    lib.gaussian_targets(j.ctypes.data, v.ctypes.data, out.ctypes.data,
                         b, k, output_res, float(sigma))
    return out


def native_available() -> bool:
    return load_library() is not None
