"""Native (C++) host components: the port's own copy of
e2enet_tpu/native/__init__.py.

The augmentation's spatial warp (resample.cpp, the same code as the JAX
package's) is built with the system g++ at first use into `build/` at the
root of the checkout, as the CUDA libraries are (ops/_native.py), under a
name that carries a hash of the source, the flags and the host's CPU
(-march=native: a library built on one machine is not loaded on another
whose CPU differs). native_available() is False where no compiler is
found or E2ENET_NO_NATIVE is set; the augmentation then takes scipy's
route (data/augment.py). route() names the route taken. This is host
code: it runs on the CPU beside the card.
"""
import ctypes
import hashlib
import os
import platform
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

_SRC = Path(__file__).resolve().parent / "resample.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
CXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC"]
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _cpu_id() -> str:
    """The host CPU's model and feature flags, as /proc/cpuinfo gives
    them (the processor name elsewhere)."""
    try:
        with open("/proc/cpuinfo") as f:
            lines = [ln for ln in f.read().splitlines()
                     if ln.startswith(("model name", "flags"))]
        return "\n".join(sorted(set(lines)))
    except OSError:
        return platform.processor()


def library_path() -> Path:
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    h.update(_cpu_id().encode())
    return BUILD_DIR / f"libresample_{h.hexdigest()[:16]}.so"


def _build() -> Optional[ctypes.CDLL]:
    so_path = library_path()
    if not so_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so_path.with_name(so_path.name + f".build{os.getpid()}")
        cmd = ["g++", *CXX_FLAGS, "-o", str(tmp), str(_SRC)]
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
            os.replace(tmp, so_path)
        except Exception:  # noqa: BLE001 - no compiler / failed build
            return None
    lib = ctypes.CDLL(str(so_path))
    dp = ctypes.POINTER(ctypes.c_double)
    fp = ctypes.POINTER(ctypes.c_float)
    lib.affine_warp_f32.argtypes = [
        fp, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        dp, dp, fp, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_float]
    lib.affine_warp_f32.restype = None
    lib.affine_warp_seg_f32.argtypes = [
        fp, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        dp, dp, fp, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float]
    lib.affine_warp_seg_f32.restype = None
    return lib


def native_available() -> bool:
    global _lib, _tried
    if os.environ.get("E2ENET_NO_NATIVE"):
        return False
    if not _tried:
        _tried = True
        _lib = _build()
    return _lib is not None


def route() -> str:
    """The warp's route on this machine: "native" or "scipy"."""
    return "native" if native_available() else "scipy"


def _cptr(a, typ):
    return a.ctypes.data_as(ctypes.POINTER(typ))


def affine_warp(vol: np.ndarray, M: np.ndarray, offset: np.ndarray,
                out_shape, order: int, cval: float = 0.0) -> np.ndarray:
    """scipy.ndimage.affine_transform semantics (input = M@out + offset,
    constant boundary) on (C, D, H, W) or (D, H, W) float32. order 3 is
    Keys cubic convolution (unfiltered), not scipy's B-spline — equivalent
    interpolant family for augmentation purposes."""
    assert native_available()
    squeeze = vol.ndim == 3
    if squeeze:
        vol = vol[None]
    vol = np.ascontiguousarray(vol, np.float32)
    M = np.ascontiguousarray(M, np.float64).reshape(9)
    offset = np.ascontiguousarray(offset, np.float64).reshape(3)
    C, D, H, W = vol.shape
    out = np.empty((C, *out_shape), np.float32)
    _lib.affine_warp_f32(
        _cptr(vol, ctypes.c_float), C, D, H, W,
        _cptr(M, ctypes.c_double), _cptr(offset, ctypes.c_double),
        _cptr(out, ctypes.c_float),
        int(out_shape[0]), int(out_shape[1]), int(out_shape[2]),
        int(order), float(cval))
    return out[0] if squeeze else out


def affine_warp_seg(seg: np.ndarray, M: np.ndarray, offset: np.ndarray,
                    out_shape, cval: float = 0.0) -> np.ndarray:
    """Label-map warp with the reference's per-label linear + >=0.5
    threshold semantics, single pass. seg: (D, H, W) float32 labels."""
    assert native_available()
    seg = np.ascontiguousarray(seg, np.float32)
    M = np.ascontiguousarray(M, np.float64).reshape(9)
    offset = np.ascontiguousarray(offset, np.float64).reshape(3)
    D, H, W = seg.shape
    out = np.empty(tuple(out_shape), np.float32)
    _lib.affine_warp_seg_f32(
        _cptr(seg, ctypes.c_float), D, H, W,
        _cptr(M, ctypes.c_double), _cptr(offset, ctypes.c_double),
        _cptr(out, ctypes.c_float),
        int(out_shape[0]), int(out_shape[1]), int(out_shape[2]),
        float(cval))
    return out
