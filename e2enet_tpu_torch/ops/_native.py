"""Build and bind the CUDA kernels of csrc/.

The sources are compiled with nvcc into a shared library with a plain C
interface at first use, into `build/` at the root of the checkout (named by
a hash of source and flags, so an edited source rebuilds), and bound with
ctypes. The compiler's report (`-Xptxas -v`: registers, shared memory,
spills) is kept beside the library as `<library>.log`. Nothing here runs at
import time: this module is imported on machines without nvcc or a card.
"""
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCE = CSRC / "fused_block.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.isfile(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return found


def library_path() -> Path:
    """build/libfused_block_<hash of source and flags>.so"""
    tag = hashlib.sha256(SOURCE.read_bytes()
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libfused_block_{tag}.so"


@functools.cache
def library() -> ctypes.CDLL:
    """Compile csrc/fused_block.cu if no library for this source exists,
    load it and declare the C signature."""
    so = library_path()
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
        r = subprocess.run(cmd, capture_output=True, text=True)
        Path(f"{so}.log").write_text(r.stdout + r.stderr)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc failed ({r.returncode}):\n{r.stderr}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    vp, ip, i = ctypes.c_void_p, ctypes.c_int, ctypes.c_int
    fn = lib.fused_block_launch
    fn.argtypes = [ctypes.POINTER(vp), ctypes.POINTER(vp),
                   ctypes.POINTER(vp), ctypes.POINTER(ip), ctypes.POINTER(ip),
                   i, ctypes.POINTER(ip), i, vp, vp, vp, vp, i, i, i, i, i,
                   vp]
    fn.restype = ctypes.c_int
    return lib


def _row_alignment(x) -> int:
    ptr, ci = x.data_ptr(), int(x.shape[-1])
    if ptr % 16 == 0 and ci % 8 == 0:
        return 16
    if ptr % 4 == 0 and ci % 2 == 0:
        return 4
    return 2


def launch_fused_block(parts, affines, groups, w9, b, y, stats) -> None:
    """Launch csrc/fused_block.cu on the current stream. parts: contiguous
    bf16 (N, D, H, W, Ci); affines: per part None or contiguous float32
    (mult, off) of shape (N, Ci); groups: [(c0, c1, shift)]; w9 (9, CO, C)
    bf16; b (CO,) bf16; outputs y (N, D, H, W, CO) bf16 and stats (N, CO, 2)
    float32 (zeroed). Raises on a refused launch."""
    if w9.data_ptr() % 16 or not w9.is_contiguous():
        raise ValueError("weights must be contiguous and 16-byte aligned")
    fn = library().fused_block_launch
    P = len(parts)
    arr = ctypes.c_void_p * P
    xs = arr(*[p.data_ptr() for p in parts])
    ms = arr(*[None if a is None else a[0].data_ptr() for a in affines])
    os_ = arr(*[None if a is None else a[1].data_ptr() for a in affines])
    pc = (ctypes.c_int * P)(*[int(p.shape[-1]) for p in parts])
    # the widest copy every pixel row of a part is aligned for
    vec = (ctypes.c_int * P)(*[_row_alignment(p) for p in parts])
    flat = [int(v) for g in groups for v in g]
    gr = (ctypes.c_int * len(flat))(*flat)
    N, D, H, W, CO = (int(s) for s in y.shape)
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        err = fn(xs, ms, os_, pc, vec, P, gr, len(groups), w9.data_ptr(),
                 b.data_ptr(), y.data_ptr(), stats.data_ptr(), N, D, H, W,
                 CO, stream)
    if err != 0:
        raise RuntimeError(f"fused_block kernel refused: cudaError {err} "
                           f"(N={N} D={D} H={H} W={W} C={sum(pc)} CO={CO})")
