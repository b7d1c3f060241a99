"""Build and bind the CUDA kernels of csrc/.

Every csrc/*.cu is compiled with nvcc into its own shared library with a
plain C interface, into `build/` at the root of the checkout, at first use:
all sources at once, one nvcc process each, started together. A library's
name carries a hash of every source, the shared headers (csrc/*.cuh) and
the flags, so an edited source rebuilds them all. Each is loaded with
ctypes; the compiler's report (`-Xptxas -v`: registers, shared memory,
spills) is kept beside it as `<library>.log`. Nothing here runs at import
time: this module is imported on machines without nvcc or a card. Every
launcher raises on a non-zero return (a refused launch); there is no
fallback.
"""
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

vp, i32 = ctypes.c_void_p, ctypes.c_int
PI = ctypes.POINTER(ctypes.c_int)
# the C entry points of each source and their argument types
SIGNATURES = {
    "fused_block": {
        # parts, affines, part_c, part_vec, nparts, groups, ngroups, w9, b,
        # y, stats, N, D, H, W, CO, the packed-weights scratch and its
        # bytes, wgmma, the halo rows above and below (arrays or null),
        # stream
        "fused_block_launch": [ctypes.POINTER(vp)] * 3 + [PI, PI, i32, PI,
                                                          i32] + [vp] * 4
        + [i32] * 5 + [vp, i32, i32] + [ctypes.POINTER(vp)] * 2 + [vp],
        # C, CO
        "fused_block_scratch_bytes": [i32, i32]},
    "qfused": {
        # the fused block's arguments, then up_raw, up_mult, up_off, up_w,
        # cin, wgmma, stream
        "qfused_lazy_launch": [ctypes.POINTER(vp)] * 3 + [PI, PI, i32, PI,
                                                          i32] + [vp] * 4
        + [i32] * 5 + [vp] * 4 + [i32, i32, vp]},
    "fused_block_bwd": {
        # the forward's parts, affines, part_c, part_vec, nparts, groups,
        # ngroups; gxs, gaffs; y, gy, gstats, w9t, gw, gb; N, D, H, W, CO;
        # the forward's halo rows above and below (arrays or null); the
        # neighbours' y, gy rows above, y, gy rows below (or null); stream
        "fused_block_bwd_launch": [ctypes.POINTER(vp)] * 3
        + [PI, PI, i32, PI, i32] + [ctypes.POINTER(vp)] * 2 + [vp] * 6
        + [i32] * 5 + [ctypes.POINTER(vp)] * 2 + [vp] * 5},
    "qstride": {
        # x, mult, off, groups, ngroups, w9, b, y, stats, N, D, H, W, C, CO,
        # Do, Ho, Wo, sd, sh, sw, parity, origin_h, origin_w, the halo rows
        # above and below (or null), stream
        "qstride_launch": [vp] * 3 + [PI, i32] + [vp] * 4 + [i32] * 15
        + [vp] * 3},
    "qlink": {
        # x, mult, off, k, the image scratch, y, N, D, H, W, Cin, Cout, sd,
        # sh, sw, the route taken, stream
        "uplink_launch": [vp] * 6 + [i32] * 9 + [PI, vp],
        # Cin, Cout, sd, sh, sw
        "uplink_image_bytes": [i32] * 5,
        # k, img, Cin, Cout, sd, sh, sw, stream
        "uplink_image_launch": [vp] * 2 + [i32] * 5 + [vp],
        # x, mult, off, y, N, D, H, W, C, wd, wh, ww, stream
        "downlink_launch": [vp] * 4 + [i32] * 8 + [vp],
        # x, gy, mult, off, gx, gaff, N, D, H, W, C, wd, wh, ww, stream
        "downlink_bwd_launch": [vp] * 6 + [i32] * 8 + [vp],
        # x, mult, off, w, y, N, voxels per sample, C, K, probs, the route
        # taken, stream
        "seghead_launch": [vp] * 5 + [i32] * 5 + [PI, vp]},
    # the experiment kernels (e2enet_tpu_torch/experiments)
    "fused_block_pipe": {
        # the fused block's arguments up to CO, the packed-weights scratch
        # and its bytes, overlap, the ring's depth taken, stream
        "fused_block_pipe_launch": [ctypes.POINTER(vp)] * 3
        + [PI, PI, i32, PI, i32] + [vp] * 4 + [i32] * 5 + [vp, i32, i32, PI,
                                                            vp],
        # C, CO
        "fused_block_pipe_scratch_bytes": [i32, i32]},
    "shift_conv_ring": {
        # x, w, the packed weights, b, y, groups, ngroups, N, D, H, W, C,
        # CO, tma, stream
        "shift_conv_ring_launch": [vp] * 5 + [PI, i32] + [i32] * 7 + [vp],
        # x, y, groups, ngroups, N, D, H, W, C, CO
        "shift_conv_ring_route": [vp] * 2 + [PI, i32] + [i32] * 6,
        # x, y, groups, ngroups, N, D, H, W, C, stream
        "depth_shift_ring_launch": [vp] * 2 + [PI, i32] + [i32] * 5 + [vp]},
    "cf_fused": {
        # x, y, H, W, C, element size, stream
        "reshape_hwc_launch": [vp] * 2 + [i32] * 4 + [vp],
        # x, w, the packed weights, b, mult, off, y, stats, groups, ngroups,
        # slots, nslots, N, D, H, W, C, CO, the route taken, stream
        "cf_fused_launch": [vp] * 8 + [PI, i32, PI, i32] + [i32] * 6
        + [PI, vp],
        # x, y, N, D, H, W, C, CO, slots, nslots
        "cf_route": [vp] * 2 + [i32] * 6 + [PI, i32]},
    "mma_gemm": {
        # a, b, c, M, N, K, int8, wgmma, the repacked-B scratch, stream
        "mma_gemm_launch": [vp] * 3 + [i32] * 5 + [vp] * 2,
        # a, b, c, M, N, K, int8
        "mma_gemm_wgmma_ok": [vp] * 3 + [i32] * 4,
        # b, bt, K, N, stream
        "mma_gemm_repack_launch": [vp] * 2 + [i32] * 2 + [vp]},
}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.isfile(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return found


def sources() -> Dict[str, Path]:
    return {p.stem: p for p in sorted(CSRC.glob("*.cu"))}


def library_path(name: str) -> Path:
    """build/lib<name>_<hash of all sources, headers and the flags>.so"""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode() + p.read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


@functools.cache
def build_all() -> Dict[str, Path]:
    """Compile every source whose library is missing, in parallel, and
    return {name: library path}. Raises with the compiler's errors."""
    srcs = sources()
    todo = {n: library_path(n) for n in srcs}
    todo = {n: so for n, so in todo.items() if not so.exists()}
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = {}
        for n, so in todo.items():
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            procs[n] = (so, tmp, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(srcs[n])],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        errors = []
        for n, (so, tmp, proc) in procs.items():
            out, _ = proc.communicate()
            Path(f"{so}.log").write_text(out)
            if proc.returncode != 0:
                errors.append(f"{srcs[n].name}: nvcc exit {proc.returncode}"
                              f"\n{out}")
            else:
                os.replace(tmp, so)
        if errors:
            raise RuntimeError("\n".join(errors))
    return {n: library_path(n) for n in srcs}


@functools.cache
def library(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, with its C signatures."""
    lib = ctypes.CDLL(str(build_all()[name]))
    for fn_name, argtypes in SIGNATURES[name].items():
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


# the routes of the up-link and the seg head, of the channels-first block
# and of the ring shift + conv, by the library's code
ROUTES = {0: "ldg", 1: "bulk"}
CF_ROUTES = {0: "ldg", 1: "tma"}
RING_ROUTES = {0: "cp_async", 1: "tma"}


def _stream(t: torch.Tensor):
    return torch.cuda.current_stream(t.device).cuda_stream


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel refused: cudaError {err}")


def _row_alignment(x) -> int:
    ptr, ci = x.data_ptr(), int(x.shape[-1])
    if ptr % 16 == 0 and ci % 8 == 0:
        return 16
    if ptr % 4 == 0 and ci % 2 == 0:
        return 4
    return 2


def _groups_arr(groups):
    flat = [int(v) for g in groups for v in g]
    return (ctypes.c_int * len(flat))(*flat), len(groups)


def _part_args(parts, affines, groups, up_channels=None):
    """The parts' C arguments (pointers, affines, channels, row alignment,
    count, groups, group count); with up_channels, a last part of that many
    channels and null pointers (the lazy up-link)."""
    ptrs = [p.data_ptr() for p in parts]
    mults = [None if a is None else a[0].data_ptr() for a in affines]
    offs = [None if a is None else a[1].data_ptr() for a in affines]
    chans = [int(p.shape[-1]) for p in parts]
    # the widest copy every pixel row of a part is aligned for
    vecs = [_row_alignment(p) for p in parts]
    if up_channels is not None:
        ptrs, mults, offs = ptrs + [None], mults + [None], offs + [None]
        chans, vecs = chans + [int(up_channels)], vecs + [2]
    P = len(ptrs)
    arr = ctypes.c_void_p * P
    gr, ng = _groups_arr(groups)
    return (arr(*ptrs), arr(*mults), arr(*offs), (ctypes.c_int * P)(*chans),
            (ctypes.c_int * P)(*vecs), P, gr, ng)


def _halo_ptr(t):
    """A halo row's pointer (None: none), its tensor contiguous and
    16-byte aligned as the kernels' row copies want it."""
    if t is None:
        return None, None
    if not t.is_contiguous() or t.data_ptr() % 16:
        t = t.clone(memory_format=torch.contiguous_format)
    return t.data_ptr(), t


def _halo_arrays(halos, P):
    """Per part the halo rows above and below as two C pointer arrays,
    or (None, None, []) without halos; keep the returned tensors alive
    until the launch."""
    if halos is None:
        return None, None, []
    arr = ctypes.c_void_p * P
    out, keep = [], []
    for rows in halos:
        got = [_halo_ptr(t) for t in rows]
        keep += [t for _, t in got if t is not None]
        out.append(arr(*[ptr for ptr, _ in got]))
    return out[0], out[1], keep


def _block_args(parts, affines, groups, w9, b, y, stats, up_channels=None):
    """The fused block's C arguments up to the stream (_part_args, then the
    weights, bias, outputs and sizes)."""
    if w9.data_ptr() % 16 or not w9.is_contiguous():
        raise ValueError("weights must be contiguous and 16-byte aligned")
    N, D, H, W, CO = (int(s) for s in y.shape)
    return _part_args(parts, affines, groups, up_channels) + (
        w9.data_ptr(), b.data_ptr(), y.data_ptr(), stats.data_ptr(), N, D, H,
        W, CO)


def launch_fused_block(parts, affines, groups, w9, b, y, stats,
                       wgmma: bool = True, halos=None) -> None:
    """Launch csrc/fused_block.cu on the current stream. parts: contiguous
    bf16 (N, D, H, W, Ci); affines: per part None or contiguous float32
    (mult, off) of shape (N, Ci); groups: [(c0, c1, shift)]; w9 (9, CO, C)
    bf16; b (CO,) bf16; outputs y (N, D, H, W, CO) bf16 and stats (N, CO, 2)
    float32 (zeroed). The kernel first packs the weights for its bulk
    copies into a scratch tensor of the size the library gives
    (fused_block_scratch_bytes). The conv's taps on wgmma, or with
    wgmma=False on mma.sync (the control). halos: (tops, bottoms), per
    part bf16 (N, D, 1, W, Ci) raw rows above row 0 / below row H - 1 of
    an H slab, or None (zero fill); None: no halo rows, today's launch.
    Raises on a refused launch."""
    lib = library("fused_block")
    args = _block_args(parts, affines, groups, w9, b, y, stats)
    C, CO = sum(args[3]), int(y.shape[-1])
    nbytes = lib.fused_block_scratch_bytes(C, CO)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=y.device)
    xts, xbs, keep = _halo_arrays(halos, len(parts))
    with torch.cuda.device(y.device):
        err = lib.fused_block_launch(*args, scratch.data_ptr(), nbytes,
                                     int(wgmma), xts, xbs, _stream(y))
    del keep
    _check(err, f"fused_block (shape {tuple(y.shape)}, C={C})")


def launch_lazy_up(parts, affines, groups, w9, b, raw, umult, uoff, wu, y,
                   stats, wgmma: bool = True) -> None:
    """Launch csrc/qfused.cu: the fused block of launch_fused_block on the
    concat of `parts` and a last up-link part computed on load from raw, the
    level-below pending raw (N, D/2, H/2, W/2, cin) contiguous bf16, with
    umult/uoff float32 (N, cin) and wu (8, C_up, cin) bf16 (parity
    bd*4 + bh*2 + bw, flips applied); the conv's taps on wgmma, or with
    wgmma=False on mma.sync (the control). Raises on a refused launch."""
    fn = library("qfused").qfused_lazy_launch
    args = _block_args(parts, affines, groups, w9, b, y, stats,
                       up_channels=int(wu.shape[1]))
    cin = int(raw.shape[-1])
    with torch.cuda.device(y.device):
        err = fn(*args, raw.data_ptr(), umult.data_ptr(), uoff.data_ptr(),
                 wu.data_ptr(), cin, int(wgmma), _stream(y))
    _check(err, f"qfused lazy (shape {tuple(y.shape)}, C={sum(args[3])}, "
                f"cin={cin})")


def launch_fused_block_bwd(parts, affines, groups, gxs, gaffs, y, gy, gstats,
                           w9t, gw, gb, halos=None, edge_rows=None) -> None:
    """Launch csrc/fused_block_bwd.cu: the fused block's backward, two
    kernels (the dgrad with the shift's adjoint, only when some part is
    wanted; the wgrad with gb). parts, affines, groups as for
    launch_fused_block (the forward's, groups with the mirror applied);
    gxs / gaffs: per part a bf16 (N, D, H, W, Ci) output (every element
    written) / a zeroed float32 (N, Ci, 2) output, or None where not
    wanted; y, gy bf16 (N, D, H, W, CO); gstats float32 (N, CO, 2); w9t
    (9, C, CO) bf16 (taps reversed, transposed); outputs gw float32
    (9, CO, C) and gb float32 (CO,), zeroed. halos: the forward's halo
    rows (launch_fused_block's); edge_rows: ((y, gy) above, (y, gy)
    below), each pair bf16 (N, D, 1, W, CO) rows of the neighbours or
    None. Raises on a refused launch."""
    if w9t.data_ptr() % 16 or not w9t.is_contiguous():
        raise ValueError("weights must be contiguous and 16-byte aligned")
    fn = library("fused_block_bwd").fused_block_bwd_launch
    args = _part_args(parts, affines, groups)
    P = len(parts)
    arr = ctypes.c_void_p * P
    gx_ptrs = arr(*[None if g is None else g.data_ptr() for g in gxs])
    ga_ptrs = arr(*[None if g is None else g.data_ptr() for g in gaffs])
    N, D, H, W, CO = (int(s) for s in y.shape)
    xts, xbs, keep = _halo_arrays(halos, P)
    edges = []
    for pair in edge_rows or (None, None):
        got = [_halo_ptr(t) for t in (pair or (None, None))]
        keep += [t for _, t in got if t is not None]
        edges += [ptr for ptr, _ in got]
    with torch.cuda.device(y.device):
        err = fn(*args, gx_ptrs, ga_ptrs, y.data_ptr(), gy.data_ptr(),
                 gstats.data_ptr(), w9t.data_ptr(), gw.data_ptr(),
                 gb.data_ptr(), N, D, H, W, CO, xts, xbs, *edges,
                 _stream(y))
    del keep
    _check(err, f"fused_block_bwd (shape {tuple(y.shape)}, "
                f"C={sum(args[3])})")


def launch_downlink_bwd(x, gy, mult, off, gx, gaff, window) -> None:
    """Launch csrc/qlink.cu's down-link backward: x contiguous bf16
    (N, D, H, W, C), the forward's input; gy bf16 (N, D//wd, H//wh, W//ww,
    C); mult/off float32 (N, C); outputs gx bf16 like x (the ragged edge
    zeroed by the caller) and gaff float32 (N, C, 2) zeroed."""
    fn = library("qlink").downlink_bwd_launch
    N, D, H, W, C = (int(s) for s in x.shape)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), gy.data_ptr(), mult.data_ptr(), off.data_ptr(),
                 gx.data_ptr(), gaff.data_ptr(), N, D, H, W, C, *window,
                 _stream(x))
    _check(err, f"downlink_bwd (N={N} D={D} H={H} W={W} C={C})")


def launch_strided(x, mult, off, groups, w9, b, y, stats, stride, parity,
                   origins, halo=(None, None)) -> None:
    """Launch csrc/qstride.cu: x contiguous bf16 (N, D, H, W, C); mult/off
    float32 (N, C); groups [(c0, c1, shift)] of C with the input depth row
    stride_d * do + parity - shift; w9 (9, CO, C) bf16 with the taps
    already mirrored; b (CO,) float32; origins (H, W) position of tap 0
    relative to stride * o; outputs y (N, Do, Ho, Wo, CO) bf16 and stats
    (N, CO, 2) float32 (zeroed); halo: bf16 (N, D, 1, W, C) raw rows above
    row 0 and below row H - 1 of an H slab, or None (zero fill)."""
    fn = library("qstride").qstride_launch
    gr, ng = _groups_arr(groups)
    N, D, H, W, C = (int(s) for s in x.shape)
    _, Do, Ho, Wo, CO = (int(s) for s in y.shape)
    (top, keep_t), (bottom, keep_b) = (_halo_ptr(t) for t in halo)
    with torch.cuda.device(y.device):
        err = fn(x.data_ptr(), mult.data_ptr(), off.data_ptr(), gr, ng,
                 w9.data_ptr(), b.data_ptr(), y.data_ptr(),
                 stats.data_ptr(), N, D, H, W, C, CO, Do, Ho, Wo,
                 *stride, parity, *origins, top, bottom, _stream(y))
    del keep_t, keep_b
    _check(err, f"qstride (N={N} D={D} H={H} W={W} C={C} CO={CO})")


def launch_uplink(x, mult, off, k, y, stride) -> str:
    """Launch csrc/qlink.cu's up-link: x contiguous bf16 (N, D, H, W, Cin);
    mult/off float32 (N, Cin); k (Cin, Cout, sd, sh, sw) contiguous bf16,
    the kernel already mirrored; output y (N, D*sd, H*sh, W*sw, Cout)
    bf16. The library first packs k into the weights' image, a scratch
    allocated here (uplink_image_bytes), then runs the route its rule
    (uplink_route) gives. Returns the route: "bulk" or "ldg"."""
    lib = library("qlink")
    N, D, H, W, C = (int(s) for s in x.shape)
    cout = int(y.shape[-1])
    img = torch.empty(lib.uplink_image_bytes(C, cout, *stride),
                      dtype=torch.uint8, device=y.device)
    route = ctypes.c_int(-1)
    with torch.cuda.device(y.device):
        err = lib.uplink_launch(x.data_ptr(), mult.data_ptr(), off.data_ptr(),
                                k.data_ptr(), img.data_ptr(), y.data_ptr(), N,
                                D, H, W, C, cout, *stride, ctypes.byref(route),
                                _stream(y))
    _check(err, f"uplink (N={N} D={D} H={H} W={W} Cin={C} Cout={cout})")
    return ROUTES[route.value]


def launch_uplink_image(k, img) -> None:
    """The up-link's weight packing alone: k (Cin, Cout, sd, sh, sw)
    contiguous bf16 -> img, a contiguous tensor of uplink_image_bytes(...)
    bytes (the image launch_uplink's products read)."""
    C, cout, sd, sh, sw = (int(s) for s in k.shape)
    with torch.cuda.device(img.device):
        err = library("qlink").uplink_image_launch(
            k.data_ptr(), img.data_ptr(), C, cout, sd, sh, sw, _stream(img))
    _check(err, f"uplink image (Cin={C} Cout={cout})")


def launch_downlink(x, mult, off, y, window) -> None:
    """Launch csrc/qlink.cu's down-link: x contiguous bf16 (N, D, H, W, C);
    mult/off float32 (N, C); output y (N, D//wd, H//wh, W//ww, C) bf16."""
    fn = library("qlink").downlink_launch
    N, D, H, W, C = (int(s) for s in x.shape)
    with torch.cuda.device(y.device):
        err = fn(x.data_ptr(), mult.data_ptr(), off.data_ptr(),
                 y.data_ptr(), N, D, H, W, C, *window, _stream(y))
    _check(err, f"downlink (N={N} D={D} H={H} W={W} C={C})")


def launch_seghead(x, mult, off, w, y, probs: bool) -> str:
    """Launch csrc/qlink.cu's seg head: x contiguous bf16 (N, D, H, W, C);
    mult/off float32 (N, C); w (K, C) bf16; output y (N, D, H, W, K): bf16
    probs when `probs`, else float32 logits. Runs the route the library's
    rule (seghead_route) gives and returns it: "bulk" or "ldg"."""
    fn = library("qlink").seghead_launch
    N, D, H, W, C = (int(s) for s in x.shape)
    K = int(w.shape[0])
    route = ctypes.c_int(-1)
    with torch.cuda.device(y.device):
        err = fn(x.data_ptr(), mult.data_ptr(), off.data_ptr(), w.data_ptr(),
                 y.data_ptr(), N, D * H * W, C, K, int(probs),
                 ctypes.byref(route), _stream(y))
    _check(err, f"seghead (N={N} D={D} H={H} W={W} C={C} K={K})")
    return ROUTES[route.value]


def launch_fused_block_pipe(parts, affines, groups, w9, b, y, stats,
                            overlap: bool = True) -> int:
    """Launch csrc/fused_block_pipe.cu, the warp-specialised pipelined fused
    block: the arguments and outputs of launch_fused_block. The kernel first
    packs the weights into a scratch tensor of the size the library gives
    (fused_block_pipe_scratch_bytes). overlap False runs its operand ring
    with one stage (the control). Returns the ring's depth; raises on a
    refused launch."""
    lib = library("fused_block_pipe")
    args = _block_args(parts, affines, groups, w9, b, y, stats)
    C, CO = sum(args[3]), int(y.shape[-1])
    nbytes = lib.fused_block_pipe_scratch_bytes(C, CO)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=y.device)
    stages = ctypes.c_int(0)
    with torch.cuda.device(y.device):
        err = lib.fused_block_pipe_launch(*args, scratch.data_ptr(), nbytes,
                                          int(overlap), ctypes.byref(stages),
                                          _stream(y))
    _check(err, f"fused_block_pipe (shape {tuple(y.shape)}, C={C})")
    return stages.value


def shift_conv_ring_route(x, y, groups) -> str:
    """The route csrc/shift_conv_ring.cu's fused kernel takes for x
    (N, D, H, W, C) -> y (N, D, H, W, CO) with the shift groups `groups`:
    "tma" or "cp_async". The rule lives in the library
    (shift_conv_ring_route)."""
    gr, ng = _groups_arr(groups)
    N, D, H, W, C = (int(s) for s in x.shape)
    return RING_ROUTES[library("shift_conv_ring").shift_conv_ring_route(
        x.data_ptr(), y.data_ptr(), gr, ng, N, D, H, W, C,
        int(y.shape[-1]))]


def launch_shift_conv_ring(x, w9, wpk, b, y, groups, route: str) -> None:
    """Launch csrc/shift_conv_ring.cu's fused kernel on `route`: x
    contiguous bf16 (N, D, H, W, C); groups [(c0, c1, shift)], shifts in
    [-2, 2]; the cp.async route's weights w9 (9, CO, C) bf16 or the TMA
    route's packed weights wpk (shift_conv.pack_weights_n48), the other
    None; b (CO,) bf16; output y (N, D, H, W, CO) bf16. The library refuses
    "tma" (an error) for a shape its rule gives to "cp_async"."""
    fn = library("shift_conv_ring").shift_conv_ring_launch
    gr, ng = _groups_arr(groups)
    N, D, H, W, C = (int(s) for s in x.shape)
    CO = int(y.shape[-1])
    opt = [None if t is None else t.data_ptr() for t in (w9, wpk)]
    with torch.cuda.device(y.device):
        err = fn(x.data_ptr(), opt[0], opt[1], b.data_ptr(), y.data_ptr(),
                 gr, ng, N, D, H, W, C, CO, int(route == "tma"), _stream(y))
    _check(err, f"shift_conv_ring {route} (N={N} D={D} H={H} W={W} C={C} "
                f"CO={CO})")


def launch_depth_shift_ring(x, y, groups) -> None:
    """Launch csrc/shift_conv_ring.cu's shift: x contiguous bf16
    (N, D, H, W, C); groups [(c0, c1, shift)], shifts in [-2, 2]; output y
    like x."""
    fn = library("shift_conv_ring").depth_shift_ring_launch
    gr, ng = _groups_arr(groups)
    N, D, H, W, C = (int(s) for s in x.shape)
    with torch.cuda.device(y.device):
        err = fn(x.data_ptr(), y.data_ptr(), gr, ng, N, D, H, W, C,
                 _stream(y))
    _check(err, f"depth_shift_ring (N={N} D={D} H={H} W={W} C={C})")


def launch_reshape_hwc(x, y, H, W, C) -> None:
    """Launch csrc/cf_fused.cu's relayout probe: x contiguous (H, W*C), y
    contiguous (H*W, C) of the same dtype."""
    fn = library("cf_fused").reshape_hwc_launch
    with torch.cuda.device(y.device):
        err = fn(x.data_ptr(), y.data_ptr(), H, W, C, x.element_size(),
                 _stream(y))
    _check(err, f"reshape_hwc (H={H} W={W} C={C})")


def cf_route(x, y, H, W, slots) -> str:
    """The route csrc/cf_fused.cu takes for x (N, D, C, H*W) -> y (N, D, CO,
    H*W) with the channels in `slots` [(first channel, channels, shift)]:
    "tma" or "ldg". The rule lives in the library (cf_route)."""
    N, D, C = (int(s) for s in x.shape[:3])
    sl, ns = _groups_arr(slots)
    return CF_ROUTES[library("cf_fused").cf_route(
        x.data_ptr(), y.data_ptr(), N, D, H, W, C, int(y.shape[2]), sl, ns)]


def launch_cf_fused(x, w2, wpk, b, mult, off, y, stats, groups, slots, H,
                    W) -> str:
    """Launch csrc/cf_fused.cu's channels-first block: x contiguous bf16
    (N, D, C, H*W); the ldg route's weights w2 (CO, 9*C) bf16 (k = tap * C
    + channel) or the TMA route's packed weights wpk
    (shift_conv.pack_weights_n48), one of them None; b (CO,) bf16;
    mult/off float32 (C,) or both None; y (N, D, CO, H*W) bf16; stats
    float32 (N, CO, 2) zeroed, or None; groups [(c0, c1, shift)]; slots [(c0, channels, shift)].
    Runs the route the library's rule gives (cf_route) and returns it."""
    fn = library("cf_fused").cf_fused_launch
    gr, ng = _groups_arr(groups)
    sl, ns = _groups_arr(slots)
    N, D, C = (int(s) for s in x.shape[:3])
    CO = int(y.shape[2])
    opt = [None if t is None else t.data_ptr()
           for t in (w2, wpk, mult, off, stats)]
    route = ctypes.c_int(-1)
    with torch.cuda.device(y.device):
        err = fn(x.data_ptr(), opt[0], opt[1], b.data_ptr(), opt[2], opt[3],
                 y.data_ptr(), opt[4], gr, ng, sl, ns, N, D, H, W, C, CO,
                 ctypes.byref(route), _stream(y))
    _check(err, f"cf_fused (N={N} D={D} H={H} W={W} C={C} CO={CO})")
    return CF_ROUTES[route.value]


def mma_gemm_wgmma_ok(a, b, c) -> bool:
    """Whether csrc/mma_gemm.cu's wgmma route takes c = a @ b: TMA needs
    16-byte-aligned pointers and row strides (bf16: K and N multiples of 8;
    int8: K a multiple of 16). The rule lives in the library."""
    M, K = (int(s) for s in a.shape)
    N = int(b.shape[1])
    return bool(library("mma_gemm").mma_gemm_wgmma_ok(
        a.data_ptr(), b.data_ptr(), c.data_ptr(), M, N, K,
        int(a.dtype == torch.int8)))


def launch_mma_gemm(a, b, c, wgmma: bool) -> None:
    """Launch csrc/mma_gemm.cu: c (M, N) = a (M, K) @ b (K, N), all
    contiguous; bf16 inputs and a float32 c, or int8 inputs and an int32
    c. wgmma: the wgmma route, for shapes mma_gemm_wgmma_ok takes (int8
    first repacks b to (N, K) into a scratch tensor allocated here); else
    the mma.sync kernel. Raises on a refused launch."""
    fn = library("mma_gemm").mma_gemm_launch
    M, K = (int(s) for s in a.shape)
    N = int(b.shape[1])
    int8 = a.dtype == torch.int8
    scratch = (torch.empty((N, K), dtype=torch.int8, device=c.device)
               if wgmma and int8 else None)
    with torch.cuda.device(c.device):
        err = fn(a.data_ptr(), b.data_ptr(), c.data_ptr(), M, N, K,
                 int(int8), int(wgmma),
                 None if scratch is None else scratch.data_ptr(), _stream(c))
    route = "wgmma" if wgmma else "mma.sync"
    _check(err, f"mma_gemm {route} (M={M} N={N} K={K} {a.dtype})")


def launch_mma_gemm_repack(b, bt) -> None:
    """Launch the wgmma route's int8 repack alone: b (K, N) contiguous int8
    -> bt (N, K), K a multiple of 16."""
    fn = library("mma_gemm").mma_gemm_repack_launch
    K, N = (int(s) for s in b.shape)
    with torch.cuda.device(bt.device):
        err = fn(b.data_ptr(), bt.data_ptr(), K, N, _stream(bt))
    _check(err, f"mma_gemm repack (K={K} N={N})")
