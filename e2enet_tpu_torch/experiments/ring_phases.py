"""Where the time of the ring shift + conv (#11) goes, on the card: each
route's kernel timed whole and in copies of csrc/shift_conv_ring.cu with
one phase cut, at 1 x 128^3 x 48 -> 48 bf16.

    python -m e2enet_tpu_torch.experiments.ring_phases [--reps N]

No profiler sees inside a kernel here, so the phases are isolated the way
the port's redesigns have done it: a copy of the source with one phase
removed by a textual edit (each edit must match its line exactly once, so
an edited source fails loudly), built with the library's nvcc flags under
build/ring_phases/, launched through the same C entry point, and timed by
CUDA events in turns with the uncut kernel. A cut kernel's output is
garbage; only its time is read. The phases:

  cp.async route (shift_conv_ring_kernel, the first design)
    copies    the cp.async of each next depth slice into the ring
    assembly  building the shifted, zero-haloed operand from the ring
    products  the ldmatrix + mma.sync loop over the 9 taps
    stores    y from the registers (the products kept alive)
  TMA route (shift_conv_tma_kernel)
    copies    the loader's TMA box per depth slice (the full barrier
              completed with no bytes)
    a_loads   the 32-bit shared loads that build wgmma's A registers (A
              from a constant)
    products  the wgmma steps
    epilogue  the bias, the rounding, the staging of each warp's row and
              its TMA store (the products kept alive)
    stores    the TMA store alone
"""
import argparse
import ctypes
import subprocess
import sys

import torch

from ..ops import _native
from . import card_line, cuda_ms, require_cuda
from .shift_conv import pack_weights_n48, ring_groups

# (route, phase) -> [(line of csrc/shift_conv_ring.cu, its replacement)]
CUTS = {
    ("cp_async", "copies"): [
        ("    if (d + 3 < p.D) load_row(d + 3);",
         "    if (d + 3 < 0) load_row(d + 3);")],
    ("cp_async", "assembly"): [
        ("    for (int i = tid; i < npix * KU; i += RING_THREADS) {",
         "    for (int i = tid; i < 0; i += RING_THREADS) {")],
    ("cp_async", "products"): [
        ("        for (int kc = 0; kc < p.Cs; kc += 16) {",
         "        for (int kc = 0; kc < 0; kc += 16) {")],
    ("cp_async", "stores"): [
        ("        if (ww >= p.W) continue;",
         "        if (ww >= p.W || p.N > 0) continue;")],
    ("tma", "copies"): [
        ("        mbar_expect(full + s, TR_PIX * PITCH);",
         "        mbar_expect(full + s, 0);"),
        ("        tma_load_5d(smem + s * p.slot_bytes, &xmap, 0, a.w0 - 1, "
         "a.h0 - 1, r,", "        if (p.D < 0) tma_load_5d(smem + s * "
         "p.slot_bytes, &xmap, 0, a.w0 - 1, a.h0 - 1, r,")],
    ("tma", "a_loads"): [
        ("  return *reinterpret_cast<const unsigned*>(p);",
         "  return (unsigned)(uintptr_t)p;")],
    ("tma", "products"): [
        ("          WgmmaRS<TR_N8>::mma(acc, ab[t % 3][ks],\n"
         "                              wgmma_desc(wsm + (t * KS + ks) * "
         "TR_N8 * 256));", "          keep_live(ab[t % 3][ks]);")],
    ("tma", "epilogue"): [
        ("      if (lane == 0) bulk_wait_read<0>();    // the last store read "
         "the row\n", "      if (p.D < 0) {\n      if (lane == 0) "
         "bulk_wait_read<0>();    // the last store read the row\n"),
        ("        bulk_commit();\n      }\n",
         "        bulk_commit();\n      }\n      }\n")],
    ("tma", "stores"): [
        ("        tma_store_5d(&ymap, out, 0, a.w0, a.h0 + row, a.d0 + i, "
         "a.n);",
         "        if (p.D < 0) tma_store_5d(&ymap, out, 0, a.w0, a.h0 + row, "
         "a.d0 + i, a.n);")],
}
OUT = _native.BUILD_DIR / "ring_phases"


def cut_source(edits) -> str:
    """csrc/shift_conv_ring.cu with each (line, replacement) applied; every
    line must occur exactly once."""
    src = (_native.CSRC / "shift_conv_ring.cu").read_text()
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"cut: {old.strip()!r} occurs "
                               f"{src.count(old)} times")
        src = src.replace(old, new)
    return src


def build_cuts():
    """{(route, phase): loaded library} of every cut copy, built in
    parallel with the library's flags (the shared headers from csrc/)."""
    OUT.mkdir(parents=True, exist_ok=True)
    nvcc = _native._nvcc()
    procs = {}
    for (route, phase), edits in CUTS.items():
        cu = OUT / f"{route}_{phase}.cu"
        cu.write_text(cut_source(edits))
        so = cu.with_suffix(".so")
        procs[(route, phase)] = (so, subprocess.Popen(
            [nvcc, *_native.NVCC_FLAGS, "-I", str(_native.CSRC), "-o",
             str(so), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for key, (so, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"cut {key}: nvcc exit {proc.returncode}\n"
                               f"{out}")
        lib = ctypes.CDLL(str(so))
        fn = lib.shift_conv_ring_launch
        fn.argtypes = _native.SIGNATURES["shift_conv_ring"][
            "shift_conv_ring_launch"]
        fn.restype = ctypes.c_int
        libs[key] = fn
    return libs


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    dev = require_cuda("ring_phases")
    bf = torch.bfloat16
    S, C, CO = 128, 48, 48
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((1, S, S, S, C), generator=gen, device=dev).to(bf)
    kernel = (torch.randn((CO, C, 3, 3), generator=gen, device=dev)
              * 0.05).to(bf)
    b = (torch.randn((CO,), generator=gen, device=dev) * 0.1).to(bf)
    y = torch.empty((1, S, S, S, CO), dtype=bf, device=dev)
    w9 = kernel.permute(2, 3, 0, 1).reshape(9, CO, C).contiguous()
    wpk = pack_weights_n48(kernel)
    gr, ng = _native._groups_arr(ring_groups(C, 5))
    whole = _native.library("shift_conv_ring").shift_conv_ring_launch
    cuts = build_cuts()
    stream = torch.cuda.current_stream(dev).cuda_stream

    def run(fn, route):
        err = fn(x.data_ptr(), w9.data_ptr(), wpk.data_ptr(), b.data_ptr(),
                 y.data_ptr(), gr, ng, 1, S, S, S, C, CO,
                 int(route == "tma"), stream)
        if err:
            raise RuntimeError(f"{route}: cudaError {err}")

    print(f"[ring_phases] {torch.cuda.get_device_name(0)} [{card_line()}]; "
          f"x 1 x {S}^3 x {C} -> {CO} bf16; ms per call, mean of "
          f"{args.reps}, in turns whole, cut, cut, whole", flush=True)
    for (route, phase), fn in cuts.items():
        t = [cuda_ms(lambda f=f: run(f, route), args.reps)
             for f in (whole, fn, fn, whole)]
        print(f"  {route} route without its {phase}: {t[1]:.4f}, "
              f"{t[2]:.4f} ms; whole {t[0]:.4f}, {t[3]:.4f} ms", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
