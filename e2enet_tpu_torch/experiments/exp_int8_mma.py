"""bf16 and int8 tensor-core products (#14). Counterpart of
experiments/exp_int8_mxu.py.

    mma_gemm(a, b)   a (M, K) @ b (K, N), row-major: bf16 x bf16 -> float32,
                     int8 x int8 -> int32

On CUDA tensors csrc/mma_gemm.cu, by shape: wgmma fed by TMA where TMA can
describe the operands (16-byte-aligned pointers; bf16 K and N multiples of
8, int8 K a multiple of 16), else mma.sync; `wgmma=False` takes mma.sync
at any shape (the control). Each route counts its launches in
`mma_gemm.routes`. On CPU tensors the plain version: a.float() @ b.float()
for bf16, and for int8 the product in float64, exact while
|sum| <= K * 128^2 < 2^53, cast to int32.

    python -m e2enet_tpu_torch.experiments.exp_int8_mma [--reps N]

measures at M = N = K = 4096 what the card delivers: the hand kernels,
torch.matmul in bf16 and torch._int_mm in int8, each timed with CUDA events
over back-to-back calls on one stream; ms, TFLOP/s or TOP/s, and the share
of the card's dense data-sheet peaks (989 TFLOP/s bf16, 1,979 TOP/s int8,
NVIDIA H100 SXM).
"""
import argparse
import sys

import torch

from ..ops.autograd import check_device
from . import card_line, cuda_ms, require_cuda

PEAK_BF16 = 989e12
PEAK_INT8 = 1979e12


def _check(a, b):
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"a {tuple(a.shape)} @ b {tuple(b.shape)}")
    if a.dtype != b.dtype or a.dtype not in (torch.bfloat16, torch.int8):
        raise TypeError(f"mma_gemm takes bf16 x bf16 or int8 x int8, got "
                        f"{a.dtype} x {b.dtype}")


def mma_gemm_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version: float32 for bf16, exact int32 for int8."""
    _check(a, b)
    if a.dtype == torch.int8:
        return (a.double() @ b.double()).to(torch.int32)
    return a.float() @ b.float()


def mma_gemm(a: torch.Tensor, b: torch.Tensor,
             wgmma: bool = True) -> torch.Tensor:
    """a @ b by the tensor-core kernel (CUDA) or the plain version (CPU).
    On the card the route follows the shape (wgmma where TMA takes it);
    wgmma=False runs the mma.sync kernel (the control)."""
    _check(a, b)
    if a.device.type == "cpu":
        return mma_gemm_ref(a, b)
    dev = check_device("mma_gemm", [a, b])
    from ..ops import _native
    out = torch.int32 if a.dtype == torch.int8 else torch.float32
    c = torch.empty((a.shape[0], b.shape[1]), dtype=out, device=dev)
    a, b = a.contiguous(), b.contiguous()
    wg = wgmma and _native.mma_gemm_wgmma_ok(a, b, c)
    _native.launch_mma_gemm(a, b, c, wg)
    mma_gemm.launches += 1
    mma_gemm.routes["wgmma" if wg else "mma_sync"] += 1
    return c


mma_gemm.launches = 0
mma_gemm.routes = {"wgmma": 0, "mma_sync": 0}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    dev = require_cuda("exp_int8_mma")
    torch.backends.cuda.matmul.allow_tf32 = False
    M = N = K = 4096
    ops = 2.0 * M * N * K
    gen = torch.Generator(device=dev).manual_seed(0)
    ab = torch.randn((M, K), generator=gen, device=dev).to(torch.bfloat16)
    bb = torch.randn((K, N), generator=gen, device=dev).to(torch.bfloat16)
    ai = torch.randint(-127, 127, (M, K), generator=gen, device=dev,
                       dtype=torch.int8)
    bi = torch.randint(-127, 127, (K, N), generator=gen, device=dev,
                       dtype=torch.int8)
    print(f"[exp_int8_mma] {torch.cuda.get_device_name(0)} [{card_line()}]; "
          f"{M} x {K} x {N}", flush=True)
    with torch.inference_mode():
        ok_i = torch.equal(mma_gemm(ai, bi), mma_gemm_ref(ai, bi))
        ref = mma_gemm_ref(ab, bb)
        rel = float((mma_gemm(ab, bb) - ref).abs().max() / ref.abs().max())
        print(f"  int8 equal to the exact product: {ok_i}; bf16 max err "
              f"{rel:.2e} of the largest |value|", flush=True)
        if not ok_i or rel > 1e-3:
            raise SystemExit("exp_int8_mma: the kernel disagrees with its "
                             "plain version")
        rows = [("hand kernel bf16 -> f32", PEAK_BF16, "TFLOP/s",
                 lambda: mma_gemm(ab, bb)),
                ("torch.matmul bf16", PEAK_BF16, "TFLOP/s",
                 lambda: torch.matmul(ab, bb)),
                ("hand kernel int8 -> int32", PEAK_INT8, "TOP/s",
                 lambda: mma_gemm(ai, bi)),
                ("torch._int_mm int8", PEAK_INT8, "TOP/s",
                 lambda: torch._int_mm(ai, bi))]
        for name, peak, unit, fn in rows:
            ms = cuda_ms(fn, args.reps)
            rate = ops / (ms * 1e-3)
            print(f"  {name}: {ms:.4f} ms = {rate / 1e12:.1f} {unit} "
                  f"({100 * rate / peak:.1f} % of {peak / 1e12:.0f})",
                  flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
