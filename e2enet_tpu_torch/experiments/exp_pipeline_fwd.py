"""The software-pipelined fused block (#13). Counterpart of
experiments/exp_pipeline_fwd.py.

    pipelined_fused_block(parts, kernel, bias, affines, overlap=True)

has the arguments and results of ops.fused_block.fused_shift_conv_block
without `flips`: channels-last parts (N, D, H, W, Ci) with per-(N, Ci)
pending affines or None, kernel (CO, C, 3, 3), bias (CO,) -> (y (N, D, H, W,
CO) in the parts' dtype, stats (N, CO, 2) float32). It computes #1's
function (the reference's `_pipe_kernel` is quadrant_fused_block's dense
mode; the port keeps the computation, not the quadrant layout). On CUDA
tensors (bfloat16) csrc/fused_block_pipe.cu runs it in warp-specialised
persistent blocks: a producer warpgroup stages each (tile, K chunk) of the
operand (copies, pending norms) into a ring of shared-memory stages while
two consumer warpgroups run the previous stage's products on #1's wgmma
body. Where it stages the same K chunks as #1 (every shape the tests and
the experiment run) y equals #1's to the bit; the statistics differ in the
order of their float32 sums. overlap=False runs the same kernel with a ring
of one stage: the same tiles and sums without the overlap, the control of
the experiment (y equal to the bit). `pipelined_fused_block.stages` holds
the ring's depth of the last launch. On CPU tensors the plain version,
fused_shift_conv_block_ref. Forward only, as the reference.

    python -m e2enet_tpu_torch.experiments.exp_pipeline_fwd [--reps N]

runs the experiment's configuration (exp_pipeline_fwd.py:236-280): two
48-channel parts with pending affines -> 48, at 1 x 128^3 (the reference's
Dq = Hq = Wq = 64 quadrants of 2^3), and prints the parity with kernel #1
(y equal to the bit: both stage 48-channel K chunks here), the ring's depth
and the times of #1, the pipelined kernel and the same kernel without the
overlap, in turns (#1, pipelined, serial, serial, pipelined, #1).
"""
import argparse
import sys

import torch

from ..ops.autograd import affine_tensors, check_device
from ..ops.fused_block import (_check_block, affine_nc, block_groups,
                               fused_shift_conv_block,
                               fused_shift_conv_block_ref)
from . import card_line, cuda_ms, require_cuda

NO_FLIPS = (False, False, False)


# the plain version: #1's
pipelined_fused_block_ref = fused_shift_conv_block_ref


def pipelined_fused_block(parts, kernel, bias, affines, overlap=True):
    """The fused block by the pipelined kernel (CUDA, bfloat16; raises on
    what it does not take) or its plain version (CPU)."""
    if len(parts) != len(affines):
        raise ValueError("one affine (or None) per part")
    if parts[0].device.type == "cpu":
        return pipelined_fused_block_ref(parts, kernel, bias, affines)
    dev = check_device("pipelined_fused_block", list(parts) + [kernel, bias]
                       + affine_tensors(affines))
    part_c, C, CO = _check_block(parts, kernel, bias)
    N, D, H, W = (int(s) for s in parts[0].shape[:4])
    bf = torch.bfloat16
    from ..ops import _native
    parts = [p.contiguous() for p in parts]
    w9 = kernel.to(bf).permute(2, 3, 0, 1).reshape(9, CO, C).contiguous()
    aff = [None if a is None else (affine_nc(a[0], N, ci),
                                   affine_nc(a[1], N, ci))
           for a, ci in zip(affines, part_c)]
    y = torch.empty((N, D, H, W, CO), dtype=bf, device=dev)
    stats = torch.zeros((N, CO, 2), dtype=torch.float32, device=dev)
    pipelined_fused_block.stages = _native.launch_fused_block_pipe(
        parts, aff, block_groups(C, NO_FLIPS), w9, bias.to(bf).contiguous(),
        y, stats, overlap)
    pipelined_fused_block.launches += 1
    return y, stats


pipelined_fused_block.launches = 0
pipelined_fused_block.stages = 0


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    dev = require_cuda("exp_pipeline_fwd")
    S, C, CO = 128, 48, 48
    bf = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape, scale=1.0, shift=0.0):
        return torch.randn(shape, generator=gen, device=dev) * scale + shift
    parts = [(rnd(1, S, S, S, C) * 0.3).to(bf) for _ in range(2)]
    kernel = rnd(CO, 2 * C, 3, 3, scale=0.3)
    bias = rnd(CO, scale=0.1)
    affines = [(rnd(1, C, scale=0.3, shift=1.0), rnd(1, C, scale=0.2))
               for _ in range(2)]
    args_ = (parts, kernel, bias, affines)
    print(f"[exp_pipeline_fwd] {torch.cuda.get_device_name(0)} "
          f"[{card_line()}]; parts 2 x 48 with pending affines -> 48, "
          f"1 x {S}^3 bf16", flush=True)
    with torch.inference_mode():
        y1, s1 = fused_shift_conv_block(*args_)
        yp, sp = pipelined_fused_block(*args_)
        diff = (yp.float() - y1.float()).abs().amax(dim=(0, 1, 2, 3))
        ch_max = y1.float().abs().amax(dim=(0, 1, 2, 3))
        ulp = torch.exp2(torch.floor(torch.log2(ch_max.clamp_min(1e-30))) - 7)
        err = float(diff.max())
        srel = float((sp - s1).abs().max() / s1.abs().max())
        same = torch.equal(yp, y1)
        print(f"  parity with kernel #1: y equal to the bit {same} (max abs "
              f"err {err:.3e}, within one bf16 step of each channel's max: "
              f"{bool((diff <= ulp).all())}; scale "
              f"{float(y1.float().abs().max()):.3e}), stats max rel err "
              f"{srel:.3e}; ring of {pipelined_fused_block.stages} stages",
              flush=True)
        ys, _ = pipelined_fused_block(*args_, overlap=False)
        if (not same or srel > 1e-4 or not torch.equal(ys, yp)):
            raise SystemExit("exp_pipeline_fwd: parity with #1 FAILED")
        runs = {"#1": lambda: fused_shift_conv_block(*args_),
                "pipelined": lambda: pipelined_fused_block(*args_),
                "serial": lambda: pipelined_fused_block(*args_,
                                                        overlap=False)}
        t = {k: [] for k in runs}
        for k in ("#1", "pipelined", "serial", "serial", "pipelined", "#1"):
            t[k].append(cuda_ms(runs[k], args.reps))
    m = {k: sum(v) / len(v) for k, v in t.items()}
    print("  " + "   ".join(f"{k} {v[0]:.4f} / {v[1]:.4f} ms"
                            for k, v in t.items())
          + f"   pipelined vs #1 {m['#1'] / m['pipelined']:.3f}x, vs serial "
          f"{m['serial'] / m['pipelined']:.3f}x", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
