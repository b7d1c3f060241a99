"""Where the time of one tile goes: the 8 mirror passes of the fast mode
(flip-free TTA, bf16 probs head, lazy level-0 up-links) on one 128^3 patch
at the bench width (48 base features, 5 x (2,2,2) pools, 16 classes, bf16,
weights from seed 0), on one CUDA card.

    python -m e2enet_tpu_torch.profile_forward [--sparse] [--materialised]
                                               [--tiles-timed 3] [--train]

--sparse profiles the bench's default configuration: the trained DSFF row
masks baked in and the row-sparse plan attached (models/masks.attach_masks).
--materialised takes the materialised up-link route (lazy_up=False).
--train profiles one train step of the row-masked DSFF trainer instead
(training/train_bench_masks.py: batch 2 of 128^3, density 0.2, seed 0;
forward with deep supervision, backward, clipping, SGD, re-masking), over
--tiles-timed steps after two warm-up steps.

Prints: the torch ops one forward (or step) enqueues, host enqueue time and
wall time per forward (step), device busy time (the sum of the kernels'
device times under torch.profiler) and the idle share, then device time by
kernel, the port's CUDA kernels first, the rest in groups by name. Needs a
card; refuses without.
"""
import argparse
import time
from collections import Counter, defaultdict

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from .inference.predictor import mirror_apply_fns_for
from .models.masks import attach_masks
from .models.unetpp import ShiftUNetPlusPlus

PORT_KERNELS = ("fused_chunked_kernel", "pack_weights_kernel",
                "qfused_lazy_kernel", "qstride_kernel",
                "uplink_kernel", "uplink_image_kernel", "uplink_ldg_kernel",
                "downlink_kernel", "seghead_kernel", "seghead_ldg_kernel",
                # the block backward (csrc/fused_block_bwd.cu: the dgrad
                # with the shift's adjoint, the wgrad with geff and gb) and
                # the down-link backward (16-byte and scalar routes)
                "dgrad_kernel", "wgrad_kernel", "downlink_bwd_vec_kernel",
                "downlink_bwd_kernel")
GROUPS = (("copy / layout", ("copy", "cat", "flip", "permute", "transpose")),
          ("reduction", ("reduce", "sum", "amax", "amin", "max", "norm")),
          ("conv / gemm", ("conv", "gemm", "cutlass", "sm90", "xmma", "cudnn",
                           "matmul", "implicit")),
          ("elementwise", ("elementwise", "vectorized", "unrolled",
                           "leaky", "where", "fill")))


def group_of(name: str) -> str:
    low = name.lower()
    for k in PORT_KERNELS:
        if k in low:
            return k
    for g, keys in GROUPS:
        if any(k in low for k in keys):
            return g
    return "other"


class OpCounter(TorchDispatchMode):
    """Counts the torch (aten) ops dispatched inside the block."""

    def __init__(self):
        super().__init__()
        self.ops = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[str(func.overloadpacket)] += 1
        return func(*args, **(kwargs or {}))


def device_times(prof, n: int):
    """{kernel name: [device ms, calls]} per unit of n units."""
    per = defaultdict(lambda: [0.0, 0])
    for ev in prof.key_averages():
        t = getattr(ev, "self_device_time_total",
                    getattr(ev, "self_cuda_time_total", 0.0))
        if t > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            per[ev.key][0] += t / 1e3 / n
            per[ev.key][1] += ev.count / n
    return per


def report(per, ops, t_enq, t_wall, n, unit):
    busy = sum(v[0] for v in per.values())
    wall = 1e3 * t_wall / n
    print(f"torch ops per {unit}: {sum(ops.ops.values())} (top: "
          f"{', '.join(f'{k} {c}' for k, c in ops.ops.most_common(6))})")
    print(f"per {unit}: host enqueue {1e3 * t_enq / n:.2f} ms, wall "
          f"{wall:.2f} ms, device busy {busy:.2f} ms (profiler), idle share "
          f"{max(0.0, 1 - busy / wall):.3f}")
    groups = defaultdict(lambda: [0.0, 0.0])
    for k, (ms, c) in per.items():
        groups[group_of(k)][0] += ms
        groups[group_of(k)][1] += c
    print(f"device ms per {unit} by group (calls per {unit}):")
    for g, (ms, c) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        print(f"  {g:24s} {ms:8.3f} ms  {c:6.1f}")
    print(f"top kernels, device ms per {unit} (calls per {unit}):")
    for k, (ms, c) in sorted(per.items(), key=lambda kv: -kv[1][0])[:25]:
        print(f"  {ms:8.3f} ms  {c:5.1f}  {k[:110]}")


def profile(run, n: int, one):
    """(op counter of one(), enqueue s, wall s, profiler of run(n)); the
    caller warms up first."""
    torch.cuda.synchronize()
    with OpCounter() as ops:
        one()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(n)
    t_enq = time.perf_counter() - t0
    torch.cuda.synchronize()
    t_wall = time.perf_counter() - t0
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        run(n)
        torch.cuda.synchronize()
    return ops, t_enq, t_wall, prof


def profile_train(dev, n_steps: int) -> None:
    from .training import train_bench_masks as tbm
    model, state, step_fn, _, _ = tbm.build(dev)
    data, targets = tbm.device_batches(np.random.RandomState(3), 1, 2,
                                       (128, 128, 128),
                                       model.num_ds_outputs(), dev)[0]

    def run(n):
        for _ in range(n):
            step_fn(state, data, targets, 0.01)
    torch.cuda.reset_peak_memory_stats()
    run(1)                                          # warm-up, build
    ops, t_enq, t_wall, prof = profile(run, n_steps, lambda: run(1))
    print(f"device {torch.cuda.get_device_name(0)}; train step, batch 2 x "
          f"128^3, row masks density 0.2; {n_steps} steps; peak memory "
          f"allocated {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    report(device_times(prof, n_steps), ops, t_enq, t_wall, n_steps, "step")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tiles-timed", type=int, default=3,
                    help="tiles (8 forwards each), or train steps, per "
                         "measurement")
    ap.add_argument("--sparse", action="store_true",
                    help="trained row masks and the row-sparse plan")
    ap.add_argument("--materialised", action="store_true",
                    help="materialised level-0 up-links (lazy_up=False)")
    ap.add_argument("--train", action="store_true",
                    help="one train step of the row-masked trainer")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the profile runs on the card only")
    dev = torch.device("cuda")
    if args.train:
        profile_train(dev, args.tiles_timed)
        return
    model = ShiftUNetPlusPlus(1, 16, ((2, 2, 2),) * 5, base_num_features=48,
                              compute_dtype=torch.bfloat16,
                              head_probs_dtype=torch.bfloat16,
                              lazy_up=not args.materialised, device=dev)
    model.reset_parameters(seed=0)
    if args.sparse:
        attach_masks(model)
    fns = mirror_apply_fns_for(model)
    x = torch.from_numpy(np.random.RandomState(1).randn(
        1, 128, 128, 128, 1).astype(np.float32)).to(dev)
    n_fwd = args.tiles_timed * len(fns)

    def tiles(n):
        for _ in range(n):
            for fn in fns:
                fn(x)

    with torch.inference_mode():
        tiles(args.tiles_timed)                     # warm-up, build
        ops, t_enq, t_wall, prof = profile(tiles, args.tiles_timed,
                                           lambda: fns[0](x))
    print(f"device {torch.cuda.get_device_name(0)}; "
          f"{'sparse' if args.sparse else 'dense'}, "
          f"{'materialised' if args.materialised else 'lazy'} up-links; "
          f"{n_fwd} forwards ({args.tiles_timed} tiles x {len(fns)} mirror "
          f"passes)")
    report(device_times(prof, n_fwd), ops, t_enq, t_wall, n_fwd, "forward")


if __name__ == "__main__":
    main()
