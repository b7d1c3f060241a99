"""Benchmark: Gaussian-weighted sliding-window inference throughput of the
flagship ShiftUNetPlusPlus (Tconv shiftConvPP, 48 base features, 5 x
(2,2,2) pools, 16 classes, bf16) on one CUDA card, reported as 128^3-patch
forward passes per second (each mirror-TTA pass counts as a patch). The
port's counterpart of the top-level bench.py (:30-292).

    python -m e2enet_tpu_torch.bench [--dense] [--accum f32|f16|bf16]
        [--masks_from auto|synthetic|PATH.npz|PATH.model]
        [--sparse_density 0.2] [--flip_free 0|1] [--device cuda|cpu]

Geometry: 128^3 patches over a seeded 192^3 volume, step 0.5 (8 tiles x 8
mirror passes), weights from seed 0. Default: the DSFF row-sparse model
with the trained masks (experiments/logs/bench_masks_trained.npz; a .model
checkpoint's masks through training/checkpoint.py, or a synthetic row
draw at --sparse_density through training/dsff.init_masks_row), flip-free
TTA, the bf16 probs head and f16 accumulators: the reference's fast mode.
--flip_free 0 runs data-flip TTA with bf16 per-pass probabilities.

Timing: CUDA events around GROUPS chained groups of REPS volumes after one
warm-up volume, the best group taken (each volume's input depends on the
last one's output). stderr gets the groups, the exact-f32 companion (f32
logits and accumulators, timed the same way), and one tile's forwards
under torch.profiler: the host's enqueue time per forward beside the
device's busy time per forward.

stdout: ONE JSON line, {"metric", "value", "unit", "vs_baseline"}, the
reference's keys and unit format; vs_baseline is 0.0 off the card.

--device cpu runs the reference's smoke geometry (32^3 patches over a
48^3 volume, width 8, synthetic masks) with host timers and no companion.

Not ported: the reference's TPU knobs --tta_batch, --no_fused,
--no_quadrant and --fused_max_level (the port has no batched mirror
passes, no unfused or quadrant layouts and a fixed fused depth), and
--profile (python -m e2enet_tpu_torch.profile_forward is the port's
profiler).
"""
import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from .inference.predictor import mirror_apply_fns_for, require_device
from .models.masks import (BENCH_MASKS, bake_masks, load_mask_artifact,
                           masks_density, masks_for_model)
from .models.sparse_plan import plan_density
from .models.unetpp import ShiftUNetPlusPlus
from .ops.sliding import compute_steps_for_sliding_window, tiled_accumulate

BASELINE_GPU_PATCHES_PER_SEC = 25.0   # the reference's estimate, bench.py
GROUPS = 3   # chained groups; the best is taken
REPS = 3     # volumes per group
TTA = 8
ACCUM = {"f32": torch.float32, "f16": torch.float16, "bf16": torch.bfloat16}


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def load_masks(source: str, model):
    """{port name: (in, out)} masks of a masks-only .npz or of a .model
    checkpoint's state."""
    if source.endswith(".npz"):
        return load_mask_artifact(source, model)
    from .training.checkpoint import load_checkpoint
    state, _epoch, _meta = load_checkpoint(source)
    if state["masks"] is None:
        raise ValueError(f"{source}: the checkpoint holds no masks")
    return masks_for_model(state["masks"], model, f"the masks of {source}")


def time_volumes(run, vol, on_gpu: bool, label: str):
    """Best of GROUPS chained groups of REPS volumes: (seconds per volume,
    host seconds spent enqueueing per volume in that group)."""
    best, best_enq = float("inf"), 0.0
    for _ in range(GROUPS):
        if on_gpu:
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            torch.cuda.synchronize()
            start.record()
        t0 = time.perf_counter()
        for _ in range(REPS):
            acc, _w = run(vol)
            vol = vol + 0.0 * acc[..., :1].to(vol.dtype)
        enq = time.perf_counter() - t0
        if on_gpu:
            end.record()
            torch.cuda.synchronize()
            g = start.elapsed_time(end) / 1e3 / REPS
        else:
            g = (time.perf_counter() - t0) / REPS
        log(f"  {label}group: {g * 1e3:.1f} ms/volume")
        if g < best:
            best, best_enq = g, enq / REPS
    return best, best_enq


def busy_ms_per_forward(fns, x) -> float:
    """Device busy time per forward (the sum of its kernels' device times
    under torch.profiler) over one tile's mirror passes."""
    from .profile_forward import device_times
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        for fn in fns:
            fn(x)
        torch.cuda.synchronize()
    return sum(ms for ms, _c in device_times(prof, len(fns)).values())


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--flip_free", type=int, default=1,
                    help="mirror TTA via statically mirrored operators "
                         "(no data flips); 0 = per-pass flip and unflip")
    ap.add_argument("--sparse_density", type=float, default=0.2,
                    help="density of the synthetic DSFF row draw (when "
                         "the masks are not read from a file); the unit "
                         "string records the density")
    ap.add_argument("--dense", action="store_true",
                    help="bench the dense model (no DSFF mask)")
    ap.add_argument("--masks_from", default="auto",
                    help="DSFF masks: a .model checkpoint or a masks-only "
                         ".npz; 'auto' = experiments/logs/"
                         "bench_masks_trained.npz on the card, a synthetic "
                         "draw on the CPU; 'synthetic' forces the draw")
    ap.add_argument("--accum", choices=sorted(ACCUM), default="f16",
                    help="sliding-window accumulator dtype; f16 = the "
                         "reference's fast mode, f32 the exact mode")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; the card must be present) or cpu")
    args = ap.parse_args(argv)
    dev = require_device(args.device)
    on_gpu = dev.type == "cuda"
    log("device:", torch.cuda.get_device_name(dev) if on_gpu else dev)

    patch = (128, 128, 128) if on_gpu else (32, 32, 32)
    vol_shape = (192, 192, 192) if on_gpu else (48, 48, 48)
    num_classes, num_mod = 16, 1
    fast = args.accum != "f32"
    model = ShiftUNetPlusPlus(
        num_mod, num_classes, ((2, 2, 2),) * 5,
        base_num_features=48 if on_gpu else 8, compute_dtype=torch.bfloat16,
        head_probs_dtype=(torch.bfloat16 if on_gpu and fast
                          and args.flip_free else None),
        device=dev)
    model.reset_parameters(seed=0)
    model.eval()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"params: {n_params / 1e6:.2f}M  patch={patch}  volume={vol_shape}")

    sparse_tag = ""
    masks_from = args.masks_from
    if masks_from == "auto":
        # the trained masks fit the card's width; the CPU smoke model is
        # narrower, so it takes the synthetic draw
        masks_from = (str(BENCH_MASKS) if on_gpu and os.path.isfile(
            BENCH_MASKS) else None)
    elif masks_from == "synthetic":
        masks_from = None
    density = None if args.dense else args.sparse_density
    if args.dense:
        masks_from = None
    if masks_from or density is not None:
        if masks_from:
            masks = load_masks(masks_from, model)
            d = masks_density(masks, model)
            log(f"masks from {masks_from}: overall density {d:.4f}")
        else:
            from .training.dsff import init_masks_row
            d = density
            masks = {k: v.cpu().numpy() for k, v in init_masks_row(
                model, d, torch.Generator().manual_seed(7),
                density_48_override=d).items()}
        plan = bake_masks(model, masks)
        assert plan, "row mask produced no sparse plan"
        model.set_sparse_plan(plan)
        sparse_tag = f"_rowsparse{round(d, 3):g}"
        log(f"row-sparse plan: {len(plan)} convs, plan row density "
            f"{plan_density(plan, masks):.4f}")

    mirror_fns = mirror_apply_fns_for(model) if args.flip_free else None
    accum = ACCUM[args.accum]
    prob_dtype = torch.bfloat16 if fast and mirror_fns is None else None

    def run(v):
        return tiled_accumulate(
            lambda x: model(x, do_ds=False), v, patch, num_classes,
            accum_dtype=accum, mirror_apply_fns=mirror_fns,
            prob_dtype=prob_dtype)

    steps = compute_steps_for_sliding_window(patch, vol_shape, 0.5)
    n_tiles = int(np.prod([len(s) for s in steps]))
    n_fwd = n_tiles * TTA
    log(f"tiles: {n_tiles} x {TTA} TTA passes")
    rng = np.random.RandomState(0)
    vol = torch.from_numpy(rng.randn(*vol_shape, num_mod).astype(
        np.float32)).to(dev)

    with torch.inference_mode():
        t0 = time.perf_counter()
        acc, _w = run(vol)
        float(acc[0, 0, 0, 0])
        log(f"build+first run: {time.perf_counter() - t0:.1f}s")
        dt, enq = time_volumes(run, vol, on_gpu, "")
        patches_per_sec = n_fwd / dt
        log(f"sliding-window: {dt * 1e3:.1f} ms/volume, "
            f"{patches_per_sec:.2f} {patch} patches/sec")
        if on_gpu:
            x = vol[:patch[0], :patch[1], :patch[2]][None]
            fns = mirror_fns or [lambda v: model(v, do_ds=False)] * TTA
            busy = busy_ms_per_forward(fns, x)
            log(f"per forward: host enqueue {enq * 1e3 / n_fwd:.2f} ms, "
                f"device {dt * 1e3 / n_fwd:.2f} ms (events), device busy "
                f"{busy:.2f} ms (profiler, one tile)")

        # the exact mode beside the fast one: f32 logits and accumulators
        if on_gpu and fast:
            model.head_probs_dtype = None
            exact_fns = (mirror_apply_fns_for(model) if args.flip_free
                         else None)

            def run_exact(v):
                return tiled_accumulate(
                    lambda x: model(x, do_ds=False), v, patch, num_classes,
                    accum_dtype=torch.float32, mirror_apply_fns=exact_fns)

            acc, _w = run_exact(vol)
            float(acc[0, 0, 0, 0])
            edt, eenq = time_volumes(run_exact, vol, on_gpu, "exact ")
            log(f"exact-f32 mode: {edt * 1e3:.1f} ms/volume, "
                f"{n_fwd / edt:.2f} patches/sec, host enqueue "
                f"{eenq * 1e3 / n_fwd:.2f} ms per forward (headline is "
                f"fast mode)")

    result = {
        "metric": "sliding_window_patch_throughput",
        "value": round(float(patches_per_sec), 3),
        "unit": f"{patch[0]}^3_patches_per_sec_per_chip_tta8{sparse_tag}",
        "vs_baseline": round(float(patches_per_sec
                                   / BASELINE_GPU_PATCHES_PER_SEC), 3)
        if on_gpu else 0.0,
    }
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
