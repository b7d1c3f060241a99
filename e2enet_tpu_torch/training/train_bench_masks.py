"""Train row-granular DSFF masks at the bench geometry: the port of
experiments/train_bench_masks.py.

The bench architecture (48 base features, 5 x (2,2,2) pools, 16 classes,
1 modality, bf16 compute, float32 parameters from a seed) on synthetic
16-organ volumes (a noisy body with one random ellipsoid per foreground
class at a class-specific intensity), batch 2 of 128^3 patches:
make_train_step (DC+CE deep supervision, SGD nesterov 0.99, weight decay
3e-5, clip 12) with a poly learning rate from 0.01, row masks at density
0.2 re-applied every step, and every `update_frequency` steps a row death
and regrowth at the cosine-decayed death rate: random regrowth, or with
--growth gradient the dead rows of largest gradient L1 (make_grad_step on
the step's batch), the setting the committed masks were trained with.

    python -m e2enet_tpu_torch.training.train_bench_masks [--steps 600]
        [--density 0.2] [--update-frequency 30] [--death-rate 0.5]
        [--growth random|gradient] [--batch 2] [--n-batches 8]
        [--patch 128 128 128] [--device cuda|cpu]
        [--out $TMPDIR/bench_masks.npz]

Runs on the card unless --device cpu is given, and refuses to start when
there is no card. Weights and masks come from seed 0. The width is the
bench's 48 base features on the card and 8 on the CPU, as the reference
cuts it off its accelerator. Prints the loss, the masks' density and ms
per step (CUDA events on the card; at the end their mean and that of
the mask updates, the gradient step included), then the trained masks'
row-sparse plan (its convs, row density and alive rows per conv), and
writes the trained masks to --out as the masks-only .npz that the sparse
path loads (models/masks.load_mask_artifact; `attach_masks(model,
path)`). The default --out is in the temporary directory; the committed
experiments/logs/bench_masks_trained.npz is never overwritten.
"""
import argparse
import os
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from ..models.masks import BENCH_MASKS, masks_density, save_mask_artifact
from ..models.sparse_plan import build_sparse_plan, plan_density
from ..models.unetpp import (ShiftUNetPlusPlus, deep_supervision_scales,
                             ds_loss_weights)
from .dsff import cosine_death_rate, init_masks_row
from .lr import poly_lr
from .train_state import (create_train_state, make_grad_step,
                          make_mask_update_step, make_train_step)

NUM_CLASSES = 16
POOLS = ((2, 2, 2),) * 5
INITIAL_LR = 0.01
SEED = 0


def make_batch(rng: np.random.RandomState, batch, patch, num_classes,
               factors):
    """Synthetic 16-organ batch (reference make_batch, the same draws):
    noisy body plus one random ellipsoid per foreground class with a
    class-specific intensity. Returns (volumes (B, D, H, W, 1) float32,
    targets per deep-supervision factor (B, D/f, H/f, W/f) int64)."""
    D, H, W = patch
    vols = np.empty((batch, D, H, W, 1), np.float32)
    segs = np.empty((batch, D, H, W), np.int32)
    zz, yy, xx = np.meshgrid(np.arange(D), np.arange(H), np.arange(W),
                             indexing="ij")
    for b in range(batch):
        vol = rng.randn(D, H, W).astype(np.float32) * 0.3
        seg = np.zeros((D, H, W), np.int32)
        for cls in range(1, num_classes):
            c = rng.rand(3) * np.array([D, H, W])
            r = 4 + rng.rand(3) * np.array([D, H, W]) * 0.12
            m = (((zz - c[0]) / r[0]) ** 2 + ((yy - c[1]) / r[1]) ** 2
                 + ((xx - c[2]) / r[2]) ** 2) < 1
            vol[m] = (0.15 * cls - 1.2
                      + 0.4 * rng.randn(int(m.sum())).astype(np.float32))
            seg[m] = cls
        vols[b, ..., 0] = vol
        segs[b] = seg
    targets = tuple(segs[:, ::f[0], ::f[1], ::f[2]].astype(np.int64)
                    for f in factors)
    return vols, targets


def ds_factors(pools, n_out):
    """Integer downsampling factor per deep-supervision output."""
    return [tuple(int(round(1.0 / s)) for s in sc)
            for sc in deep_supervision_scales(pools, n_out)]


def make_update(model, weights, growth="random"):
    """update(state, death_rate, data, targets) -> state: the row mask
    update with random growth, or with gradient growth fed the plain
    gradient (make_grad_step) on the batch (data, targets)."""
    update = make_mask_update_step(model, growth)
    grad_step = (make_grad_step(model, weights) if growth == "gradient"
                 else None)

    def mask_update(state, death_rate, data=None, targets=None):
        grads = None if grad_step is None else grad_step(data, targets)
        return update(state, death_rate, grads)
    return mask_update


def build(device, base_features=48, density=0.2, optimizer="sgd",
          growth="random"):
    """(bf16 model with weights from SEED, train state with row masks at
    `density` for `optimizer`, step function, mask update (make_update
    with `growth`), ds weights)."""
    model = ShiftUNetPlusPlus(1, NUM_CLASSES, POOLS,
                              base_num_features=base_features,
                              compute_dtype=torch.bfloat16, device=device)
    model.reset_parameters(seed=SEED)
    gen = torch.Generator().manual_seed(SEED + 1)
    masks = init_masks_row(model, density, gen, density_48_override=density)
    state = create_train_state(model, masks, seed=SEED, optimizer=optimizer)
    weights = ds_loss_weights(len(POOLS), model.num_ds_outputs())
    return (model, state, make_train_step(model, weights,
                                          optimizer=optimizer),
            make_update(model, weights, growth), weights)


def device_batches(rng, n, batch, patch, n_out, device):
    """n synthetic batches made on the host and moved to `device`."""
    out = []
    for _ in range(n):
        v, ts = make_batch(rng, batch, patch, NUM_CLASSES,
                           ds_factors(POOLS, n_out))
        out.append((torch.from_numpy(v).to(device),
                    tuple(torch.from_numpy(t).to(device) for t in ts)))
    return out


def train(model, state, step_fn, mask_update, batches, steps, t_max,
          update_frequency=30, death_rate=0.5, on_step=None):
    """The loop: poly LR, a mask update every update_frequency steps on the
    step's batch. on_step(i, state, metrics, ms, updated) after each step
    (ms of the train step on the card's clock, None on the CPU). Returns
    the last metrics."""
    cuda = next(model.parameters()).is_cuda
    metrics = None
    for i in range(steps):
        data, targets = batches[i % len(batches)]
        lr = poly_lr(i, t_max, INITIAL_LR)
        if cuda:
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
        state, metrics = step_fn(state, data, targets, lr)
        ms = None
        if cuda:
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end)
        updated = (i + 1) % update_frequency == 0
        if updated:
            state = mask_update(state, cosine_death_rate(
                i + 1, death_rate, t_max), data, targets)
        if on_step is not None:
            on_step(i, state, metrics, ms, updated)
    return metrics


def report_plan(masks) -> None:
    """Print the row-sparse plan of trained masks as the reference does:
    its convs, row density and alive rows per conv."""
    host = {k: np.asarray(v.detach().cpu() if isinstance(v, torch.Tensor)
                          else v) for k, v in masks.items()}
    plan = build_sparse_plan(host)
    print(f"trained plan: {len(plan) if plan else 0} convs, plan row "
          f"density {plan_density(plan, host):.4f}", flush=True)
    for key, alive in sorted(plan or ()):
        print(f"  {key}: {len(alive)} alive rows", flush=True)


def main(argv=None):
    """The command line; returns (model, the trained state)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--density", type=float, default=0.2)
    ap.add_argument("--update-frequency", type=int, default=30)
    ap.add_argument("--death-rate", type=float, default=0.5)
    ap.add_argument("--growth", default="random",
                    choices=["random", "gradient"],
                    help="row regrowth: random draws, or the dead rows of "
                         "largest gradient L1")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--n-batches", type=int, default=8)
    ap.add_argument("--patch", type=int, nargs=3, default=[128, 128, 128])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "bench_masks.npz"),
                    help="the trained masks, a masks-only .npz")
    args = ap.parse_args(argv)
    if Path(args.out).resolve() == BENCH_MASKS.resolve():
        raise SystemExit(f"--out {args.out} is the committed artifact; "
                         f"write elsewhere and copy it over by hand")
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to train on the "
                         "CPU")
    dev = torch.device(args.device)
    patch = tuple(args.patch)
    model, state, step_fn, update, _ = build(
        dev, 48 if dev.type == "cuda" else 8, args.density,
        growth=args.growth)
    update_ms = []

    def mask_update(st, death_rate, data, targets):
        if dev.type != "cuda":
            return update(st, death_rate, data, targets)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        st = update(st, death_rate, data, targets)
        end.record()
        end.synchronize()
        update_ms.append(start.elapsed_time(end))
        return st

    rng = np.random.RandomState(3)
    print(f"generating {args.n_batches} batches ({args.batch} x "
          f"{patch})...", flush=True)
    batches = device_batches(rng, args.n_batches, args.batch, patch,
                             model.num_ds_outputs(), dev)
    t0 = time.time()

    step_ms = []

    def report(i, st, metrics, ms, updated):
        if ms is not None:
            step_ms.append(ms)
        if updated or (i + 1) % 50 == 0 or i < 3:
            dens = masks_density(st.masks, model)
            ms_text = "" if ms is None else f" {ms:.1f} ms/step"
            print(f"step {i + 1}: loss={float(metrics['loss']):.4f} "
                  f"grad_norm={float(metrics['grad_norm']):.3f} "
                  f"density={dens:.4f}{ms_text}"
                  f"{' (DSFF update)' if updated else ''} "
                  f"({time.time() - t0:.0f} s)", flush=True)

    train(model, state, step_fn, mask_update, batches, args.steps,
          args.steps, args.update_frequency, args.death_rate,
          on_step=report)
    if len(step_ms) > 1:
        print(f"{args.growth} growth: {np.mean(step_ms[1:]):.1f} ms per "
              f"train step (steps 2..{len(step_ms)}, CUDA events); "
              f"{np.mean(update_ms):.1f} ms per mask update "
              f"({len(update_ms)} updates)", flush=True)
    report_plan(state.masks)
    save_mask_artifact(args.out, state.masks)
    print(f"saved the trained masks -> {args.out}", flush=True)
    return model, state


if __name__ == "__main__":
    main()
