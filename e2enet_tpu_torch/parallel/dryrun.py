"""The dry run of sharded training: the counterpart of the JAX package's
dryrun_multichip(n) (__graft_entry__.py).

    python -m e2enet_tpu_torch.parallel.dryrun [--num_devices 2]
        [--device cuda|cpu]

n ranks (NCCL on n cards, the default; gloo with --device cpu) on the JAX
dry run's grid: spatial parallel 2 at an even n, so n / 2 data rows of
two H slabs (n = 2 is a 1 x 2 grid), else n data rows. They take one
sharded train step of a tiny ShiftUNet++ (base 8, five pools, 3 classes;
float32 on the CPU as the JAX dry run, bfloat16 on the card, whose
kernels take it) with kernel-granular DSFF masks at density 0.3 on a
seeded batch of one sample per data row, 8 x 32 S x 32 (S the spatial
size), each on its rows and slab, then a DSFF death/growth update.
Checks: the loss is finite, and the masks after the update are equal on
every rank, to the bit. Rank 0 prints one line. Fewer cards than ranks
raises: nothing moves to the CPU unless asked.
"""
import argparse

import numpy as np
import torch

from . import mesh

POOLS = ((1, 2, 2), (2, 2, 2), (2, 2, 2), (2, 2, 2), (1, 2, 2))
D, H_PER_SLAB, W = 8, 32, 32
DENSITY = 0.3
DEATH_RATE = 0.3


def spatial_size(n_devices: int) -> int:
    """The JAX dry run's spatial size: 2 at an even n above 1, else 1."""
    return 2 if n_devices % 2 == 0 and n_devices > 1 else 1


def _rank_run(device: str):
    import torch.distributed as dist
    from ..models.unetpp import ShiftUNetPlusPlus, ds_loss_weights
    from ..training import dsff
    from ..training.train_state import (create_train_state,
                                        make_mask_update_step,
                                        make_sharded_train_step,
                                        replicate_state)
    n = mesh.world_size()
    sp = spatial_size(n)
    dp = n // sp
    grid = mesh.make_grid(n, sp)
    dev = torch.device(device)
    dtype = torch.float32 if dev.type == "cpu" else torch.bfloat16
    model = ShiftUNetPlusPlus(1, 3, POOLS, base_num_features=8,
                              compute_dtype=dtype, device=dev)
    model.reset_parameters(seed=0)
    masks = dsff.init_masks(model, DENSITY,
                            torch.Generator().manual_seed(1))
    masks = {k: v.to(dev) for k, v in masks.items()}
    state = replicate_state(create_train_state(model, masks), grid)
    n_out = model.num_ds_outputs()
    step = make_sharded_train_step(
        model, ds_loss_weights(len(POOLS), n_out), grid=grid)
    rng = np.random.RandomState(0)
    H = H_PER_SLAB * sp
    data = rng.randn(dp, D, H, W, 1).astype(np.float32)
    factors = [(1, 1, 1), (1, 2, 2), (2, 4, 4), (4, 8, 8)][:n_out]
    targets = tuple(rng.randint(0, 3, (dp, D // f[0], H // f[1], W // f[2]))
                    for f in factors)
    data, targets = mesh.shard_batch(data, targets, grid)
    state, metrics = step(state, torch.from_numpy(data).to(dev),
                          tuple(torch.from_numpy(t).to(dev)
                                for t in targets), 1e-2)
    loss = float(metrics["loss"])
    assert np.isfinite(loss), f"non-finite loss {loss}"
    update = make_mask_update_step(model, "random", granularity="kernel")
    before = sum(int(m.sum()) for m in state.masks.values())
    state = update(state, DEATH_RATE)
    flat = torch.cat([m.reshape(-1).float() for m in state.masks.values()])
    others = flat.clone()
    dist.all_reduce(others)
    assert torch.equal(others, flat * n), "the masks differ across ranks"
    moved = int((flat != torch.cat([m.reshape(-1).float()
                                    for m in masks.values()])).sum())
    if mesh.rank() == 0:
        print(f"dryrun_multichip({n}): {dist.get_backend()} grid={dp}x{sp} "
              f"(data x space) loss={loss:.4f}, DSFF death/growth changed "
              f"{moved} mask entries ({before} alive before), masks equal "
              f"on every rank OK", flush=True)
    return loss


def dryrun_multichip(n_devices: int = 2, device: str = "cuda") -> float:
    """The dry run on n_devices ranks; returns the step's loss. On the
    card it needs n_devices cards (raises otherwise; pass device='cpu' for
    gloo ranks on the CPU)."""
    if torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("dryrun_multichip: no CUDA device; pass "
                               "--device cpu to run the ranks on the CPU")
        have = torch.cuda.device_count()
        if have < n_devices:
            raise RuntimeError(f"dryrun_multichip: {n_devices} ranks need "
                               f"{n_devices} cards, {have} present; pass "
                               f"--device cpu to run them on the CPU")
    return mesh.launch(_rank_run, n_devices, device, device)[0]


def main(args=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--num_devices", type=int, default=2)
    parser.add_argument("--device", default="cuda",
                        help="cuda (default: one card per rank) or cpu")
    a = parser.parse_args(args)
    dryrun_multichip(a.num_devices, a.device)


if __name__ == "__main__":
    main()
