"""The dry run of data-parallel training: the counterpart of the JAX
package's dryrun_multichip(n) (__graft_entry__.py).

    python -m e2enet_tpu_torch.parallel.dryrun [--num_devices 2]
        [--device cpu|cuda]

n ranks (gloo on the CPU, NCCL on n cards) take one sharded train step of
a tiny ShiftUNet++ (base 8, five pools, 3 classes, float32) with
kernel-granular DSFF masks at density 0.3, each on its rows of a seeded
batch of n samples, then a DSFF death/growth update. Checks: the loss is
finite, and the masks after the update are equal on every rank, to the
bit. Rank 0 prints one line.
"""
import argparse

import numpy as np
import torch

from . import mesh

POOLS = ((1, 2, 2), (2, 2, 2), (2, 2, 2), (2, 2, 2), (1, 2, 2))
SHAPE = (8, 32, 32)
DENSITY = 0.3
DEATH_RATE = 0.3


def _rank_run(device: str):
    import torch.distributed as dist
    from ..models.unetpp import ShiftUNetPlusPlus, ds_loss_weights
    from ..training import dsff
    from ..training.train_state import (create_train_state,
                                        make_mask_update_step,
                                        make_sharded_train_step,
                                        replicate_state)
    n = mesh.world_size()
    dev = torch.device(device)
    model = ShiftUNetPlusPlus(1, 3, POOLS, base_num_features=8,
                              compute_dtype=torch.float32, device=dev)
    model.reset_parameters(seed=0)
    masks = dsff.init_masks(model, DENSITY,
                            torch.Generator().manual_seed(1))
    masks = {k: v.to(dev) for k, v in masks.items()}
    state = replicate_state(create_train_state(model, masks))
    n_out = model.num_ds_outputs()
    step = make_sharded_train_step(
        model, ds_loss_weights(len(POOLS), n_out))
    rng = np.random.RandomState(0)
    D, H, W = SHAPE
    data = rng.randn(n, D, H, W, 1).astype(np.float32)
    factors = [(1, 1, 1), (1, 2, 2), (2, 4, 4), (4, 8, 8)][:n_out]
    targets = tuple(rng.randint(0, 3, (n, D // f[0], H // f[1], W // f[2]))
                    for f in factors)
    data, targets = mesh.shard_batch(data, targets)
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
        print(f"dryrun_multichip({n}): {dist.get_backend()} world={n} "
              f"loss={loss:.4f}, DSFF death/growth changed {moved} mask "
              f"entries ({before} alive before), masks equal on every "
              f"rank OK", flush=True)
    return loss


def dryrun_multichip(n_devices: int = 2, device: str = "cpu") -> float:
    """The dry run on n_devices ranks; returns the step's loss."""
    return mesh.launch(_rank_run, n_devices, device, device)[0]


def main(args=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--num_devices", type=int, default=2)
    parser.add_argument("--device", default="cpu")
    a = parser.parse_args(args)
    dryrun_multichip(a.num_devices, a.device)


if __name__ == "__main__":
    main()
