"""Data- and spatial-parallel training and tile-sharded prediction over a
torch.distributed process group: the port of e2enet_tpu/parallel/mesh.py's
("data", "space") mesh.

The JAX package shards the batch over a mesh axis and lets GSPMD insert
the gradient psum and the global batch-Dice reduction. Here it is
PyTorch's idiom and the reference nnU-Net's own (nnUNetTrainerV2_DDP): one
process per device in a process group, NCCL on the card and gloo on the
CPU. The backend is an explicit argument that defaults by device; nothing
falls back from one backend to the other.

- `launch(fn, num_devices, device, *args)` spawns the ranks (the spawn
  start method), each on its own card (`torch.cuda.set_device(rank)`
  before it touches the card), initialises the group, runs fn(*args) and
  returns every rank's result. Rendezvous goes through a file in a fresh
  temporary directory, never a fixed port.
- `make_grid(num_devices, spatial_parallel)`: the (data x space) grid of
  the world, as make_mesh's devices.reshape(dp, sp): rank r sits at data
  index r // sp and space index r % sp. Its groups (collectives.Grid) are
  made on every rank in one fixed order.
- `shard_batch`: rank r keeps its data index's rows of the global batch
  and, on a grid of sp > 1, its space index's H slab (axis 2 of the
  channels-last batch and of each target level), as P("data", None,
  "space") does.
- `broadcast_array`: rank 0's preprocessed volume on every rank.

The reductions inside the loss and batch norm are in collectives.py; the
state's broadcast from rank 0 (replicate_state) and the sharded train step
(make_sharded_train_step) are in training/train_state.py.
"""
import datetime
import os
import shutil
import tempfile
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from . import collectives

# collectives wait this long for a slow rank (rank 0 validating alone)
TIMEOUT = datetime.timedelta(hours=3)
LAUNCH_HINT = ("launch the ranks with e2enet_tpu_torch.parallel.launch(fn, "
               "n, device) or the CLIs' --num_devices n")


def default_backend(device) -> str:
    """NCCL for the card, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def check_num_devices(num_devices: int, device) -> None:
    """More CUDA ranks than cards raises, as the JAX predictor asserts."""
    if torch.device(device).type != "cuda":
        return
    have = torch.cuda.device_count()
    if num_devices > have:
        raise RuntimeError(f"requested {num_devices} devices, only {have} "
                           f"present")


def init_group(rank: int, world_size: int, backend: str,
               init_method: str) -> None:
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size, timeout=TIMEOUT)


def destroy_group() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def world_size(group=None) -> int:
    return dist.get_world_size(group) if is_initialized() else 1


def world_group(what: str = "a sharded train step"):
    """The process group this process runs in (the default group);
    raises outside one, saying how to launch."""
    if not is_initialized():
        raise RuntimeError(f"{what} runs in a process group: {LAUNCH_HINT}")
    return dist.group.WORLD


def data_group(num_devices: int):
    """The process group of num_devices ranks this process runs in (the
    default group); raises outside one or at another size."""
    world_group(f"num_devices={num_devices}")
    n = dist.get_world_size()
    if n != num_devices:
        raise RuntimeError(f"num_devices={num_devices} in a process group "
                           f"of {n} ranks")
    return dist.group.WORLD


def check_grid(num_devices: int, spatial_parallel: int,
               batch_size: Optional[int] = None, patch_h: Optional[int] = None,
               h_divisor: int = 1) -> int:
    """The data-parallel size of num_devices ranks at spatial_parallel;
    raises, naming the numbers, where the grid does not divide them: the
    devices, the batch (the JAX trainer's assert batch % (n // sp) == 0)
    and the patch's H into slabs whose height the model's H pools divide
    (h_divisor)."""
    sp = int(spatial_parallel)
    if sp < 1 or num_devices % sp:
        raise ValueError(f"spatial_parallel={sp} does not divide "
                         f"num_devices={num_devices}")
    dp = num_devices // sp
    if batch_size is not None and batch_size % dp:
        raise ValueError(f"batch {batch_size} not divisible by the "
                         f"data-parallel size {dp} (num_devices="
                         f"{num_devices} // spatial_parallel={sp})")
    if patch_h is not None and sp > 1:
        if patch_h % sp or (patch_h // sp) % h_divisor:
            raise ValueError(f"patch H {patch_h} does not split into "
                             f"{sp} slabs whose height the H pools' "
                             f"product {h_divisor} divides")
    return dp


def make_grid(num_devices: int, spatial_parallel: int = 1
              ) -> collectives.Grid:
    """The (data x space) grid of this process group of num_devices ranks
    (raises outside one or at another size): rank r at data index r // sp
    and space index r % sp. Every rank makes every group, in one order
    (dist.new_group's rule); an axis of one rank is None."""
    world = data_group(num_devices)
    sp = int(spatial_parallel)
    dp = check_grid(num_devices, sp)
    if sp == 1:
        return collectives.Grid(data=world, space=None, world=world)
    r = dist.get_rank()
    space = data = None
    for i in range(dp):
        g = dist.new_group(list(range(i * sp, (i + 1) * sp)))
        if r // sp == i:
            space = g
    if dp > 1:
        for j in range(sp):
            g = dist.new_group(list(range(j, num_devices, sp)))
            if r % sp == j:
                data = g
    return collectives.Grid(data=data, space=space, world=world)


def barrier() -> None:
    if is_initialized():
        dist.barrier()


def _rank_entry(index, fn, args, num_devices, device, backend,
                init_method, shared_device, out_dir):
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(0 if shared_device else index)
    init_group(index, num_devices, backend, init_method)
    try:
        result = fn(*args)
        torch.save(result, os.path.join(out_dir, f"rank{index}.pt"))
    finally:
        destroy_group()


def launch(fn: Callable, num_devices: int, device="cuda", *args,
           backend: Optional[str] = None,
           _shared_device: bool = False) -> list:
    """Run fn(*args) on num_devices ranks of a new process group, one
    spawned process each, and return [rank 0's result, ...] (each result
    saved by torch.save). fn must be importable by name (a module-level
    function). device 'cuda' puts rank r on cuda:r; the kernels are built
    here first, so the ranks do not run nvcc at once. The rendezvous file
    and the results live in a fresh temporary directory, removed after.
    _shared_device exists only for chip_smoke.py's two-rank check on a
    one-card host: every rank on cuda:0, which NCCL refuses (it passes
    backend='gloo'); no user path sets it."""
    dev = torch.device(device)
    backend = backend or default_backend(dev)
    if not _shared_device:
        check_num_devices(num_devices, dev)
    if dev.type == "cuda":
        from ..ops import _native
        _native.build_all()
    tmp = tempfile.mkdtemp(prefix="e2enet_ranks_")
    try:
        init_method = "file://" + os.path.join(tmp, "rendezvous")
        torch.multiprocessing.start_processes(
            _rank_entry, args=(fn, args, num_devices, str(dev), backend,
                               init_method, _shared_device, tmp),
            nprocs=num_devices, join=True, start_method="spawn")
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(num_devices)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _slab(a, axis: int, i: int, sp: int):
    L = int(a.shape[axis])
    if L % sp:
        raise ValueError(f"H extent {L} does not split into {sp} slabs")
    index = [slice(None)] * a.ndim
    index[axis] = slice(i * L // sp, (i + 1) * L // sp)
    return a[tuple(index)]


def shard_batch(data, targets: Sequence, group=None, h_axis: int = 2):
    """This rank's part of the global batch (arrays or tensors, batch
    first) and of each target: the rows of its data index, [i B/dp,
    (i+1) B/dp), and on a grid (collectives.Grid) of sp > 1 the H slab of
    its space index along h_axis (2: channels-last data and the targets;
    the host batch (B, C, D, H, W) passes 3 for the data)."""
    grid = collectives.as_grid(dist.group.WORLD if group is None else group)
    dp = world_size(grid.data) if grid.data is not None else 1
    i = dist.get_rank(grid.data) if grid.data is not None else 0
    B = int(data.shape[0])
    if B % dp:
        raise ValueError(f"batch {B} not divisible by the data-parallel "
                         f"size {dp}")
    rows = slice(i * B // dp, (i + 1) * B // dp)
    data, parts = data[rows], [t[rows] for t in targets]
    if grid.space is not None:
        sp, j = world_size(grid.space), dist.get_rank(grid.space)
        data = _slab(data, h_axis, j, sp)
        parts = [_slab(t, 2, j, sp) for t in parts]
    return data, type(targets)(parts)


def broadcast_array(a: Optional[np.ndarray], device, group=None
                    ) -> Optional[np.ndarray]:
    """Rank 0's array (or None) on every rank: its shape and dtype as an
    object, then its data through the device."""
    header = [None if a is None else (tuple(a.shape), a.dtype.str)]
    dist.broadcast_object_list(header, src=0, group=group)
    if header[0] is None:
        return None
    shape, dtype = header[0]
    if a is None:
        t = torch.empty(shape, dtype=torch.from_numpy(
            np.zeros(0, dtype)).dtype, device=device)
    else:
        t = torch.from_numpy(np.ascontiguousarray(a)).to(device)
    dist.broadcast(t, src=0, group=group)
    return t.cpu().numpy()

