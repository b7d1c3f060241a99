"""Data-parallel training and tile-sharded prediction over a
torch.distributed process group: the port of e2enet_tpu/parallel/mesh.py's
"data" axis.

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
- `shard_batch`: rank r keeps rows [r B/n, (r+1) B/n) of the global batch,
  as P("data") does.
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


def shard_batch(data, targets: Sequence, group=None):
    """This rank's rows [r B/n, (r+1) B/n) of the global batch (arrays or
    tensors, batch first) and of each target."""
    n, r = world_size(group), dist.get_rank(group)
    B = int(data.shape[0])
    assert B % n == 0, (f"batch {B} not divisible by data-parallel size "
                        f"{n}")
    rows = slice(r * B // n, (r + 1) * B // n)
    return data[rows], type(targets)(t[rows] for t in targets)


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

