"""The reductions that a sharded step needs inside its model, loss and batch
norm (ops/blocks.py, ops/losses.py, models/) and after its backward
(training/train_state.py), by axis of the (data x space) grid of ranks.
Nothing here imports the training code, so ops/ can depend on it.

A `Grid` holds three process groups: the ranks of this rank's data row
that hold the other H slabs of its samples (`space`), the ranks that hold
the other rows of the batch at this slab (`data`), and all of them
(`world`); an axis of one rank is None. Inside `reducing(grid)` the sums
go over the axis they name:

- "space": the spatial sums of one sample (instance norm's statistics,
  per-sample Dice's counts);
- "data": the sums over the batch of per-sample values (per-sample Dice's
  mean);
- "world": the sums over batch and space (batch Dice's counts, the voxel
  means of CE, batch norm's statistics, the gradients).

Two reductions carry them, with different backwards:

- `all_sum` sums forward and passes the gradient through unchanged: every
  rank computes the same value from the sum, so each rank's backward must
  carry exactly its own share (the parameter gradients are then summed
  over the world, `all_reduce_sum_`).
- `sync_sum` sums forward and backward: the norms' ranks use the same
  statistics for different outputs, so the statistics' gradient is the
  sum of every rank's part, as SyncBatchNorm's is.

`gather_rows` gives every rank the values of every rank of an axis (the
top-k cross-entropy takes its k% of the global voxels). Outside
`reducing`, or with an axis of one rank, each is this rank's own value.
A plain process group given as the grid is a data-parallel one: its
ranks hold rows, none holds a slab.
"""
import contextlib
from typing import NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist

AXES = ("data", "space", "world")


class Grid(NamedTuple):
    """The process groups of a (data x space) grid; None for an axis of
    one rank."""
    data: Optional[object]
    space: Optional[object]
    world: Optional[object]


def as_grid(group) -> Optional[Grid]:
    """A Grid, None (one rank), or a plain process group taken as a
    data-parallel grid."""
    if group is None or isinstance(group, Grid):
        return group
    return Grid(data=group, space=None, world=group)


_ACTIVE: list = []


@contextlib.contextmanager
def reducing(group):
    """Inside the block, the model, the losses and the norms reduce over
    the axes of `group` (a Grid, a data-parallel process group, or None:
    no reduction)."""
    _ACTIVE.append(as_grid(group))
    try:
        yield
    finally:
        _ACTIVE.pop()


def active_grid() -> Optional[Grid]:
    """The grid the sums reduce over, or None outside a sharded step."""
    return _ACTIVE[-1] if _ACTIVE else None


def axis_group(over: str):
    """The active grid's group of axis `over`, or None (no grid, or one
    rank on that axis)."""
    if over not in AXES:
        raise ValueError(f"axis {over!r}: one of {AXES}")
    grid = active_grid()
    return None if grid is None else getattr(grid, over)


def axis_size(over: str) -> int:
    group = axis_group(over)
    return 1 if group is None else dist.get_world_size(group)


def space_size() -> int:
    """The ranks that share each sample's H extent (1 outside a grid)."""
    return axis_size("space")


class _AllSum(torch.autograd.Function):
    """Sum over the ranks forward, the gradient unchanged backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SyncSum(_AllSum):
    """Sum over the ranks forward and backward."""

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _GatherRows(torch.autograd.Function):
    """Every rank's rows concatenated in rank order forward (through one
    sum of zero-padded copies, which every backend takes); this rank's
    rows of the gradient backward."""

    @staticmethod
    def forward(ctx, x, group):
        n, r = dist.get_world_size(group), dist.get_rank(group)
        rows = x.shape[0]
        ctx.rows = slice(r * rows, (r + 1) * rows)
        y = x.new_zeros((n * rows,) + tuple(x.shape[1:]))
        y[ctx.rows] = x
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g[ctx.rows], None


def all_sum(x: torch.Tensor, over: str = "world") -> torch.Tensor:
    """x summed over the active grid's axis `over` (x outside one); the
    gradient passes through unchanged."""
    group = axis_group(over)
    return x if group is None else _AllSum.apply(x, group)


def sync_sum(x: torch.Tensor, over: str = "world") -> torch.Tensor:
    """x summed over the active grid's axis `over` (x outside one), its
    gradient summed too."""
    group = axis_group(over)
    return x if group is None else _SyncSum.apply(x, group)


def gather_rows(x: torch.Tensor, over: str = "world") -> torch.Tensor:
    """Every rank's x (batch first) of the axis `over` concatenated in
    rank order (x outside a grid)."""
    group = axis_group(over)
    return x if group is None else _GatherRows.apply(x, group)


def count(n, over: str):
    """n local elements as the number along the axis `over`: every rank
    holds as many."""
    return n * axis_size(over)


def batch_mean(x: torch.Tensor, over: str = "world") -> torch.Tensor:
    """The mean of x over every rank of the axis `over`: "world" for
    per-voxel values (batch first, slab in the spatial axes), "data" for
    per-sample values that the space ranks already share."""
    if axis_group(over) is None:
        return x.mean()
    return all_sum(x.sum(), over) / count(x.numel(), over)


def batch_count(n: int) -> int:
    """n local rows as global rows."""
    return count(n, "data")


def all_reduce_sum_(tensors: Sequence[torch.Tensor], group=None) -> None:
    """Each tensor (one dtype) summed over the ranks in place, through one
    flat buffer."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    parts = flat.split([t.numel() for t in tensors])
    torch._foreach_copy_(list(tensors),
                         [v.view_as(t) for v, t in zip(parts, tensors)])
