"""The reductions over the batch that a data-parallel step needs inside its
loss and batch norm (ops/losses.py, ops/blocks.batch_norm) and after its
backward (training/train_state.py). Nothing here imports the training
code, so ops/ can depend on it.

Inside `reducing(group)` the losses and batch norm take their sums over
the batch across the group. Two reductions carry them, with different
backwards:

- `all_sum` sums forward and passes the gradient through unchanged: every
  rank computes the same loss from the sum, so each rank's backward must
  carry exactly its own share (the parameter gradients are then summed
  over the ranks, `all_reduce_sum_`).
- `sync_sum` sums forward and backward: batch norm's ranks use the same
  statistics for different outputs, so the statistics' gradient is the
  sum of every rank's part, as SyncBatchNorm's is.

`gather_rows` gives every rank the global batch (the top-k cross-entropy
takes its k% of it). Outside `reducing`, or with group None, each is this
rank's own value.
"""
import contextlib
from typing import Sequence

import torch
import torch.distributed as dist

_ACTIVE: list = []


@contextlib.contextmanager
def reducing(group):
    """Inside the block, the losses and batch norm reduce their batch sums
    over `group` (None: no reduction)."""
    _ACTIVE.append(group)
    try:
        yield
    finally:
        _ACTIVE.pop()


def active_group():
    """The group the batch sums reduce over, or None outside a sharded
    step."""
    return _ACTIVE[-1] if _ACTIVE else None


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


def all_sum(x: torch.Tensor) -> torch.Tensor:
    """x summed over the active group's ranks (x outside one); the
    gradient passes through unchanged."""
    group = active_group()
    return x if group is None else _AllSum.apply(x, group)


def sync_sum(x: torch.Tensor) -> torch.Tensor:
    """x summed over the active group's ranks (x outside one), its
    gradient summed too."""
    group = active_group()
    return x if group is None else _SyncSum.apply(x, group)


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """Every rank's x (batch first) concatenated in rank order: the global
    batch (x outside a group)."""
    group = active_group()
    return x if group is None else _GatherRows.apply(x, group)


def batch_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of x (batch first) over the global batch: every rank holds
    the same number of rows."""
    group = active_group()
    if group is None:
        return x.mean()
    return all_sum(x.sum()) / (x.numel() * dist.get_world_size(group))


def batch_count(n: int) -> int:
    """n local rows as global rows."""
    group = active_group()
    return n if group is None else n * dist.get_world_size(group)


def all_reduce_sum_(tensors: Sequence[torch.Tensor], group=None) -> None:
    """Each tensor (one dtype) summed over the ranks in place, through one
    flat buffer."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    parts = flat.split([t.numel() for t in tensors])
    torch._foreach_copy_(list(tensors),
                         [v.view_as(t) for v, t in zip(parts, tensors)])
