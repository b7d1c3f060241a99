"""The halo exchange of spatial parallelism: each rank of a space group
holds one H slab of its samples, in rank order, and a conv whose window
reaches past the slab's first or last row reads those rows from the
neighbouring ranks.

`halo_rows(x, group, axis, top, bottom)` returns (the `top` rows just
above this slab, the `bottom` rows just below it) along `axis`, each None
where the slab is at the volume's edge (or the count is 0). It is one
all_reduce over the group of zero-padded slots: rank i writes its first
`bottom` rows (rank i - 1's rows below) and its last `top` rows (rank
i + 1's rows above) into slot i, and reads slots i - 1 and i + 1. Every
backend takes an all_reduce, gloo with CUDA tensors too, which has no
CUDA send/recv. A point-to-point exchange is a later speed item
(ROADMAP).

`halo_rows_grad` is the differentiable form: its adjoint returns each
halo row's gradient to the rank that owns the row and adds it there, by
the same exchange in the other direction. It returns zeros, not None, at
the volume's edge, and its callers consume both results on every rank:
its backward is a collective, which every rank's autograd must reach, in
the same order (`at_edge` tells a caller which results to treat as the
volume's edge). The plain paths
(ops/blocks.conv3d_*, the strided transition's backward) use it; the
fused block's kernel route passes the rows without a gradient, since its
backward computes every gradient of its own rows from its neighbours' y
and gy rows (ops/fused_block.py).
"""
from typing import Optional, Tuple

import torch
import torch.distributed as dist

Rows = Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]


def _exchange(a: torch.Tensor, b: torch.Tensor, group, rank: int,
              size: int) -> Rows:
    """One all_reduce of slots (size, a.numel() + b.numel()), this rank's
    (a, b) in slot `rank`: returns (slot rank - 1's b, slot rank + 1's
    a), each None beyond the group's ends or when empty."""
    na, nb = a.numel(), b.numel()
    buf = a.new_zeros(size, na + nb)
    buf[rank, :na] = a.reshape(-1)
    buf[rank, na:] = b.reshape(-1)
    dist.all_reduce(buf, group=group)
    prev_b = (buf[rank - 1, na:].reshape(b.shape)
              if rank > 0 and nb else None)
    next_a = (buf[rank + 1, :na].reshape(a.shape)
              if rank < size - 1 and na else None)
    return prev_b, next_a


def halo_rows(x: torch.Tensor, group, axis: int, top: int,
              bottom: int) -> Rows:
    """(the `top` rows above this slab, the `bottom` rows below it) along
    `axis` from the neighbouring ranks of `group`, None at the volume's
    edge; no gradient. group None: (None, None)."""
    if group is None or (top == 0 and bottom == 0):
        return None, None
    size, rank = dist.get_world_size(group), dist.get_rank(group)
    L = x.shape[axis]
    if top > L or bottom > L:
        raise ValueError(f"a halo of {max(top, bottom)} rows from slabs of "
                         f"{L}")
    with torch.no_grad():
        first = x.narrow(axis, 0, bottom).detach()
        last = x.narrow(axis, L - top, top).detach()
        # (rank - 1's last rows, rank + 1's first rows)
        return _exchange(first, last, group, rank, size)


def at_edge(group) -> Tuple[bool, bool]:
    """Whether this rank's slab is the volume's first and its last."""
    if group is None:
        return True, True
    size, rank = dist.get_world_size(group), dist.get_rank(group)
    return rank == 0, rank == size - 1


class _HaloRows(torch.autograd.Function):
    """halo_rows forward; backward, each rank's halo gradients go to the
    rows' owners: rank i's (g above, g below) in slot i, rank j adds slot
    j + 1's g above to its last rows and slot j - 1's g below to its
    first rows."""

    @staticmethod
    def forward(ctx, x, group, axis, top, bottom):
        ctx.meta = (group, axis, top, bottom, x.shape)
        above, below = halo_rows(x, group, axis, top, bottom)

        def zeros(n):
            shape = list(x.shape)
            shape[axis] = n
            return x.new_zeros(shape)
        return (zeros(top) if above is None else above,
                zeros(bottom) if below is None else below)

    @staticmethod
    def backward(ctx, g_above, g_below):
        group, axis, top, bottom, shape = ctx.meta
        size, rank = dist.get_world_size(group), dist.get_rank(group)
        ref = g_above if g_above is not None else g_below

        def slot(g, n, present):
            rows = list(shape)
            rows[axis] = n
            if present and g is not None:
                return g.reshape(rows)
            return ref.new_zeros(rows)
        g_above = slot(g_above, top, rank > 0)
        g_below = slot(g_below, bottom, rank < size - 1)
        # (rank - 1's g below: our first rows', rank + 1's g above: our
        # last rows')
        g_first, g_last = _exchange(g_above, g_below, group, rank, size)
        gx = ref.new_zeros(shape)
        L = shape[axis]
        if g_first is not None:
            gx.narrow(axis, 0, bottom).add_(g_first)
        if g_last is not None:
            gx.narrow(axis, L - top, top).add_(g_last)
        return gx, None, None, None, None


def halo_rows_grad(x: torch.Tensor, group, axis: int, top: int,
                   bottom: int) -> Rows:
    """halo_rows with an adjoint: each halo row's gradient goes back to
    the rank that owns the row and is added there. Zeros at the volume's
    edge (at_edge), None only for a count of 0."""
    if group is None or (top == 0 and bottom == 0):
        return None, None
    if not (torch.is_grad_enabled() and x.requires_grad):
        return halo_rows(x, group, axis, top, bottom)
    above, below = _HaloRows.apply(x, group, axis, top, bottom)
    return above if top else None, below if bottom else None
