"""Restricted depth shift of shiftConvPP: channel-grouped shift along depth
with zero fill. Counterpart of e2enet_tpu/ops/shift.py.

Channels are split into `shift_size` groups with torch.chunk semantics
(group size ceil(C/n), possibly fewer than n groups); group g moves along
depth by (g - shift_size//2) voxels: out[d] = x[d - s], zero where d - s
falls outside [0, D). C=1 gives one group with shift -2; C=3 gives -2,-1,0.
"""
from typing import List, Sequence, Tuple

import torch


def chunk_sizes(num_channels: int, num_chunks: int) -> List[int]:
    """torch.chunk sizing: chunks of ceil(C/n), the last one the remainder."""
    if num_chunks <= 0:
        raise ValueError("num_chunks must be positive")
    k = -(-num_channels // num_chunks)
    sizes = []
    rem = num_channels
    while rem > 0:
        take = min(k, rem)
        sizes.append(take)
        rem -= take
    return sizes


def group_shifts(num_channels: int,
                 shift_size: int) -> List[Tuple[int, int, int]]:
    """[(c_start, c_end, shift)] per channel group; group i shifts by
    i - shift_size//2."""
    pad = shift_size // 2
    out = []
    start = 0
    for i, s in enumerate(chunk_sizes(num_channels, shift_size)):
        out.append((start, start + s, i - pad))
        start += s
    return out


def restrict_groups(groups: Sequence[Tuple[int, int, int]], lo: int,
                    hi: int) -> Tuple[Tuple[int, int, int], ...]:
    """The groups of channels [lo, hi) of a concatenation, re-based to the
    slice: shift(cat)[..., lo:hi] == depth_shift_groups(cat[..., lo:hi],
    restrict_groups(groups, lo, hi))."""
    return tuple((max(c0, lo) - lo, min(c1, hi) - lo, s)
                 for (c0, c1, s) in groups if c0 < hi and c1 > lo)


def compact_groups(groups: Sequence[Tuple[int, int, int]], alive
                   ) -> Tuple[Tuple[int, int, int], ...]:
    """Shift groups of a gathered channel set (reference
    ops/shift.compact_groups): compact channel j is original channel
    alive[j] and keeps the shift of the original group holding it;
    consecutive compact channels of equal shift merge.
    depth_shift_groups(x[..., alive], compact_groups(groups, alive)) ==
    depth_shift_groups(x, groups)[..., alive]."""
    shift_of = {c: s for c0, c1, s in groups for c in range(c0, c1)}
    out = []
    for j, c in enumerate(alive):
        s = shift_of[int(c)]
        if out and out[-1][2] == s and out[-1][1] == j:
            out[-1] = (out[-1][0], j + 1, s)
        else:
            out.append((j, j + 1, s))
    return tuple(out)


def mirror_groups(groups: Sequence[Tuple[int, int, int]]
                  ) -> Tuple[Tuple[int, int, int], ...]:
    """Groups of the depth-mirrored shift: flip_d(shift(flip_d(x))) shifts
    every group by -s (reference blocks.py ShiftConvBlock, fd branch)."""
    return tuple((c0, c1, -s) for (c0, c1, s) in groups)


def strided_depth_source(groups: Sequence[Tuple[int, int, int]],
                         stride_d: int, flip_d: bool):
    """(groups, parity) of a depth-strided shift-conv: output row `do` of
    channel group (c0, c1, s) reads input row stride_d * do + parity - s.
    Unmirrored: parity 0. Mirrored, the shifts are negated and the kept
    rows move to the other end of each window, parity stride_d - 1 (at
    stride 2 the shift s -> -(s+1) at even rows of reference
    qstride._groups; reference conv3d_as_2d slices D from sd - 1)."""
    if not flip_d:
        return tuple(groups), 0
    return mirror_groups(groups), stride_d - 1


def depth_shift_groups(x: torch.Tensor, groups, axis: int = 1
                       ) -> torch.Tensor:
    """Shift channel ranges of a channels-last tensor along `axis` with zero
    fill; groups = ((c0, c1, shift), ...) relative to x's channels. The
    depth-mirrored shift is depth_shift_groups(x, mirror_groups(groups))."""
    D = x.shape[axis]
    out = torch.zeros_like(x)
    for c0, c1, s in groups:
        lo, hi = max(0, s), min(D, D + s)       # destination depth range
        if lo >= hi:
            continue
        dst = out.narrow(axis, lo, hi - lo)[..., c0:c1]
        dst.copy_(x.narrow(axis, lo - s, hi - lo)[..., c0:c1])
    return out


def depth_shift(x: torch.Tensor, shift_size: int, axis: int = 1
                ) -> torch.Tensor:
    """Channel-grouped depth shift of x (N, D, H, W, C)."""
    if shift_size // 2 == 0:
        return x
    return depth_shift_groups(x, group_shifts(x.shape[-1], shift_size), axis)
