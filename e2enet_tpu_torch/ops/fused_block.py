"""Fused shift-conv block: the stride-1 (1,3,3) shiftConvPP block with the
previous block's instance norm applied on load. Counterpart of
e2enet_tpu/ops/fused_block.py (`fused_shift_conv_block`, Pallas `_kernel`).

For an implicit channel concat of parts (each channels-last (N, D, H, W, Ci)),
with per-part pending affines (mult, off) or None:

    u_p = lrelu(x_p * mult_p + off_p)     in float32, cast to the input dtype
    S   = depth_shift(concat(u_p))        groups of the WHOLE concat; zero
                                          fill AFTER the normalisation
    y   = conv2d_3x3(S) + b               float32 accumulation, stored in the
                                          input dtype
    stats[n, co] = (sum y, sum y^2)       over (d, h, w) of the float32
                                          accumulator before rounding

The H/W halo of the conv is zero, as is every depth row the shift pulls from
outside [0, D). Consumers turn stats into the next (mult, off) with
norm_affine_from_stats, so a normalised tensor is never materialised between
chained blocks.

flips (fd, fh, fw) give the mirrored block, block(x, flips=c) ==
flip_c(block(flip_c(x))) (flip-free mirror TTA): the kernel's taps are
reversed along a mirrored H/W axis and a mirrored depth negates the group
shifts. Both are host-side changes of the kernel's arguments.

The port is channels-last (N, D, H, W, C) throughout; it has no quadrant or
padded channels-first layout.

`fused_shift_conv_block` runs the CUDA kernel (csrc/fused_block.cu) for CUDA
tensors and its plain torch version for CPU tensors. Where a gradient is
wanted it is a torch.autograd.Function whose backward is
`fused_shift_conv_block_bwd`: the CUDA kernel of csrc/fused_block_bwd.cu
for CUDA tensors (TPU kernels e2enet_tpu/ops/fused_block.py:_bwd_kernel and
qfused.py:_bwd_kernel) and `fused_shift_conv_block_bwd_ref` for CPU
tensors. Given (y, gy, gstats) it returns

    geff = gy + gs1 + 2 y gs2             in the parts' dtype, step by step
    gb   = sum geff                       float32
    ct   = conv_T(geff)                   float32 sums, rounded to the dtype
    gU   = ct[d + s_g]                    the shift's adjoint, zero fill
    gx_p = gU lrelu'(a) m, g(m), g(o)     parts with a pending affine
                                          (lrelu'(a) = 1 where a >= 0, else
                                          the slope), float32 sums
    gx_p = gU                             other parts
    gW   = sum S (x) geff                 float32, S the forward's operand

(reference fused_block.py:331-346 and `_fused_bwd_xla`). The plain forward
writes its leaky relu with the same derivative, so torch's autograd of it
(the comparison path, ops.blocks.plain_ops) agrees with this backward.

Spatial parallelism (an H slab per rank of a space group): `halos`
(tops, bottoms) give per part the raw row above row 0 and below row H - 1,
(N, D, 1, W, Ci), under the part's pending affine, or None at the
volume's edge. The forward reads them through the norm where it would
zero-fill; y and the statistics stay the slab's own (summed over the
space group by the caller). The backward takes the recommended route:
with `edge_rows` ((y, gy) of the neighbour row above, of the row below)
the dgrad forms geff on those rows too and reads it where it would
zero-fill, so each rank computes the whole gradient of its own rows and
no gradient is sent back for the halo rows; the wgrad's staged S reads
the forward's halo rows. The autograd op exchanges the y and gy rows
itself (parallel/halo.halo_rows over `space`) and saves the two halo
rows, not a padded copy.
"""
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from .autograd import (affine_grads, affine_tensors, block_cotangents,
                       check_device, first_order_only, grad_like, needs_grad,
                       unflatten_affines, wanted_parts)
from ..parallel.halo import halo_rows
from .shift import depth_shift_groups, group_shifts, mirror_groups

LRELU_SLOPE = 0.01
INSTNORM_EPS = 1e-5
SHIFT_SIZE = 5          # shift groups of shiftConvPP
NO_FLIPS = (False, False, False)

Affine = Optional[Tuple[torch.Tensor, torch.Tensor]]
Flips = Tuple[bool, bool, bool]


def mirror_conv_kernel(kernel: torch.Tensor, flips: Flips) -> torch.Tensor:
    """A (CO, C, kh, kw) kernel with its taps reversed along the mirrored H
    and W axes (flips[1], flips[2]); depth has no taps."""
    dims = [d for d, f in ((2, flips[1]), (3, flips[2])) if f]
    return kernel.flip(dims) if dims else kernel


def shift_groups(C: int, do_shift: bool = True):
    """The shift groups of a block over C channels: shiftConvPP's five, or
    with the shift off one group of shift 0 (shiftConvPP_noshift and 2D
    plans; reference fused_block.py:997-998, qfused.py:1541-1542)."""
    return tuple(group_shifts(C, SHIFT_SIZE)) if do_shift else ((0, C, 0),)


def block_groups(C: int, flips: Flips, groups_override=None):
    """Shift groups of a stride-1 block over C concat channels, mirrored
    when the depth axis is. groups_override: explicit groups over the
    (compact) channel space instead (the sparse plan's gathered channels
    keep the shifts of their original positions, shift.compact_groups; a
    block without the shift passes shift_groups(C, False))."""
    if groups_override is None:
        groups = shift_groups(C)
    else:
        groups = tuple(groups_override)
        if groups[0][0] != 0 or groups[-1][1] != C:
            raise ValueError(f"groups {groups} do not cover {C} channels")
    return mirror_groups(groups) if flips[0] else tuple(groups)


def affine_nc(a: torch.Tensor, N: int, ci: int) -> torch.Tensor:
    """mult/off given as (Ci,) or (N, Ci) -> contiguous float32 (N, Ci).
    One already in that form is returned as it is, with no torch op: the
    kernel wrappers call this on every launch, and the serving paths are
    bound by the host."""
    if a.dtype == torch.float32 and a.shape == (N, ci) and a.is_contiguous():
        return a
    return a.float().reshape(-1, ci).expand(N, ci).contiguous()


def _normed(parts, affines, dtype, N):
    """Each part through its pending norm (lrelu(x m + o), rounded to
    dtype), concatenated over the channels."""
    normed = []
    for x, a in zip(parts, affines):
        if a is not None:
            ci = x.shape[-1]
            m = affine_nc(a[0], N, ci)[:, None, None, None, :]
            o = affine_nc(a[1], N, ci)[:, None, None, None, :]
            x = lrelu_where(x.float() * m + o).to(dtype)
        normed.append(x)
    return torch.cat(normed, dim=-1)


def _halo_normed(parts, affines, halos, dtype, N, edge=(False, False)):
    """The normalised operand with its H halo rows, (N, D, H + 2, W, C):
    row -1 and row H from the halo rows through each part's norm, zeros
    (after the norm) where a part has none or the side is the volume's
    edge (edge: rows given there pass through the same ops, then zero)."""
    ext = []
    for rows, at_edge in zip(halos, edge):
        present = [r for r in rows if r is not None]
        if not present:
            ext.append(None)
            continue
        like = present[0]
        full = [r if r is not None else like.new_zeros(
            tuple(like.shape[:4]) + (int(p.shape[-1]),))
            for r, p in zip(rows, parts)]
        u = _normed(full, affines, dtype, N)
        # a part without a row there stays zero after its norm
        keep = torch.cat([torch.full((int(p.shape[-1]),),
                                     r is not None and not at_edge,
                                     device=u.device)
                          for r, p in zip(rows, parts)])
        ext.append(torch.where(keep, u, torch.zeros((), dtype=u.dtype,
                                                    device=u.device)))
    x = _normed(parts, affines, dtype, N)
    zero = x.new_zeros(x.shape[:2] + (1,) + x.shape[3:])
    return torch.cat([zero if ext[0] is None else ext[0], x,
                      zero if ext[1] is None else ext[1]], dim=2)


def fused_shift_conv_block_ref(parts: Sequence[torch.Tensor],
                               kernel: torch.Tensor, bias: torch.Tensor,
                               affines: Sequence[Affine],
                               flips: Flips = NO_FLIPS,
                               groups_override=None, halos=None,
                               halo_edge=(False, False)):
    """Plain torch version. kernel (CO, C, 3, 3), bias (CO,); halos
    (module docstring) or None; halo_edge: per side whether the slab is
    at the volume's edge there (rows given there read as zeros after the
    norm). Returns (y (N, D, H, W, CO) in the parts' dtype, stats
    (N, CO, 2) float32)."""
    dtype = parts[0].dtype
    N = parts[0].shape[0]
    if halos is None:
        x = _normed(parts, affines, dtype, N)
        pad = 1
    else:
        x = _halo_normed(parts, affines, halos, dtype, N, halo_edge)
        pad = (0, 1)
    N, D, He, W, C = x.shape
    H = He if halos is None else He - 2
    CO = kernel.shape[0]
    s = depth_shift_groups(x, block_groups(C, flips, groups_override))
    # operands rounded to the compute dtype, products and sums in float32
    x2 = s.reshape(N * D, He, W, C).permute(0, 3, 1, 2).float()
    acc = F.conv2d(x2, mirror_conv_kernel(kernel.to(dtype), flips).float(),
                   None, padding=pad)
    acc = acc + bias.to(dtype).float()[None, :, None, None]
    acc = acc.permute(0, 2, 3, 1).reshape(N, D, H, W, CO)
    stats = torch.stack([acc.sum(dim=(1, 2, 3)),
                         acc.square().sum(dim=(1, 2, 3))], dim=-1)
    return acc.to(dtype), stats


def fused_shift_conv_block(parts: Sequence[torch.Tensor],
                           kernel: torch.Tensor, bias: torch.Tensor,
                           affines: Sequence[Affine],
                           flips: Flips = NO_FLIPS, groups_override=None,
                           halos=None, halo_edge=(False, False), *,
                           wgmma: bool = True, space=None):
    """The fused block: plain version for CPU tensors, the CUDA kernel for
    CUDA tensors (bfloat16 only; raises on what the kernel does not take).
    Same arguments and results as fused_shift_conv_block_ref. With a
    gradient wanted, an autograd op whose backward is
    fused_shift_conv_block_bwd; with halos, `space` is the process group
    of the slabs, over which the backward exchanges its y and gy edge rows
    (module docstring); halo_edge as the plain version's. wgmma=False runs the kernel's taps on mma.sync
    instead, a control for measuring the wgmma tap loop (forward only)."""
    if len(parts) != len(affines):
        raise ValueError("one affine (or None) per part")
    if needs_grad(list(parts) + [kernel, bias] + affine_tensors(affines)):
        if not wgmma:
            raise ValueError("the mma.sync control has no backward")
        if halos is not None and space is None:
            raise ValueError("halo rows with a gradient need the space "
                             "group their backward exchanges over")
        has_halo = (None if halos is None else
                    tuple(tuple(r is not None for r in rows)
                          for rows in halos))
        return _FusedBlockFn.apply(
            (tuple(flips), groups_override, len(parts),
             tuple(a is not None for a in affines), has_halo,
             tuple(halo_edge), space),
            *parts, kernel, bias, *affine_tensors(affines),
            *_halo_tensors(halos))
    return _fused_forward(parts, kernel, bias, affines, flips,
                          groups_override, wgmma, halos, halo_edge)


def _drop_edges(halos, edge):
    """halos with the rows on a volume's-edge side made None."""
    if halos is None:
        return None
    return tuple([None] * len(rows) if e else list(rows)
                 for rows, e in zip(halos, edge))


def _halo_tensors(halos) -> list:
    """The flat list of the halo rows that are not None (tops, then
    bottoms)."""
    return [] if halos is None else [
        r for rows in halos for r in rows if r is not None]


def _unflatten_halos(has_halo, tensors):
    """_halo_tensors' inverse."""
    if has_halo is None:
        return None
    it = iter(tensors)
    return tuple([next(it) if h else None for h in rows]
                 for rows in has_halo)


def _check_halos(halos, parts):
    """Halo rows (N, D, 1, W, Ci) of each part in its dtype, or None."""
    for rows in halos:
        for r, p in zip(rows, parts):
            if r is not None and (tuple(r.shape) != tuple(p.shape[:2]) + (
                    1,) + tuple(p.shape[3:]) or r.dtype != p.dtype):
                raise ValueError(f"halo row {tuple(r.shape)} {r.dtype} "
                                 f"does not fit part {tuple(p.shape)}")


def _check_block(parts, kernel, bias):
    """(part channels, C, CO) of a CUDA block call; raises on what the
    kernels do not take."""
    N, D, H, W = parts[0].shape[:4]
    if any(tuple(p.shape[:4]) != (N, D, H, W) for p in parts):
        raise ValueError("parts differ in (N, D, H, W)")
    dtype = parts[0].dtype
    if dtype != torch.bfloat16 or any(p.dtype != dtype for p in parts):
        raise TypeError("the CUDA fused block takes bfloat16 parts")
    part_c = [int(p.shape[-1]) for p in parts]
    C = sum(part_c)
    CO = int(kernel.shape[0])
    if tuple(kernel.shape) != (CO, C, 3, 3) or tuple(bias.shape) != (CO,):
        raise ValueError(f"kernel {tuple(kernel.shape)} / bias "
                         f"{tuple(bias.shape)} do not fit C={C}")
    return part_c, C, CO


def _fused_forward(parts, kernel, bias, affines, flips, groups_override,
                   wgmma=True, halos=None, halo_edge=(False, False)):
    if halos is not None:
        _check_halos(halos, parts)
    dev = parts[0].device
    if dev.type == "cpu":
        return fused_shift_conv_block_ref(parts, kernel, bias, affines,
                                          flips, groups_override, halos,
                                          halo_edge)
    halos = _drop_edges(halos, halo_edge)
    check_device("fused_shift_conv_block", list(parts) + [kernel, bias]
                  + affine_tensors(affines) + _halo_tensors(halos))
    N = parts[0].shape[0]
    dtype = parts[0].dtype
    part_c, C, CO = _check_block(parts, kernel, bias)
    D, H, W = parts[0].shape[1:4]
    from . import _native
    parts = [p.contiguous() for p in parts]
    # (9 taps, CO, C): each output channel's K row contiguous; a mirrored
    # H/W axis reverses the taps, a mirrored depth negates the shifts
    w9 = mirror_conv_kernel(kernel.to(dtype), flips).permute(2, 3, 0, 1) \
        .reshape(9, CO, C).contiguous()
    b = bias.to(dtype).contiguous()
    aff = [None if a is None else (affine_nc(a[0], N, ci),
                                   affine_nc(a[1], N, ci))
           for a, ci in zip(affines, part_c)]
    y = torch.empty((N, D, H, W, CO), dtype=dtype, device=dev)
    stats = torch.zeros((N, CO, 2), dtype=torch.float32, device=dev)
    _native.launch_fused_block(parts, aff,
                               block_groups(C, flips, groups_override), w9,
                               b, y, stats, wgmma, halos)
    fused_shift_conv_block.launches += 1
    return y, stats


fused_shift_conv_block.launches = 0


def fused_shift_conv_block_bwd_ref(parts: Sequence[torch.Tensor],
                                   kernel: torch.Tensor, bias: torch.Tensor,
                                   affines: Sequence[Affine],
                                   y: torch.Tensor, gy: torch.Tensor,
                                   gstats: torch.Tensor,
                                   flips: Flips = NO_FLIPS,
                                   groups_override=None, halos=None,
                                   edge_rows=None):
    """Plain torch version of the block's backward (reference
    `_fused_bwd_xla`, rounding where the kernels round): y the forward's
    output, gy its cotangent, gstats (N, CO, 2) the statistics' cotangent;
    halos, edge_rows: an H slab's (module docstring). Returns (gparts in
    the parts' dtype, gkernel (CO, C, 3, 3) float32, gbias (CO,) float32,
    per part None or (g mult, g off) each (N, Ci) float32)."""
    dtype = parts[0].dtype
    N, D, H, W = parts[0].shape[:4]
    CO = kernel.shape[0]
    bshape = (N, 1, 1, 1, CO)
    # the kernels' bf16 steps (reference fused_block.py:482-487)
    gs1 = gstats[..., 0].to(dtype).reshape(bshape)
    gs2 = (2.0 * gstats[..., 1]).to(dtype).reshape(bshape)

    def geff_of(g, yv):
        return (g.to(dtype) + gs1) + yv.to(dtype) * gs2
    geff = geff_of(gy, y)
    gb = geff.float().sum(dim=(0, 1, 2, 3))
    slab = halos is not None or edge_rows is not None
    xcat = (_halo_normed(parts, affines, halos or ((None,) * len(parts),) * 2,
                         dtype, N) if slab
            else _normed(parts, affines, dtype, N))
    C = xcat.shape[-1]
    groups = block_groups(C, flips, groups_override)
    s2 = depth_shift_groups(xcat, groups).reshape(N * D, -1, W, C) \
        .permute(0, 3, 1, 2).float()
    k = mirror_conv_kernel(kernel.to(dtype), flips).float()
    g2 = geff.reshape(N * D, H, W, CO).permute(0, 3, 1, 2).float()
    # dgrad rounded to the dtype before the shift's adjoint (:525), wgrad
    # from the same bf16 operands, both with float32 sums
    if not slab:
        ct = torch.nn.grad.conv2d_input(s2.shape, k, g2, padding=1)
        gw = torch.nn.grad.conv2d_weight(s2, k.shape, g2, padding=1)
    else:
        # geff on the neighbours' rows (zero at the volume's edge), then
        # the dgrad of this slab's rows from all of them
        zero = geff.new_zeros((N, D, 1, W, CO))
        ext = [zero if pair is None else geff_of(pair[1], pair[0])
               for pair in (edge_rows or (None, None))]
        gext = torch.cat([ext[0], geff, ext[1]], dim=2)
        ge2 = gext.reshape(N * D, H + 2, W, CO).permute(0, 3, 1, 2).float()
        ct = F.conv2d(ge2, k.flip(2, 3).transpose(0, 1), None,
                      padding=(0, 1))
        gw = torch.nn.grad.conv2d_weight(s2, k.shape, g2, padding=(0, 1))
    ct = ct.to(dtype).permute(0, 2, 3, 1).reshape(N, D, H, W, C)
    gu_all = depth_shift_groups(ct, mirror_groups(groups))
    gparts, gaffs = [], []
    off = 0
    for x, a in zip(parts, affines):
        ci = x.shape[-1]
        gu = gu_all[..., off:off + ci]
        off += ci
        if a is None:
            gparts.append(gu)
            gaffs.append(None)
            continue
        m = affine_nc(a[0], N, ci)[:, None, None, None, :]
        o = affine_nc(a[1], N, ci)[:, None, None, None, :]
        xf = x.float()
        sel = torch.where(xf * m + o >= 0, 1.0, LRELU_SLOPE)
        guf = gu.float() * sel
        gparts.append((guf * m).to(dtype))
        gaffs.append(((guf * xf).sum(dim=(1, 2, 3)),
                      guf.sum(dim=(1, 2, 3))))
    return gparts, mirror_conv_kernel(gw, flips), gb, gaffs


def fused_shift_conv_block_bwd(parts: Sequence[torch.Tensor],
                               kernel: torch.Tensor, bias: torch.Tensor,
                               affines: Sequence[Affine], y: torch.Tensor,
                               gy: torch.Tensor, gstats: torch.Tensor,
                               flips: Flips = NO_FLIPS, groups_override=None,
                               want=None, halos=None, edge_rows=None):
    """The block's backward: plain version for CPU tensors, the CUDA kernel
    (csrc/fused_block_bwd.cu) for CUDA tensors (bfloat16; raises on what
    the kernel does not take). Same arguments and results as
    fused_shift_conv_block_bwd_ref; want: per part whether its gradient
    and its affine's are wanted (default all), None where not."""
    want = [True] * len(parts) if want is None else list(want)
    dev = parts[0].device
    if dev.type == "cpu":
        gp, gk, gb, ga = fused_shift_conv_block_bwd_ref(
            parts, kernel, bias, affines, y, gy, gstats, flips,
            groups_override, halos, edge_rows)
        return ([g if w else None for g, w in zip(gp, want)], gk, gb,
                [g if w else None for g, w in zip(ga, want)])
    edges = [t for pair in (edge_rows or ()) if pair is not None
             for t in pair]
    check_device("fused_shift_conv_block_bwd",
                  list(parts) + [kernel, bias, y, gy, gstats]
                  + affine_tensors(affines) + _halo_tensors(halos) + edges)
    part_c, C, CO = _check_block(parts, kernel, bias)
    N, D, H, W = (int(v) for v in parts[0].shape[:4])
    dtype = torch.bfloat16
    if y.dtype != dtype or tuple(y.shape) != (N, D, H, W, CO) or \
            tuple(gy.shape) != (N, D, H, W, CO) or \
            tuple(gstats.shape) != (N, CO, 2):
        raise ValueError(f"y {tuple(y.shape)} {y.dtype}, gy "
                         f"{tuple(gy.shape)}, gstats {tuple(gstats.shape)} "
                         f"do not fit the block's output")
    from . import _native
    parts = [p.contiguous() for p in parts]
    aff = [None if a is None else (affine_nc(a[0], N, ci),
                                   affine_nc(a[1], N, ci))
           for a, ci in zip(affines, part_c)]
    # the dgrad's taps: the forward's reversed and transposed, (9, C, CO)
    k = mirror_conv_kernel(kernel.to(dtype), flips)
    w9t = k.flip(2, 3).permute(2, 3, 1, 0).reshape(9, C, CO).contiguous()
    f32 = dict(dtype=torch.float32, device=dev)
    gxs = [torch.empty_like(p) if w else None for p, w in zip(parts, want)]
    gaffs = [torch.zeros((N, ci, 2), **f32) if w and a is not None else None
             for ci, w, a in zip(part_c, want, aff)]
    gw = torch.zeros((9, CO, C), **f32)
    gb = torch.zeros((CO,), **f32)
    if edge_rows is not None:
        edge_rows = [None if pair is None else
                     tuple(t.to(dtype).contiguous() for t in pair)
                     for pair in edge_rows]
    _native.launch_fused_block_bwd(
        parts, aff, block_groups(C, flips, groups_override), gxs, gaffs,
        y.contiguous(), gy.to(dtype).contiguous(),
        gstats.float().contiguous(), w9t, gw, gb, halos, edge_rows)
    fused_shift_conv_block_bwd.launches += 1
    gk = mirror_conv_kernel(gw.reshape(3, 3, CO, C).permute(2, 3, 0, 1),
                            flips)
    return gxs, gk, gb, [None if g is None else (g[..., 0], g[..., 1])
                         for g in gaffs]


fused_shift_conv_block_bwd.launches = 0


class _FusedBlockFn(torch.autograd.Function):
    """The fused block as an autograd op: forward the kernel (or its plain
    version on the CPU), backward fused_shift_conv_block_bwd. Saves the
    parts, weights, affines and y, as the reference's _fused_fwd does."""

    @staticmethod
    def _unpack(meta, tensors):
        flips, groups, P, has_affine, has_halo = meta[:5]
        parts, (kernel, bias) = list(tensors[:P]), tensors[P:P + 2]
        n_aff = 2 * sum(has_affine)
        affines = unflatten_affines(has_affine, tensors[P + 2:P + 2 + n_aff])
        halos = _unflatten_halos(has_halo, tensors[P + 2 + n_aff:])
        return parts, kernel, bias, affines, halos

    @staticmethod
    def forward(ctx, meta, *tensors):
        flips, groups = meta[:2]
        parts, kernel, bias, affines, halos = _FusedBlockFn._unpack(
            meta, tensors)
        y, stats = _fused_forward(parts, kernel, bias, affines, flips, groups,
                                  halos=halos, halo_edge=meta[5])
        ctx.meta = meta
        ctx.n_halo = len(_halo_tensors(halos))
        ctx.save_for_backward(*tensors, y)
        return y, stats

    @staticmethod
    def backward(ctx, gy, gstats):
        first_order_only("fused_shift_conv_block")
        flips, groups, P, has_affine, has_halo, edge, space = ctx.meta
        *tensors, y = ctx.saved_tensors
        parts, kernel, bias, affines, halos = _FusedBlockFn._unpack(
            ctx.meta, tensors)
        halos = _drop_edges(halos, edge)
        gy, gstats = block_cotangents(y, gy, gstats)
        edge_rows = None
        if halos is not None:
            # the neighbours' y and gy rows next to this slab
            CO = y.shape[-1]
            pairs = halo_rows(torch.cat([y, gy.to(y.dtype)], dim=-1), space,
                              2, 1, 1)
            edge_rows = tuple(None if r is None else (r[..., :CO], r[..., CO:])
                              for r in pairs)
        want = wanted_parts(ctx.needs_input_grad[1:], P, has_affine)
        gp, gk, gb, ga = fused_shift_conv_block_bwd(
            parts, kernel, bias, affines, y, gy, gstats, flips, groups, want,
            halos, edge_rows)
        grads = [grad_like(g, t) for g, t in zip(gp, parts)]
        grads += [grad_like(gk, kernel), grad_like(gb, bias)]
        # each rank computes its own rows' whole gradient: none for the
        # halo rows
        return (None, *grads, *affine_grads(affines, ga),
                *([None] * ctx.n_halo))


def norm_affine_from_stats(stats: torch.Tensor, n_vox: int,
                           scale: torch.Tensor, nbias: torch.Tensor,
                           eps: float = INSTNORM_EPS):
    """(mult, off), each (N, CO) float32, of the instance-norm apply from
    accumulated (sum, sumsq): consumers compute lrelu(x * mult + off)."""
    s1, s2 = stats[..., 0], stats[..., 1]
    mean = s1 / n_vox
    var = s2 / n_vox - mean * mean
    mult = torch.rsqrt(var + eps) * scale.float()[None]
    off = nbias.float()[None] - mean * mult
    return mult, off


def apply_norm_lrelu(x: torch.Tensor, mult: torch.Tensor,
                     off: torch.Tensor) -> torch.Tensor:
    """Materialise a pending normalisation: lrelu(x * mult + off) for x
    (N, D, H, W, C), mult/off (N, C). float32 input computes in float32;
    otherwise in the input dtype (the reference's bf16 apply)."""
    ct = torch.float32 if x.dtype == torch.float32 else x.dtype
    shape = (x.shape[0], 1, 1, 1, x.shape[-1])
    a = x.to(ct) * mult.to(ct).reshape(shape) + off.to(ct).reshape(shape)
    return lrelu_max(a).to(x.dtype)


def pooled_part(x: torch.Tensor, mult: torch.Tensor, off: torch.Tensor,
                window) -> torch.Tensor:
    """max_pool(apply_norm_lrelu(x, mult, off), window) without materialising
    the normalised tensor (the reference's pooled_part_cf): the apply,
    rounding included, is non-decreasing in x where mult >= 0 and
    non-increasing where mult < 0, so the window's largest normalised value
    is the apply of the raw maximum or minimum. Exact.

    With a gradient wanted it pools the materialised apply instead (the
    same values), so that the gradient is the reference's: a tie within a
    window of normalised bf16 values splits evenly (jnp.max) and the leaky
    relu's derivative at 0 is (1 + slope) / 2 (jnp.maximum)."""
    wd, wh, ww = window
    N, D, H, W, C = x.shape
    if needs_grad((x, mult, off)):
        u = apply_norm_lrelu(x, mult, off)
        return u.reshape(N, D // wd, wd, H // wh, wh, W // ww, ww, C).amax(
            dim=(2, 4, 6))
    xw = x.reshape(N, D // wd, wd, H // wh, wh, W // ww, ww, C)
    pick = torch.where((mult >= 0).reshape(N, 1, 1, 1, C),
                       xw.amax(dim=(2, 4, 6)), xw.amin(dim=(2, 4, 6)))
    return apply_norm_lrelu(pick, mult, off)


def slope_in(dtype: torch.dtype) -> float:
    """The leaky-relu slope rounded to `dtype`, as the reference multiplies
    by a constant of the operand's dtype."""
    return float(torch.tensor(LRELU_SLOPE, dtype=dtype))


def lrelu_where(a: torch.Tensor) -> torch.Tensor:
    """Leaky relu as the reference's kernels and blocks.leaky_relu write it,
    jnp.where(a >= 0, a, a * slope): derivative 1 at a == 0."""
    return torch.where(a >= 0, a, a * slope_in(a.dtype))


def lrelu_max(a: torch.Tensor) -> torch.Tensor:
    """Leaky relu as the reference's XLA twins write it,
    jnp.maximum(a, a * slope): the same values, derivative (1 + slope) / 2
    at a == 0 (maximum splits a tie)."""
    return torch.maximum(a, a * slope_in(a.dtype))
