"""The strided encoder transition with the previous block's instance norm
applied on load. Counterpart of e2enet_tpu/ops/qstride.py
(`quadrant_strided_fused`, Pallas `_kernel`), which computes it on the
quadrant layout; the port is channels-last (N, D, H, W, C) with no quadrant
or padded layout, so the same function is written as a strided conv.

For the pending raw x (N, D, H, W, C) of the block before, with its affine
(mult, off):

    u    = lrelu(x * mult + off)           float32, rounded to x's dtype
    S    = depth_shift(u)                  channel groups of C; zero fill
                                           AFTER the normalisation
    y    = conv_(1,3,3), stride s (S) + b  float32 accumulation; the bias is
                                           added in float32, NOT rounded to
                                           the compute dtype (unlike the
                                           stride-1 block); stored in x's
                                           dtype
    stats[n, co] = (sum y, sum y^2)        of the float32 accumulator

Output row do of a channel group with shift sh reads input depth
s_d * do + parity - sh; output (ho, wo) reads H/W positions
s * o + origin + t for taps t in {0, 1, 2} with origin -1 (zero halo before
row 0). flips (fd, fh, fw) give the mirrored op, op(x, flips=c) ==
flip_c(op(flip_c(x))) for sizes divisible by the stride: a mirrored axis
reverses the taps and, at stride 2, re-anchors the window grid (origin 0,
depth parity 1, negated shifts; reference qstride._groups/_tap_geometry).
Output extent per axis: (L - parity + s - 1) // s, parity s - 1 on a
mirrored axis.

Spatial parallelism (an H slab per rank): `halo` (top, bottom) gives the
raw rows (N, D, 1, W, C) next to the slab, or None at the volume's edge;
they are read through the norm where the op would zero-fill row -1 or row
H (unmirrored, stride 2: the top row only). Their gradients come back
through the plain version's autograd, to be returned to their owners
(parallel/halo.halo_rows_grad).

`strided_fused` runs the CUDA kernel (csrc/qstride.cu) for CUDA tensors
and its plain torch version for CPU tensors. Where a gradient is wanted it
is an autograd op whose backward is torch's autograd of the plain version,
as the reference's `_bwd` (qstride.py:354-356) takes jax.vjp of its XLA
composition; the plain version writes the leaky relu as that composition
does, jnp.maximum(a, a * slope) (ops.fused_block.lrelu_max).
"""
from typing import Tuple

import torch
import torch.nn.functional as F

from .autograd import needs_grad, plain_vjp
from .fused_block import (NO_FLIPS, Flips, affine_nc, lrelu_max,
                          mirror_conv_kernel, shift_groups)
from .shift import depth_shift_groups, strided_depth_source


def _out_extent(L: int, s: int, flipped: bool) -> int:
    parity = s - 1 if flipped else 0
    return (L - parity + s - 1) // s


def _tap_origin(s: int, flipped: bool) -> int:
    """H/W position of tap 0 relative to s * o: -1, or 0 on a mirrored
    stride-2 axis (padding (1, 1) -> (0, 1), reference conv3d_as_2d)."""
    return 0 if (flipped and s == 2) else -1


def halo_extent(H: int, sh: int, flipped: bool) -> Tuple[int, int]:
    """The rows above and below an H slab that the op's windows read (its
    zero halo on the whole volume)."""
    lo = -_tap_origin(sh, flipped)
    hi = sh * (_out_extent(H, sh, flipped) - 1) + 2 - lo - (H - 1)
    return lo, max(hi, 0)


def strided_fused_ref(x: torch.Tensor, mult: torch.Tensor, off: torch.Tensor,
                      kernel: torch.Tensor, bias: torch.Tensor,
                      stride: Tuple[int, int, int] = (2, 2, 2),
                      flips: Flips = NO_FLIPS, groups_override=None,
                      halo=(None, None), edge=(False, False)):
    """Plain torch version. x (N, D, H, W, C), mult/off (C,) or (N, C),
    kernel (CO, C, 3, 3), bias (CO,); groups_override: the shift groups of
    C (default shiftConvPP's, fused_block.shift_groups; one group of shift
    0 with the shift off); halo, edge: an H slab's (module docstring,
    strided_fused). Returns (y (N, Do, Ho, Wo, CO) in x's dtype, stats
    (N, CO, 2) float32)."""
    dtype = x.dtype
    N, D, H, W, C = x.shape
    CO = kernel.shape[0]
    sd, sh, sw = stride
    m = affine_nc(mult, N, C)[:, None, None, None, :]
    o = affine_nc(off, N, C)[:, None, None, None, :]
    groups, parity = strided_depth_source(
        groups_override or shift_groups(C), sd, flips[0])

    def shifted(v):
        u = lrelu_max(v.float() * m + o).to(dtype)
        return depth_shift_groups(u, groups)[:, parity::sd]
    s = shifted(x)
    Do = s.shape[1]
    # zero halo: `origin` rows before, the rest after
    pads = []
    for L, st, f in ((W, sw, flips[2]), (H, sh, flips[1])):
        pads += list(halo_extent(L, st, f))
    if any(r is not None for r in halo):
        # an H slab: the neighbours' rows where the volume's H halo is
        # not zero
        rows = []
        for r, n, e in zip(halo, pads[2:], edge):
            if n > 1 or (r is not None and n == 0):
                raise ValueError(f"a halo of {n} rows, given "
                                 f"{'one' if r is not None else 'none'}")
            zero = s.new_zeros(s.shape[:2] + (1,) + s.shape[3:])
            # a row at the volume's edge passes the same ops, then zero
            rows.append(None if n == 0 else zero if r is None else
                        torch.where(torch.tensor(e), zero, shifted(r)))
        s = torch.cat([t for t in (rows[0], s, rows[1]) if t is not None],
                      dim=2)
        H = s.shape[2]
        pads[2:] = [0, 0]
    x2 = F.pad(s.reshape(N * Do, H, W, C).permute(0, 3, 1, 2).float(), pads)
    acc = F.conv2d(x2, mirror_conv_kernel(kernel.to(dtype), flips).float(),
                   None, stride=(sh, sw))
    Ho = _out_extent(x.shape[2], sh, flips[1])
    Wo = _out_extent(W, sw, flips[2])
    acc = acc[:, :, :Ho, :Wo] + bias.float()[None, :, None, None]
    acc = acc.permute(0, 2, 3, 1).reshape(N, Do, Ho, Wo, CO)
    stats = torch.stack([acc.sum(dim=(1, 2, 3)),
                         acc.square().sum(dim=(1, 2, 3))], dim=-1)
    return acc.to(dtype), stats


def strided_fused(x: torch.Tensor, mult: torch.Tensor, off: torch.Tensor,
                  kernel: torch.Tensor, bias: torch.Tensor,
                  stride: Tuple[int, int, int] = (2, 2, 2),
                  flips: Flips = NO_FLIPS, groups_override=None,
                  halo=(None, None), edge=(False, False)):
    """The strided transition: plain version for CPU tensors, the CUDA
    kernel for CUDA tensors (bfloat16, strides of 1 or 2; raises on what the
    kernel does not take). Same arguments and results as
    strided_fused_ref; with a gradient wanted, an autograd op whose
    backward is strided_fused_ref's (the halo rows' gradients included).
    edge: per side, whether the slab is at the volume's edge there: a halo
    row given on that side enters the autograd op (every rank's backward
    then reaches its exchange, parallel/halo.py) but is read as absent."""
    has = tuple(r is not None for r in halo)
    rows = [r for r in halo if r is not None]

    def split(t):
        it = iter(t[5:])
        return t[:5], tuple(next(it) if h else None for h in has)

    if needs_grad((x, mult, off, kernel, bias, *rows)):
        return plain_vjp(
            lambda *t: _strided_forward(*split(t)[0], stride, flips,
                                        groups_override, split(t)[1], edge),
            lambda *t: strided_fused_ref(*split(t)[0], stride, flips,
                                         groups_override, split(t)[1], edge),
            (x, mult, off, kernel, bias, *rows))
    return _strided_forward(x, mult, off, kernel, bias, stride, flips,
                            groups_override, tuple(halo), edge)


def _strided_forward(x, mult, off, kernel, bias, stride, flips,
                     groups_override=None, halo=(None, None),
                     edge=(False, False)):
    dev = x.device
    if dev.type == "cpu":
        return strided_fused_ref(x, mult, off, kernel, bias, stride, flips,
                                 groups_override, halo, edge)
    halo = tuple(None if e else r for r, e in zip(halo, edge))
    if dev.type != "cuda":
        raise ValueError(f"strided_fused: unsupported device {dev}")
    tensors = (x, mult, off, kernel, bias) + tuple(
        r for r in halo if r is not None)
    if any(t.device != dev for t in tensors):
        raise ValueError("strided_fused: tensors on several devices")
    if x.dtype != torch.bfloat16 or x.dim() != 5:
        raise TypeError("the CUDA strided transition takes a bfloat16 "
                        "(N, D, H, W, C) tensor")
    if any(s not in (1, 2) for s in stride):
        raise ValueError(f"the CUDA strided transition takes strides of 1 "
                         f"or 2, not {tuple(stride)}")
    N, D, H, W, C = (int(v) for v in x.shape)
    CO = int(kernel.shape[0])
    if tuple(kernel.shape) != (CO, C, 3, 3) or tuple(bias.shape) != (CO,):
        raise ValueError(f"kernel {tuple(kernel.shape)} / bias "
                         f"{tuple(bias.shape)} do not fit C={C}")
    from . import _native
    sd, sh, sw = stride
    groups, parity = strided_depth_source(
        groups_override or shift_groups(C), sd, flips[0])
    w9 = mirror_conv_kernel(kernel.to(x.dtype), flips).permute(2, 3, 0, 1) \
        .reshape(9, CO, C).contiguous()
    out = (_out_extent(D, sd, flips[0]), _out_extent(H, sh, flips[1]),
           _out_extent(W, sw, flips[2]))
    y = torch.empty((N, *out, CO), dtype=x.dtype, device=dev)
    stats = torch.zeros((N, CO, 2), dtype=torch.float32, device=dev)
    lo, hi = halo_extent(H, sh, flips[1])
    for r, n in zip(halo, (lo, hi)):
        if r is not None and (n != 1 or r.dtype != x.dtype or tuple(
                r.shape) != (N, D, 1, W, C)):
            raise ValueError(f"halo row {tuple(r.shape)} {r.dtype} where "
                             f"the op reads {n} rows of (N, D, 1, W, C)")
    _native.launch_strided(
        x.contiguous(), affine_nc(mult, N, C), affine_nc(off, N, C),
        groups, w9, bias.float().contiguous(), y, stats, stride, parity,
        (_tap_origin(sh, flips[1]), _tap_origin(sw, flips[2])), halo)
    strided_fused.launches += 1
    return y, stats


strided_fused.launches = 0
