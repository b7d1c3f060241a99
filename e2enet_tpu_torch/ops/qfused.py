"""The fused block with a lazy up-link part: the k == s transposed-conv
up-link of the level below computed on load, inside the conv kernel, so the
finer level's up tensor is never stored. Counterpart of the lazy mode of
e2enet_tpu/ops/qfused.py (`LazyUp`, `quadrant_fused_block`, Pallas
`_fwd_kernel`), which runs on the quadrant layout; the port is channels-last
(N, D, H, W, C).

For parts x_p with pending affines and a LazyUp (raw, mult, off, kernel)
whose up-link is the LAST part of the implicit concat:

    u = uplink_ref(raw, mult, off, kernel)   the up-link op's arithmetic:
                                             mult and off rounded to the
                                             compute dtype, norm and lrelu in
                                             that dtype, float32 sums rounded
                                             to it (reference qfused.py:607-
                                             623)
    y, stats = fused block of concat(x_p, u)  its shift zero-fills after the
                                             up-link: up values outside the
                                             volume (the conv's halo, depth
                                             rows shifted out of [0, D)) are
                                             zero, not W . lrelu(off)

The LazyUp's kernel carries the mirror flips already (qlink.
flip_transp_kernel); `flips` mirrors the conv taps and negates the groups,
as for the fused block. `groups_override` gives compact-space shift groups
(the sparse plan).

`lazy_up_fused_block` runs the CUDA kernel (csrc/qfused.cu) for CUDA
tensors and `lazy_up_fused_block_ref` for CPU tensors. Where a gradient is
wanted it is an autograd op whose backward is the reference's
`_qfused_op_lazy` VJP (qfused.py:1342-1360): u is materialised once
through the up-link op (the up-link kernel on CUDA tensors), the block's
backward (ops.fused_block.fused_shift_conv_block_bwd) runs with u as a
plain last part, and u's gradient goes through the up-link's backward,
torch's autograd of its plain version.
"""
from typing import NamedTuple, Sequence

import torch

from .autograd import (affine_grads, affine_tensors, block_cotangents,
                       first_order_only, grad_like, needs_grad,
                       unflatten_affines, wanted_parts)
from .fused_block import (NO_FLIPS, Affine, Flips, affine_nc, block_groups,
                          fused_shift_conv_block_bwd,
                          fused_shift_conv_block_ref, mirror_conv_kernel)
from .qlink import _check_cuda, uplink, uplink_ref

LAZY_STRIDE = (2, 2, 2)     # the up-link strides the CUDA kernel computes


class LazyUp(NamedTuple):
    """An up-link part that is not materialised: the consuming kernel
    computes it on load."""
    raw: torch.Tensor       # (N, Dc, Hc, Wc, cin) level-below pending raw
    mult: torch.Tensor      # (cin,) or (N, cin) float32
    off: torch.Tensor
    kernel: torch.Tensor    # (cin, C_up, sd, sh, sw), flips applied


def lazy_up_fused_block_ref(parts: Sequence[torch.Tensor], lazy_up: LazyUp,
                            kernel: torch.Tensor, bias: torch.Tensor,
                            affines: Sequence[Affine],
                            flips: Flips = NO_FLIPS, groups_override=None):
    """Plain torch version: the up-link op's plain version, then the fused
    block's on the concat (parts..., up). Returns (y, stats) as
    fused_shift_conv_block_ref."""
    u = uplink_ref(*lazy_up)
    return fused_shift_conv_block_ref(list(parts) + [u], kernel, bias,
                                      list(affines) + [None], flips,
                                      groups_override)


def lazy_up_fused_block(parts: Sequence[torch.Tensor], lazy_up: LazyUp,
                        kernel: torch.Tensor, bias: torch.Tensor,
                        affines: Sequence[Affine], flips: Flips = NO_FLIPS,
                        groups_override=None, *, wgmma: bool = True):
    """The fused block with a lazy up-link last part: plain version for CPU
    tensors, the CUDA kernel for CUDA tensors (bfloat16, up-link stride
    (2, 2, 2); raises on what the kernel does not take). Same arguments and
    results as lazy_up_fused_block_ref; with a gradient wanted, an autograd
    op (the reference's lazy VJP). wgmma=False runs the kernel's taps on
    mma.sync instead, a control for measuring the wgmma tap loop (forward
    only)."""
    if len(parts) != len(affines):
        raise ValueError("one affine (or None) per materialised part")
    tensors = (list(parts) + list(lazy_up) + [kernel, bias]
               + affine_tensors(affines))
    if needs_grad(tensors):
        if not wgmma:
            raise ValueError("the mma.sync control has no backward")
        return _LazyBlockFn.apply(
            (tuple(flips), groups_override, len(parts),
             tuple(a is not None for a in affines)), *tensors)
    return _lazy_forward(parts, lazy_up, kernel, bias, affines, flips,
                         groups_override, wgmma)


def _lazy_forward(parts, lazy_up, kernel, bias, affines, flips,
                  groups_override, wgmma=True):
    if parts[0].device.type == "cpu":
        return lazy_up_fused_block_ref(parts, lazy_up, kernel, bias, affines,
                                       flips, groups_override)
    if not isinstance(lazy_up, LazyUp) or any(isinstance(p, LazyUp)
                                              for p in parts):
        raise TypeError("one LazyUp, after the materialised parts")
    dev = _check_cuda("lazy_up_fused_block",
                      list(parts) + list(lazy_up) + [kernel, bias]
                      + affine_tensors(affines))
    raw, umult, uoff, ukern = lazy_up
    if any(p.dtype != torch.bfloat16 or p.dim() != 5
           for p in list(parts) + [raw]):
        raise TypeError("the CUDA lazy block takes bfloat16 parts and raw")
    N, D, H, W = (int(v) for v in parts[0].shape[:4])
    if any(tuple(p.shape[:4]) != (N, D, H, W) for p in parts):
        raise ValueError("parts differ in (N, D, H, W)")
    cin, cout = (int(v) for v in ukern.shape[:2])
    if tuple(ukern.shape[2:]) != LAZY_STRIDE or tuple(raw.shape) != (
            N, D // 2, H // 2, W // 2, cin) or D % 2 or H % 2 or W % 2:
        raise ValueError(f"up-link kernel {tuple(ukern.shape)} and raw "
                         f"{tuple(raw.shape)} do not give a stride-2 up-link "
                         f"to {(N, D, H, W)}")
    part_c = [int(p.shape[-1]) for p in parts]
    C = sum(part_c) + cout
    CO = int(kernel.shape[0])
    if tuple(kernel.shape) != (CO, C, 3, 3) or tuple(bias.shape) != (CO,):
        raise ValueError(f"kernel {tuple(kernel.shape)} / bias "
                         f"{tuple(bias.shape)} do not fit C={C}")
    from . import _native
    dtype = torch.bfloat16
    w9 = mirror_conv_kernel(kernel.to(dtype), flips).permute(2, 3, 0, 1) \
        .reshape(9, CO, C).contiguous()
    # (8 parities bd*4 + bh*2 + bw, C_up, cin): K contiguous per column
    wu = ukern.to(dtype).permute(2, 3, 4, 1, 0).reshape(8, cout, cin) \
        .contiguous()
    aff = [None if a is None else (affine_nc(a[0], N, ci),
                                   affine_nc(a[1], N, ci))
           for a, ci in zip(affines, part_c)]
    groups = block_groups(C, flips, groups_override)
    y = torch.empty((N, D, H, W, CO), dtype=dtype, device=dev)
    stats = torch.zeros((N, CO, 2), dtype=torch.float32, device=dev)
    _native.launch_lazy_up(
        [p.contiguous() for p in parts], aff, groups, w9,
        bias.to(dtype).contiguous(), raw.contiguous(),
        affine_nc(umult, N, cin), affine_nc(uoff, N, cin), wu, y, stats,
        wgmma)
    lazy_up_fused_block.launches += 1
    return y, stats


lazy_up_fused_block.launches = 0


class _LazyBlockFn(torch.autograd.Function):
    """The lazy block as an autograd op; tensors laid out (parts..., raw,
    up mult, up off, up kernel, kernel, bias, affines...)."""

    @staticmethod
    def forward(ctx, meta, *tensors):
        flips, groups, P, has_affine = meta
        parts = list(tensors[:P])
        up = LazyUp(*tensors[P:P + 4])
        kernel, bias = tensors[P + 4:P + 6]
        affines = unflatten_affines(has_affine, tensors[P + 6:])
        y, stats = _lazy_forward(parts, up, kernel, bias, affines, flips,
                                 groups)
        ctx.meta = meta
        ctx.save_for_backward(*tensors, y)
        return y, stats

    @staticmethod
    def backward(ctx, gy, gstats):
        first_order_only("lazy_up_fused_block")
        flips, groups, P, has_affine = ctx.meta
        *tensors, y = ctx.saved_tensors
        need = ctx.needs_input_grad[1:]
        parts = list(tensors[:P])
        up = LazyUp(*tensors[P:P + 4])
        kernel, bias = tensors[P + 4:P + 6]
        affines = unflatten_affines(has_affine, tensors[P + 6:])
        gy, gstats = block_cotangents(y, gy, gstats)
        # the block's layout (parts..., u, kernel, bias, affines...)
        block_need = list(need[:P]) + list(need[P + 4:])
        want = wanted_parts(block_need, P, has_affine)
        want_up = any(need[P:P + 4])
        u = uplink(*up)
        gp, gk, gb, ga = fused_shift_conv_block_bwd(
            parts + [u], kernel, bias, list(affines) + [None], y, gy, gstats,
            flips, groups, want + [want_up])
        g_up = [None] * 4
        if want_up:
            with torch.enable_grad():
                inputs = [t.detach().requires_grad_(n)
                          for t, n in zip(up, need[P:P + 4])]
                u_ref = uplink_ref(*inputs)
                wrt = [t for t in inputs if t.requires_grad]
                gi = iter(torch.autograd.grad(u_ref, wrt, gp[-1]))
            g_up = [next(gi) if n else None for n in need[P:P + 4]]
        grads = [grad_like(g, t) for g, t in zip(gp[:P], parts)] + g_up
        grads += [grad_like(gk, kernel), grad_like(gb, bias)]
        return (None, *grads, *affine_grads(affines, ga[:P]))
