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
tensors and its plain torch version for CPU tensors. Inference only.
"""
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

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


def block_groups(C: int, flips: Flips, groups_override=None):
    """Shift groups of a stride-1 block over C concat channels, mirrored
    when the depth axis is. groups_override: explicit groups over the
    (compact) channel space instead (the sparse plan's gathered channels
    keep the shifts of their original positions, shift.compact_groups)."""
    if groups_override is None:
        groups = group_shifts(C, SHIFT_SIZE)
    else:
        groups = tuple(groups_override)
        if groups[0][0] != 0 or groups[-1][1] != C:
            raise ValueError(f"groups {groups} do not cover {C} channels")
    return mirror_groups(groups) if flips[0] else tuple(groups)


def affine_nc(a: torch.Tensor, N: int, ci: int) -> torch.Tensor:
    """mult/off given as (Ci,) or (N, Ci) -> contiguous float32 (N, Ci)."""
    return a.float().reshape(-1, ci).expand(N, ci).contiguous()


def fused_shift_conv_block_ref(parts: Sequence[torch.Tensor],
                               kernel: torch.Tensor, bias: torch.Tensor,
                               affines: Sequence[Affine],
                               flips: Flips = NO_FLIPS,
                               groups_override=None):
    """Plain torch version. kernel (CO, C, 3, 3), bias (CO,); returns
    (y (N, D, H, W, CO) in the parts' dtype, stats (N, CO, 2) float32)."""
    dtype = parts[0].dtype
    N = parts[0].shape[0]
    normed = []
    for x, a in zip(parts, affines):
        if a is not None:
            ci = x.shape[-1]
            m = affine_nc(a[0], N, ci)[:, None, None, None, :]
            o = affine_nc(a[1], N, ci)[:, None, None, None, :]
            x = F.leaky_relu(x.float() * m + o, LRELU_SLOPE).to(dtype)
        normed.append(x)
    x = torch.cat(normed, dim=-1)
    N, D, H, W, C = x.shape
    CO = kernel.shape[0]
    s = depth_shift_groups(x, block_groups(C, flips, groups_override))
    # operands rounded to the compute dtype, products and sums in float32
    x2 = s.reshape(N * D, H, W, C).permute(0, 3, 1, 2).float()
    acc = F.conv2d(x2, mirror_conv_kernel(kernel.to(dtype), flips).float(),
                   None, padding=1)
    acc = acc + bias.to(dtype).float()[None, :, None, None]
    acc = acc.permute(0, 2, 3, 1).reshape(N, D, H, W, CO)
    stats = torch.stack([acc.sum(dim=(1, 2, 3)),
                         acc.square().sum(dim=(1, 2, 3))], dim=-1)
    return acc.to(dtype), stats


def fused_shift_conv_block(parts: Sequence[torch.Tensor],
                           kernel: torch.Tensor, bias: torch.Tensor,
                           affines: Sequence[Affine],
                           flips: Flips = NO_FLIPS, groups_override=None):
    """The fused block: plain version for CPU tensors, the CUDA kernel for
    CUDA tensors (bfloat16 only; raises on what the kernel does not take).
    Same arguments and results as fused_shift_conv_block_ref."""
    dev = parts[0].device
    if dev.type == "cpu":
        return fused_shift_conv_block_ref(parts, kernel, bias, affines,
                                          flips, groups_override)
    if dev.type != "cuda":
        raise ValueError(f"fused_shift_conv_block: unsupported device {dev}")
    tensors = list(parts) + [kernel, bias] + [t for a in affines
                                              if a is not None for t in a]
    if any(t.device != dev for t in tensors):
        raise ValueError("fused_shift_conv_block: tensors on several devices")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError("fused_shift_conv_block has no backward kernel; "
                           "run it under torch.no_grad()/inference_mode()")
    if len(parts) != len(affines):
        raise ValueError("one affine (or None) per part")
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
                               b, y, stats)
    fused_shift_conv_block.launches += 1
    return y, stats


fused_shift_conv_block.launches = 0


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
    return F.leaky_relu(a, slope_in(ct)).to(x.dtype)


def pooled_part(x: torch.Tensor, mult: torch.Tensor, off: torch.Tensor,
                window) -> torch.Tensor:
    """max_pool(apply_norm_lrelu(x, mult, off), window) without materialising
    the normalised tensor (the reference's pooled_part_cf): the apply,
    rounding included, is non-decreasing in x where mult >= 0 and
    non-increasing where mult < 0, so the window's largest normalised value
    is the apply of the raw maximum or minimum. Exact."""
    wd, wh, ww = window
    N, D, H, W, C = x.shape
    xw = x.reshape(N, D // wd, wd, H // wh, wh, W // ww, ww, C)
    pick = torch.where((mult >= 0).reshape(N, 1, 1, 1, C),
                       xw.amax(dim=(2, 4, 6)), xw.amin(dim=(2, 4, 6)))
    return apply_norm_lrelu(pick, mult, off)


def slope_in(dtype: torch.dtype) -> float:
    """The leaky-relu slope rounded to `dtype`, as the reference multiplies
    by a constant of the operand's dtype."""
    return float(torch.tensor(LRELU_SLOPE, dtype=dtype))
