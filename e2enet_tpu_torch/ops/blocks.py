"""Network building blocks in channels-last (N, D, H, W, C) torch ops: the
counterpart of e2enet_tpu/ops/blocks.py without its quadrant or padded
channels-first layouts.

A conv whose kernel is 1 along one axis ((1,3,3), and the (3,1,3) / (3,3,1)
ablations) is a batched 2D conv with that axis folded into the batch
(conv3d_one_flat); a stride along it is a slice before the fold. A full 3D
kernel ((3,3,3): allConv3x3, the residual-encoder UNet) is cuDNN's 3D conv
(conv3d_full), with no depth shift and no mirrored operator. Transposed
convs have kernel == stride and are one matmul followed by a
depth-to-space reshape. The norms (NORM_OPS) and nonlinearities (NONLINS)
of the reference's architectural variants are plain torch.

Parameter layouts are PyTorch's: conv kernels (Cout, Cin, k, k) with the
flat axis dropped or (Cout, Cin, kd, kh, kw), transposed conv kernels (Cin,
Cout, sd, sh, sw), seg-head kernels (K, Cin). Parameters are stored in
float32 and cast to the compute dtype at use, as the reference casts its
float32 params.

Every op takes `flips` (fd, fh, fw) and then computes its mirrored variant,
op(x, flips=c) == flip_c(op(flip_c(x))), with the same parameters
(flip-free mirror TTA, reference `flips`): mirrored conv kernels, strided
windows re-anchored, negated shift groups. Norms, nonlinearities, max pools
with window == stride and 1x1 heads are flip-equivariant as they are.

The kernel sites of the model go through this module's names
`fused_shift_conv_block`, `lazy_up_fused_block`, `strided_fused`, `uplink`,
`downlink` and `seghead`; `plain_ops()` swaps their plain torch versions in.
Each is differentiable: the fused block's and the lazy block's backward is
the block backward kernel, the down-link's its own kernel (BACKWARD_OPS),
the rest take torch's autograd of their plain versions. The plain ops here
differentiate as the reference's do: the leaky relu of a block is
jnp.where(x >= 0, ...) (derivative 1 at 0), a max pool splits a tie in a
window evenly, the depth shift's adjoint is the shift by the negated
offsets (copies into a zero tensor).

DSFF row-sparse inference (models/sparse_plan.py): `set_sparse` gives a
block, stack or transposed conv the static wiring of the reference's
sparse fields (e2enet_tpu/ops/blocks.py: sparse_in, sparse_in_full,
sparse_compact, sparse_out, sparse_chain, sparse_in_compact). Kernel rows
are gathered over the full concat, output columns pruned, and the compact
shift groups computed once there; the gathered weights are derived again
only when a source parameter changes.
"""
import contextlib
import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.collectives import axis_group, count, sync_sum
from ..parallel.halo import at_edge, halo_rows, halo_rows_grad
from .autograd import needs_grad
from .fused_block import (INSTNORM_EPS, LRELU_SLOPE, NO_FLIPS, SHIFT_SIZE,
                          Flips, block_groups, fused_shift_conv_block,
                          fused_shift_conv_block_bwd,
                          fused_shift_conv_block_bwd_ref,
                          fused_shift_conv_block_ref, lrelu_where,
                          mirror_conv_kernel, norm_affine_from_stats,
                          shift_groups)
from .qfused import LazyUp, lazy_up_fused_block, lazy_up_fused_block_ref
from .qlink import (downlink, downlink_bwd, downlink_bwd_ref, downlink_ref,
                    flip_transp_kernel, seghead, seghead_ref, uplink,
                    uplink_ref)
from .qstride import halo_extent as strided_halo_extent
from .qstride import strided_fused, strided_fused_ref
from .shift import (compact_groups, depth_shift_groups, group_shifts,
                    restrict_groups)

# kernel site name -> (kernel wrapper, plain version)
KERNEL_OPS = {
    "fused_shift_conv_block": (fused_shift_conv_block,
                               fused_shift_conv_block_ref),
    "lazy_up_fused_block": (lazy_up_fused_block, lazy_up_fused_block_ref),
    "strided_fused": (strided_fused, strided_fused_ref),
    "uplink": (uplink, uplink_ref),
    "downlink": (downlink, downlink_ref),
    "seghead": (seghead, seghead_ref),
}
# backward kernels (wrapper, plain version), launched by the autograd ops
# of the fused block, the lazy block and the down-link
BACKWARD_OPS = {
    "fused_shift_conv_block_bwd": (fused_shift_conv_block_bwd,
                                   fused_shift_conv_block_bwd_ref),
    "downlink_bwd": (downlink_bwd, downlink_bwd_ref),
}


@contextlib.contextmanager
def plain_ops():
    """Inside the block, every kernel site of the model runs the kernel's
    plain torch version, on any device (the comparison path)."""
    g = globals()
    try:
        for name, (_, ref) in KERNEL_OPS.items():
            g[name] = ref
        yield
    finally:
        for name, (op, _) in KERNEL_OPS.items():
            g[name] = op


def _spatial_mean(v: torch.Tensor, axes) -> torch.Tensor:
    """The mean of v over `axes`, which hold this rank's H slab: under a
    space group (parallel/collectives) the sum over every slab of the
    sample, the gradient summed too, over the global count."""
    if axis_group("space") is None:
        return v.mean(axes, keepdim=True)
    n = count(math.prod(v.shape[a] for a in axes), "space")
    return sync_sum(v.sum(axes, keepdim=True), "space") / float(n)


def instance_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                  eps: float = INSTNORM_EPS) -> torch.Tensor:
    """Per-(sample, channel) normalization over D, H, W with float32
    statistics. bfloat16 input: one-pass E[x^2] - E[x]^2 and the affine
    applied with bfloat16-rounded scalars; float32 input: two-pass variance
    and a float32 apply (reference blocks.py:47-71). Under a space group
    the statistics are the whole sample's (_spatial_mean)."""
    dtype = x.dtype
    axes = tuple(range(1, x.dim() - 1))
    xf = x.float()
    if dtype == torch.bfloat16:
        if axis_group("space") is None:
            n = float(math.prod(x.shape[a] for a in axes))
            s1 = xf.sum(axes, keepdim=True)
            s2 = (xf * xf).sum(axes, keepdim=True)
        else:
            n = float(count(math.prod(x.shape[a] for a in axes), "space"))
            s1, s2 = sync_sum(torch.stack([xf.sum(axes, keepdim=True),
                                           (xf * xf).sum(axes, keepdim=True)
                                           ]), "space")
        mean = s1 / n
        var = s2 / n - mean * mean
        mult = torch.rsqrt(var + eps) * scale.float()
        off = bias.float() - mean * mult
        return x * mult.to(dtype) + off.to(dtype)
    mean = _spatial_mean(xf, axes)
    var = _spatial_mean((xf - mean).square(), axes)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(dtype)


def leaky_relu(x: torch.Tensor, slope: float = LRELU_SLOPE) -> torch.Tensor:
    """jnp.where(x >= 0, x, x * slope) with the slope rounded to x's dtype
    (derivative 1 at 0), as the reference's blocks.leaky_relu."""
    if slope == LRELU_SLOPE:
        return lrelu_where(x)
    return torch.where(x >= 0, x, x * float(torch.tensor(slope,
                                                         dtype=x.dtype)))


def _affine_f32(y: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
    return (y * scale.float() + bias.float()).to(dtype)


def batch_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = INSTNORM_EPS) -> torch.Tensor:
    """Per-channel normalization over (N, D, H, W) with batch statistics,
    in training and at inference alike (reference blocks.batch_norm: the
    functional trainer keeps no running averages). Inside a data-parallel
    step (parallel/collectives.reducing) the statistics are the global
    batch's, as GSPMD computes them: Σx and then Σ(x - mean)² summed over
    every rank of the grid (rows and slabs), their gradients summed too
    (collectives.sync_sum)."""
    xf = x.float()
    axes = tuple(range(x.dim() - 1))
    if axis_group("world") is None:
        mean = xf.mean(axes, keepdim=True)
        var = (xf - mean).square().mean(axes, keepdim=True)
    else:
        n = float(count(math.prod(x.shape[:-1]), "world"))
        mean = sync_sum(xf.sum(axes, keepdim=True)) / n
        var = sync_sum((xf - mean).square().sum(axes, keepdim=True)) / n
    return _affine_f32((xf - mean) * torch.rsqrt(var + eps), scale, bias,
                       x.dtype)


def group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               num_groups: int = 8, eps: float = INSTNORM_EPS
               ) -> torch.Tensor:
    """GroupNorm over 8 channel groups, or one group where C % 8 != 0
    (reference blocks.group_norm); under a space group over the whole
    sample."""
    N, C = x.shape[0], x.shape[-1]
    g = num_groups if C % num_groups == 0 else 1
    xf = x.float().reshape(N, -1, g, C // g)
    mean = _spatial_mean(xf, (1, 3))
    var = _spatial_mean((xf - mean).square(), (1, 3))
    y = ((xf - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    return _affine_f32(y, scale, bias, x.dtype)


def frn(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
        eps: float = 1e-6) -> torch.Tensor:
    """Filter response normalization, x / sqrt(mean(x^2) + eps) over D, H,
    W, then the affine (reference blocks.frn); a block pairs it with the
    thresholded linear unit max(y, tau); under a space group over the whole
    sample."""
    xf = x.float()
    nu2 = _spatial_mean(xf * xf, tuple(range(1, x.dim() - 1)))
    return _affine_f32(xf * torch.rsqrt(nu2 + eps), scale, bias, x.dtype)


def mish(x: torch.Tensor) -> torch.Tensor:
    """x * tanh(softplus(x)) in float32 (reference blocks.mish)."""
    xf = x.float()
    return (xf * torch.tanh(F.softplus(xf))).to(x.dtype)


NORM_OPS = {"instance": instance_norm, "batch": batch_norm,
            "group": group_norm, "frn": frn,
            "none": lambda x, scale, bias: x}

# jax.nn.gelu is the tanh approximation by default (approximate=True)
NONLINS = {"lrelu": leaky_relu, "relu": torch.relu,
           "gelu": lambda x: F.gelu(x, approximate="tanh"), "mish": mish,
           "none": lambda x: x,
           # nnUNetTrainerV2_LReLU_slope_2en1
           "lrelu2e1": lambda x: leaky_relu(x, 0.2)}


def halo_pad(x: torch.Tensor, axis: int, k: int, s: int, lo: int,
             hi: int) -> Tuple[torch.Tensor, int, int]:
    """Under a space group (parallel/collectives), x with the rows that a
    window of k at stride s, padded (lo, hi), reads beyond this rank's H
    slab along `axis` taken from the neighbouring slabs (zeros at the
    volume's edge), and the padding (0, 0) left for that axis; else
    (x, lo, hi). The rows carry their gradient back to their owners
    (halo.halo_rows_grad)."""
    group = axis_group("space")
    if group is None or axis is None:
        return x, lo, hi
    L = int(x.shape[axis])
    out = (L + lo + hi - k) // s + 1
    after = max(0, (out - 1) * s + k - lo - L)
    top, bottom = halo_rows_grad(x, group, axis, lo, after)

    def rows(t, n):
        if t is not None or n == 0:
            return t
        shape = list(x.shape)
        shape[axis] = n
        return x.new_zeros(shape)
    cat = [t for t in (rows(top, lo), x, rows(bottom, after)) if t is not None]
    return torch.cat(cat, dim=axis), 0, 0


def conv3d_as_2d(x: torch.Tensor, kernel: torch.Tensor,
                 bias: Optional[torch.Tensor], stride: Tuple[int, int, int],
                 compute_dtype: torch.dtype,
                 flips: Flips = NO_FLIPS, halo_axis: Optional[int] = 2
                 ) -> torch.Tensor:
    """(1, kh, kw) conv of x (N, D, H, W, Cin) with kernel (Cout, Cin, kh,
    kw); padding kh//2, kw//2; the depth stride slices D.

    flips: the mirrored conv. A mirrored H/W axis reverses the kernel along
    it; a mirrored stride-s axis re-anchors the window grid: padding
    (k//2, k//2) -> (k - s - k//2, k//2), and the depth slice starts at
    sd - 1 (reference conv3d_as_2d).

    halo_axis: the axis of x (2 or 3) that holds the volume's H, split
    into slabs under a space group: its padding becomes the neighbouring
    slabs' rows (halo_pad); None where H is the flat axis."""
    sd, sh, sw = stride
    if sd > 1:
        x = x[:, sd - 1::sd] if flips[0] else x[:, ::sd]
    cout, _, kh, kw = kernel.shape
    pads = []
    for k, s, f in ((kw, sw, flips[2]), (kh, sh, flips[1])):
        pads += [k - s - k // 2, k // 2] if f else [k // 2, k // 2]
    if halo_axis == 2:
        x, pads[2], pads[3] = halo_pad(x, 2, kh, sh, pads[2], pads[3])
    elif halo_axis == 3:
        x, pads[0], pads[1] = halo_pad(x, 3, kw, sw, pads[0], pads[1])
    N, D, H, W, C = x.shape
    x2 = x.reshape(N * D, H, W, C).permute(0, 3, 1, 2).to(compute_dtype)
    k2 = mirror_conv_kernel(kernel, flips).to(compute_dtype)
    if pads[0] == pads[1] and pads[2] == pads[3]:
        y = F.conv2d(x2, k2, None, stride=(sh, sw),
                     padding=(pads[2], pads[0]))
    else:                           # re-anchored: an uneven halo
        y = F.conv2d(F.pad(x2, pads), k2, None, stride=(sh, sw))
    Ho, Wo = y.shape[2], y.shape[3]
    y = y.permute(0, 2, 3, 1).reshape(N, D, Ho, Wo, cout)
    if bias is not None:
        y = y + bias.to(compute_dtype)
    return y


def conv3d_one_flat(x: torch.Tensor, kernel: torch.Tensor,
                    bias: Optional[torch.Tensor],
                    stride: Tuple[int, int, int], flat_axis: int,
                    compute_dtype: torch.dtype,
                    flips: Flips = NO_FLIPS) -> torch.Tensor:
    """A 3D conv whose kernel is 1 along `flat_axis` (0 = D, 1 = H, 2 = W):
    that axis moved into the depth slot of conv3d_as_2d, kernel (Cout, Cin,
    ka, kb) over the other two axes in order. Covers the _313 / _331
    ablations; flips as conv3d_as_2d's, per true axis (reference
    conv3d_one_flat)."""
    if flat_axis == 0:
        return conv3d_as_2d(x, kernel, bias, stride, compute_dtype, flips)
    perm = {1: (0, 2, 1, 3, 4), 2: (0, 3, 1, 2, 4)}[flat_axis]
    inv = {1: (0, 2, 1, 3, 4), 2: (0, 2, 3, 1, 4)}[flat_axis]
    order = {1: (1, 0, 2), 2: (2, 0, 1)}[flat_axis]
    # where the volume's H lands: the flat slot (no window) or axis 3
    y = conv3d_as_2d(x.permute(perm), kernel, bias,
                     tuple(stride[a] for a in order), compute_dtype,
                     tuple(flips[a] for a in order),
                     halo_axis={1: None, 2: 3}[flat_axis])
    return y.permute(inv)


def conv3d_full(x: torch.Tensor, kernel: torch.Tensor,
                bias: Optional[torch.Tensor], stride: Tuple[int, int, int],
                compute_dtype: torch.dtype) -> torch.Tensor:
    """cuDNN's 3D conv of x (N, D, H, W, Cin) with kernel (Cout, Cin, kd,
    kh, kw), padding k//2 per side, the bias added in the compute dtype
    (reference conv3d_full). It has no mirrored variant: networks built
    from it take data-flip TTA. Under a space group its H padding is the
    neighbouring slabs' rows (halo_pad)."""
    pad = [int(k) // 2 for k in kernel.shape[2:]]
    kh = int(kernel.shape[3])
    x, pad[1], _ = halo_pad(x, 2, kh, int(stride[1]), pad[1], pad[1])
    y = F.conv3d(x.permute(0, 4, 1, 2, 3).to(compute_dtype),
                 kernel.to(compute_dtype), None, stride=tuple(stride),
                 padding=tuple(pad)).permute(0, 2, 3, 4, 1)
    if bias is not None:
        y = y + bias.to(compute_dtype)
    return y


def transp_conv_matmul(x: torch.Tensor, kernel: torch.Tensor,
                       stride: Tuple[int, int, int],
                       compute_dtype: torch.dtype) -> torch.Tensor:
    """Transposed conv with kernel == stride: x (N, D, H, W, Cin), kernel
    (Cin, Cout, sd, sh, sw) -> (N, D*sd, H*sh, W*sw, Cout)."""
    sd, sh, sw = stride
    N, D, H, W, C = x.shape
    cin, cout = kernel.shape[:2]
    assert tuple(kernel.shape[2:]) == (sd, sh, sw), \
        "transposed conv requires kernel == stride"
    w2 = kernel.permute(0, 2, 3, 4, 1).reshape(cin, sd * sh * sw * cout)
    y = x.to(compute_dtype) @ w2.to(compute_dtype)
    y = y.reshape(N, D, H, W, sd, sh, sw, cout)
    y = y.permute(0, 1, 4, 2, 5, 3, 6, 7)
    return y.reshape(N, D * sd, H * sh, W * sw, cout)


def max_pool(x: torch.Tensor, window: Tuple[int, int, int]) -> torch.Tensor:
    """Max pool with window == stride over (N, D, H, W, C)."""
    wd, wh, ww = window
    N, D, H, W, C = x.shape
    assert D % wd == 0 and H % wh == 0 and W % ww == 0, (x.shape, window)
    x = x.reshape(N, D // wd, wd, H // wh, wh, W // ww, ww, C)
    return x.amax(dim=(2, 4, 6))


def _he_normal_(t: torch.Tensor, fan_in: int,
                generator: torch.Generator) -> None:
    """Kaiming normal, fan_in, leaky-relu gain (reference he_normal_leaky)."""
    std = math.sqrt(2.0 / (1.0 + LRELU_SLOPE ** 2) / fan_in)
    with torch.no_grad():
        t.copy_(torch.randn(t.shape, generator=generator) * std)


class _Derived:
    """Tensors derived from parameters (gathered, pruned, cast), derived
    again only when a source parameter changes (its version counter;
    parameters made under inference_mode have none and are derived once)."""

    def __init__(self, fn, params):
        self.fn, self.params = fn, list(params)
        self.key, self.value = None, None

    def get(self):
        if needs_grad(self.params):
            raise RuntimeError("derived (gathered, pruned) weights carry no "
                               "gradient: detach the sparse plan "
                               "(set_sparse_plan(None)) to train")
        key = tuple(-1 if p.is_inference() else p._version
                    for p in self.params)
        if self.value is None or key != self.key:
            with torch.no_grad():
                self.value = self.fn()
            self.key = key
        return self.value


def _index(channels, device) -> Optional[torch.Tensor]:
    return None if channels is None else torch.tensor(
        [int(c) for c in channels], dtype=torch.long, device=device)


def _gather_index(alive, full: int, compact: bool, device):
    """The gather of a part's alive channels, or None when the part tensor
    is taken as it is (already compact, or every channel in order)."""
    if compact or tuple(alive) == tuple(range(full)):
        return None
    return _index(alive, device)


def _he_shape(kernel: Tuple[int, int, int]) -> Tuple[int, ...]:
    """The spatial dims of a conv parameter of kernel (kd, kh, kw): the two
    that are not 1 when one is (the batched-2D layout), all three
    otherwise."""
    flat = [i for i, k in enumerate(kernel) if k == 1]
    if not flat:
        return tuple(kernel)
    spatial = tuple(k for k in kernel if k != 1) or (1, 1)
    return spatial if len(spatial) == 2 else (spatial[0], 1)


class ShiftConvBlock(nn.Module):
    """shift -> conv -> norm -> nonlinearity (reference ShiftConvBlock,
    list-of-parts branch). The defaults are shiftConvPP's: a (1,3,3)
    kernel, shift size 5, instance norm, leaky relu. do_shift=False drops
    the shift (shiftConvPP_noshift, 2D plans): every kernel site then
    takes one group of shift 0 (fused_block.shift_groups). The shift
    applies only to a (1,3,3) kernel, in groups of shift_size (3 for ori).
    kernel (3,1,3) / (3,3,1) runs the batched-2D conv over the other flat
    axis, (3,3,3) cuDNN's 3D conv (no shift, no mirrored operator).
    norm_op (NORM_OPS) and nonlin (NONLINS) as the reference's; with
    nonlin_before_norm the block is conv -> nonlin -> norm; otherwise
    norm_op "frn" adds the parameter frn_tau and ends in max(y, frn_tau)
    (the TLU) instead of the nonlinearity.

    forward(parts, flips): plain torch; x may be a tensor or a list of parts
    of an implicit channel concat, conv(shift(cat)) == sum_p
    conv(shift_p(part_p)) with each part's shift groups cut from the groups
    of the whole concat.

    forward_fused(parts, affines, flips): runs the fused block op (stride
    1; the lazy up-link op when the last part is a LazyUp) or the strided
    transition (one part with a pending affine) and returns (raw, stats,
    norm_scale, norm_bias) with the norm pending. Only the default block
    (kernel_block()) has that route.
    """

    def __init__(self, in_channels: int, features: int,
                 stride: Tuple[int, int, int] = (1, 1, 1),
                 compute_dtype: torch.dtype = torch.bfloat16,
                 do_shift: bool = True, device=None,
                 kernel: Tuple[int, int, int] = (1, 3, 3),
                 shift_size: int = SHIFT_SIZE, norm_op: str = "instance",
                 nonlin: str = "lrelu", nonlin_before_norm: bool = False):
        super().__init__()
        if norm_op not in NORM_OPS or nonlin not in NONLINS:
            raise ValueError(f"norm_op {norm_op!r} / nonlin {nonlin!r}: "
                             f"one of {sorted(NORM_OPS)} / "
                             f"{sorted(NONLINS)}")
        self.in_channels = in_channels
        self.features = features
        self.stride = tuple(stride)
        self.do_shift = do_shift
        self.compute_dtype = compute_dtype
        self.kernel_size = tuple(int(k) for k in kernel)
        flat = [i for i, k in enumerate(self.kernel_size) if k == 1]
        self.flat_axis = flat[0] if flat else None
        self.shift_size = shift_size
        self.shifting = do_shift and self.kernel_size == (1, 3, 3)
        self.norm_op, self.nonlin = norm_op, nonlin
        self.nonlin_before_norm = nonlin_before_norm
        f32 = dict(dtype=torch.float32, device=device)
        self.kernel = nn.Parameter(torch.empty(
            features, in_channels, *_he_shape(self.kernel_size), **f32))
        self.bias = nn.Parameter(torch.zeros(features, **f32))
        self.norm_scale = nn.Parameter(torch.ones(features, **f32))
        self.norm_bias = nn.Parameter(torch.zeros(features, **f32))
        # the TLU's threshold: FRN's, unless the nonlinearity comes first
        self.tlu = norm_op == "frn" and not nonlin_before_norm
        if self.tlu:
            self.frn_tau = nn.Parameter(torch.zeros(features, **f32))
        self.set_sparse()

    def kernel_block(self) -> bool:
        """Whether the block is the one the kernels bake: (1,3,3), shift
        size 5 or none, instance norm, then leaky relu."""
        return (self.kernel_size == (1, 3, 3)
                and (self.shift_size == SHIFT_SIZE or not self.do_shift)
                and self.norm_op == "instance" and self.nonlin == "lrelu"
                and not self.nonlin_before_norm)

    def reset_parameters(self, generator: torch.Generator) -> None:
        _he_normal_(self.kernel, math.prod(self.kernel.shape[1:]),
                    generator)
        with torch.no_grad():
            self.bias.zero_()
            self.norm_scale.fill_(1.0)
            self.norm_bias.zero_()
            if self.tlu:
                self.frn_tau.zero_()

    def _full_groups(self, C: int):
        """The shift groups over C concat channels: shift_size groups, or
        one group of shift 0 without the shift."""
        if not self.shifting:
            return shift_groups(C, False)
        return tuple(group_shifts(C, self.shift_size))

    def set_sparse(self, sparse_in=None, sparse_in_full=None,
                   sparse_compact=None, sparse_out=None) -> None:
        """The static sparse wiring (None everywhere: dense). sparse_in: per
        input part, its alive channels within the part's full range
        (sparse_in_full); sparse_compact: the part tensor already holds
        exactly those channels; sparse_out: emit only these output
        channels. The kernel rows of the full concat are gathered to the
        alive channels, whose shifts follow their original positions.
        Without the shift every site takes the one-group table."""
        dev = self.kernel.device
        rows, self._gathers = None, None
        self._groups = (None if self.shifting
                        and self.shift_size == SHIFT_SIZE
                        else self._full_groups(self.in_channels))
        if sparse_in is not None:
            full = tuple(int(f) for f in sparse_in_full)
            compact = tuple(sparse_compact or (False,) * len(full))
            off = [sum(full[:p]) for p in range(len(full))]
            galive = [off[p] + int(c) for p, a in enumerate(sparse_in)
                      for c in a]
            rows = _index(galive, dev)
            self._groups = compact_groups(self._full_groups(sum(full)),
                                          galive)
            self._gathers = [_gather_index(a, f, c, dev) for a, f, c
                             in zip(sparse_in, full, compact)]
        cols = self._cols = _index(sparse_out, dev)
        self._derived = None
        if rows is not None or cols is not None:
            def derive():
                k, b = self.kernel, self.bias
                sc, nb = self.norm_scale, self.norm_bias
                if rows is not None:
                    k = k.index_select(1, rows)
                if cols is not None:
                    k, b, sc, nb = (t.index_select(0, cols)
                                    for t in (k, b, sc, nb))
                return k.to(self.compute_dtype).contiguous(), b, sc, nb
            self._derived = _Derived(derive, (self.kernel, self.bias,
                                              self.norm_scale,
                                              self.norm_bias))

    def weights(self):
        """(kernel, bias, norm_scale, norm_bias) with the sparse wiring's
        rows gathered and outputs pruned (the kernel then already in the
        compute dtype), else the parameters."""
        if self._derived is None:
            return self.kernel, self.bias, self.norm_scale, self.norm_bias
        return self._derived.get()

    def _gather_parts(self, parts, affines=None):
        """Each part (and its pending affine) gathered to its alive
        channels, unless compact already."""
        affines = affines or [None] * len(parts)
        if self._gathers is None:
            return list(parts), affines
        out, affs = [], []
        for x, a, idx in zip(parts, affines, self._gathers):
            if idx is not None:
                x = x.index_select(-1, idx)
                if a is not None:
                    a = tuple(t.index_select(-1, idx) for t in a)
            out.append(x)
            affs.append(a)
        return out, affs

    def norm_nonlin(self, y: torch.Tensor, scale: torch.Tensor,
                    nbias: torch.Tensor) -> torch.Tensor:
        """The block's tail on its conv output y (reference
        ShiftConvBlock)."""
        norm, act = NORM_OPS[self.norm_op], NONLINS[self.nonlin]
        if self.nonlin_before_norm:
            return norm(act(y), scale, nbias)
        y = norm(y, scale, nbias)
        if self.tlu:
            tau = (self.frn_tau if self._cols is None
                   else self.frn_tau.index_select(0, self._cols))
            return torch.maximum(y, tau.to(y.dtype))
        return act(y)

    def forward(self, x, flips: Flips = NO_FLIPS) -> torch.Tensor:
        parts = list(x) if isinstance(x, (list, tuple)) else [x]
        kernel, bias, scale, nbias = self.weights()
        parts, _ = self._gather_parts(parts)
        cin = sum(int(p.shape[-1]) for p in parts)
        assert cin == kernel.shape[1], (cin, tuple(kernel.shape))
        if self.flat_axis is None and any(flips):
            raise ValueError("a full 3D kernel has no mirrored operator: "
                             "its network takes data-flip TTA")
        # a mirrored depth negates the shifts; conv3d_as_2d re-anchors the
        # depth stride
        groups = (block_groups(cin, flips, self._groups) if self.shifting
                  else None)
        y = None
        off = 0
        for part in parts:
            pc = int(part.shape[-1])
            if groups is not None:
                part = depth_shift_groups(
                    part, restrict_groups(groups, off, off + pc))
            k = kernel[:, off:off + pc]
            b = bias if y is None else None
            contrib = (conv3d_full(part, k, b, self.stride,
                                   self.compute_dtype)
                       if self.flat_axis is None else
                       conv3d_one_flat(part, k, b, self.stride,
                                       self.flat_axis, self.compute_dtype,
                                       flips))
            y = contrib if y is None else y + contrib
            off += pc
        return self.norm_nonlin(y, scale, nbias)

    def forward_fused(self, parts: Sequence, affines,
                      flips: Flips = NO_FLIPS):
        if not self.kernel_block():
            raise ValueError("the kernels bake a (1,3,3) block with instance "
                             "norm and leaky relu; this block materialises")
        cd = self.compute_dtype
        kernel, bias, scale, nbias = self.weights()
        space = axis_group("space")
        if self.stride == (1, 1, 1):
            parts, affines = self._gather_parts(parts, affines)
            if isinstance(parts[-1], LazyUp):
                if space is not None:
                    raise NotImplementedError(
                        "the lazy up-link block takes no halo rows "
                        "(ROADMAP: #3 with halo rows); a model under a "
                        "space group takes the materialised up-link")
                y, stats = lazy_up_fused_block(
                    parts[:-1], parts[-1], kernel.to(cd), bias.to(cd),
                    affines[:-1], flips, self._groups)
            elif space is None:
                y, stats = fused_shift_conv_block(
                    parts, kernel.to(cd), bias.to(cd), affines, flips,
                    self._groups)
            else:
                # the kernel op's backward exchanges y and gy rows and
                # sends no gradient back for the halo rows; its plain
                # version (plain_ops) returns them through the exchange
                plain = fused_shift_conv_block is fused_shift_conv_block_ref
                fetch = halo_rows_grad if plain else halo_rows
                rows = [fetch(p, space, 2, 1, 1) for p in parts]
                halos = tuple([r[i] for r in rows] for i in (0, 1))
                kw = {} if plain else {"space": space}
                y, stats = fused_shift_conv_block(
                    parts, kernel.to(cd), bias.to(cd), affines, flips,
                    self._groups, halos, at_edge(space), **kw)
        else:
            (x,), ((mult, off),) = parts, affines
            halo, edge = (None, None), (True, True)
            if space is not None:
                halo = halo_rows_grad(x, space, 2, *strided_halo_extent(
                    int(x.shape[2]), self.stride[1], flips[1]))
                edge = at_edge(space)
            # the strided transition adds its bias in float32
            y, stats = strided_fused(x, mult, off, kernel.to(cd), bias,
                                     self.stride, flips, self._groups,
                                     halo, edge)
        # the instance norm's statistics of the whole sample
        return y, sync_sum(stats, "space"), scale, nbias


class StackedConvBlocks(nn.Module):
    """num_convs ShiftConvBlocks named block0..; the stride applies to the
    first only (convolutional pooling)."""

    def __init__(self, in_channels: int, features: int, num_convs: int,
                 first_stride: Tuple[int, int, int] = (1, 1, 1),
                 compute_dtype: torch.dtype = torch.bfloat16,
                 do_shift: bool = True, device=None, **block_kw):
        """block_kw: ShiftConvBlock's kernel, shift_size, norm_op, nonlin,
        nonlin_before_norm, the same for every block."""
        super().__init__()
        self.num_convs = num_convs
        self.features = features
        for i in range(num_convs):
            self.add_module(f"block{i}", ShiftConvBlock(
                in_channels if i == 0 else features, features,
                stride=first_stride if i == 0 else (1, 1, 1),
                compute_dtype=compute_dtype, do_shift=do_shift,
                device=device, **block_kw))

    def blocks(self):
        return [getattr(self, f"block{i}") for i in range(self.num_convs)]

    def set_sparse(self, sparse_in=None, sparse_in_full=None,
                   sparse_compact=None, sparse_chain=None,
                   sparse_out=None) -> None:
        """Block0 takes sparse_in/sparse_in_full/sparse_compact; block i >= 1
        contracts only sparse_chain[i] (not None), which block i-1 then
        emits; sparse_out prunes the last block's outputs (reference
        StackedConvBlocks._block_sparse)."""
        chain = sparse_chain or (None,) * self.num_convs
        for i, blk in enumerate(self.blocks()):
            if i == 0:
                sin, sfull, scomp = sparse_in, sparse_in_full, sparse_compact
            elif chain[i] is not None:
                sin, sfull, scomp = (tuple(chain[i]),), (self.features,), \
                    (True,)
            else:
                sin = sfull = scomp = None
            nxt = chain[i + 1] if i + 1 < self.num_convs else None
            sout = (tuple(nxt) if nxt is not None
                    else (sparse_out if i == self.num_convs - 1 else None))
            blk.set_sparse(sin, sfull, scomp, sout)

    def forward(self, x, flips: Flips = NO_FLIPS):
        for blk in self.blocks():
            x = blk(x, flips)
        return x

    def forward_fused(self, parts, affines, flips: Flips = NO_FLIPS):
        """Blocks chained through their instance-norm statistics: block i's
        norm + lrelu is applied on load by block i+1. A strided first block
        runs the strided transition on its one pending part. Returns the
        last block's (raw, stats, norm_scale, norm_bias)."""
        out = None
        for blk in self.blocks():
            if out is not None:
                raw, stats, scale, nbias = out
                n_vox = count(math.prod(raw.shape[1:4]), "space")
                parts = [raw]
                affines = [norm_affine_from_stats(stats, n_vox, scale, nbias)]
            out = blk.forward_fused(parts, affines, flips)
        return out


class TranspConv(nn.Module):
    """Transposed conv, kernel == stride, no bias."""

    def __init__(self, in_channels: int, features: int,
                 stride: Tuple[int, int, int],
                 compute_dtype: torch.dtype = torch.bfloat16, device=None):
        super().__init__()
        self.stride = tuple(stride)
        self.compute_dtype = compute_dtype
        self.kernel = nn.Parameter(torch.empty(
            in_channels, features, *self.stride, dtype=torch.float32,
            device=device))
        self.set_sparse()

    def reset_parameters(self, generator: torch.Generator) -> None:
        fan_in = math.prod(self.stride) * self.kernel.shape[0]
        _he_normal_(self.kernel, fan_in, generator)

    def set_sparse(self, sparse_in=None, sparse_in_compact: bool = False,
                   sparse_in_full: Optional[int] = None,
                   sparse_out=None) -> None:
        """The static sparse wiring: contract only the input channels
        sparse_in (of the full input range; gathered from the input unless
        sparse_in_compact, the input holding exactly those already) and
        emit only the output channels sparse_out (reference TranspConv)."""
        dev = self.kernel.device
        rows, cols = _index(sparse_in, dev), _index(sparse_out, dev)
        self._in_gather = None if sparse_in_compact else rows
        self._derived = None
        if rows is not None or cols is not None:
            def derive():
                k = self.kernel
                if rows is not None:
                    k = k.index_select(0, rows)
                if cols is not None:
                    k = k.index_select(1, cols)
                return k.to(self.compute_dtype).contiguous()
            self._derived = _Derived(derive, (self.kernel,))

    def weight(self) -> torch.Tensor:
        """The kernel in the compute dtype, gathered and pruned."""
        if self._derived is None:
            return self.kernel.to(self.compute_dtype)
        return self._derived.get()

    def forward(self, x: torch.Tensor,
                flips: Flips = NO_FLIPS) -> torch.Tensor:
        if self._in_gather is not None:
            x = x.index_select(-1, self._in_gather)
        return transp_conv_matmul(x, flip_transp_kernel(self.weight(), flips),
                                  self.stride, self.compute_dtype)

    def forward_pending(self, raw: torch.Tensor, mult: torch.Tensor,
                        off: torch.Tensor, flips: Flips = NO_FLIPS,
                        lazy: bool = False):
        """The up-link from a pending input: its norm on load, straight to
        the finer level (the up-link op), or with `lazy` a LazyUp for the
        consuming block to compute on load."""
        if self._in_gather is not None:
            g = self._in_gather
            raw = raw.index_select(-1, g)
            mult, off = mult.index_select(-1, g), off.index_select(-1, g)
        if lazy:
            return LazyUp(raw, mult, off,
                          flip_transp_kernel(self.weight(), flips))
        return uplink(raw, mult, off, self.weight(), flips)


class SegHead(nn.Module):
    """1x1x1 conv, with a bias only when use_bias (the *_biasInSegOutput
    variants); float32 logits from compute-dtype operands (products exact,
    float32 sums, as the reference's preferred_element_type=float32), the
    bias added to them in float32. With probs_dtype, the float32 class
    softmax of the logits stored in that dtype instead (the probs head,
    refused with a bias as in the reference). forward_pending reads a
    pending input through the seg-head op."""

    def __init__(self, in_channels: int, num_classes: int,
                 compute_dtype: torch.dtype = torch.bfloat16, device=None,
                 use_bias: bool = False):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.use_bias = use_bias
        self.kernel = nn.Parameter(torch.empty(
            num_classes, in_channels, dtype=torch.float32, device=device))
        if use_bias:
            self.bias = nn.Parameter(torch.zeros(
                num_classes, dtype=torch.float32, device=device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        _he_normal_(self.kernel, self.kernel.shape[1], generator)
        if self.use_bias:
            with torch.no_grad():
                self.bias.zero_()

    def _check_probs(self, probs_dtype) -> None:
        if probs_dtype is not None and self.use_bias:
            raise ValueError("a seg head with a bias has no probs head "
                             "(reference SegHead: emit_probs_dtype asserts "
                             "not use_bias)")

    def forward(self, x: torch.Tensor,
                probs_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        self._check_probs(probs_dtype)
        cd = self.compute_dtype
        logits = x.to(cd).float() @ self.kernel.to(cd).float().t()
        if self.use_bias:
            logits = logits + self.bias
        if probs_dtype is None:
            return logits
        return torch.softmax(logits, dim=-1).to(probs_dtype)

    def forward_pending(self, raw: torch.Tensor, mult: torch.Tensor,
                        off: torch.Tensor,
                        probs_dtype: Optional[torch.dtype] = None
                        ) -> torch.Tensor:
        self._check_probs(probs_dtype)
        out = seghead(raw.to(self.compute_dtype), mult, off,
                      self.kernel.to(self.compute_dtype), probs_dtype)
        return out + self.bias if self.use_bias else out
