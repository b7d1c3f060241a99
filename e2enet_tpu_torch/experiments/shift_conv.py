"""Depth-ring shift + (1,3,3) conv, and the ring shift alone (#11).
Counterpart of experiments/shift_conv_pallas.py.

    fused_shift_conv(x, kernel, bias)  conv_(1,3,3)(depth_shift(x)) + bias
                                       (the reference's fused_shift_conv and
                                       fused_shift_conv_v2: one function)
    depth_shift_ring(x)                depth_shift(x) (pallas_depth_shift)

x is channels-last (N, D, H, W, C) in any float dtype, the kernel (CO, C, 3,
3) (the reference's (3, 3, C, CO) transposed), the shift groups torch.chunk's
with shifts in [-2, 2] (shift_size <= 5). The products are of operands
rounded to x's dtype, the sums float32 with the bias, y rounded once to x's
dtype: the reference kernels' arithmetic. Any W: the reference's v2 needs
W * C % 128 == 0 for its DMA, the function does not.

On CUDA tensors (bfloat16 only) both run csrc/shift_conv_ring.cu, whose
blocks walk depth with a ring of input slices in shared memory, so that each
input value is read from device memory once per tile; on CPU tensors their
plain versions. The fused kernel has two routes, chosen by the library's
rule by shape (`_native.shift_conv_ring_route`): "tma" (whole depth slices
by TMA into the ring, wgmma with A built in registers, its weights packed
once per call by pack_weights_n48) where C % 8 == 0, every shift group's
edges are even, CO <= 48 and CO % 8 == 0, C <= 64 and x and y are 16-byte
aligned; "cp_async", the first design, otherwise.
`fused_shift_conv.routes` counts the launches per route; `route=` runs one
route (the first design as a control; "tma" raises where the rule refuses
the shape). Gradients: fused_shift_conv's is the autograd of its plain
version (the reference's is XLA's autodiff of its `_reference`, not a
kernel); depth_shift_ring's is the ring kernel itself with the shifts
negated (the reference's `_bwd_shift_ring`).

    python -m e2enet_tpu_torch.experiments.shift_conv [--reps N]

repeats the reference's STATUS measurements (shift_conv_pallas.py:24-41) on
the card at 1 x 128^3 x 48 -> 48, bf16, with block #1 (which restages the
operand from device memory for every depth) on the same input beside them.
"""
import argparse
import sys

import torch
import torch.nn.functional as F

from ..ops.autograd import (check_device, first_order_only, needs_grad,
                             plain_vjp)
from ..ops.blocks import conv3d_as_2d
from ..ops.fused_block import fused_shift_conv_block
from ..ops.shift import (depth_shift, depth_shift_groups, group_shifts,
                         mirror_groups)
from . import card_line, cuda_ms, require_cuda

SHIFT_SIZE = 5
# the output channels of the TMA routes of #11 and #12: one wgmma n48 tile
# (csrc/shift_conv_ring.cu TR_NCO, csrc/cf_fused.cu CF_NCO)
N48 = 48
ROUTES = ("tma", "cp_async")


def ring_groups(C: int, shift_size: int):
    """The (c0, c1, shift) groups of C channels; the ring holds 5 depth
    slices, so |shift| <= 2."""
    groups = tuple(group_shifts(C, shift_size))
    if any(abs(s) > 2 for _, _, s in groups):
        raise ValueError(f"shift_size {shift_size}: the ring holds shifts in "
                         f"[-2, 2]")
    return groups


def _check_x(name, x):
    if x.dim() != 5:
        raise ValueError(f"{name}: x must be (N, D, H, W, C), got "
                         f"{tuple(x.shape)}")
    if x.device.type == "cuda" and x.dtype != torch.bfloat16:
        raise TypeError(f"the CUDA {name} takes bfloat16")


# ---------------------------------------------------------------- the shift
def depth_shift_ring_ref(x: torch.Tensor, shift_size: int = SHIFT_SIZE,
                         groups=None) -> torch.Tensor:
    """Plain version: ops.shift.depth_shift_groups, exact in any dtype."""
    if groups is None:
        groups = ring_groups(x.shape[-1], shift_size)
    return depth_shift_groups(x, groups)


def _shift_forward(x, groups):
    _check_x("depth_shift_ring", x)
    if x.device.type == "cpu":
        return depth_shift_ring_ref(x, groups=groups)
    check_device("depth_shift_ring", [x])
    from ..ops import _native
    x = x.contiguous()
    y = torch.empty_like(x)
    _native.launch_depth_shift_ring(x, y, groups)
    depth_shift_ring.launches += 1
    return y


class _RingShiftFn(torch.autograd.Function):
    """The ring shift; its backward the same kernel with negated shifts."""

    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return _shift_forward(x, groups)

    @staticmethod
    def backward(ctx, g):
        first_order_only("depth_shift_ring")
        return _shift_forward(g, mirror_groups(ctx.groups)), None


def depth_shift_ring(x: torch.Tensor, shift_size: int = SHIFT_SIZE
                     ) -> torch.Tensor:
    """depth_shift(x, shift_size) by the ring kernel (CUDA, bf16) or its
    plain version (CPU); differentiable."""
    groups = ring_groups(x.shape[-1], shift_size)
    if needs_grad([x]):
        return _RingShiftFn.apply(x, groups)
    return _shift_forward(x, groups)


depth_shift_ring.launches = 0


# ---------------------------------------------------------- shift + conv
def fused_shift_conv_ref(x: torch.Tensor, kernel: torch.Tensor,
                         bias: torch.Tensor, shift_size: int = SHIFT_SIZE
                         ) -> torch.Tensor:
    """Plain version: depth_shift_groups, then conv3d_as_2d on operands
    rounded to x's dtype with float32 sums, the bias added in float32, y
    rounded to x's dtype once."""
    dtype = x.dtype
    s = depth_shift_groups(x, ring_groups(x.shape[-1], shift_size))
    acc = conv3d_as_2d(s.float(), kernel.to(dtype).float(), None, (1, 1, 1),
                       torch.float32)
    return (acc + bias.to(dtype).float()).to(dtype)


def pack_weights_n48(kernel: torch.Tensor) -> torch.Tensor:
    """The TMA routes' weights (#11 and #12): kernel (CO <= 48, C, 3, 3)
    -> a flat tensor of 9 taps x KS = ceil(C / 16) steps of 16 K rows (the
    channels in order, zero past C) x 48 output channels (zero past CO),
    laid out for wgmma's B operand (csrc/shift_conv_block.cuh
    wgmma_b_index: per (tap, step) six groups of 8 output channels, each
    two 8 x 8 core matrices, K halves 128 bytes apart), in the kernel's
    dtype."""
    CO, C = (int(s) for s in kernel.shape[:2])
    if CO > N48:
        raise ValueError(f"CO = {CO} exceeds the TMA routes' {N48}")
    KS = -(-C // 16)
    pad = kernel.new_zeros((9, N48, KS * 16))
    # (tap, co, c) with tap = 3 * kh + kw
    pad[:, :CO, :C] = kernel.permute(2, 3, 0, 1).reshape(9, CO, C)
    # [t][co = 8 * n8 + nr][k = 16 * ks + 8 * kh + kr] ->
    # [t][ks][n8][kh][nr][kr]
    return (pad.reshape(9, N48 // 8, 8, KS, 2, 8)
            .permute(0, 3, 1, 4, 2, 5).contiguous().reshape(-1))


def _fused_forward(x, kernel, bias, shift_size, route):
    _check_x("fused_shift_conv", x)
    N, D, H, W, C = (int(s) for s in x.shape)
    CO = int(kernel.shape[0])
    if tuple(kernel.shape) != (CO, C, 3, 3) or tuple(bias.shape) != (CO,):
        raise ValueError(f"kernel {tuple(kernel.shape)} / bias "
                         f"{tuple(bias.shape)} do not fit C={C}")
    if route is not None and route not in ROUTES:
        raise ValueError(f"route {route!r}: one of {ROUTES} or None")
    if x.device.type == "cpu":
        return fused_shift_conv_ref(x, kernel, bias, shift_size)
    check_device("fused_shift_conv", [x, kernel, bias])
    from ..ops import _native
    bf = torch.bfloat16
    x = x.contiguous()
    groups = ring_groups(C, shift_size)
    y = torch.empty((N, D, H, W, CO), dtype=bf, device=x.device)
    if route is None:
        route = _native.shift_conv_ring_route(x, y, groups)
    kb = kernel.to(bf)
    if route == "tma":
        w9, wpk = None, pack_weights_n48(kb)
    else:
        w9 = kb.permute(2, 3, 0, 1).reshape(9, CO, C).contiguous()
        wpk = None
    _native.launch_shift_conv_ring(x, w9, wpk, bias.to(bf).contiguous(), y,
                                   groups, route)
    fused_shift_conv.launches += 1
    fused_shift_conv.routes[route] += 1
    return y


def fused_shift_conv(x: torch.Tensor, kernel: torch.Tensor,
                     bias: torch.Tensor, shift_size: int = SHIFT_SIZE,
                     route=None) -> torch.Tensor:
    """conv_(1,3,3)(depth_shift(x)) + bias by the ring kernel (CUDA, bf16;
    on the route the library's rule gives, or on `route`) or its plain
    version (CPU); x (N, D, H, W, C), kernel (CO, C, 3, 3), bias (CO,) ->
    (N, D, H, W, CO) in x's dtype. With a gradient wanted, its backward is
    the autograd of fused_shift_conv_ref."""
    if needs_grad([x, kernel, bias]):
        return plain_vjp(
            lambda a, k, b: _fused_forward(a, k, b, shift_size, route),
            lambda a, k, b: fused_shift_conv_ref(a, k, b, shift_size),
            (x, kernel, bias))
    return _fused_forward(x, kernel, bias, shift_size, route)


fused_shift_conv.launches = 0
fused_shift_conv.routes = dict.fromkeys(ROUTES, 0)


# ---------------------------------------------------------------- main
def bf16_close(y, ref, ulps=2.0) -> bool:
    """Within `ulps` bf16 steps of each output channel's largest |ref|."""
    y, ref = y.float(), ref.float()
    dims = tuple(range(y.dim() - 1))
    top = ref.abs().amax(dim=dims).clamp_min(2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(top)) - 7)
    return bool(((y - ref).abs().amax(dim=dims) <= ulps * ulp).all())


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    dev = require_cuda("shift_conv")
    torch.backends.cudnn.allow_tf32 = False
    bf = torch.bfloat16
    S, C, CO = 128, 48, 48
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((1, S, S, S, C), generator=gen, device=dev).to(bf)
    kernel = torch.randn((CO, C, 3, 3), generator=gen, device=dev) * 0.05
    bias = torch.randn((CO,), generator=gen, device=dev) * 0.1
    print(f"[shift_conv] {torch.cuda.get_device_name(0)} [{card_line()}]; "
          f"x 1 x {S}^3 x {C} -> {CO} bf16", flush=True)
    with torch.inference_mode():
        routes = dict(fused_shift_conv.routes)
        y = fused_shift_conv(x, kernel, bias)
        route = next(r for r in ROUTES
                     if fused_shift_conv.routes[r] > routes[r])
        ok_y = bf16_close(y, fused_shift_conv_ref(x, kernel, bias))
        s = depth_shift_ring(x)
        ok_s = torch.equal(s, depth_shift(x, SHIFT_SIZE))
        print(f"  ring shift + conv ({route} route) vs its plain version: "
              f"within 2 bf16 steps {ok_y}; ring shift vs depth_shift: "
              f"equal {ok_s}", flush=True)
        if not (ok_y and ok_s):
            raise SystemExit("shift_conv: the kernels disagree with their "
                             "plain versions")
        x2 = s.reshape(S, S, S, C).permute(0, 3, 1, 2)
        w2 = kernel.to(bf).contiguous(memory_format=torch.channels_last)
        kb = kernel.to(bf)
        t = {
            "ring shift + conv (kernel)":
                cuda_ms(lambda: fused_shift_conv(x, kernel, bias), args.reps),
            "plain pair (depth_shift, then cuDNN conv)":
                cuda_ms(lambda: conv3d_as_2d(depth_shift(x, SHIFT_SIZE), kb,
                                             bias, (1, 1, 1), bf), args.reps),
            "cuDNN conv alone on the pre-shifted operand":
                cuda_ms(lambda: F.conv2d(x2, w2, padding=1), args.reps),
            "block #1 (restages the operand for every depth)":
                cuda_ms(lambda: fused_shift_conv_block([x], kernel, bias,
                                                       [None]), args.reps),
            "ring shift alone (kernel)":
                cuda_ms(lambda: depth_shift_ring(x), args.reps),
            "plain depth_shift":
                cuda_ms(lambda: depth_shift(x, SHIFT_SIZE), args.reps),
        }
    for k, v in t.items():
        print(f"  {k}: {v:.4f} ms", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
