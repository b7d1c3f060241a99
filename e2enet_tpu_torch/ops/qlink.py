"""The links between level 0 and level 1, and the seg head, each reading a
pending raw tensor (a fused block's output with its instance norm not yet
applied) once. Counterpart of e2enet_tpu/ops/qlink.py, whose Pallas
kernels work on the quadrant layout; the port is channels-last
(N, D, H, W, C) with no quadrant or padded layout. Each op rounds where its
reference kernel does, which differs per op:

  uplink    (_uplink_kernel)   u = lrelu(x * m + o) in the compute dtype,
                               m and o rounded to it first (reference
                               qlink.py:106-113); then the k == s transposed
                               conv, float32 sums, stored in x's dtype
                               straight to the finer level's channels-last
                               positions (no depth-to-space copy)
  downlink  (_downlink_kernel) max and min of the raw over each window, the
                               max where mult > 0 and the min elsewhere,
                               then lrelu(pick * mult + off) in float32,
                               stored in x's dtype (exactly the max pool of
                               the normalised tensor: the apply is monotone)
  seghead   (_seghead_probs_kernel, and _seghead_kernel as its logits mode)
                               u = lrelu(x * mult + off) in float32, rounded
                               to x's dtype; 1x1 conv with float32 sums;
                               then either float32 logits or a max-subtracted
                               float32 class softmax stored as probs_dtype

flips: the down-link and the seg head are flip-equivariant as they are;
the up-link's mirrored op reverses its kernel along the mirrored axes
(reference blocks.flip_transp_kernel).

Each op runs its CUDA kernel (csrc/qlink.cu) for CUDA tensors and its plain
torch version (`*_ref`) for CPU tensors. The up-link and the seg head each
have two routes, chosen by the library's rule from the shapes and the
alignment (`uplink.routes`, `seghead.routes` count them): "bulk", the
design for this card (bulk copies in and out with the next tile in flight,
the products on tensor cores), and "ldg", the first design, for the shapes
the bulk copies do not take. Where a gradient is wanted each is
an autograd op. The down-link's backward is TPU kernel #8
(e2enet_tpu/ops/qlink.py:_downlink_bwd_kernel), `downlink_bwd`: the CUDA
kernel for CUDA tensors, `downlink_bwd_ref` for CPU tensors; it recomputes
the raw running max/min chains over each window and routes the gradient
along the chain with maximum's subgradient, a tie splitting 0.5 at every
pairwise step. The up-link's and the seg head's backward is torch's
autograd of their plain versions, as the reference delegates to jax.vjp of
its XLA twins; those write the leaky relu as jnp.maximum(a, a * slope)
does (ops.fused_block.lrelu_max).
"""
from typing import Optional, Tuple

import torch

from .autograd import (check_device, first_order_only, grad_like, needs_grad,
                       plain_vjp)
from .fused_block import LRELU_SLOPE, NO_FLIPS, Flips, affine_nc, lrelu_max


def flip_transp_kernel(kernel: torch.Tensor, flips: Flips) -> torch.Tensor:
    """A (Cin, Cout, sd, sh, sw) transposed-conv kernel (kernel == stride)
    of the mirrored op: y[s*j + r] = x[j] * k[r], so mirroring an axis
    reverses the kernel's entries along it (r <-> s-1-r)."""
    dims = [2 + a for a in range(3) if flips[a]]
    return kernel.flip(dims) if dims else kernel


def _check_cuda(name, tensors, dtype=torch.bfloat16):
    dev = check_device(name, tensors)
    x = tensors[0]
    if x.dtype != dtype or x.dim() != 5:
        raise TypeError(f"the CUDA {name} takes a bfloat16 (N, D, H, W, C) "
                        f"tensor")
    return dev


# --------------------------------------------------------------------------
# up-link: pending raw -> compute-dtype norm + lrelu -> k == s transposed conv

def uplink_ref(x: torch.Tensor, mult: torch.Tensor, off: torch.Tensor,
               kernel: torch.Tensor, flips: Flips = NO_FLIPS) -> torch.Tensor:
    """Plain torch version. x (N, D, H, W, Cin), mult/off (Cin,) or
    (N, Cin), kernel (Cin, Cout, sd, sh, sw) -> (N, D*sd, H*sh, W*sw, Cout)
    in x's dtype. A float32 x computes its norm in float32."""
    dtype = x.dtype
    N, D, H, W, C = x.shape
    shape = (N, 1, 1, 1, C)
    m = affine_nc(mult, N, C).to(dtype).reshape(shape)
    o = affine_nc(off, N, C).to(dtype).reshape(shape)
    u = lrelu_max(x * m + o)
    k = flip_transp_kernel(kernel, flips).to(dtype).float()
    cout, (sd, sh, sw) = k.shape[1], k.shape[2:]
    w2 = k.permute(0, 2, 3, 4, 1).reshape(C, sd * sh * sw * cout)
    y = (u.float() @ w2).to(dtype)
    y = y.reshape(N, D, H, W, sd, sh, sw, cout).permute(0, 1, 4, 2, 5, 3, 6, 7)
    return y.reshape(N, D * sd, H * sh, W * sw, cout)


def uplink_image_ref(kernel: torch.Tensor,
                     flips: Flips = NO_FLIPS) -> torch.Tensor:
    """Plain version of the weights' image the CUDA up-link packs once per
    call (csrc/qlink.cu: uplink_image_kernel) and its products read: a
    (Cin, Cout, sd, sh, sw) kernel -> (sd*sh, NWs, Cs + 8) in its dtype,
    [bd*sh + bh, bw*Cout + co, c] = k[c, co, bd, bh, bw] of the mirrored
    kernel: chunk (bd, bh) holds the NW = sw*Cout columns of one finer row
    per coarse voxel (uplink_ref's columns, ch*NW + col). Zero past NW (NWs
    rounds it up to 16) and past Cin (Cs rounds it up to 16; 8 more values
    pad each row)."""
    k = flip_transp_kernel(kernel, flips)
    C, cout, sd, sh, sw = (int(v) for v in k.shape)
    nw = sw * cout
    img = k.new_zeros((sd * sh, -(-nw // 16) * 16, -(-C // 16) * 16 + 8))
    img[:, :nw, :C] = k.permute(2, 3, 4, 1, 0).reshape(sd * sh, nw, C)
    return img


def uplink(x: torch.Tensor, mult: torch.Tensor, off: torch.Tensor,
           kernel: torch.Tensor, flips: Flips = NO_FLIPS) -> torch.Tensor:
    """The up-link: plain version for CPU tensors, the CUDA kernel for CUDA
    tensors (bfloat16). Same arguments and result as uplink_ref; with a
    gradient wanted, an autograd op whose backward is uplink_ref's."""
    if needs_grad((x, mult, off, kernel)):
        return plain_vjp(lambda *t: _uplink_forward(*t, flips),
                         lambda *t: uplink_ref(*t, flips),
                         (x, mult, off, kernel))
    return _uplink_forward(x, mult, off, kernel, flips)


def _uplink_forward(x, mult, off, kernel, flips):
    if x.device.type == "cpu":
        return uplink_ref(x, mult, off, kernel, flips)
    dev = _check_cuda("uplink", (x, mult, off, kernel))
    N, D, H, W, C = (int(v) for v in x.shape)
    if kernel.dim() != 5 or int(kernel.shape[0]) != C:
        raise ValueError(f"kernel {tuple(kernel.shape)} does not fit Cin={C}")
    cout = int(kernel.shape[1])
    sd, sh, sw = (int(v) for v in kernel.shape[2:])
    from . import _native
    # the library packs the (mirrored) kernel into the image its products
    # read: chunk (bd, bh) is one finer row of sw*Cout contiguous values per
    # coarse voxel
    k = flip_transp_kernel(kernel, flips).to(x.dtype).contiguous()
    y = torch.empty((N, D * sd, H * sh, W * sw, cout), dtype=x.dtype,
                    device=dev)
    route = _native.launch_uplink(x.contiguous(), affine_nc(mult, N, C),
                                  affine_nc(off, N, C), k, y, (sd, sh, sw))
    uplink.launches += 1
    uplink.routes[route] += 1
    return y


uplink.launches = 0
# per route (csrc/qlink.cu: uplink_route): "bulk" uplink_kernel, "ldg" the
# first design uplink_ldg_kernel
uplink.routes = {"bulk": 0, "ldg": 0}


# --------------------------------------------------------------------------
# down-link: pending raw -> window max/min -> float32 norm + lrelu

def downlink_ref(x: torch.Tensor, mult: torch.Tensor, off: torch.Tensor,
                 window: Tuple[int, int, int] = (2, 2, 2)) -> torch.Tensor:
    """Plain torch version. x (N, D, H, W, C), mult/off (C,) or (N, C) ->
    (N, D//wd, H//wh, W//ww, C) in x's dtype (a ragged edge is dropped)."""
    wd, wh, ww = window
    N, D, H, W, C = x.shape
    Do, Ho, Wo = D // wd, H // wh, W // ww
    xw = x[:, :Do * wd, :Ho * wh, :Wo * ww].reshape(N, Do, wd, Ho, wh, Wo,
                                                    ww, C)
    m = affine_nc(mult, N, C)
    o = affine_nc(off, N, C)
    pick = torch.where((m > 0).reshape(N, 1, 1, 1, C),
                       xw.amax(dim=(2, 4, 6)), xw.amin(dim=(2, 4, 6)))
    shape = (N, 1, 1, 1, C)
    a = pick.float() * m.reshape(shape) + o.reshape(shape)
    return lrelu_max(a).to(x.dtype)


def downlink(x: torch.Tensor, mult: torch.Tensor, off: torch.Tensor,
             window: Tuple[int, int, int] = (2, 2, 2)) -> torch.Tensor:
    """The down-link: plain version for CPU tensors, the CUDA kernel for
    CUDA tensors (bfloat16). Same arguments and result as downlink_ref;
    with a gradient wanted, an autograd op whose backward is
    downlink_bwd."""
    if needs_grad((x, mult, off)):
        return _DownlinkFn.apply(tuple(int(v) for v in window), x, mult, off)
    return _downlink_forward(x, mult, off, window)


def _downlink_forward(x, mult, off, window):
    if x.device.type == "cpu":
        return downlink_ref(x, mult, off, window)
    dev = _check_cuda("downlink", (x, mult, off))
    N, D, H, W, C = (int(v) for v in x.shape)
    wd, wh, ww = (int(v) for v in window)
    from . import _native
    y = torch.empty((N, D // wd, H // wh, W // ww, C), dtype=x.dtype,
                    device=dev)
    _native.launch_downlink(x.contiguous(), affine_nc(mult, N, C),
                            affine_nc(off, N, C), y, (wd, wh, ww))
    downlink.launches += 1
    return y


downlink.launches = 0


def downlink_bwd_ref(x: torch.Tensor, mult: torch.Tensor, off: torch.Tensor,
                     gy: torch.Tensor, window: Tuple[int, int, int] = (2, 2, 2)):
    """Plain torch version of the down-link's backward (TPU kernel #8): x
    the forward's input, gy the cotangent of its output. The window's
    elements are taken in the reference's block order (bd, bh, bw); along
    the running max (mult > 0) or min chain, element k takes 1 of what
    reaches it where it beats the running value before it, 0.5 where it
    ties, and passes the rest on. Returns (gx in x's dtype, zero on a
    ragged edge; g mult, g off (N, C) float32)."""
    wd, wh, ww = window
    N, D, H, W, C = x.shape
    Do, Ho, Wo = D // wd, H // wh, W // ww
    Q = wd * wh * ww
    xw = x[:, :Do * wd, :Ho * wh, :Wo * ww].reshape(
        N, Do, wd, Ho, wh, Wo, ww, C).permute(0, 1, 3, 5, 2, 4, 6, 7) \
        .reshape(N, Do, Ho, Wo, Q, C).float()
    shape = (N, 1, 1, 1, C)
    m = affine_nc(mult, N, C).reshape(shape)
    o = affine_nc(off, N, C).reshape(shape)
    use_max = m > 0
    run = [xw[..., 0, :]]
    for k in range(1, Q):
        xk = xw[..., k, :]
        run.append(torch.where(use_max, torch.maximum(run[-1], xk),
                               torch.minimum(run[-1], xk)))
    pick = run[-1]
    ga = gy.float()
    ga = torch.where(pick * m + o >= 0, ga, ga * LRELU_SLOPE)
    gmult = (ga * pick).sum(dim=(1, 2, 3))
    goff = ga.sum(dim=(1, 2, 3))
    g = ga * m
    gxs = [None] * Q
    for k in range(Q - 1, 0, -1):
        xk, prev = xw[..., k, :], run[k - 1]
        beats = torch.where(use_max, xk > prev, xk < prev)
        w = beats.float() + 0.5 * (xk == prev).float()
        gxs[k] = g * w
        g = g * (1.0 - w)
    gxs[0] = g
    gxw = torch.stack(gxs, dim=4).reshape(N, Do, Ho, Wo, wd, wh, ww, C) \
        .permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(N, Do * wd, Ho * wh,
                                                 Wo * ww, C)
    gx = torch.zeros_like(x)
    gx[:, :Do * wd, :Ho * wh, :Wo * ww] = gxw.to(x.dtype)
    return gx, gmult, goff


def downlink_bwd(x: torch.Tensor, mult: torch.Tensor, off: torch.Tensor,
                 gy: torch.Tensor, window: Tuple[int, int, int] = (2, 2, 2)):
    """The down-link's backward: plain version for CPU tensors, the CUDA
    kernel for CUDA tensors (bfloat16, windows of at most 8 elements, at
    most 256 channels; raises on what the kernel does not take). Same
    arguments and results as downlink_bwd_ref."""
    if x.device.type == "cpu":
        return downlink_bwd_ref(x, mult, off, gy, window)
    dev = _check_cuda("downlink_bwd", (x, mult, off, gy))
    N, D, H, W, C = (int(v) for v in x.shape)
    wd, wh, ww = (int(v) for v in window)
    if tuple(gy.shape) != (N, D // wd, H // wh, W // ww, C):
        raise ValueError(f"gy {tuple(gy.shape)} does not fit x "
                         f"{tuple(x.shape)} and window {tuple(window)}")
    from . import _native
    ragged = D % wd or H % wh or W % ww
    gx = torch.zeros_like(x) if ragged else torch.empty_like(x)
    gaff = torch.zeros((N, C, 2), dtype=torch.float32, device=dev)
    _native.launch_downlink_bwd(x.contiguous(), gy.to(x.dtype).contiguous(),
                                affine_nc(mult, N, C), affine_nc(off, N, C),
                                gx, gaff, (wd, wh, ww))
    downlink_bwd.launches += 1
    return gx, gaff[..., 0], gaff[..., 1]


downlink_bwd.launches = 0


class _DownlinkFn(torch.autograd.Function):
    """The down-link as an autograd op: forward the kernel (or its plain
    version), backward downlink_bwd (kernel #8's port)."""

    @staticmethod
    def forward(ctx, window, x, mult, off):
        ctx.window = window
        ctx.save_for_backward(x, mult, off)
        return _downlink_forward(x, mult, off, window)

    @staticmethod
    def backward(ctx, gy):
        first_order_only("downlink")
        x, mult, off = ctx.saved_tensors
        gx, gm, go = downlink_bwd(x, mult, off, gy, ctx.window)
        return (None, grad_like(gx, x), grad_like(gm, mult),
                grad_like(go, off))


# --------------------------------------------------------------------------
# seg head: pending raw -> float32 norm + lrelu -> 1x1 -> logits or probs

def seghead_ref(x: torch.Tensor, mult: torch.Tensor, off: torch.Tensor,
                weight: torch.Tensor,
                probs_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Plain torch version. x (N, D, H, W, C), mult/off (C,) or (N, C),
    weight (K, C) -> float32 logits (N, D, H, W, K), or with probs_dtype
    the class softmax (float32, max-subtracted) stored in probs_dtype."""
    N, C = x.shape[0], x.shape[-1]
    shape = (N, 1, 1, 1, C)
    a = (x.float() * affine_nc(mult, N, C).reshape(shape)
         + affine_nc(off, N, C).reshape(shape))
    u = lrelu_max(a).to(x.dtype)
    logits = u.float() @ weight.to(x.dtype).float().t()
    if probs_dtype is None:
        return logits
    return torch.softmax(logits, dim=-1).to(probs_dtype)


def seghead(x: torch.Tensor, mult: torch.Tensor, off: torch.Tensor,
            weight: torch.Tensor,
            probs_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The seg head: plain version for CPU tensors, the CUDA kernel for
    CUDA tensors (bfloat16 in; bfloat16 probs or float32 logits out). Same
    arguments and result as seghead_ref; with a gradient wanted, an
    autograd op whose backward is seghead_ref's."""
    if needs_grad((x, mult, off, weight)):
        return plain_vjp(lambda *t: _seghead_forward(*t, probs_dtype),
                         lambda *t: seghead_ref(*t, probs_dtype),
                         (x, mult, off, weight))
    return _seghead_forward(x, mult, off, weight, probs_dtype)


def _seghead_forward(x, mult, off, weight, probs_dtype):
    if x.device.type == "cpu":
        return seghead_ref(x, mult, off, weight, probs_dtype)
    dev = _check_cuda("seghead", (x, mult, off, weight))
    if probs_dtype not in (None, torch.bfloat16):
        raise TypeError("the CUDA seg head stores bfloat16 probs or float32 "
                        "logits")
    N, D, H, W, C = (int(v) for v in x.shape)
    if weight.dim() != 2 or int(weight.shape[1]) != C:
        raise ValueError(f"weight {tuple(weight.shape)} does not fit C={C}")
    K = int(weight.shape[0])
    from . import _native
    y = torch.empty((N, D, H, W, K), device=dev,
                    dtype=probs_dtype or torch.float32)
    route = _native.launch_seghead(x.contiguous(), affine_nc(mult, N, C),
                                   affine_nc(off, N, C),
                                   weight.to(x.dtype).contiguous(), y,
                                   probs_dtype is not None)
    seghead.launches += 1
    seghead.routes[route] += 1
    return y


seghead.launches = 0
# per route (csrc/qlink.cu: seghead_route): "bulk" seghead_kernel, "ldg" the
# first design seghead_ldg_kernel
seghead.routes = {"bulk": 0, "ldg": 0}
