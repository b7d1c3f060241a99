"""What the ops' autograd functions share: whether a gradient is wanted,
the device check of a kernel launch, the flat (parts..., kernel, bias,
affines...) layout of a block op's tensors, the op whose backward is
torch's autograd of its plain version, and the refusal of a double
backward.

Every kernel op's backward is first order: the backward kernels compute
first derivatives, and _PlainVJP takes torch's autograd of the plain
version without building a graph of it. A double backward through any of
them (torch.autograd.grad(..., create_graph=True), a Hessian-vector
product) would drop terms of the second derivative without a word, so
each backward raises instead (first_order_only). Second derivatives run
the model under ops.blocks.plain_ops(), whose plain versions torch
differentiates twice (training/dsff.init_masks_grasp)."""
import torch


def needs_grad(tensors) -> bool:
    """Whether autograd records an op on these tensors (None skipped)."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def check_device(name, tensors):
    """The one CUDA device of a kernel's tensors; raises otherwise."""
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: tensors on several devices")
    return dev


def affine_tensors(affines) -> list:
    """The flat (mult, off, ...) list of the affines that are not None."""
    return [t for a in affines if a is not None for t in a]


def unflatten_affines(has_affine, tensors):
    """affine_tensors' inverse: per part (mult, off) or None."""
    out, i = [], 0
    for h in has_affine:
        out.append((tensors[i], tensors[i + 1]) if h else None)
        i += 2 if h else 0
    return out


def grad_like(g, t):
    """g summed to t's shape (an affine given as (C,) for every sample)
    and cast to t's dtype; None stays None."""
    if g is None:
        return None
    if g.shape != t.shape:
        g = g.reshape(-1, *t.shape).sum(dim=0)
    return g.to(t.dtype)


def block_cotangents(y, gy, gstats):
    """(gy, gstats) of a block's outputs, zeros where autograd gives None
    (an output that reached no loss)."""
    if gy is None:
        gy = torch.zeros_like(y)
    if gstats is None:
        gstats = torch.zeros((y.shape[0], y.shape[-1], 2),
                             dtype=torch.float32, device=y.device)
    return gy, gstats


def affine_grads(affines, gaffines) -> list:
    """The flat (g mult, g off) list of the parts with an affine, shaped and
    typed as the affines."""
    out = []
    for a, g in zip(affines, gaffines):
        if a is not None:
            out += ([None, None] if g is None else
                    [grad_like(g[0], a[0]), grad_like(g[1], a[1])])
    return out


def wanted_parts(needs, n_parts, has_affine):
    """Per part: whether the part or its affine needs a gradient, from
    ctx.needs_input_grad laid out (parts..., kernel, bias, affines...)."""
    want, i = [], n_parts + 2
    for p, h in enumerate(has_affine):
        w = needs[p]
        if h:
            w = w or needs[i] or needs[i + 1]
            i += 2
        want.append(w)
    return want


def first_order_only(name: str) -> None:
    """Raise inside a kernel op's backward when autograd is building a
    graph of it (create_graph=True: grad mode is on in the backward only
    then)."""
    if torch.is_grad_enabled():
        raise RuntimeError(
            f"{name}: a double backward (create_graph=True) through a "
            f"hand-written kernel's op; its backward is first order and "
            f"would drop terms. Run the model under "
            f"e2enet_tpu_torch.ops.blocks.plain_ops() for second "
            f"derivatives")


class _PlainVJP(torch.autograd.Function):
    """An op whose backward is torch's autograd of its plain version
    recomputed on the saved inputs, as the reference's custom VJPs delegate
    to jax.vjp of their XLA twins."""

    @staticmethod
    def forward(ctx, fns, *tensors):
        op, ref = fns
        ctx.ref = ref
        ctx.save_for_backward(*tensors)
        return op(*tensors)

    @staticmethod
    def backward(ctx, *gouts):
        first_order_only("plain_vjp")
        need = ctx.needs_input_grad[1:]
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(n)
                      for t, n in zip(ctx.saved_tensors, need)]
            outs = ctx.ref(*inputs)
            outs = outs if isinstance(outs, tuple) else (outs,)
            pairs = [(o, g) for o, g in zip(outs, gouts)
                     if g is not None and o.requires_grad]
            wrt = [t for t in inputs if t.requires_grad]
            grads = iter(torch.autograd.grad(
                [o for o, _ in pairs], wrt, [g for _, g in pairs],
                allow_unused=True) if pairs and wrt else [None] * len(wrt))
        return (None, *[next(grads) if n else None for n in need])


def plain_vjp(op, ref, tensors):
    """op(*tensors) (the kernel on CUDA tensors) as an autograd op whose
    backward is the autograd of ref(*tensors), its plain version."""
    return _PlainVJP.apply((op, ref), *tensors)
