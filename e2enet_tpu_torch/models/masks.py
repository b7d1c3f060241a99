"""DSFF masks at inference: which parameters carry one, baking them into
the weights (w * mask), loading a masks-only artifact, and the overall
density. Counterpart of the inference subset of e2enet_tpu/training/dsff.py
(is_masked_path, apply_masks, masks_density) and of bench.py's artifact
load, in the port's layouts. numpy and torch only.

A mask has one of two granularities (reference mask_granularity,
dsff.py:305-315). A kernel-pair (or row) mask is stored (in, out), as the
reference stores it, and broadcast over the spatial kernel dims:
  conv kernel        (CO, C, kh, kw)           * mask.T[:, :, None, None]
                     (CO, C, kd, kh, kw)       * mask.T[:, :, None, None, None]
  transp-conv kernel (Cin, Cout, sd, sh, sw)   * mask[:, :, None, None, None]
A kernel's name tells a transposed conv's from a full 3D conv's (both rank
5; models/weights.is_transposed); the helpers here take `transposed` and,
without it, take rank 5 as a transposed conv's (every masked rank-5 kernel
but those of allConv3x3's nest).
An element mask has its kernel's full shape, in the port's layout on the
port's side and in the flax layout ((kh, kw, in, out), (kd, kh, kw, in,
out)) in checkpoints and artifacts; it crosses between the two by the
weights' own permutations (models/weights.py). The rank tells the two
apart: 2 is (in, out), 4 or 5 is element.

The artifact (experiments/logs/bench_masks_trained.npz) keys its masks by
the flax path joined with '|' ('loc0_0|block0|kernel'); the port's name is
the same path joined with '.'.
"""
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .weights import is_transposed, kernel_perm, kernel_unperm

MASKED_TOKENS = ("loc", "up")
EXCLUDED_TOKENS = ("context",)


def is_masked_path(path: Tuple[str, ...], leaf_name: str) -> bool:
    """The reference's targeting (core_channel.py:320-336): kernels whose
    path holds 'loc' or 'up' and not 'context'."""
    if leaf_name != "kernel":
        return False
    joined = "/".join(path)
    if any(t in joined for t in EXCLUDED_TOKENS):
        return False
    return any(t in joined for t in MASKED_TOKENS)


def masked_params(model: nn.Module) -> Dict[str, torch.nn.Parameter]:
    """{port name: parameter} of every kernel that carries a mask."""
    out = {}
    for name, p in model.named_parameters():
        *path, leaf = name.split(".")
        if is_masked_path(tuple(path), leaf):
            out[name] = p
    return out


def transposed_name(name: str) -> bool:
    """Whether the port parameter `name` is a transposed conv's kernel."""
    return is_transposed(name.split("."))


def _transposed(param: torch.Tensor, transposed: Optional[bool]) -> bool:
    if param.dim() not in (4, 5):
        raise ValueError(f"no mask layout for a kernel of rank "
                         f"{param.dim()}")
    return param.dim() == 5 if transposed is None else transposed


def mask_shape(param: torch.Tensor, transposed: Optional[bool] = None
               ) -> Tuple[int, int]:
    """(in, out) of a conv (CO, C, ...) or transp-conv (Cin, Cout, ...)
    kernel."""
    if _transposed(param, transposed):
        return int(param.shape[0]), int(param.shape[1])
    return int(param.shape[1]), int(param.shape[0])


def is_element_mask(mask) -> bool:
    """Whether a mask is element-granular (its kernel's full shape, rank 4
    or 5) rather than (in, out)."""
    return len(mask.shape) != 2


def check_mask(name: str, mask, param: torch.Tensor) -> None:
    """Raise unless the mask is the kernel's (in, out) or, element-
    granular, its full shape in the port's layout."""
    io = mask_shape(param, transposed_name(name))
    want = tuple(param.shape) if is_element_mask(mask) else io
    if tuple(mask.shape) != want:
        raise ValueError(f"{name}: mask {tuple(mask.shape)} for a kernel of "
                         f"shape {tuple(param.shape)} (in, out) {io}")


def broadcast_mask(mask: torch.Tensor, param: torch.Tensor,
                   transposed: Optional[bool] = None) -> torch.Tensor:
    """A mask shaped to broadcast over the kernel's layout: an (in, out)
    mask over the spatial dims, an element mask as it is."""
    if is_element_mask(mask):
        return mask
    taps = (None,) * (param.dim() - 2)
    if _transposed(param, transposed):
        return mask[(slice(None), slice(None)) + taps]
    return mask.t()[(slice(None), slice(None)) + taps]


def apply_masks_to(tensors: Dict[str, torch.Tensor], masks) -> None:
    """t *= mask in place for every named tensor with a mask (a kernel or
    its optimizer state, in the kernel's layout); masks are numpy arrays or
    tensors, (in, out) or element-granular, checked against each tensor
    (check_mask)."""
    with torch.no_grad():
        for name, m in masks.items():
            t = tensors[name]
            check_mask(name, m, t)
            mt = torch.as_tensor(m, dtype=t.dtype, device=t.device)
            t.mul_(broadcast_mask(mt, t, transposed_name(name)))


def apply_masks(model: nn.Module, masks) -> None:
    """w *= mask on every masked kernel, in place (reference apply_masks:
    the reference's inference semantics). Each mask must have its
    kernel's (in, out) shape or its full shape."""
    apply_masks_to(masked_params(model), masks)


def load_mask_artifact(path, model: nn.Module) -> Dict[str, np.ndarray]:
    """The masks of a masks-only .npz keyed by '|'-joined flax paths, as
    {port name: float32 mask in the port's layout} (masks_for_model)."""
    with np.load(path) as z:
        flax_masks = {k: z[k] for k in z.files}
    return masks_for_model(flax_masks, model, f"mask artifact {path}")


def masks_for_model(flax_masks, model: nn.Module, what: str = "masks",
                    sep: str = "|") -> Dict[str, np.ndarray]:
    """{sep-joined flax path: mask in the flax layout} (a checkpoint's, its
    fired masks' or an artifact's) as {port name: float32 mask in the
    port's layout}, checked against the model: no missing or extra key,
    every mask its kernel's (in, out) or its full shape (check_mask)."""
    params = masked_params(model)
    masks = {}
    for k, v in flax_masks.items():
        m = np.asarray(v, np.float32)
        if is_element_mask(m):
            m = np.ascontiguousarray(m.transpose(
                kernel_perm(k.split(sep), m.ndim)))
        masks[k.replace(sep, ".")] = m
    missing = sorted(set(params) - set(masks))
    extra = sorted(set(masks) - set(params))
    if missing or extra:
        raise ValueError(f"{what} does not fit the model: missing "
                         f"{missing[:4]}, extra {extra[:4]}")
    for name, m in masks.items():
        check_mask(name, m, params[name])
    return masks


def masks_to_flax(masks, sep: str = "|") -> Dict[str, np.ndarray]:
    """masks_for_model's inverse: {port name: mask} as {sep-joined flax
    path: float32 numpy mask in the flax layout}."""
    out = {}
    for name, m in masks.items():
        a = np.asarray(m.detach().cpu().float() if isinstance(
            m, torch.Tensor) else m, np.float32)
        if is_element_mask(a):
            a = np.ascontiguousarray(a.transpose(
                kernel_unperm(name.split("."), a.ndim)))
        out[name.replace(".", sep)] = a
    return out


def save_mask_artifact(path, masks) -> None:
    """Write {port name: mask} as the masks-only .npz that
    load_mask_artifact reads: keys the '|'-joined paths, values float32 in
    the flax layout."""
    with open(path, "wb") as f:
        np.savez_compressed(f, **masks_to_flax(masks))


def masks_density(masks, model: nn.Module) -> float:
    """Element density over the masked kernels (reference masks_density,
    dsff.py:348-359): each (in, out) entry counts its kernel's spatial
    taps, each entry of an element mask once."""
    params = masked_params(model)
    nz = tot = 0.0
    for name, m in masks.items():
        taps = (1 if is_element_mask(m)
                else int(np.prod(params[name].shape[2:])))
        nz += float(m.sum()) * taps
        tot += int(np.prod(m.shape)) * taps
    return nz / tot


BENCH_MASKS = (Path(__file__).resolve().parents[2] / "experiments" / "logs"
               / "bench_masks_trained.npz")


def bake_masks(model: nn.Module, masks):
    """The masks baked into the model's weights (w * mask) and the
    row-sparse plan built from them, returned and not attached (None when
    the masks are not row-structured)."""
    from .sparse_plan import build_sparse_plan
    apply_masks(model, masks)
    return build_sparse_plan(masks)


def attach_masks(model: nn.Module, path=BENCH_MASKS):
    """The bench's sparse serving configuration on `model` (weights already
    loaded): the artifact's masks baked into the weights (w * mask) and the
    row-sparse plan built from them and attached. Returns (masks, plan)."""
    masks = load_mask_artifact(path, model)
    plan = bake_masks(model, masks)
    if plan is None:
        raise ValueError(f"{path}: the masks are not row-structured")
    model.set_sparse_plan(plan)
    return masks, plan
