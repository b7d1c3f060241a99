"""DSFF masks at inference: which parameters carry one, baking them into
the weights (w * mask), loading a masks-only artifact, and the overall
density. Counterpart of the inference subset of e2enet_tpu/training/dsff.py
(is_masked_path, apply_masks, masks_density) and of bench.py's artifact
load, in the port's layouts. numpy and torch only.

A mask is stored (in, out), as the reference stores it, and broadcast over
the spatial kernel dims:
  conv kernel        (CO, C, kh, kw)           * mask.T[:, :, None, None]
  transp-conv kernel (Cin, Cout, sd, sh, sw)   * mask[:, :, None, None, None]

The artifact (experiments/logs/bench_masks_trained.npz) keys its masks by
the flax path joined with '|' ('loc0_0|block0|kernel'); the port's name is
the same path joined with '.'.
"""
from pathlib import Path
from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn

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


def mask_shape(param: torch.Tensor) -> Tuple[int, int]:
    """(in, out) of a conv (CO, C, kh, kw) or transp-conv (Cin, Cout, ...)
    kernel."""
    if param.dim() == 4:
        return int(param.shape[1]), int(param.shape[0])
    if param.dim() == 5:
        return int(param.shape[0]), int(param.shape[1])
    raise ValueError(f"no mask layout for a kernel of rank {param.dim()}")


def broadcast_mask(mask: torch.Tensor, param: torch.Tensor) -> torch.Tensor:
    """An (in, out) mask shaped to broadcast over the kernel's layout."""
    if param.dim() == 4:
        return mask.t()[:, :, None, None]
    return mask[:, :, None, None, None]


def apply_masks_to(tensors: Dict[str, torch.Tensor], masks) -> None:
    """t *= mask in place for every named tensor with a mask (a kernel or
    its optimizer state, in the kernel's layout); masks are (in, out)
    numpy arrays or tensors, checked against each tensor's (in, out)."""
    with torch.no_grad():
        for name, m in masks.items():
            t = tensors[name]
            if tuple(m.shape) != mask_shape(t):
                raise ValueError(f"{name}: mask {tuple(m.shape)} for a "
                                 f"kernel of (in, out) {mask_shape(t)}")
            mt = torch.as_tensor(m, dtype=t.dtype, device=t.device)
            t.mul_(broadcast_mask(mt, t))


def apply_masks(model: nn.Module, masks) -> None:
    """w *= mask on every masked kernel, in place (reference apply_masks:
    the reference's inference semantics). Each mask must have its
    kernel's (in, out) shape."""
    apply_masks_to(masked_params(model), masks)


def load_mask_artifact(path, model: nn.Module) -> Dict[str, np.ndarray]:
    """The masks of a masks-only .npz keyed by '|'-joined flax paths, as
    {port name: (in, out) float32}. Refuses a missing or an extra key and a
    mask whose shape is not its kernel's (in, out)."""
    with np.load(path) as z:
        flax_masks = {k: z[k] for k in z.files}
    return masks_for_model(flax_masks, model, f"mask artifact {path}")


def masks_for_model(flax_masks, model: nn.Module, what: str = "masks"
                    ) -> Dict[str, np.ndarray]:
    """{'|'-joined flax path: (in, out) mask} (a checkpoint's or an
    artifact's) as {port name: (in, out) float32}, checked against the
    model: no missing or extra key, every mask its kernel's (in, out)."""
    params = masked_params(model)
    masks = {k.replace("|", "."): np.asarray(v, np.float32)
             for k, v in flax_masks.items()}
    missing = sorted(set(params) - set(masks))
    extra = sorted(set(masks) - set(params))
    if missing or extra:
        raise ValueError(f"{what} does not fit the model: missing "
                         f"{missing[:4]}, extra {extra[:4]}")
    for name, m in masks.items():
        if m.shape != mask_shape(params[name]):
            raise ValueError(f"{name}: mask {m.shape} for a kernel of "
                             f"(in, out) {mask_shape(params[name])}")
    return masks


def save_mask_artifact(path, masks) -> None:
    """Write {port name: (in, out) mask} as the masks-only .npz that
    load_mask_artifact reads: keys the '|'-joined paths, values float32."""
    arrays = {name.replace(".", "|"): np.asarray(
        m.detach().cpu() if isinstance(m, torch.Tensor) else m, np.float32)
        for name, m in masks.items()}
    with open(path, "wb") as f:
        np.savez_compressed(f, **arrays)


def masks_density(masks, model: nn.Module) -> float:
    """Element density over the masked kernels (reference masks_density):
    each (in, out) entry counts its kernel's spatial taps."""
    params = masked_params(model)
    nz = tot = 0.0
    for name, m in masks.items():
        taps = int(np.prod(params[name].shape[2:]))
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
