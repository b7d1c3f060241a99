"""The train state and the train step, SGD only: the port of
e2enet_tpu/training/train_state.py (TrainState, create_train_state,
global_norm, clip_by_global_norm, sgd_nesterov_update, mask_opt_state,
make_train_step, make_mask_update_step).

One step is the reference trainer's inner loop (nnUNetTrainer_simple.
run_iteration): forward with deep supervision, DC+CE loss, backward,
gradient clipping at global norm 12, SGD with nesterov momentum 0.99 and
weight decay 3e-5 (torch.optim.SGD semantics: decay added to the
gradient, b = m b + g, update g + m b), then the DSFF masks re-applied to
the parameters and the momentum.

The parameters live in the model (float32); the momentum is a dict of
tensors by parameter name. Both are updated in place, which keeps one copy
of each on the card; the returned state holds the same tensors. Gradients
are the full gradients, dead kernels included (the masks are applied after
the update), as the reference's.
"""
from dataclasses import dataclass
from typing import Dict, Optional

import torch
from torch import nn

from ..models.masks import apply_masks_to
from ..ops.losses import deep_supervision_loss
from . import dsff

GRAD_CLIP_NORM = 12.0
MOMENTUM = 0.99
WEIGHT_DECAY = 3e-5


@dataclass
class TrainState:
    params: Dict[str, nn.Parameter]       # the model's, by name
    momentum: Dict[str, torch.Tensor]
    masks: Optional[Dict[str, torch.Tensor]]   # (in, out) per masked kernel
    generator: torch.Generator            # the mask updates' draws (CPU)
    step: int = 0


def create_train_state(model: nn.Module, masks=None,
                       seed: int = 0) -> TrainState:
    """The model's parameters (masked in place when masks are given), zero
    momentum, a generator seeded with `seed`."""
    params = dict(model.named_parameters())
    if masks is not None:
        apply_masks_to(params, masks)
    momentum = {n: torch.zeros_like(p) for n, p in params.items()}
    return TrainState(params=params, momentum=momentum, masks=masks,
                      generator=torch.Generator().manual_seed(seed))


def global_norm(tree: Dict[str, torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum((g.float().square().sum() for g in tree.values()),
                          torch.zeros((), device=next(iter(
                              tree.values())).device)))


def clip_by_global_norm(tree: Dict[str, torch.Tensor], max_norm: float):
    """(tree scaled by min(1, max_norm / (norm + 1e-6)), norm)."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    return {n: g * scale for n, g in tree.items()}, norm


def sgd_nesterov_update(params, momentum, grads, lr: float) -> None:
    """torch.optim.SGD(momentum=0.99, nesterov=True, weight_decay=3e-5) on
    the tensors, in place."""
    with torch.no_grad():
        for n, p in params.items():
            g = grads[n].float() + WEIGHT_DECAY * p
            b = momentum[n]
            b.mul_(MOMENTUM).add_(g)
            p.sub_(lr * (g + MOMENTUM * b))


def mask_opt_state(momentum, masks) -> None:
    """The masks applied to the momentum, in place (reference's
    momentum-buffer zeroing)."""
    if masks is not None:
        apply_masks_to(momentum, masks)


def make_train_step(model: nn.Module, ds_weights):
    """step(state, data, targets, lr) -> (state, {"loss", "grad_norm"}):
    data (B, D, H, W, C) float32, targets one integer tensor per
    deep-supervision output, finest first; batch dice."""
    weights = [float(w) for w in ds_weights]

    def train_step(state: TrainState, data, targets, lr: float):
        names = list(state.params)
        outs = model(data, do_ds=True)
        loss = deep_supervision_loss(outs, targets, weights)
        got = torch.autograd.grad(loss, [state.params[n] for n in names],
                                  allow_unused=True)
        grads = {n: torch.zeros_like(state.params[n]) if g is None else g
                 for n, g in zip(names, got)}
        grads, gnorm = clip_by_global_norm(grads, GRAD_CLIP_NORM)
        sgd_nesterov_update(state.params, state.momentum, grads, lr)
        if state.masks is not None:
            apply_masks_to(state.params, state.masks)
            mask_opt_state(state.momentum, state.masks)
        state.step += 1
        return state, {"loss": loss.detach(), "grad_norm": gnorm.detach()}

    return train_step


def make_mask_update_step(model: nn.Module, growth: str = "random",
                          granularity: str = "row"):
    """update(state, death_rate, scores=None) -> state with new masks, the
    parameters and the momentum masked by them (reference
    make_mask_update_step, local prune; row granularity with random growth
    only)."""
    if growth != "random" or granularity != "row":
        raise ValueError(f"only row granularity with random growth, not "
                         f"{granularity!r} / {growth!r}")

    def update(state: TrainState, death_rate: float, scores=None):
        new_masks, _ = dsff.death_growth_update(
            model, state.masks, death_rate, state.generator, scores)
        apply_masks_to(state.params, new_masks)
        mask_opt_state(state.momentum, new_masks)
        state.masks = new_masks
        return state

    return update
