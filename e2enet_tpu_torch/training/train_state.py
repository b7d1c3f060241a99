"""The train state, the train step and the eval step, SGD only: the port of
e2enet_tpu/training/train_state.py (TrainState, create_train_state,
global_norm, clip_by_global_norm, sgd_nesterov_update, mask_opt_state,
make_train_step, make_eval_step, make_mask_update_step).

One step is the reference trainer's inner loop (nnUNetTrainer_simple.
run_iteration): forward with deep supervision, DC+CE loss (batch dice or
per-sample dice), backward, gradient clipping at global norm 12, SGD with
nesterov momentum 0.99 and weight decay 3e-5 (torch.optim.SGD semantics:
decay added to the gradient, b = m b + g, update g + m b), then the DSFF
masks re-applied to the parameters and the momentum. The eval step is the
validation iteration: the loss and the hard tp/fp/fn of the full-resolution
head (run_online_evaluation), without a gradient.

The parameters live in the model (float32); the momentum is a dict of
tensors by parameter name. Both are updated in place, which keeps one copy
of each on the card; the returned state holds the same tensors. Gradients
are the full gradients, dead kernels included (the masks are applied after
the update), as the reference's. Every result stays on the device: nothing
here waits for the card.

Not ported (ROADMAP Queue 1 item 4b): Ranger and Adam, the other losses,
dynamic loss weights and momentum (the trainer refuses each, naming the
item), and make_grad_step (gradient-fed DSFF updates), which raises.
"""
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

import torch
from torch import nn

from ..models.masks import apply_masks_to
from ..ops.losses import deep_supervision_loss, hard_tp_fp_fn
from . import dsff

GRAD_CLIP_NORM = 12.0
MOMENTUM = 0.99
WEIGHT_DECAY = 3e-5
NOT_PORTED_ITEM = "ROADMAP Queue 1 item 4b (train_state, the rest)"


@dataclass
class TrainState:
    params: Dict[str, nn.Parameter]       # the model's, by name
    momentum: Dict[str, torch.Tensor]
    masks: Optional[Dict[str, torch.Tensor]]   # (in, out) per masked kernel
    generator: torch.Generator            # the mask updates' draws (CPU)
    step: int = 0
    # the reference's PRNG key (uint32[2]) as a checkpoint stores it: that
    # of PRNGKey(seed), or the one a loaded checkpoint carried
    rng: Optional[np.ndarray] = None


def create_train_state(model: nn.Module, masks=None,
                       seed: int = 0) -> TrainState:
    """The model's parameters (masked in place when masks are given), zero
    momentum, a generator seeded with `seed`."""
    params = dict(model.named_parameters())
    if masks is not None:
        apply_masks_to(params, masks)
    momentum = {n: torch.zeros_like(p) for n, p in params.items()}
    return TrainState(params=params, momentum=momentum, masks=masks,
                      generator=torch.Generator().manual_seed(seed),
                      rng=np.array([0, seed], np.uint32))


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


def make_train_step(model: nn.Module, ds_weights, batch_dice: bool = True):
    """step(state, data, targets, lr) -> (state, {"loss", "grad_norm"}):
    data (B, D, H, W, C) float32, targets one integer tensor per
    deep-supervision output, finest first; batch dice unless batch_dice
    is False."""
    weights = [float(w) for w in ds_weights]

    def train_step(state: TrainState, data, targets, lr: float):
        names = list(state.params)
        outs = model(data, do_ds=True)
        loss = deep_supervision_loss(outs, targets, weights,
                                     batch_dice=batch_dice)
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


def make_eval_step(model: nn.Module, ds_weights, batch_dice: bool = True):
    """step(data, targets) -> {"loss", "tp", "fp", "fn"} on the device:
    the deep-supervision loss and the hard counts of the full-resolution
    head (reference make_eval_step, train_state.py:211-238), no
    gradient."""
    weights = [float(w) for w in ds_weights]

    def eval_step(data, targets):
        with torch.no_grad():
            outs = model(data, do_ds=True)
            loss = deep_supervision_loss(outs, targets, weights,
                                         batch_dice=batch_dice)
            tp, fp, fn = hard_tp_fp_fn(outs[0], targets[0])
        return {"loss": loss, "tp": tp, "fp": fp, "fn": fn}

    return eval_step


def make_mask_update_step(model: nn.Module, growth: str = "random",
                          granularity: str = "row"):
    """update(state, death_rate, scores=None) -> state with new masks, the
    parameters and the momentum masked by them (reference
    make_mask_update_step, train_state.py:241-267, local prune): random
    growth at row or kernel granularity."""
    if growth != "random" or granularity not in ("row", "kernel"):
        raise NotImplementedError(f"{granularity!r} granularity with "
                                  f"{growth!r} growth: "
                                  f"{dsff.NOT_PORTED_ITEM}")

    def update(state: TrainState, death_rate: float, scores=None):
        new_masks, _ = dsff.death_growth_update(
            model, state.masks, death_rate, state.generator, scores,
            granularity=granularity)
        apply_masks_to(state.params, new_masks)
        mask_opt_state(state.momentum, new_masks)
        state.masks = new_masks
        return state

    return update


def make_grad_step(*args, **kwargs):
    """The reference's plain gradient for gradient-fed DSFF updates
    (train_state.py:270-287): not ported."""
    raise NotImplementedError(f"make_grad_step: {NOT_PORTED_ITEM}")
