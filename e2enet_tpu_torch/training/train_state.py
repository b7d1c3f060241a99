"""The train state, the train and eval steps and the DSFF steps: the port
of e2enet_tpu/training/train_state.py (TrainState, create_train_state,
global_norm, clip_by_global_norm, sgd_nesterov_update, AdamState,
adam_init, adam_update, mask_opt_state, make_train_step, make_eval_step,
make_mask_update_step, make_grad_step), with Ranger from ranger.py.

One step is the reference trainer's inner loop (nnUNetTrainer_simple.
run_iteration): forward with deep supervision, the configured loss (DC+CE
by default; batch dice or per-sample dice), backward, gradient clipping at
global norm 12, the optimizer, then the DSFF masks re-applied to the
parameters and to every buffer of the optimizer's state. The optimizers:
SGD with nesterov momentum 0.99 (torch.optim.SGD semantics: decay added
to the gradient, b = m b + g, update g + m b), Ranger (the
nnUNetTrainerV2_Ranger_* variants) and Adam with amsgrad (the
nnUNetTrainerV2_Adam* variants), each with weight decay 3e-5 as the
reference's step passes it. The eval step is the validation iteration:
the loss and the hard tp/fp/fn of the full-resolution head
(run_online_evaluation; per region channel for the region trainers),
without a gradient. The grad step is the plain gradient of the
deep-supervision loss that gradient-fed DSFF growth reads. With
do_ds=False (the noDeepSupervision variant) each step runs the model's
full-resolution head alone and its loss on the one target; the step
takes that head's float32 logits and refuses a probabilities head.

The parameters live in the model (float32); the optimizer's state is a
dict of tensors by parameter name (SGD's momentum) or a RangerState /
AdamState of such dicts and a step count. Both are updated in place,
which keeps one copy of each on the card; the returned state holds the
same tensors. Gradients are the full gradients, dead kernels included
(the masks are applied after the update), as the reference's. Every
result stays on the device: nothing here waits for the card.

Data parallel (group, a torch.distributed process group;
make_sharded_train_step): each rank passes its rows of the batch and the
same state (replicate_state). The loss runs under parallel/collectives.
reducing(group), so it is the whole
batch's on every rank and each rank's backward carries its own share; the
parameter gradients are then summed over the ranks, clipped at global
norm 12 and fed to the optimizer, so every rank makes the same update.
The grad step's gradients are summed alike; the eval step's loss is the
whole batch's and its tp/fp/fn are summed. The mask update needs no
communication: every rank draws from the same seeded state.generator on
the same parameters (and gradients) and reaches the same masks.
"""
from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional, Union

import numpy as np

import torch
from torch import nn

from ..models.masks import apply_masks_to
from ..ops.losses import (deep_supervision_loss, hard_tp_fp_fn,
                          hard_tp_fp_fn_regions)
from ..parallel import mesh
from ..parallel.collectives import all_reduce_sum_, all_sum, reducing
from . import dsff
from .ranger import RangerState, ranger_init, ranger_update

GRAD_CLIP_NORM = 12.0
MOMENTUM = 0.99
WEIGHT_DECAY = 3e-5
OPTIMIZERS = ("sgd", "ranger", "adam")


@dataclass
class TrainState:
    params: Dict[str, nn.Parameter]       # the model's, by name
    # SGD's momentum by name, or a RangerState / AdamState
    momentum: Union[Dict[str, torch.Tensor], RangerState, "AdamState"]
    # per masked kernel, (in, out) or element-granular
    masks: Optional[Dict[str, torch.Tensor]]
    generator: torch.Generator            # the mask updates' draws (CPU)
    step: int = 0
    # the reference's PRNG key (uint32[2]) as a checkpoint stores it: that
    # of PRNGKey(seed), or the one a loaded checkpoint carried
    rng: Optional[np.ndarray] = None


def create_train_state(model: nn.Module, masks=None, seed: int = 0,
                       optimizer: str = "sgd") -> TrainState:
    """The model's parameters (masked in place when masks are given), the
    optimizer's initial state ('sgd': zero momentum; 'ranger'; 'adam'), a
    generator seeded with `seed`."""
    if optimizer not in OPTIMIZERS:
        raise ValueError(f"unknown optimizer '{optimizer}'")
    params = dict(model.named_parameters())
    if masks is not None:
        apply_masks_to(params, masks)
    if optimizer == "ranger":
        momentum = ranger_init(params)
    elif optimizer == "adam":
        momentum = adam_init(params)
    else:
        momentum = {n: torch.zeros_like(p) for n, p in params.items()}
    return TrainState(params=params, momentum=momentum, masks=masks,
                      generator=torch.Generator().manual_seed(seed),
                      rng=np.array([0, seed], np.uint32))


def replicate_state(state: TrainState, group=None) -> TrainState:
    """The state's parameters, optimizer buffers and masks broadcast from
    rank 0 of the process group, in place (the JAX package's
    replicate_state)."""
    tensors = [p.data for p in state.params.values()]
    for d in _state_dicts(state.momentum) + [state.masks or {}]:
        tensors += list(d.values())
    for t in tensors:
        torch.distributed.broadcast(t, src=0, group=group)
    return state


def global_norm(tree: Dict[str, torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum((g.float().square().sum() for g in tree.values()),
                          torch.zeros((), device=next(iter(
                              tree.values())).device)))


def clip_by_global_norm(tree: Dict[str, torch.Tensor], max_norm: float):
    """(tree scaled by min(1, max_norm / (norm + 1e-6)), norm)."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    return {n: g * scale for n, g in tree.items()}, norm


def sgd_nesterov_update(params, momentum, grads, lr: float,
                        weight_decay: float = WEIGHT_DECAY,
                        mom: float = MOMENTUM) -> None:
    """torch.optim.SGD(momentum=mom, nesterov=True, weight_decay) on the
    tensors, in place."""
    with torch.no_grad():
        for n, p in params.items():
            g = grads[n].float() + weight_decay * p
            b = momentum[n]
            b.mul_(mom).add_(g)
            p.sub_(lr * (g + mom * b))


class AdamState(NamedTuple):
    step: int
    exp_avg: Dict[str, torch.Tensor]
    exp_avg_sq: Dict[str, torch.Tensor]
    max_exp_avg_sq: Dict[str, torch.Tensor]


def adam_init(params: Dict[str, torch.Tensor]) -> AdamState:
    def zeros():
        return {n: torch.zeros_like(p, dtype=torch.float32)
                for n, p in params.items()}
    return AdamState(step=0, exp_avg=zeros(), exp_avg_sq=zeros(),
                     max_exp_avg_sq=zeros())


def adam_update(params, state: AdamState, grads, lr: float,
                betas=(0.9, 0.999), eps: float = 1e-8,
                weight_decay: float = 0.0):
    """torch.optim.Adam(amsgrad=True) semantics, the L2 decay added to the
    gradient (reference train_state.py:96-117), on params in place in
    float32 in the reference's order of operations; returns (params, the
    new state, whose tensors are the old state's, updated in place)."""
    f = np.float32
    b1, b2 = betas
    step = state.step + 1
    bc1 = f(1) - f(b1) ** f(step)
    bc2 = f(1) - f(b2) ** f(step)
    names = list(params)
    p = [params[n] for n in names]
    m = [state.exp_avg[n] for n in names]
    v = [state.exp_avg_sq[n] for n in names]
    vmax = [state.max_exp_avg_sq[n] for n in names]
    with torch.no_grad():
        g = torch._foreach_mul(p, float(f(weight_decay)))
        torch._foreach_add_(g, [grads[n].float() for n in names])
        torch._foreach_mul_(m, float(f(b1)))
        torch._foreach_add_(m, torch._foreach_mul(g, float(f(1 - b1))))
        gg = torch._foreach_mul(g, float(f(1 - b2)))
        torch._foreach_mul_(gg, g)
        del g
        torch._foreach_mul_(v, float(f(b2)))
        torch._foreach_add_(v, gg)
        del gg
        torch._foreach_maximum_(vmax, v)
        denom = torch._foreach_div(vmax, float(bc2))
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, float(f(eps)))
        upd = torch._foreach_mul(m, float(f(lr) / bc1))
        torch._foreach_div_(upd, denom)
        del denom
        torch._foreach_sub_(p, upd)
    return params, state._replace(step=step)


def _state_dicts(opt_state):
    """The dicts of tensors by parameter name that an optimizer's state
    holds (every field but the step)."""
    if isinstance(opt_state, tuple):
        return [v for v in opt_state if isinstance(v, dict)]
    return [opt_state]


def mask_opt_state(opt_state, masks) -> None:
    """The masks applied in place to every buffer of an optimizer's state
    (SGD's momentum; Ranger's exp_avg, exp_avg_sq, slow; Adam's exp_avg,
    exp_avg_sq, max_exp_avg_sq), never to the step (reference
    train_state.py:120-131, the momentum-buffer zeroing of
    core_channel.py:427-434)."""
    if masks is not None:
        for d in _state_dicts(opt_state):
            apply_masks_to(d, masks)


def _loss_fn(ds_weights, batch_dice, loss_name, loss_kwargs):
    weights = [float(w) for w in ds_weights]

    def loss(outs, targets, extra_kw=None):
        return deep_supervision_loss(
            outs, targets, weights, batch_dice=batch_dice,
            loss_name=loss_name,
            loss_kwargs={**(loss_kwargs or {}), **(extra_kw or {})})
    return loss


def _outputs(model: nn.Module, data: torch.Tensor, do_ds: bool):
    """The model's deep-supervision logits (finest first), or with do_ds
    False its full-resolution head's logits as a one-element list. A head
    that returns probabilities (the model's head_probs_dtype) is refused:
    the losses take logits, and no head's output is taken twice through a
    nonlinearity."""
    if do_ds:
        return model(data, do_ds=True)
    out = model(data, do_ds=False)
    if out.dtype != torch.float32:
        raise TypeError(f"do_ds=False head output of dtype {out.dtype}: "
                        f"the step takes float32 logits (set the model's "
                        f"head_probs_dtype to None)")
    return [out]


def _full_grads(loss, params: Dict[str, torch.Tensor], group=None):
    """{name: d loss / d param}, zeros where a parameter has no path to
    the loss; with a group, summed over its ranks."""
    names = list(params)
    got = torch.autograd.grad(loss, [params[n] for n in names],
                              allow_unused=True)
    grads = {n: torch.zeros_like(params[n]) if g is None else g
             for n, g in zip(names, got)}
    if group is not None:
        all_reduce_sum_(list(grads.values()), group)
    return grads


def make_train_step(model: nn.Module, ds_weights, batch_dice: bool = True,
                    loss_name: str = "dc_ce", momentum: float = MOMENTUM,
                    weight_decay: float = WEIGHT_DECAY,
                    optimizer: str = "sgd", loss_kwargs=None,
                    dynamic_loss_weights: bool = False,
                    dynamic_momentum: bool = False, do_ds: bool = True,
                    group=None):
    """step(state, data, targets, lr, *extras) -> (state, {"loss",
    "grad_norm"}): data (B, D, H, W, C) float32, targets one tensor per
    deep-supervision output, finest first (do_ds=False: the
    full-resolution head alone, one target); batch dice unless batch_dice
    is False. optimizer 'sgd' | 'ranger' | 'adam' (state.momentum made by
    create_train_state with the same one); loss_name a LOSS_REGISTRY name
    with loss_kwargs. extras, floats: (weight_ce, weight_dice) when
    dynamic_loss_weights (the CE -> Dice transition), then the momentum
    when dynamic_momentum (SGD only; the momentum reduction); reference
    make_train_step, train_state.py:133-208. group: data parallel over
    its ranks, data and targets this rank's rows (the module's
    docstring)."""
    if optimizer not in OPTIMIZERS:
        raise ValueError(f"unknown optimizer '{optimizer}'")
    if dynamic_momentum and optimizer != "sgd":
        raise ValueError("dynamic momentum is an SGD-only variant")
    loss_fn = _loss_fn(ds_weights, batch_dice, loss_name, loss_kwargs)

    def train_step(state: TrainState, data, targets, lr: float, *extras):
        extras = list(extras)
        extra_kw = {}
        if dynamic_loss_weights:
            extra_kw["weight_ce"] = extras.pop(0)
            extra_kw["weight_dice"] = extras.pop(0)
        mom = extras.pop(0) if dynamic_momentum else momentum
        with reducing(group):
            loss = loss_fn(_outputs(model, data, do_ds), targets, extra_kw)
        grads, gnorm = clip_by_global_norm(
            _full_grads(loss, state.params, group), GRAD_CLIP_NORM)
        if optimizer == "sgd":
            sgd_nesterov_update(state.params, state.momentum, grads, lr,
                                weight_decay=weight_decay, mom=mom)
        elif optimizer == "ranger":
            _, state.momentum = ranger_update(
                state.params, state.momentum, grads, lr,
                weight_decay=weight_decay)
        else:
            _, state.momentum = adam_update(
                state.params, state.momentum, grads, lr,
                weight_decay=weight_decay)
        if state.masks is not None:
            apply_masks_to(state.params, state.masks)
            mask_opt_state(state.momentum, state.masks)
        state.step += 1
        return state, {"loss": loss.detach(), "grad_norm": gnorm.detach()}

    return train_step


def make_sharded_train_step(model: nn.Module, ds_weights,
                            batch_dice: bool = True, **step_kwargs):
    """make_train_step over the process group this process runs in (the
    JAX package's make_sharded_train_step on a "data" mesh): each rank
    passes its rows (parallel.shard_batch) and the replicated state; raises
    outside a group."""
    return make_train_step(model, ds_weights, batch_dice,
                           group=mesh.world_group(), **step_kwargs)


def make_eval_step(model: nn.Module, ds_weights, batch_dice: bool = True,
                   loss_name: str = "dc_ce", loss_kwargs=None,
                   dynamic_loss_weights: bool = False, do_ds: bool = True,
                   regions: bool = False, group=None):
    """step(data, targets, *extras) -> {"loss", "tp", "fp", "fn"} on the
    device: the deep-supervision loss (do_ds=False: the full-resolution
    head's alone) and the hard counts of the full-resolution head, per
    foreground class, or with regions per region channel of sigmoid > 0.5
    against region targets (reference make_eval_step, train_state.py:
    211-238), no gradient; extras (weight_ce, weight_dice) when
    dynamic_loss_weights. group: data parallel, the loss and the counts
    the whole batch's."""
    loss_fn = _loss_fn(ds_weights, batch_dice, loss_name, loss_kwargs)

    def eval_step(data, targets, *extras):
        extra_kw = ({"weight_ce": extras[0], "weight_dice": extras[1]}
                    if dynamic_loss_weights else {})
        with torch.no_grad(), reducing(group):
            outs = _outputs(model, data, do_ds)
            loss = loss_fn(outs, targets, extra_kw)
            counts = hard_tp_fp_fn_regions if regions else hard_tp_fp_fn
            tp, fp, fn = counts(outs[0], targets[0])
            if group is not None:
                tp, fp, fn = all_sum(torch.stack([tp, fp, fn]))
        return {"loss": loss, "tp": tp, "fp": fp, "fn": fn}

    return eval_step


def apply_new_masks(state: TrainState, masks) -> TrainState:
    """state.masks = masks, applied in place to the parameters and to every
    buffer of the optimizer's state (SGD, Ranger and Adam alike)."""
    apply_masks_to(state.params, masks)
    mask_opt_state(state.momentum, masks)
    state.masks = masks
    return state


def make_mask_update_step(model: nn.Module, growth: str = "random",
                          prune_mode: str = "local",
                          granularity: str = "row"):
    """update(state, death_rate, grads=None, regrow_ratio=1.0) -> state with
    new masks, the parameters and every buffer of the optimizer's state
    masked by them (reference make_mask_update_step, train_state.py:
    241-267). prune_mode 'local': the per-layer death and growth at row,
    kernel or element granularity, growth by random draws (from
    state.generator) or by gradient (grads: {name: gradient}, as
    make_grad_step returns them); 'global': truncate_weights_global on
    element masks, the regrow budget scaled by regrow_ratio (the
    gradual-density schedule's), growth by gradient."""
    dsff.check_growth(growth)
    if prune_mode not in ("local", "global"):
        raise ValueError(f"unknown prune_mode {prune_mode!r}: 'local' or "
                         f"'global'")
    if granularity not in ("row", "kernel", "element"):
        raise ValueError(f"unknown granularity {granularity!r}")
    if prune_mode == "global" and granularity != "element":
        raise ValueError("global prune/grow runs on element-granular "
                         "(full-shape) masks")

    def update(state: TrainState, death_rate: float, grads=None,
               regrow_ratio: float = 1.0):
        if prune_mode == "global":
            if grads is None:
                raise ValueError("the global prune grows by gradient and "
                                 "needs the gradients")
            new_masks, _ = dsff.truncate_weights_global(
                model, state.masks, death_rate, regrow_ratio, grads,
                state.generator)
        else:
            new_masks, _ = dsff.death_growth_update(
                model, state.masks, death_rate, state.generator,
                granularity=granularity, growth=growth, grads=grads)
        return apply_new_masks(state, new_masks)

    return update


def make_grad_step(model: nn.Module, ds_weights, batch_dice: bool = True,
                   loss_name: str = "dc_ce", do_ds: bool = True,
                   group=None):
    """grad_step(data, targets) -> {name: gradient} of the plain
    deep-supervision loss with respect to every parameter of the model,
    through the same kernels as the train step (reference make_grad_step,
    train_state.py:270-287: the weight.grad that kernel_grad_growth
    reads); do_ds=False as make_train_step's (the reference runs every
    head and weighs the first alone: the same loss, zero gradients for
    the other heads). The trainer feeds it to gradient-fed DSFF
    updates. group: data parallel, the gradients summed over its ranks."""
    loss_fn = _loss_fn(ds_weights, batch_dice, loss_name, None)

    def grad_step(data, targets):
        params = dict(model.named_parameters())
        with reducing(group):
            loss = loss_fn(_outputs(model, data, do_ds), targets)
        return _full_grads(loss, params, group)

    return grad_step
