"""Dynamic Sparse Feature Fusion (DSFF): the port of
e2enet_tpu/training/dsff.py, every engine of it:

- kernel granularity (the reference engine, core_channel.py: init_masks,
  kernel_death_survive, layer_death_growth) and row granularity
  (init_masks_row, layer_death_growth_row), masks (in, out);
- element granularity (the ITOP engine, core.py: init_masks_element with
  uniform_ori, ERK or snip, layer_death_growth_element), masks of their
  kernel's full shape in the port's layout;
- GMP (init_masks_gmp, gmp_prune_masks per epoch), the lottery ticket
  (init_masks_lottery), GraSP (grasp_scores, init_masks_grasp);
- the global prune (truncate_weights_global) with its gradual-density
  schedule (grow_schedule_ratio);
- death_growth_update, cosine_death_rate, mask_granularity, update_fired,
  fired_ratio and DSFFConfig.

Masks are float32 tensors on the kernels' device, keyed by the port's
parameter names: one per fusion conv ("loc") or nest transposed conv
("up"); which kernels carry one, applying them and the density
(masks_density) are models/masks.py's. Random draws come from an explicit
torch.Generator (on the CPU), so that a CPU run and a card run draw the
same masks; every function that draws also takes its draws as an argument
(`scores`, `draws`), in the port's layout, where a test feeds the
reference's. Gradient growth scores each dead entry (element), kernel pair
or row by the L1 of the loss's gradient over it (kernel_grad_growth,
core_channel.py:771-790). Growth revives exactly as many entries as died,
ties in index order (_grow_top); the reference marks every entry at or
above the threshold instead.

The counts and thresholds follow the reference's float32 arithmetic
(np.float32 on the host), so that the same weights, masks and draws give
the same masks to the bit.
"""
import math
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..models.masks import mask_shape, masked_params, transposed_name

GROWTH_MODES = ("random", "gradient")
F32 = np.float32


def _sorted_names(names):
    """The reference's order: its path tuples sorted."""
    return sorted(names, key=lambda n: tuple(n.split(".")))


def _count_f32(masks, names) -> np.float32:
    """Σ of the masks' entries as the reference sums them: a float32 sum per
    mask, the masks added in float32 in order."""
    total = F32(0.0)
    for n in names:
        total = F32(total + F32(float(masks[n].sum())))
    return total


def init_masks_row(model: nn.Module, density: float,
                   generator: torch.Generator,
                   density_48_override: float = 0.2
                   ) -> Dict[str, torch.Tensor]:
    """round(in * density) random input rows alive per masked kernel (all
    outputs), density_48_override for kernels whose torch dim 0 is 48
    (reference dsff.py:396-412)."""
    masks = {}
    params = masked_params(model)
    for name in _sorted_names(params):
        w = params[name]
        cin, cout = mask_shape(w, transposed_name(name))
        d = density_48_override if int(w.shape[0]) == 48 else density
        n_alive = max(1, min(int(round(cin * d)), cin))
        perm = torch.randperm(cin, generator=generator)
        rows = torch.zeros(cin, dtype=torch.float32)
        rows[perm[:n_alive]] = 1.0
        masks[name] = rows[:, None].expand(cin, cout).contiguous().to(
            w.device)
    return masks


def _io(w: torch.Tensor, transposed: Optional[bool]) -> torch.Tensor:
    """|w| in float32 as (in, out, taps...): a conv (CO, C, ...) kernel's
    first two dims swapped, a transposed conv's (Cin, Cout, ...) as it is
    (models/masks.mask_shape's rule)."""
    a = w.detach().float().abs()
    tr = w.dim() == 5 if transposed is None else transposed
    return a if tr else a.transpose(0, 1)


def _row_l1(w: torch.Tensor, transposed: Optional[bool] = None
            ) -> torch.Tensor:
    """L1 of each input row (the in axis of the (in, out) mask) over the
    spatial taps and the outputs: conv (CO, C, ...) or transposed conv
    (Cin, Cout, sd, sh, sw)."""
    a = _io(w, transposed)
    return a.sum(dim=tuple(range(1, a.dim())))


def _grow_top(score: torch.Tensor, num_death: int) -> torch.Tensor:
    """0/1 of score's shape marking the num_death entries of the highest
    score (dead entries carry their draw or gradient, the others -inf),
    ties taken in index order. The reference marks every entry at or above
    the num_death-th highest score (dsff.py:229-232, :296-300, :444-447),
    which grows more than it killed when two scores tie there: float32
    draws in [0, 1) take ~8.4M distinct values, so over the ~10^5 dead
    pairs of a bench-width kernel they tie now and then, and over the up
    to ~2.2M dead elements of an element mask routinely. Otherwise the two
    agree."""
    flat = score.reshape(-1)
    idx = torch.sort(flat, descending=True, stable=True).indices[:num_death]
    grow = torch.zeros_like(flat)
    grow[idx] = 1.0
    return grow.reshape(score.shape)


def _scored(dead: torch.Tensor, scores: torch.Tensor) -> torch.Tensor:
    """The growth score: each dead entry's score, -inf elsewhere."""
    return torch.where(dead > 0, scores.to(dead.device).float(),
                       torch.full_like(dead, -math.inf))


def layer_death_growth_row(w: torch.Tensor, mask: torch.Tensor,
                           death_rate: float,
                           generator: Optional[torch.Generator] = None,
                           scores: Optional[torch.Tensor] = None,
                           transposed: Optional[bool] = None
                           ) -> Tuple[torch.Tensor, int]:
    """One kernel's row death and regrowth (reference dsff.py:415-452):
    kill the ceil(death_rate * alive) alive rows of smallest L1 (ties can
    kill more), then revive as many dead rows, those of the highest scores
    (uniform draws from `generator`, or `scores` (in,): the reference's
    draws, or the gradient's row L1 for gradient growth; _grow_top).
    Returns (new mask (in, out), kernel pairs killed)."""
    cin, cout = mask.shape
    rows = mask[:, 0].float()
    l1 = _row_l1(w, transposed) * rows
    nonzeros = rows.sum()
    zeros = cin - nonzeros
    prune_num = torch.ceil(torch.tensor(death_rate, dtype=torch.float32)
                           * nonzeros.cpu()).to(torch.int64)
    kill_idx = int((zeros.cpu().to(torch.int64) + prune_num - 1).clamp(
        0, cin - 1))
    thr = torch.sort(l1).values[kill_idx]
    survived = (l1 > thr).float() * rows
    num_death = int(nonzeros - survived.sum())
    if scores is None:
        scores = torch.rand(cin, generator=generator)
    new_rows = (survived + _grow_top(_scored(1.0 - survived, scores),
                                     num_death)).clamp(0.0, 1.0)
    return new_rows[:, None].expand(cin, cout).contiguous(), num_death * cout


def _kernel_l1(w: torch.Tensor, transposed: Optional[bool] = None
               ) -> torch.Tensor:
    """L1 of each kernel pair over its spatial taps, as (in, out): conv
    (CO, C, ...) or transposed conv (Cin, Cout, sd, sh, sw)."""
    a = _io(w, transposed)
    return a.sum(dim=tuple(range(2, a.dim())))


def init_masks(model: nn.Module, density: float, generator: torch.Generator,
               mode: str = "uniform", density_48_override: float = 0.2
               ) -> Dict[str, torch.Tensor]:
    """Uniform kernel-pair init (reference dsff.py:79-99): round(in * out *
    density) random kernel pairs alive per masked kernel, density_48_override
    for kernels whose torch dim 0 is 48; mode "dense" keeps every pair."""
    if mode not in ("uniform", "dense"):
        raise ValueError(f"kernel-pair init mode {mode!r}: 'uniform' or "
                         f"'dense'")
    masks = {}
    params = masked_params(model)
    for name in _sorted_names(params):
        w = params[name]
        cin, cout = mask_shape(w, transposed_name(name))
        if mode == "dense":
            masks[name] = torch.ones((cin, cout), dtype=torch.float32,
                                     device=w.device)
            continue
        d = density_48_override if int(w.shape[0]) == 48 else density
        kernel_num = max(1, min(int(round(cin * cout * d)), cin * cout))
        perm = torch.randperm(cin * cout, generator=generator)
        flat = torch.zeros(cin * cout, dtype=torch.float32)
        flat[perm[:kernel_num]] = 1.0
        masks[name] = flat.reshape(cin, cout).to(w.device)
    return masks


def _draw(shape, generator, draws, name) -> torch.Tensor:
    """The uniform draws in [0, 1) of one masked kernel: draws[name] where
    given (the reference's, in the port's layout), else from the
    generator."""
    if draws is not None:
        return torch.as_tensor(draws[name], dtype=torch.float32)
    return torch.rand(tuple(shape), generator=generator)


def _global_threshold(scores, keep: int) -> torch.Tensor:
    """The keep-th largest of every score together (the reference's
    jnp.sort(flat)[::-1][keep - 1])."""
    flat = torch.cat([s.reshape(-1) for s in scores])
    return torch.sort(flat, descending=True).values[keep - 1]


def init_masks_element(model: nn.Module, density: float,
                       generator: Optional[torch.Generator] = None,
                       mode: str = "uniform_ori",
                       grads: Optional[Dict[str, torch.Tensor]] = None,
                       erk_power_scale: float = 1.0,
                       draws: Optional[Dict[str, torch.Tensor]] = None
                       ) -> Dict[str, torch.Tensor]:
    """Element-granular init, the ITOP engine (reference dsff.py:123-172,
    sparselearning/core.py), masks of each kernel's full shape:
      uniform_ori: Bernoulli(density) per element;
      ERK: per-kernel density eps * (Σ dims / numel)^erk_power_scale,
           clipped to [0, 1], eps set so that Σ density_l numel_l is
           density Σ numel_l (the port's kernel shapes have the flax
           shapes' dims in another order, so the sums agree), then
           Bernoulli per element;
      snip: the global top int(numel * density) of |g * w| kept, at or
           above the threshold (snip.py:19); grads {name: gradient}.
    Draws (uniform_ori, ERK) one uniform per element, kernel by kernel in
    the reference's order, from `generator` or from `draws`."""
    params = masked_params(model)
    names = _sorted_names(params)
    if mode == "snip":
        if grads is None:
            raise ValueError("snip init requires gradients")
        scores = {n: (params[n].detach().float() * grads[n].detach().to(
            params[n].device).float()).abs() for n in names}
        keep = max(1, int(sum(s.numel() for s in scores.values())
                          * density))
        thr = _global_threshold([scores[n] for n in names], keep)
        return {n: (scores[n] >= thr).float() for n in names}
    if mode == "uniform_ori":
        dens = {n: density for n in names}
    elif mode == "ERK":
        raw = {n: (float(np.sum(params[n].shape))
                   / float(np.prod(params[n].shape))) ** erk_power_scale
               for n in names}
        total = sum(int(np.prod(params[n].shape)) for n in names)
        denom = sum(raw[n] * np.prod(params[n].shape) for n in names)
        eps = density * total / denom
        dens = {n: float(np.clip(eps * raw[n], 0.0, 1.0)) for n in names}
    else:
        raise KeyError(f"unknown element init mode '{mode}'")
    return {n: (_draw(params[n].shape, generator, draws, n) < dens[n])
            .float().to(params[n].device) for n in names}


def layer_death_growth_element(w: torch.Tensor, mask: torch.Tensor,
                               death_rate: float,
                               generator: Optional[torch.Generator] = None,
                               scores: Optional[torch.Tensor] = None
                               ) -> Tuple[torch.Tensor, int]:
    """One kernel's element death and regrowth (reference
    _layer_death_growth_element, dsff.py:207-233; magnitude_death and
    random_growth / gradient_growth of core.py): kill the ceil(death_rate *
    alive) alive elements of smallest |w| (the dead ones first, |w| 0 under
    the mask; ties can kill more), then revive as many dead elements,
    those of the highest scores (uniform draws of w's shape from
    `generator`, or `scores`: the reference's draws, or |grad| for
    gradient growth; _grow_top). Returns (new mask, elements killed)."""
    m = mask.float()
    n = m.numel()
    absw = w.detach().float().abs() * m
    nonzeros = F32(float(m.sum()))
    num_remove = int(np.ceil(F32(death_rate) * nonzeros))
    kill_idx = min(max(int(F32(n) - nonzeros) + num_remove - 1, 0), n - 1)
    thr = torch.sort(absw.reshape(-1)).values[kill_idx]
    survived = (absw > thr).float() * m
    num_death = int(nonzeros) - int(survived.sum())
    if scores is None:
        scores = torch.rand(tuple(mask.shape), generator=generator)
    grow = _grow_top(_scored(1.0 - survived, scores), num_death)
    return (survived + grow).clamp(0.0, 1.0), num_death


def kernel_death_survive(w: torch.Tensor, mask: torch.Tensor,
                         death_rate: float,
                         transposed: Optional[bool] = None
                         ) -> Tuple[torch.Tensor, int]:
    """The death half of one kernel's update (reference dsff.py:244-270,
    kernel_death of core_channel.py:647-666): kill the (dead pairs +
    ceil(death_rate * alive)) pairs of smallest L1, already-dead pairs
    having L1 0; ties can kill more. The counts in float32 as the
    reference takes them. Returns (survived (in, out) 0/1 float32, pairs
    killed among the alive)."""
    cin, cout = mask.shape
    k_size = int(np.prod(w.shape[2:]))
    n_pairs = cin * cout
    m = mask.float()
    l1 = _kernel_l1(w, transposed) * m
    f32 = dict(dtype=torch.float32)
    nonzeros_el = m.sum().cpu() * k_size
    zeros_el = torch.tensor(float(n_pairs * k_size), **f32) - nonzeros_el
    prune_num = int(torch.ceil(torch.tensor(death_rate, **f32)
                               * nonzeros_el / k_size))
    num_zero_k = int(torch.ceil(zeros_el / k_size))
    kill_idx = min(max(num_zero_k + prune_num - 1, 0), n_pairs - 1)
    thr = torch.sort(l1.reshape(-1)).values[kill_idx]
    survived = (l1 > thr).float() * m
    return survived, int(m.sum() - survived.sum())


def layer_death_growth(w: torch.Tensor, mask: torch.Tensor,
                       death_rate: float,
                       generator: Optional[torch.Generator] = None,
                       scores: Optional[torch.Tensor] = None,
                       transposed: Optional[bool] = None
                       ) -> Tuple[torch.Tensor, int]:
    """One kernel's death and regrowth at kernel granularity (reference
    dsff.py:273-302, kernel_growth / kernel_grad_growth of
    core_channel.py:721-790): kernel_death_survive, then revive as many
    dead pairs, those of the highest scores (uniform draws (in, out) from
    `generator`, or `scores`: the reference's draws, or the gradient's L1
    per pair for gradient growth; _grow_top). Returns (new mask (in, out),
    pairs killed)."""
    cin, cout = mask.shape
    survived, num_death = kernel_death_survive(w, mask, death_rate,
                                               transposed)
    if scores is None:
        scores = torch.rand((cin, cout), generator=generator)
    grow = _grow_top(_scored(1.0 - survived, scores), num_death)
    return (survived + grow).clamp(0.0, 1.0), num_death


def mask_granularity(masks: Dict[str, torch.Tensor], model: nn.Module) -> str:
    """'kernel' for (in, out) masks (row masks included, as the reference
    counts them), 'element' for masks of their kernel's full shape
    (reference dsff.py:305-315); mixed granularities are refused."""
    params = masked_params(model)
    kinds = {("element" if tuple(m.shape) == tuple(params[n].shape)
              else "kernel") for n, m in masks.items()}
    if len(kinds) > 1:
        raise ValueError(f"mixed mask granularities: {sorted(kinds)}")
    return kinds.pop() if kinds else "kernel"


def gradient_scores(grads: Dict[str, torch.Tensor], granularity: str
                    ) -> Dict[str, torch.Tensor]:
    """Gradient growth's score of every masked kernel by name: |grad| per
    element ("element"), its L1 per (in, out) kernel pair over the spatial
    taps ("kernel"), or per input row over the taps and the outputs
    ("row"); reference dsff.py:224, :278-280, :435-437."""
    l1 = {"row": _row_l1, "kernel": _kernel_l1,
          "element": lambda g, _: g.detach().float().abs()}[granularity]
    return {n: l1(g, transposed_name(n)) for n, g in grads.items()}


def check_growth(growth: str) -> None:
    """Raise ValueError for a growth mode other than random or gradient
    (the reference takes any other value as random, dsff.py:292)."""
    if growth not in GROWTH_MODES:
        raise ValueError(f"unknown growth {growth!r}: 'random' or "
                         f"'gradient'")


def death_growth_update(model: nn.Module, masks: Dict[str, torch.Tensor],
                        death_rate: float,
                        generator: Optional[torch.Generator] = None,
                        scores: Optional[Dict[str, torch.Tensor]] = None,
                        granularity: str = "row", growth: str = "random",
                        grads: Optional[Dict[str, torch.Tensor]] = None):
    """truncate_weights, the local prune (reference dsff.py:318-345): every
    masked kernel's death and growth in the reference's order, at
    granularity "row", "kernel" or "element". growth "random" revives dead
    entries by uniform draws from `generator` (or `scores`, {name: draws
    of the mask's shape}); "gradient" by the gradients (gradient_scores of
    `grads`, {name: gradient} of at least every masked kernel). Returns
    (new masks, {"total_death": entries (element) or kernel pairs
    killed})."""
    fns = {"row": layer_death_growth_row, "kernel": layer_death_growth,
           "element": layer_death_growth_element}
    if granularity not in fns:
        raise ValueError(f"unknown granularity {granularity!r}")
    check_growth(growth)
    if growth == "gradient":
        if grads is None:
            raise ValueError("gradient growth needs the gradients")
        scores = gradient_scores({n: grads[n] for n in masks}, granularity)
    params = masked_params(model)
    new, total = {}, 0
    for name in _sorted_names(masks):
        kw = ({} if granularity == "element"
              else dict(transposed=transposed_name(name)))
        nm, nd = fns[granularity](
            params[name], masks[name], death_rate, generator,
            None if scores is None else scores[name], **kw)
        new[name] = nm
        total += nd
    return new, {"total_death": total}


def cosine_death_rate(step: float, death_rate: float, t_max: int,
                      eta_min: float = 0.001) -> float:
    """Cosine annealing of the death rate (reference dsff.py:236-241)."""
    frac = min(max(step / max(t_max, 1), 0.0), 1.0)
    return eta_min + (death_rate - eta_min) * 0.5 * (
        1.0 + math.cos(math.pi * frac))


def update_fired(fired: Dict[str, torch.Tensor],
                 masks: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """ITOP fired-mask tracking (reference dsff.py:362-365)."""
    return {k: torch.maximum(fired[k], masks[k]) for k in masks}


def fired_ratio(fired: Dict[str, torch.Tensor]) -> float:
    """Fired entries over maskable entries (reference dsff.py:368-375)."""
    nf = sum(float(m.sum()) for m in fired.values())
    return nf / sum(m.numel() for m in fired.values())


# --------------------------------------------------------------------------
# GMP, the lottery ticket, GraSP, and the global prune with its schedule

def init_masks_gmp(model: nn.Module) -> Dict[str, torch.Tensor]:
    """GMP starts dense (reference dsff.py:471-476): element masks of
    ones; gmp_prune_masks then prunes per epoch."""
    return {n: torch.ones_like(w, dtype=torch.float32)
            for n, w in masked_params(model).items()}


def init_masks_lottery(model: nn.Module, density: float
                       ) -> Dict[str, torch.Tensor]:
    """The lottery ticket (reference dsff.py:479-490, core_channel.py:
    119-139): the globally largest int(numel * density) |w| over every
    masked kernel kept, element masks (|w| >= the threshold)."""
    params = masked_params(model)
    names = _sorted_names(params)
    absw = {n: params[n].detach().float().abs() for n in names}
    keep = max(1, int(sum(a.numel() for a in absw.values()) * density))
    thr = _global_threshold([absw[n] for n in names], keep)
    return {n: (absw[n] >= thr).float() for n in names}


def gmp_prune_masks(model: nn.Module, masks: Dict[str, torch.Tensor],
                    epoch: int, density: float, init_prune_epoch: int = 0,
                    final_prune_epoch: int = 1000, multiplier: int = 1
                    ) -> Dict[str, torch.Tensor]:
    """One GMP prune, per epoch (reference dsff.py:493-524,
    truncate_weights_GMP of core_channel.py:436-467): between
    multiplier * init_prune_epoch and multiplier * final_prune_epoch the
    prune rate ramps cubically from 0 toward 1 - density; each kernel's
    mask is zeroed at its int(curr_prune_rate * numel) smallest |w| (ties
    at the threshold go too), no regrow. Outside the window the masks are
    returned as they are."""
    prune_rate = 1.0 - density
    lo = multiplier * init_prune_epoch
    hi = multiplier * final_prune_epoch
    if not lo <= epoch <= hi:
        return masks
    prune_decay = (1.0 - (epoch - lo) / (hi - lo + 1)) ** 3
    curr_prune_rate = prune_rate - prune_rate * prune_decay
    params = masked_params(model)
    new = {}
    for name in _sorted_names(masks):
        w, m = params[name], masks[name]
        if tuple(m.shape) != tuple(w.shape):
            raise ValueError("GMP runs on element-granular (full-shape) "
                             "masks")
        absw = w.detach().float().abs()
        p = int(curr_prune_rate * absw.numel())
        if p == 0:
            new[name] = m
            continue
        thr = torch.sort(absw.reshape(-1)).values[p - 1]
        new[name] = m * (absw > thr).float()
    return new


def grow_schedule_ratio(steps: int, update_frequency: int,
                        iters_per_epoch: int, density: float,
                        final_density: float, death_rate: float,
                        total_weights: float, total_nonzeros: float,
                        curr_density: float, prev_regrow_ratio: float,
                        init_prune_epoch: int = 0,
                        final_prune_epoch: int = 1000) -> float:
    """The gradual-density schedule (reference dsff.py:527-563,
    cal_grow_schedule of core_channel.py:350-386): the regrow budget, as a
    multiple of the killed weights, that moves the live density from
    `density` toward `final_density` on a cubic ramp over [init_prune_epoch,
    final_prune_epoch]; 1.0 outside the window. The reference's
    process_flag latch: the ratio moves only while the previous ratio was
    above 1 or the density is more than 3e-4 below final_density. A host
    function of host scalars."""
    curr_prune_iter = int(steps / update_frequency)
    final_iter = int((final_prune_epoch * iters_per_epoch)
                     / update_frequency)
    ini_iter = int((init_prune_epoch * iters_per_epoch) / update_frequency)
    total_prune_iter = max(final_iter - ini_iter, 1)
    process_flag = (prev_regrow_ratio > 1.0) or (
        curr_density < final_density - 0.0003)
    if ini_iter <= curr_prune_iter <= final_iter:
        prune_decay = (1.0 - (curr_prune_iter - ini_iter)
                       / total_prune_iter) ** 3
        curr_sparse_level = density + (final_density - density) * (
            1.0 - prune_decay)
        curr_ones = total_weights * curr_sparse_level
        regrow_ones = int(curr_ones - total_nonzeros * (1.0 - death_rate))
        if process_flag:
            return regrow_ones / max(total_nonzeros * death_rate, 1.0)
    return 1.0


def truncate_weights_global(model: nn.Module, masks: Dict[str, torch.Tensor],
                            death_rate: float, regrow_ratio: float,
                            grads: Dict[str, torch.Tensor],
                            generator: Optional[torch.Generator] = None,
                            draws: Optional[Dict[str, torch.Tensor]] = None):
    """The global prune and grow (reference dsff.py:566-626,
    truncate_weights_global of core_channel.py:469-553), element masks:
    - prune: one magnitude threshold over every masked kernel, the
      int(alive * (1 - death_rate)) largest |w| kept (at or above it; dead
      weights are 0 under their masks);
    - grow: the budget regrow_ratio * alive * death_rate allocated by a
      Bernoulli draw over each kernel's dead set from before the update
      (probability budget / all dead), each kernel then reviving its
      allocation at its dead elements of the highest |grad| (_grow_top).
    The uniform draws, one per element kernel by kernel in the reference's
    order, come from `generator` or from `draws` {name: draws of the mask's
    shape}. Returns (new masks, {"total_death", "total_grown"})."""
    params = masked_params(model)
    names = _sorted_names(masks)
    for n in names:
        if tuple(masks[n].shape) != tuple(params[n].shape):
            raise ValueError("global prune/grow runs on element-granular "
                             "(full-shape) masks")
    total_nonzeros = _count_f32(masks, names)
    total_elems = sum(masks[n].numel() for n in names)
    absw = {n: params[n].detach().float().abs() for n in names}
    num_keep = int(total_nonzeros * (F32(1.0) - F32(death_rate)))
    size = sum(a.numel() for a in absw.values())
    thr = _global_threshold([absw[n] for n in names],
                            min(max(num_keep, 1), size))
    total_regrow = F32(F32(regrow_ratio) * total_nonzeros) * F32(death_rate)
    n_dead = max(F32(F32(total_elems) - total_nonzeros), F32(1.0))
    p_grow = float(F32(total_regrow / n_dead))
    new, killed, grown = {}, 0, 0
    for n in names:
        m0 = masks[n]
        dead0 = m0 == 0
        pruned = (absw[n] >= thr).float()
        u = _draw(m0.shape, generator, draws, n).to(m0.device)
        regrow_num = int(((u < p_grow) & dead0).sum())
        score = torch.where(dead0, grads[n].detach().to(m0.device).float()
                            .abs(), torch.full_like(absw[n], -math.inf))
        grow = _grow_top(score, regrow_num)
        new[n] = (pruned + grow).clamp(0.0, 1.0)
        killed += int(pruned.sum())
        grown += regrow_num
    return new, {"total_death": int(total_nonzeros) - killed,
                 "total_grown": grown}


def grasp_scores(loss_fn: Callable, model: nn.Module, data, targets
                 ) -> Dict[str, torch.Tensor]:
    """GraSP's score of every masked element (reference dsff.py:181-197,
    snip.py GraSP :115-215): -w * (H g1), g1 the loss's gradient and H g1
    the gradient of g1 . g(w) with g1 held constant, divided by |Σ scores|
    + 1e-10. loss_fn(model, data, targets) -> scalar.

    H g1 is a second derivative, and the hand-written kernels' backwards
    are first order: a double backward through them would drop terms
    (ops/autograd.first_order_only refuses it). So this function always
    runs the model's plain ops (ops.blocks.plain_ops()), which torch
    differentiates twice, on whatever device the model is on, the card
    included; there is no second-order kernel in either package."""
    from ..ops import blocks
    params = masked_params(model)
    names = _sorted_names(params)
    ws = [params[n] for n in names]
    with blocks.plain_ops():
        loss = loss_fn(model, data, targets)
        g = torch.autograd.grad(loss, ws, create_graph=True)
        inner = sum((gi.detach() * gi).float().sum() for gi in g)
        hg = torch.autograd.grad(inner, ws, allow_unused=True)
    scores = {n: -(w.detach().float() * (torch.zeros_like(w) if h is None
                                         else h.detach()).float())
              for n, w, h in zip(names, ws, hg)}
    norm = torch.cat([scores[n].reshape(-1) for n in names]).sum().abs() \
        + 1e-10
    return {n: scores[n] / norm for n in names}


def init_masks_grasp(loss_fn: Callable, model: nn.Module, density: float,
                     data, targets) -> Dict[str, torch.Tensor]:
    """GraSP init (reference dsff.py:175-204): of grasp_scores (on the
    model's plain ops, see there), the int(numel * (1 - density)) largest
    removed; the element masks keep the scores at or below the threshold.
    loss_fn(model, data, targets) -> scalar."""
    scores = grasp_scores(loss_fn, model, data, targets)
    names = _sorted_names(scores)
    flat = torch.cat([scores[n].reshape(-1) for n in names])
    num_rm = int(flat.numel() * (1.0 - density))
    if num_rm == 0:
        return {n: torch.ones_like(scores[n]) for n in names}
    thr = torch.sort(flat, descending=True).values[num_rm - 1]
    return {n: (scores[n] <= thr).float() for n in names}


@dataclass
class DSFFConfig:
    """The DSFF flags (reference DSFFConfig, dsff.py:630-658; add_sparse_args
    of core_channel.py:17-31). prune_mode 'local' is the per-layer,
    density-preserving engine (final_density has no effect); 'global' the
    cross-layer prune and gradient grow with the gradual-density schedule
    toward final_density over [init_prune_epoch, final_prune_epoch], on
    element masks. sparse_init 'GMP' prunes per epoch instead (multiplier
    scales its window). granularity 'auto' takes the masks' own."""
    sparse: bool = True
    sparse_init: str = "uniform"
    growth: str = "random"
    death: str = "magnitude"
    death_rate: float = 0.5
    density: float = 0.3
    final_density: float = 0.05
    update_frequency: int = 1200
    fix: bool = False
    decay_schedule: str = "cosine"
    prune_mode: str = "local"
    init_prune_epoch: int = 0
    final_prune_epoch: int = 1000
    multiplier: int = 1
    granularity: str = "auto"
