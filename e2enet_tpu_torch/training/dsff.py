"""Dynamic Sparse Feature Fusion (DSFF) at row granularity: the training
subset of e2enet_tpu/training/dsff.py that the row-masked trainer takes
(init_masks_row, _layer_death_growth_row, death_growth_update with
granularity "row" and random growth, cosine_death_rate).

Masks are (in, out) float32 tensors on the kernels' device, keyed by the
port's parameter names, with constant rows: a row is one input channel of
a fusion conv ("loc") or nest transposed conv ("up"), alive or dead for
every output channel. Which kernels carry one, applying them and the
density are models/masks.py's. Random draws come from an explicit
torch.Generator (on the CPU); the growth takes its scores as an argument
where a test feeds the reference's draw.
"""
import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..models.masks import mask_shape, masked_params


def _sorted_names(names):
    """The reference's order: its path tuples sorted."""
    return sorted(names, key=lambda n: tuple(n.split(".")))


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
        cin, cout = mask_shape(w)
        d = density_48_override if int(w.shape[0]) == 48 else density
        n_alive = max(1, min(int(round(cin * d)), cin))
        perm = torch.randperm(cin, generator=generator)
        rows = torch.zeros(cin, dtype=torch.float32)
        rows[perm[:n_alive]] = 1.0
        masks[name] = rows[:, None].expand(cin, cout).contiguous().to(
            w.device)
    return masks


def _row_l1(w: torch.Tensor) -> torch.Tensor:
    """L1 of each input row (the in axis of the (in, out) mask) over the
    spatial taps and the outputs: conv (CO, C, kh, kw) or transposed conv
    (Cin, Cout, sd, sh, sw)."""
    a = w.detach().float().abs()
    if w.dim() == 4:
        return a.sum(dim=(0, 2, 3))
    return a.sum(dim=(1, 2, 3, 4))


def layer_death_growth_row(w: torch.Tensor, mask: torch.Tensor,
                           death_rate: float,
                           generator: Optional[torch.Generator] = None,
                           scores: Optional[torch.Tensor] = None
                           ) -> Tuple[torch.Tensor, int]:
    """One kernel's row death and random regrowth (reference
    dsff.py:415-452): kill the ceil(death_rate * alive) alive rows of
    smallest L1 (ties can kill more), then revive as many dead rows, those
    of the highest scores (uniform draws from `generator`, or `scores`
    (in,)). Returns (new mask (in, out), kernel pairs killed)."""
    cin, cout = mask.shape
    rows = mask[:, 0].float()
    l1 = _row_l1(w) * rows
    nonzeros = rows.sum()
    zeros = cin - nonzeros
    prune_num = torch.ceil(torch.tensor(death_rate, dtype=torch.float32)
                           * nonzeros.cpu()).to(torch.int64)
    kill_idx = int((zeros.cpu().to(torch.int64) + prune_num - 1).clamp(
        0, cin - 1))
    thr = torch.sort(l1).values[kill_idx]
    survived = (l1 > thr).float() * rows
    num_death = int(nonzeros - survived.sum())
    dead = 1.0 - survived
    if scores is None:
        scores = torch.rand(cin, generator=generator)
    score = torch.where(dead > 0, scores.to(dead.device).float(),
                        torch.full_like(dead, -math.inf))
    gthr = torch.sort(score, descending=True).values[
        min(max(num_death - 1, 0), cin - 1)]
    grow = ((score >= gthr) & (dead > 0)).float() if num_death > 0 \
        else torch.zeros_like(dead)
    new_rows = (survived + grow).clamp(0.0, 1.0)
    return new_rows[:, None].expand(cin, cout).contiguous(), num_death * cout


def death_growth_update(model: nn.Module, masks: Dict[str, torch.Tensor],
                        death_rate: float,
                        generator: Optional[torch.Generator] = None,
                        scores: Optional[Dict[str, torch.Tensor]] = None):
    """truncate_weights at row granularity with random growth (reference
    dsff.py:318-350): every masked kernel's death and growth, in the
    reference's order. Returns (new masks, {"total_death": kernel pairs
    killed})."""
    params = masked_params(model)
    new, total = {}, 0
    for name in _sorted_names(masks):
        nm, nd = layer_death_growth_row(
            params[name], masks[name], death_rate, generator,
            None if scores is None else scores[name])
        new[name] = nm
        total += nd
    return new, {"total_death": total}


def cosine_death_rate(step: float, death_rate: float, t_max: int,
                      eta_min: float = 0.001) -> float:
    """Cosine annealing of the death rate (reference dsff.py:236-241)."""
    frac = min(max(step / max(t_max, 1), 0.0), 1.0)
    return eta_min + (death_rate - eta_min) * 0.5 * (
        1.0 + math.cos(math.pi * frac))
