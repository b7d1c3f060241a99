"""Dynamic Sparse Feature Fusion (DSFF): the training subset of
e2enet_tpu/training/dsff.py that the port's trainers take, at kernel
granularity (the reference engine, core_channel.py: init_masks,
kernel_death_survive, _layer_death_growth with random or gradient growth)
and at row granularity (init_masks_row, _layer_death_growth_row), with
death_growth_update, cosine_death_rate, mask_granularity, update_fired,
fired_ratio and DSFFConfig.

Masks are (in, out) float32 tensors on the kernels' device, keyed by the
port's parameter names: one entry per (input, output) kernel pair of a
fusion conv ("loc") or nest transposed conv ("up"); a row mask has
constant rows (one input channel alive or dead for every output). Which
kernels carry one, applying them and the density (masks_density) are
models/masks.py's. Random growth draws its scores from an explicit
torch.Generator (on the CPU), or takes them as an argument where a test
feeds the reference's draw; gradient growth scores each dead kernel pair
(or row) by the L1 of the loss's gradient over it (kernel_grad_growth,
core_channel.py:771-790).

Not ported (ROADMAP Queue 1 item 4c; each raises, naming it): element
granularity and its inits, GMP, lottery ticket, GraSP, the global prune
and its grow schedule.
"""
import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..models.masks import mask_shape, masked_params


NOT_PORTED_ITEM = "ROADMAP Queue 1 item 4c (DSFF, the rest)"


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


def _grow_top(score: torch.Tensor, num_death: int) -> torch.Tensor:
    """0/1 of score's shape marking the num_death entries of the highest
    score (dead entries carry their draw, the others -inf), ties taken in
    index order. The reference marks every entry at or above the
    num_death-th highest score (dsff.py:296-300), which grows more than it
    killed when two draws tie there (float32 draws over ~10^5 dead pairs
    of a bench-width kernel tie now and then); otherwise the two agree."""
    flat = score.reshape(-1)
    idx = torch.sort(flat, descending=True, stable=True).indices[:num_death]
    grow = torch.zeros_like(flat)
    grow[idx] = 1.0
    return grow.reshape(score.shape)


def layer_death_growth_row(w: torch.Tensor, mask: torch.Tensor,
                           death_rate: float,
                           generator: Optional[torch.Generator] = None,
                           scores: Optional[torch.Tensor] = None
                           ) -> Tuple[torch.Tensor, int]:
    """One kernel's row death and regrowth (reference dsff.py:415-452):
    kill the ceil(death_rate * alive) alive rows of smallest L1 (ties can
    kill more), then revive as many dead rows, those of the highest scores
    (uniform draws from `generator`, or `scores` (in,): the reference's
    draws, or the gradient's row L1 for gradient growth; _grow_top).
    Returns (new mask (in, out), kernel pairs killed)."""
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
    new_rows = (survived + _grow_top(score, num_death)).clamp(0.0, 1.0)
    return new_rows[:, None].expand(cin, cout).contiguous(), num_death * cout


def _kernel_l1(w: torch.Tensor) -> torch.Tensor:
    """L1 of each kernel pair over its spatial taps, as (in, out): conv
    (CO, C, kh, kw) or transposed conv (Cin, Cout, sd, sh, sw)."""
    a = w.detach().float().abs()
    if w.dim() == 4:
        return a.sum(dim=(2, 3)).t()
    return a.sum(dim=(2, 3, 4))


def init_masks(model: nn.Module, density: float, generator: torch.Generator,
               mode: str = "uniform", density_48_override: float = 0.2
               ) -> Dict[str, torch.Tensor]:
    """Uniform kernel-pair init (reference dsff.py:79-99): round(in * out *
    density) random kernel pairs alive per masked kernel, density_48_override
    for kernels whose torch dim 0 is 48; mode "dense" keeps every pair."""
    if mode not in ("uniform", "dense"):
        raise NotImplementedError(f"sparse_init {mode!r}: {NOT_PORTED_ITEM}")
    masks = {}
    params = masked_params(model)
    for name in _sorted_names(params):
        w = params[name]
        cin, cout = mask_shape(w)
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


def kernel_death_survive(w: torch.Tensor, mask: torch.Tensor,
                         death_rate: float) -> Tuple[torch.Tensor, int]:
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
    l1 = _kernel_l1(w) * m
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
                       scores: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, int]:
    """One kernel's death and regrowth at kernel granularity (reference
    dsff.py:273-302, kernel_growth / kernel_grad_growth of
    core_channel.py:721-790): kernel_death_survive, then revive as many
    dead pairs, those of the highest scores (uniform draws (in, out) from
    `generator`, or `scores`: the reference's draws, or the gradient's L1
    per pair for gradient growth; _grow_top). Returns (new mask (in, out),
    pairs killed)."""
    cin, cout = mask.shape
    survived, num_death = kernel_death_survive(w, mask, death_rate)
    dead = 1.0 - survived
    if scores is None:
        scores = torch.rand((cin, cout), generator=generator)
    score = torch.where(dead > 0, scores.to(dead.device).float(),
                        torch.full_like(dead, -math.inf))
    return (survived + _grow_top(score, num_death)).clamp(0.0, 1.0), \
        num_death


def mask_granularity(masks: Dict[str, torch.Tensor], model: nn.Module) -> str:
    """'kernel' for (in, out) masks (row masks included, as the reference
    counts them), 'element' for masks of their kernel's full shape
    (reference dsff.py:305-315); mixed granularities are refused."""
    params = masked_params(model)
    kinds = {("element" if tuple(m.shape) == tuple(params[n].shape)
              else "kernel") for n, m in masks.items()}
    assert len(kinds) <= 1, f"mixed mask granularities: {kinds}"
    return kinds.pop() if kinds else "kernel"


def gradient_scores(grads: Dict[str, torch.Tensor], granularity: str
                    ) -> Dict[str, torch.Tensor]:
    """Gradient growth's score of every masked kernel by name: the L1 of
    |grad| per (in, out) kernel pair over the spatial taps ("kernel"), or
    per input row over the taps and the outputs ("row"); reference
    dsff.py:278-280, :435-437."""
    l1 = {"row": _row_l1, "kernel": _kernel_l1}[granularity]
    return {n: l1(g) for n, g in grads.items()}


def death_growth_update(model: nn.Module, masks: Dict[str, torch.Tensor],
                        death_rate: float,
                        generator: Optional[torch.Generator] = None,
                        scores: Optional[Dict[str, torch.Tensor]] = None,
                        granularity: str = "row", growth: str = "random",
                        grads: Optional[Dict[str, torch.Tensor]] = None):
    """truncate_weights (reference dsff.py:318-345): every masked kernel's
    death and growth in the reference's order, at granularity "row" or
    "kernel" ("element" raises). growth "random" revives dead entries by
    uniform draws from `generator` (or `scores`); "gradient" by the
    gradients' L1 (gradient_scores of `grads`, {name: gradient} of at
    least every masked kernel). Returns (new masks, {"total_death": kernel
    pairs killed})."""
    fns = {"row": layer_death_growth_row, "kernel": layer_death_growth}
    if granularity not in fns:
        raise NotImplementedError(f"{granularity!r} granularity: "
                                  f"{NOT_PORTED_ITEM}")
    if growth == "gradient":
        if grads is None:
            raise ValueError("gradient growth needs the gradients")
        scores = gradient_scores({n: grads[n] for n in masks}, granularity)
    elif growth != "random":
        raise NotImplementedError(f"--growth {growth}: {NOT_PORTED_ITEM}")
    params = masked_params(model)
    new, total = {}, 0
    for name in _sorted_names(masks):
        nm, nd = fns[granularity](
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


def update_fired(fired: Dict[str, torch.Tensor],
                 masks: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """ITOP fired-mask tracking (reference dsff.py:362-365)."""
    return {k: torch.maximum(fired[k], masks[k]) for k in masks}


def fired_ratio(fired: Dict[str, torch.Tensor]) -> float:
    """Fired pairs over maskable pairs (reference dsff.py:368-375)."""
    nf = sum(float(m.sum()) for m in fired.values())
    return nf / sum(m.numel() for m in fired.values())


@dataclass
class DSFFConfig:
    """The DSFF flags (reference DSFFConfig, dsff.py:630-658; add_sparse_args
    of core_channel.py:17-31). The port trains prune_mode 'local' with
    random or gradient growth at kernel granularity ('auto' on kernel
    masks) or row granularity; the rest raises in the trainer, naming
    ROADMAP Queue 1 item 4c."""
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

    def check_ported(self) -> None:
        """Raise NotImplementedError naming ROADMAP Queue 1 item 4c for a
        setting the port does not train."""
        refused = []
        if self.sparse_init not in ("uniform", "dense"):
            refused.append(f"--sparse_init {self.sparse_init}")
        if self.granularity == "element":
            refused.append("--granularity element")
        if self.granularity == "row" and self.sparse_init != "uniform":
            refused.append("--granularity row with --sparse_init "
                           f"{self.sparse_init}")
        if self.prune_mode != "local":
            refused.append(f"--prune_mode {self.prune_mode}")
        if self.growth not in ("random", "gradient"):
            refused.append(f"--growth {self.growth}")
        if refused:
            raise NotImplementedError(f"{', '.join(refused)}: "
                                      f"{NOT_PORTED_ITEM}")
