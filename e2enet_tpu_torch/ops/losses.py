"""Segmentation losses with deep supervision and the online evaluation's
hard counts: the port of e2enet_tpu/ops/losses.py, every loss of its
LOSS_REGISTRY (reference e2enet/training/loss_functions/dice_loss.py
get_tp_fp_fn_tn, SoftDiceLoss, GDL, SoftDiceLossSquared, DC_and_CE_loss,
DC_and_BCE_loss, GDL_and_CE_loss, DC_and_topk_loss, MCCLoss;
crossentropy.py RobustCrossEntropyLoss; TopK_loss.py; focal_loss.py;
deep_supervision.py MultipleOutputLoss2; nnUNetTrainer_simple.
run_online_evaluation).

Layout: logits (N, D, H, W, C), float32 as the heads return them; targets
(N, D, H, W) integer labels, or (N, D, H, W, R) 0/1 region channels for
dc_bce and dice_regions. All loss math in float32.

Inside a sharded step (parallel/collectives.reducing over a grid of
ranks) each rank holds its rows of the batch and, with spatial
parallelism, an H slab of them; every loss is the whole batch's, on every
rank (collectives.all_sum by axis): the sums over batch and space (batch
dice's tp/fp/fn, GDL's volumes, MCC's totals, the ignore-label mask's
counts, the voxel means of CE, BCE and focal) over the world, the spatial
sums of per-sample counts (without batch dice) over the space group, and
the mean of per-sample scores over the data group. The top-k
cross-entropy takes its k% of the global voxels from their gathered
values. Outside one each reduction is this rank's own.
"""
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..parallel.collectives import (all_sum, batch_count, batch_mean, count,
                                   gather_rows)


def softmax_helper(x: torch.Tensor) -> torch.Tensor:
    return torch.softmax(x, dim=-1)


def one_hot(target: torch.Tensor, num_classes: int) -> torch.Tensor:
    return F.one_hot(target.long(), num_classes).float()


def get_tp_fp_fn_tn(probs: torch.Tensor, target: torch.Tensor,
                    batch_dice: bool,
                    loss_mask: Optional[torch.Tensor] = None):
    """Soft confusion counts (tp, fp, fn) of probs (N, ..., C) against
    integer targets (N, ...): sums over the spatial axes, and over the batch
    too when batch_dice. fp = sum(p) - tp, fn = sum(y) - tp (reference
    losses.py:29-49)."""
    y = one_hot(target, probs.shape[-1])
    if loss_mask is not None:
        m = loss_mask[..., None].float()
        probs = probs * m
        y = y * m
    axes = tuple(range(0 if batch_dice else 1, probs.dim() - 1))
    tp = (probs * y).sum(dim=axes)
    ps, ys = probs.sum(dim=axes), y.sum(dim=axes)
    tp, ps, ys = all_sum(torch.stack([tp, ps, ys]), _over(batch_dice))
    return tp, ps - tp, ys - tp


def _over(batch_dice: bool) -> str:
    """The axis of the grid a loss's counts are summed over: the world
    with batch dice, else each sample's slabs."""
    return "world" if batch_dice else "space"


def _dice_mean(dc: torch.Tensor, batch_dice: bool) -> torch.Tensor:
    """The mean of per-class (batch dice) or per-sample-and-class
    scores over the global batch (the space ranks share each sample's)."""
    return dc.mean() if batch_dice else batch_mean(dc, "data")


def soft_dice_loss(logits: torch.Tensor, target: torch.Tensor,
                   batch_dice: bool = True, do_bg: bool = False,
                   smooth: float = 1e-5,
                   loss_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Minus the mean soft Dice over the foreground classes (reference
    losses.py:52-63)."""
    probs = softmax_helper(logits.float())
    tp, fp, fn = get_tp_fp_fn_tn(probs, target, batch_dice, loss_mask)
    dc = (2.0 * tp + smooth) / (2.0 * tp + fp + fn + smooth + 1e-8)
    if not do_bg:
        dc = dc[1:] if batch_dice else dc[:, 1:]
    return -_dice_mean(dc, batch_dice)


def robust_cross_entropy(logits: torch.Tensor, target: torch.Tensor,
                         loss_mask: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Mean cross-entropy over the voxels, contracted against the one-hot
    target (reference losses.py:66-79)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -(logp * one_hot(target, logits.shape[-1])).sum(dim=-1)
    if loss_mask is not None:
        m = loss_mask.float()
        num, den = all_sum(torch.stack([(nll * m).sum(), m.sum()]))
        return num / den.clamp_min(1.0)
    return batch_mean(nll)


def dc_and_ce_loss(logits: torch.Tensor, target: torch.Tensor,
                   batch_dice: bool = True, weight_ce: float = 1.0,
                   weight_dice: float = 1.0, smooth: float = 1e-5,
                   ignore_label: Optional[int] = None) -> torch.Tensor:
    """The training loss: CE + soft Dice (batch dice, smooth 1e-5, no
    background), reference losses.py:82-97."""
    loss_mask = None
    if ignore_label is not None:
        loss_mask = target != ignore_label
        target = torch.where(loss_mask, target, torch.zeros_like(target))
    dc = soft_dice_loss(logits, target, batch_dice=batch_dice, do_bg=False,
                        smooth=smooth, loss_mask=loss_mask)
    ce = robust_cross_entropy(logits, target, loss_mask=loss_mask)
    return weight_ce * ce + weight_dice * dc


def topk_cross_entropy(logits: torch.Tensor, target: torch.Tensor,
                       k_percent: float = 10.0) -> torch.Tensor:
    """The mean cross-entropy of the k% voxels of highest cross-entropy
    (reference losses.py:99-108)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = gather_rows(-logp.gather(-1, target.long()[..., None])[..., 0])
    nll = nll.reshape(-1)
    num = int(nll.shape[0] * k_percent / 100.0)
    return torch.topk(nll, max(num, 1), sorted=False).values.mean()


# the losses that take the batch-dice flag (reference losses.py:116-118)
_TAKES_BATCH_DICE = ("dc_ce", "dice", "dice_squared", "gdl", "gdl_ce",
                     "dc_topk", "dc_bce", "dice_regions")


def make_loss(name: str, batch_dice: bool = True, **loss_kwargs):
    """fn(logits, target) of the loss registered as `name`, with the
    batch-dice flag where it takes one and loss_kwargs (e.g. smooth=0, or
    weight_ce / weight_dice) forwarded (reference losses.py:111-124)."""
    fn = LOSS_REGISTRY[name]
    if name in _TAKES_BATCH_DICE:
        return lambda o, t: fn(o, t, batch_dice=batch_dice, **loss_kwargs)
    if loss_kwargs:
        return lambda o, t: fn(o, t, **loss_kwargs)
    return fn


def deep_supervision_loss(outputs: Sequence[torch.Tensor],
                          targets: Sequence[torch.Tensor],
                          weights: Sequence[float],
                          batch_dice: bool = True,
                          loss_name: str = "dc_ce",
                          loss_kwargs=None) -> torch.Tensor:
    """Weighted sum of the loss `loss_name` over the deep-supervision
    heads, zero-weight heads skipped (reference losses.py:127-140)."""
    loss_fn = make_loss(loss_name, batch_dice, **(loss_kwargs or {}))
    total = torch.zeros((), dtype=torch.float32, device=outputs[0].device)
    for o, t, w in zip(outputs, targets, weights):
        if float(w) == 0.0:
            continue
        total = total + float(w) * loss_fn(o, t)
    return total


def generalized_dice_loss(logits: torch.Tensor, target: torch.Tensor,
                          batch_dice: bool = False, do_bg: bool = True,
                          smooth: float = 1.0,
                          square_volumes: bool = False) -> torch.Tensor:
    """GDL: per-class tp, fp, fn weighted by 1 / volume and summed over the
    classes before the Dice ratio (reference losses.py:144-169)."""
    probs = softmax_helper(logits.float())
    y = one_hot(target, probs.shape[-1])
    if not do_bg:
        probs, y = probs[..., 1:], y[..., 1:]
    axes = tuple(range(0 if batch_dice else 1, probs.dim() - 1))
    tp = (probs * y).sum(dim=axes)
    fp = (probs * (1.0 - y)).sum(dim=axes)
    fn = ((1.0 - probs) * y).sum(dim=axes)
    volumes = y.sum(dim=axes)
    tp, fp, fn, volumes = all_sum(torch.stack([tp, fp, fn, volumes]),
                                  _over(batch_dice))
    volumes = volumes + 1e-6
    if square_volumes:
        volumes = volumes ** 2
    tp, fp, fn = tp / volumes, fp / volumes, fn / volumes
    axis = 0 if batch_dice else 1
    tp, fp, fn = tp.sum(dim=axis), fp.sum(dim=axis), fn.sum(dim=axis)
    dc = (2 * tp + smooth) / (2 * tp + fp + fn + smooth)
    return -_dice_mean(dc, batch_dice)


def soft_dice_loss_squared(logits: torch.Tensor, target: torch.Tensor,
                           batch_dice: bool = False, do_bg: bool = True,
                           smooth: float = 1.0) -> torch.Tensor:
    """Soft Dice with probs^2 + onehot^2 in the denominator (reference
    losses.py:172-186)."""
    probs = softmax_helper(logits.float())
    y = one_hot(target, probs.shape[-1])
    axes = tuple(range(0 if batch_dice else 1, probs.dim() - 1))
    intersect = (probs * y).sum(dim=axes)
    denominator = (probs ** 2 + y ** 2).sum(dim=axes)
    intersect, denominator = all_sum(torch.stack([intersect, denominator]),
                                     _over(batch_dice))
    dc = 2 * (intersect + smooth) / (denominator + smooth)
    if not do_bg:
        dc = dc[1:] if batch_dice else dc[:, 1:]
    return -_dice_mean(dc, batch_dice)


def _sigmoid_dice(probs: torch.Tensor, t: torch.Tensor, batch_dice: bool,
                  smooth: float) -> torch.Tensor:
    """The mean soft Dice over the region channels of sigmoid
    probabilities against 0/1 targets (and over the samples without batch
    dice)."""
    axes = tuple(range(0 if batch_dice else 1, probs.dim() - 1))
    tp = (probs * t).sum(dim=axes)
    fp = (probs * (1 - t)).sum(dim=axes)
    fn = ((1 - probs) * t).sum(dim=axes)
    tp, fp, fn = all_sum(torch.stack([tp, fp, fn]), _over(batch_dice))
    return _dice_mean((2 * tp + smooth) / (2 * tp + fp + fn + smooth + 1e-8),
                      batch_dice)


def dc_and_bce_loss(logits: torch.Tensor, target_onehot: torch.Tensor,
                    batch_dice: bool = False,
                    smooth: float = 1.0) -> torch.Tensor:
    """Binary cross-entropy plus sigmoid soft Dice over region channels
    (reference losses.py:189-203); target_onehot (..., R) 0/1."""
    logits = logits.float()
    t = target_onehot.float()
    bce = batch_mean(logits.clamp_min(0) - logits * t
                     + torch.log1p(torch.exp(-logits.abs())))
    return bce - _sigmoid_dice(torch.sigmoid(logits), t, batch_dice, smooth)


def gdl_and_ce_loss(logits, target, **gdl_kwargs):
    """GDL plus cross-entropy (reference losses.py:206-209)."""
    return (generalized_dice_loss(logits, target, **gdl_kwargs)
            + robust_cross_entropy(logits, target))


def dc_and_topk_loss(logits, target, batch_dice: bool = True,
                     k_percent: float = 10.0, smooth: float = 1e-5):
    """Soft Dice plus the top-k cross-entropy (reference
    losses.py:212-217)."""
    return (soft_dice_loss(logits, target, batch_dice=batch_dice,
                           do_bg=False, smooth=smooth)
            + topk_cross_entropy(logits, target, k_percent))


def focal_loss(logits: torch.Tensor, target: torch.Tensor,
               gamma: float = 2.0, alpha: float = 0.25,
               smooth: float = 1e-5) -> torch.Tensor:
    """Per-voxel cross-entropy scaled by alpha_t (1 - p_t)^gamma, p_t
    clipped to [smooth, 1 - smooth], alpha for class 0 and 1 - alpha for
    the rest (reference losses.py:220-236)."""
    logits = logits.float()
    num_classes = logits.shape[-1]
    probs = softmax_helper(logits).reshape(-1, num_classes)
    t = target.reshape(-1).long()
    pt = probs.gather(-1, t[:, None])[:, 0]
    if smooth:
        pt = pt.clamp(smooth, 1.0 - smooth)
    alpha_t = torch.where(t == 0, torch.full_like(pt, alpha),
                          torch.full_like(pt, 1.0 - alpha))
    return batch_mean(-alpha_t * torch.pow(1.0 - pt, gamma) * torch.log(pt))


def mcc_loss(logits: torch.Tensor, target: torch.Tensor,
             batch_dice: bool = True, do_bg: bool = True,
             smooth: float = 0.0,
             loss_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Minus the mean Matthews correlation coefficient of the soft counts,
    normalised by the voxels per sample (reference losses.py:239-263).
    Where a class is absent from the targets the gradient is finite (the
    reference's is NaN)."""
    probs = softmax_helper(logits.float())
    # a sample's voxels: its slabs' under a space group
    voxels = float(count(np.prod(logits.shape[1:-1]), "space"))
    tp, fp, fn = get_tp_fp_fn_tn(probs, target, batch_dice, loss_mask)
    if loss_mask is None:
        total = voxels * (batch_count(logits.shape[0]) if batch_dice else 1)
    else:
        axes = tuple(range(0 if batch_dice else 1, probs.dim() - 1))
        total = all_sum(loss_mask.float().sum(dim=axes)[..., None],
                        _over(batch_dice))
    tn = total - tp - fp - fn
    tp, fp, fn, tn = (v / voxels for v in (tp, fp, fn, tn))
    nominator = tp * tn - fp * fn + smooth
    # sqrt's derivative is infinite at 0, where a class is absent from the
    # targets: the reference's gradient is NaN there, this one that of the
    # zero held constant (the values are the reference's)
    prod = (tp + fp) * (tp + fn) * (tn + fp) * (tn + fn)
    pos = prod > 0
    denominator = torch.where(pos, prod, torch.ones_like(prod)).sqrt() \
        * pos + smooth
    mcc = nominator / (denominator + 1e-8)
    if not do_bg:
        mcc = mcc[1:] if batch_dice else mcc[:, 1:]
    return -_dice_mean(mcc, batch_dice)


def soft_dice_regions(logits: torch.Tensor, target_onehot: torch.Tensor,
                      batch_dice: bool = False,
                      smooth: float = 0.0) -> torch.Tensor:
    """Sigmoid soft Dice over region channels, background included
    (reference losses.py:266-279); target_onehot (..., R) 0/1."""
    probs = torch.sigmoid(logits.float())
    return -_sigmoid_dice(probs, target_onehot.float(), batch_dice, smooth)


LOSS_REGISTRY = {
    "dc_ce": dc_and_ce_loss,
    "mcc": mcc_loss,
    "dice": soft_dice_loss,
    "dice_squared": soft_dice_loss_squared,
    "gdl": generalized_dice_loss,
    "gdl_ce": gdl_and_ce_loss,
    "dc_topk": dc_and_topk_loss,
    "topk": topk_cross_entropy,
    "ce": robust_cross_entropy,
    "focal": focal_loss,
    "dc_bce": dc_and_bce_loss,
    "dice_regions": soft_dice_regions,
}


def hard_tp_fp_fn(logits: torch.Tensor, target: torch.Tensor):
    """Per-class hard counts for the online foreground-Dice estimate
    (reference losses.py:311-326): the argmax of logits (N, ..., C) against
    integer targets (N, ...), summed over the batch and the spatial axes.
    Returns (tp, fp, fn), each (C - 1,) float32 over the foreground
    classes, on the logits' device."""
    num_classes = logits.shape[-1]
    seg = logits.argmax(dim=-1)
    classes = torch.arange(1, num_classes, device=logits.device)
    pred = seg[..., None] == classes
    tgt = target.long()[..., None] == classes
    axes = tuple(range(pred.dim() - 1))
    tp = (pred & tgt).sum(dim=axes)
    fp = (pred & ~tgt).sum(dim=axes)
    fn = (~pred & tgt).sum(dim=axes)
    return tp.float(), fp.float(), fn.float()


def hard_tp_fp_fn_regions(logits: torch.Tensor,
                          target_onehot: torch.Tensor):
    """Per-region hard counts for the online evaluation of the region
    trainers (reference losses.py:282-300,
    nnUNetTrainerV2BraTSRegions.run_online_evaluation): sigmoid(logits) >
    0.5 on each region channel of (N, ..., R) against the 0/1 targets of
    the same shape. Returns (tp, fp, fn), each (R,) float32, on the
    logits' device."""
    pred = torch.sigmoid(logits.float()) > 0.5
    t = target_onehot > 0.5
    axes = tuple(range(pred.dim() - 1))
    tp = (pred & t).sum(dim=axes)
    fp = (pred & ~t).sum(dim=axes)
    fn = (~pred & t).sum(dim=axes)
    return tp.float(), fp.float(), fn.float()


def downsample_seg_for_ds(seg: torch.Tensor,
                          scales: Sequence[Sequence[float]]
                          ) -> List[torch.Tensor]:
    """Nearest-neighbour target downsampling for deep supervision: strided
    slicing from 0 by the reciprocal of each scale (reference
    losses.py:329-340)."""
    outs = []
    for s in scales:
        f = [int(round(1.0 / x)) for x in s]
        outs.append(seg[:, ::f[0], ::f[1], ::f[2]])
    return outs
