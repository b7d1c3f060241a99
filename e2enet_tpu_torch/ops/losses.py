"""Segmentation losses: soft Dice + cross-entropy with deep supervision and
the online evaluation's hard counts, the `dc_ce` subset of
e2enet_tpu/ops/losses.py with hard_tp_fp_fn (reference
e2enet/training/loss_functions/dice_loss.py get_tp_fp_fn_tn, SoftDiceLoss,
DC_and_CE_loss; crossentropy.py RobustCrossEntropyLoss;
deep_supervision.py MultipleOutputLoss2; nnUNetTrainer_simple.
run_online_evaluation).

Layout: logits (N, D, H, W, C), float32 as the heads return them; targets
(N, D, H, W) integer labels. All loss math in float32.
"""
from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F


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
    fp = probs.sum(dim=axes) - tp
    fn = y.sum(dim=axes) - tp
    return tp, fp, fn


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
    return -dc.mean()


def robust_cross_entropy(logits: torch.Tensor, target: torch.Tensor,
                         loss_mask: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Mean cross-entropy over the voxels, contracted against the one-hot
    target (reference losses.py:66-79)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -(logp * one_hot(target, logits.shape[-1])).sum(dim=-1)
    if loss_mask is not None:
        m = loss_mask.float()
        return (nll * m).sum() / m.sum().clamp_min(1.0)
    return nll.mean()


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


def deep_supervision_loss(outputs: Sequence[torch.Tensor],
                          targets: Sequence[torch.Tensor],
                          weights: Sequence[float],
                          batch_dice: bool = True) -> torch.Tensor:
    """Weighted sum of dc_and_ce_loss over the deep-supervision heads,
    zero-weight heads skipped (reference losses.py:127-140)."""
    total = torch.zeros((), dtype=torch.float32, device=outputs[0].device)
    for o, t, w in zip(outputs, targets, weights):
        if float(w) == 0.0:
            continue
        total = total + float(w) * dc_and_ce_loss(o, t, batch_dice=batch_dice)
    return total


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
