"""Ranger (RAdam + Lookahead) for the variant trainers: the port of
e2enet_tpu/training/ranger.py (reference e2enet/training/optimizer/
ranger.py:11-120; defaults lr, alpha=0.5, k=6, N_sma_threshhold=5,
betas=(0.95, 0.999), eps=1e-5, weight_decay=0; used by the
nnUNetTrainerV2_Ranger_* variants).

The state holds dicts of float32 tensors by parameter name and the step
as a Python int. The step's scalars (the bias corrections, the rectifier,
whether the variance term is used, whether Lookahead fires) are computed
on the host in float32 as the reference computes them, so no update waits
for the card; the tensors are updated in place with torch's multi-tensor
(_foreach) ops, a few launches per update on the card whatever the number
of tensors.
"""
from typing import Dict, NamedTuple

import numpy as np
import torch

_F = np.float32


class RangerState(NamedTuple):
    step: int
    exp_avg: Dict[str, torch.Tensor]
    exp_avg_sq: Dict[str, torch.Tensor]
    slow: Dict[str, torch.Tensor]


def ranger_init(params: Dict[str, torch.Tensor]) -> RangerState:
    """Zero moments and slow weights equal to the parameters."""
    def zeros():
        return {n: torch.zeros_like(p, dtype=torch.float32)
                for n, p in params.items()}
    return RangerState(step=0, exp_avg=zeros(), exp_avg_sq=zeros(),
                       slow={n: p.detach().float().clone()
                             for n, p in params.items()})


def radam_scalars(step: int, b1: float, b2: float,
                  n_sma_threshhold: float):
    """(use_var, step_size, 1 - b2^step) of RAdam at `step`, in float32 in
    the reference's order of operations (ranger.py:43-55)."""
    tf = _F(step)
    beta2_t = _F(b2) ** tf
    n_sma_max = 2.0 / (1 - b2) - 1
    n_sma = _F(n_sma_max) - _F(2) * tf * beta2_t / (_F(1) - beta2_t)
    use_var = bool(n_sma > _F(n_sma_threshhold))
    r = np.sqrt(np.maximum(
        (n_sma - _F(4)) / _F(max(n_sma_max - 4, 1e-8))
        * (n_sma - _F(2)) / np.maximum(n_sma, _F(1e-8))
        * _F(n_sma_max) / _F(n_sma_max - 2), _F(0)))
    bc1 = _F(1) - _F(b1) ** tf
    step_size = r / bc1 if use_var else _F(1) / bc1
    return use_var, _F(step_size), _F(1) - beta2_t


def ranger_update(params: Dict[str, torch.Tensor], state: RangerState,
                  grads: Dict[str, torch.Tensor], lr: float,
                  betas=(0.95, 0.999), eps: float = 1e-5,
                  weight_decay: float = 0.0, alpha: float = 0.5,
                  k: int = 6, n_sma_threshhold: int = 5):
    """One Ranger step on params (in place) from grads; returns (params,
    the new state, whose tensors are the old state's, updated in
    place)."""
    b1, b2 = betas
    step = state.step + 1
    use_var, step_size, one_minus_b2t = radam_scalars(step, b1, b2,
                                                      n_sma_threshhold)
    lr = _F(lr)
    names = list(params)
    p = [params[n] for n in names]
    g = [grads[n].float() for n in names]
    m = [state.exp_avg[n] for n in names]
    v = [state.exp_avg_sq[n] for n in names]
    with torch.no_grad():
        # m = b1 m + (1 - b1) g; v = b2 v + (1 - b2) g g
        torch._foreach_mul_(m, float(_F(b1)))
        torch._foreach_add_(m, torch._foreach_mul(g, float(_F(1 - b1))))
        gg = torch._foreach_mul(g, float(_F(1 - b2)))
        torch._foreach_mul_(gg, g)
        torch._foreach_mul_(v, float(_F(b2)))
        torch._foreach_add_(v, gg)
        del gg
        if weight_decay != 0:
            torch._foreach_sub_(p, torch._foreach_mul(
                p, float(lr * _F(weight_decay))))
        if use_var:
            denom = torch._foreach_div(v, float(one_minus_b2t))
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, float(_F(eps)))
            delta = torch._foreach_div(m, denom)
            del denom
        else:
            delta = m
        torch._foreach_sub_(p, torch._foreach_mul(
            delta, float(lr * step_size)))
        del delta
        if step % k == 0:
            # Lookahead: the slow weights move alpha of the way to the
            # fast ones, which then take their value
            slow = [state.slow[n] for n in names]
            diff = torch._foreach_sub(p, slow)
            torch._foreach_add_(slow, torch._foreach_mul(
                diff, float(_F(alpha))))
            for a, b in zip(p, slow):
                a.copy_(b)
    return params, state._replace(step=step)
