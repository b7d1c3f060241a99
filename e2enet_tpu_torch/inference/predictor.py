"""Inference helpers around the sliding-window predictor. Counterpart of
e2enet_tpu/inference/predictor.py; so far only the flip-free mirror TTA
of the port's channels-last model."""
from typing import Callable, List, Sequence

import torch

from ..ops.sliding import flip_combinations


def mirror_apply_fns_for(model, mirror_axes: Sequence[int] = (0, 1, 2)
                         ) -> List[Callable[[torch.Tensor], torch.Tensor]]:
    """Flip-free mirror TTA: one statically mirrored forward per flip
    combination, in ops/sliding.flip_combinations order, all sharing the
    model's parameters: fns[m](x) == flip_m(model(flip_m(x))) through the
    mirrored operators of model.forward(..., flips=...), so the
    sliding-window predictor never flips data (reference
    mirror_apply_fns_for)."""
    fns = []
    for c in flip_combinations(mirror_axes):
        f = tuple(a in c for a in (0, 1, 2))
        fns.append(lambda x, _f=f: model(x, do_ds=False, flips=_f))
    return fns
