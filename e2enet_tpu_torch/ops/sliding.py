"""Gaussian-weighted sliding-window inference with mirror TTA.
Counterpart of e2enet_tpu/ops/sliding.py (step grid, Gaussian map, the
plain channels-last branches of _tiled_accumulate and
predict_volume_tiled), as a Python loop over tiles and mirror passes on
the device. Two kinds of mirror TTA: data flips (flip the tile, unflip the
probabilities) and flip-free (one statically mirrored forward per pass on
the unflipped tile, inference/predictor.mirror_apply_fns_for). The
probabilities are the class softmax, or with nonlin="sigmoid" one sigmoid
per channel (the region trainers' heads, reference make_tiled_predictor's
nonlin).
"""
import functools
import warnings
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
from scipy.ndimage import gaussian_filter


def compute_steps_for_sliding_window(patch_size: Sequence[int],
                                     image_size: Sequence[int],
                                     step_size: float) -> List[List[int]]:
    """Tile starts per axis: ceil-spaced, first at 0, last flush with the
    end, stride at most patch_size * step_size."""
    assert all(i >= j for i, j in zip(image_size, patch_size)), \
        "image size must be as large or larger than patch_size"
    assert 0 < step_size <= 1, "step_size must be in (0, 1]"
    target = [i * step_size for i in patch_size]
    num_steps = [int(np.ceil((i - k) / j)) + 1
                 for i, j, k in zip(image_size, target, patch_size)]
    steps = []
    for dim in range(len(patch_size)):
        max_step_value = image_size[dim] - patch_size[dim]
        actual = (max_step_value / (num_steps[dim] - 1)
                  if num_steps[dim] > 1 else 99999999999)
        steps.append([int(np.round(actual * i))
                      for i in range(num_steps[dim])])
    return steps


@functools.lru_cache(maxsize=8)
def gaussian_importance_map(patch_size: Tuple[int, ...],
                            sigma_scale: float = 1.0 / 8) -> np.ndarray:
    """Tile-blending weights: sigma = patch/8, peak 1, zeros floored to the
    smallest positive value. Callers must not write to the result."""
    tmp = np.zeros(patch_size)
    tmp[tuple(i // 2 for i in patch_size)] = 1
    g = gaussian_filter(tmp, [i * sigma_scale for i in patch_size], 0,
                        mode="constant", cval=0)
    g = (g / np.max(g)).astype(np.float32)
    g[g == 0] = np.min(g[g != 0])
    return g


def flip_combinations(mirror_axes: Sequence[int]) -> List[Tuple[int, ...]]:
    """All subsets of the mirror axes, identity first: the 2**n passes."""
    combos = [()]
    for a in sorted(mirror_axes):
        combos = combos + [c + (a,) for c in combos]
    return combos


NONLINS = ("softmax", "sigmoid")


def head_probs(out: torch.Tensor, nonlin: str = "softmax") -> torch.Tensor:
    """Probabilities of a head's output, in float32: float32 logits through
    the class softmax (nonlin="softmax") or a sigmoid per channel
    ("sigmoid", the region trainers'); bfloat16 probabilities (a probs
    head's softmax) taken as they are under "softmax". Anything else is
    refused, sigmoid over a probs head included, so no head's output goes
    through a second nonlinearity."""
    if nonlin not in NONLINS:
        raise ValueError(f"nonlin {nonlin!r}: one of {NONLINS}")
    if out.dtype == torch.float32:
        if nonlin == "sigmoid":
            return torch.sigmoid(out)
        return torch.softmax(out, dim=-1)
    if out.dtype == torch.bfloat16 and nonlin == "softmax":
        return out.float()
    raise TypeError(f"head output of dtype {out.dtype} under {nonlin}: "
                    f"expected float32 logits"
                    + (" or bfloat16 probabilities" if nonlin == "softmax"
                       else " (a bfloat16 output is a probs head's softmax)"))


def check_prob_dtype(prob_dtype, mirror_apply_fns):
    """prob_dtype acts only on the data-flip branch's unflips: under
    flip-free TTA there are none, so it is ignored there with a warning
    (reference _check_prob_dtype)."""
    if prob_dtype is not None and mirror_apply_fns is not None:
        warnings.warn("prob_dtype is a no-op under flip-free TTA "
                      "(mirror_apply_fns); ignoring it", stacklevel=3)
        return None
    return prob_dtype


def pad_volume_to_patch(data: np.ndarray, patch_size: Sequence[int]):
    """Pad (C, X, Y, Z) with centred zeros so every spatial dim >= patch.
    Returns (padded, slicer that undoes it)."""
    shape = data.shape[1:]
    diff = [max(s, p) - s for s, p in zip(shape, patch_size)]
    lo = [d // 2 for d in diff]
    pad = [(0, 0)] + [(l, d - l) for l, d in zip(lo, diff)]
    padded = np.pad(data, pad, mode="constant")
    slicer = tuple([slice(None)] + [slice(l, l + s)
                                    for l, s in zip(lo, shape)])
    return padded, slicer


def bucket_num_tiles(n: int, buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512,
                                      1024, 2048, 4096)) -> int:
    """Tile count rounded up to a bucket (the reference pads its tile list
    to one so a compiled program serves many shapes)."""
    for b in buckets:
        if n <= b:
            return b
    return int(2 ** np.ceil(np.log2(n)))


def tiled_accumulate(apply_fn: Callable[[torch.Tensor], torch.Tensor],
                     vol: torch.Tensor, patch_size: Sequence[int],
                     num_classes: int, step_size: float = 0.5,
                     mirror_axes: Tuple[int, ...] = (0, 1, 2),
                     do_mirroring: bool = True,
                     accum_dtype: torch.dtype = torch.float32,
                     mirror_apply_fns: Optional[
                         Sequence[Callable[[torch.Tensor],
                                           torch.Tensor]]] = None,
                     prob_dtype: Optional[torch.dtype] = None,
                     nonlin: str = "softmax"
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The tile loop on the device (the reference's make_tiled_predictor
    program): vol (X, Y, Z, C) float32 on the device, each dim at least
    the patch's -> the accumulators (acc (X, Y, Z, num_classes), weights
    (X, Y, Z)) in accum_dtype, on vol's device.

    apply_fn(x (1, pd, ph, pw, C)) -> float32 logits or bfloat16
    probabilities (1, pd, ph, pw, num_classes) (head_probs; under
    nonlin="sigmoid" float32 logits only). Per tile: every mirror pass
    flips the patch, takes the head's probabilities (head_probs(.,
    nonlin)) in float32 and unflips them. With mirror_apply_fns (one per
    flip_combinations pass, fns[m](x) == flip_m(net(flip_m(x)))) pass m
    runs fns[m] on the unflipped patch instead, and apply_fn is not used.
    prob_dtype (data-flip branch only; reference make_tiled_predictor):
    each pass's probabilities are rounded to it before the unflip, as the
    reference stores them in its fast mode (bfloat16). The float32 mean
    over passes is weighted by the Gaussian, cast to accum_dtype and added
    to the accumulators, as are the weights."""
    prob_dtype = check_prob_dtype(prob_dtype, mirror_apply_fns)
    device = vol.device
    X, Y, Z, _ = vol.shape
    pd, ph, pw = patch_size
    steps = compute_steps_for_sliding_window(patch_size, (X, Y, Z),
                                             step_size)
    combos = flip_combinations(mirror_axes) if do_mirroring else [()]
    if mirror_apply_fns is not None and len(mirror_apply_fns) != len(combos):
        raise ValueError(f"{len(mirror_apply_fns)} mirror_apply_fns for "
                         f"{len(combos)} mirror passes")
    gmap = torch.from_numpy(
        gaussian_importance_map(tuple(patch_size))).to(device)
    gmap_acc = gmap.to(accum_dtype)
    acc = torch.zeros((X, Y, Z, num_classes), dtype=accum_dtype,
                      device=device)
    wacc = torch.zeros((X, Y, Z), dtype=accum_dtype, device=device)
    for x0 in steps[0]:
        for y0 in steps[1]:
            for z0 in steps[2]:
                sl = (slice(x0, x0 + pd), slice(y0, y0 + ph),
                      slice(z0, z0 + pw))
                patch = vol[sl]
                prob_sum = torch.zeros((pd, ph, pw, num_classes),
                                       dtype=torch.float32, device=device)
                if mirror_apply_fns is not None:
                    for fn in mirror_apply_fns:
                        prob_sum += head_probs(fn(patch[None])[0],
                                               nonlin)
                else:
                    for combo in combos:
                        xin = patch.flip(combo) if combo else patch
                        p = head_probs(apply_fn(xin[None])[0], nonlin)
                        if prob_dtype is not None:
                            p = p.to(prob_dtype)
                        prob_sum += p.flip(combo) if combo else p
                mean = prob_sum / len(combos)
                acc[sl] += (mean * gmap[..., None]).to(accum_dtype)
                wacc[sl] += gmap_acc
    return acc, wacc


def predict_volume_tiled(apply_fn: Callable[[torch.Tensor], torch.Tensor],
                         data: np.ndarray, patch_size: Sequence[int],
                         num_classes: int, *, device,
                         step_size: float = 0.5,
                         mirror_axes: Tuple[int, ...] = (0, 1, 2),
                         do_mirroring: bool = True,
                         accum_dtype: torch.dtype = torch.float32,
                         mirror_apply_fns: Optional[
                             Sequence[Callable[[torch.Tensor],
                                               torch.Tensor]]] = None,
                         prob_dtype: Optional[torch.dtype] = None,
                         nonlin: str = "softmax") -> np.ndarray:
    """data: (C, X, Y, Z) float32 -> class probabilities (num_classes, X,
    Y, Z), per-channel sigmoid probabilities under nonlin="sigmoid", as
    numpy in accum_dtype: the volume padded to the patch and moved
    to `device`, tiled_accumulate (which says what the arguments do), then
    acc / weights computed in accum_dtype (a zero weight taken as 1, as the
    reference does) and the padding cropped."""
    padded, slicer = pad_volume_to_patch(data, patch_size)
    vol = torch.from_numpy(np.ascontiguousarray(
        np.moveaxis(padded, 0, -1), dtype=np.float32)).to(device)
    acc, wacc = tiled_accumulate(
        apply_fn, vol, patch_size, num_classes, step_size=step_size,
        mirror_axes=mirror_axes, do_mirroring=do_mirroring,
        accum_dtype=accum_dtype, mirror_apply_fns=mirror_apply_fns,
        prob_dtype=prob_dtype, nonlin=nonlin)
    wacc = torch.where(wacc == 0, torch.ones_like(wacc), wacc)
    probs = (acc / wacc[..., None]).cpu().numpy()
    probs = np.moveaxis(probs, -1, 0)
    return probs[(slice(None),) + slicer[1:]]
