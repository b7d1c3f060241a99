"""Region-based training targets (BraTS competition trainers).

Parity: reference ConvertSegmentationToRegionsTransform
(data_augmentation/custom_transforms.py) as used by
nnUNetTrainerV2BraTSRegions (competitions_with_custom_Trainers/BraTS2020/
nnUNetTrainerV2BraTSRegions.py:66-140): the label map becomes one binary
channel per region (a union of labels); the network emits one sigmoid
head per region and the export reconstructs labels via regions_class_order.

The port's own copy of e2enet_tpu/training/regions.py; it imports nothing
of the JAX package.
"""
from typing import Dict, Sequence, Tuple

import numpy as np

from ..evaluation.region_based_evaluation import get_brats_regions


def resolve_regions(spec) -> Dict[str, Tuple[int, ...]]:
    """'brats' | {name: labels} -> ordered region dict."""
    if spec == "brats":
        return get_brats_regions()
    if isinstance(spec, dict):
        return {str(k): tuple(int(x) for x in v) for k, v in spec.items()}
    raise ValueError(f"unknown regions spec {spec!r}")


def convert_seg_to_regions(seg: np.ndarray,
                           regions: Sequence[Tuple[int, ...]]
                           ) -> np.ndarray:
    """(B, x, y, z) int labels -> (B, x, y, z, R) float32 region one-hot
    (channels-last, matching the network logits layout)."""
    out = np.zeros((*seg.shape, len(regions)), np.float32)
    for r, labels in enumerate(regions):
        m = np.zeros(seg.shape, bool)
        for l in labels:
            m |= seg == l
        out[..., r] = m
    return out


def regions_seg_from_probs(probs: np.ndarray,
                           class_order: Sequence[int]) -> np.ndarray:
    """Sigmoid region probs (R, X, Y, Z) -> label map via
    regions_class_order (nnUNetTrainerV2BraTSRegions.validate: seg starts
    at 0; region i's voxels above 0.5 are overwritten with class_order[i],
    in order).

    A library function kept for parity with the JAX package: no path of
    the port calls it. Validation's labels come from
    inference/export.save_segmentation_nifti_from_softmax, which applies
    the same rule after resampling."""
    seg = np.zeros(probs.shape[1:], np.uint8)
    for i, c in enumerate(class_order):
        seg[probs[i] > 0.5] = c
    return seg
