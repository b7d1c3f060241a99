"""Region-based evaluation for composite-label challenges.

Parity: reference e2enet/evaluation/region_based_evaluation.py (:12-53):
BraTS regions (whole tumor / tumor core / enhancing tumor) and KiTS
(kidney+tumor / tumor); Dice over the union of each region's labels.

The port's own copy of e2enet_tpu/evaluation/region_based_evaluation.py,
unchanged but for this note: summary.csv is written as the JAX package
writes it. The port imports nothing of the JAX package.
"""
from collections import OrderedDict
from typing import Dict, List, Tuple

import numpy as np

from ..io.nifti import read_nifti
from ..utils.files import join, subfiles


def get_brats_regions() -> Dict[str, Tuple[int, ...]]:
    return OrderedDict([
        ("whole tumor", (1, 2, 3)),
        ("tumor core", (2, 3)),
        ("enhancing tumor", (3,)),
    ])


def get_kits_regions() -> Dict[str, Tuple[int, ...]]:
    return OrderedDict([
        ("kidney incl tumor", (1, 2)),
        ("tumor", (2,)),
    ])


def create_region_from_mask(mask: np.ndarray, join_labels) -> np.ndarray:
    mask_new = np.zeros_like(mask, dtype=np.uint8)
    for l in join_labels:
        mask_new[mask == l] = 1
    return mask_new


def evaluate_case(file_pred: str, file_gt: str, regions) -> List[float]:
    """The Dice of each region (a tuple of labels) between two label maps,
    NaN where the region is empty in both."""
    image_gt = read_nifti(file_gt).array
    image_pred = read_nifti(file_pred).array
    results = []
    for r in regions:
        mask_pred = create_region_from_mask(image_pred, r)
        mask_gt = create_region_from_mask(image_gt, r)
        tp = float(np.sum((mask_gt == 1) & (mask_pred == 1)))
        denom = float(np.sum(mask_gt) + np.sum(mask_pred))
        dc = np.nan if denom == 0 else 2 * tp / denom
        results.append(dc)
    return results


def evaluate_regions(folder_predicted: str, folder_gt: str,
                     regions: Dict[str, Tuple[int, ...]]):
    """Every prediction of `folder_predicted` against its ground truth in
    `folder_gt` by region; writes folder_predicted/summary.csv (one row
    per case, then the mean and the median, NaN left out) and returns
    {region: [Dice per case]}."""
    region_names = list(regions.keys())
    files_in_pred = subfiles(folder_predicted, suffix=".nii.gz", join=False)
    files_in_gt = subfiles(folder_gt, suffix=".nii.gz", join=False)
    have_no_gt = [i for i in files_in_pred if i not in files_in_gt]
    assert len(have_no_gt) == 0, "predictions without ground truth"
    evaluate_files = [i for i in files_in_gt if i in files_in_pred]

    full_pred = [join(folder_predicted, i) for i in evaluate_files]
    full_gt = [join(folder_gt, i) for i in evaluate_files]
    results = [evaluate_case(p, g, list(regions.values()))
               for p, g in zip(full_pred, full_gt)]

    all_results = {r: [] for r in region_names}
    with open(join(folder_predicted, "summary.csv"), "w") as f:
        f.write("casename")
        for r in region_names:
            f.write(",%s" % r)
        f.write("\n")
        for i in range(len(evaluate_files)):
            f.write(evaluate_files[i][:-7])
            for k, r in enumerate(region_names):
                f.write(",%02.4f" % results[i][k])
                all_results[r].append(results[i][k])
            f.write("\n")
        f.write("mean")
        for r in region_names:
            f.write(",%02.4f" % np.nanmean(all_results[r]))
        f.write("\n")
        f.write("median")
        for r in region_names:
            f.write(",%02.4f" % np.nanmedian(all_results[r]))
        f.write("\n")
    return all_results
