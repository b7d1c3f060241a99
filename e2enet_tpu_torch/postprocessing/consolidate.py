"""Consolidate cross-validation folds and re-determine postprocessing.

Parity: reference postprocessing/consolidate_postprocessing.py
(consolidate_folds :25-70): merge all 5 folds' raw validation niftis into
cv_niftis_raw/, evaluate against the ground truth, then run
determine_postprocessing on the pooled set so postprocessing.json reflects
the full CV rather than one fold.

The port's own copy of e2enet_tpu/postprocessing/consolidate.py,
unchanged but for this note: the port imports nothing of the JAX package.
"""

import numpy as np

from ..evaluation.evaluator import aggregate_scores
from ..evaluation.model_selection import collect_cv_niftis
from ..io.nifti import read_nifti
from ..utils.files import isfile, join, load_json, subfiles
from .connected_components import determine_postprocessing


def consolidate_folds(output_folder_base: str, gt_labels_folder: str,
                      validation_folder_name: str = "validation_raw",
                      folds=(0, 1, 2, 3, 4), advanced_postprocessing=False,
                      processes: int = 2):
    raw = join(output_folder_base, "cv_niftis_raw")
    collect_cv_niftis(output_folder_base, raw, validation_folder_name,
                      folds)

    niftis = subfiles(raw, join=False, suffix=".nii.gz")
    assert len(niftis) > 0, "no validation niftis collected"

    # labels from one fold's summary (or from gt)
    some_summary = None
    for f in folds:
        s = join(output_folder_base, f"fold_{f}", validation_folder_name,
                 "summary.json")
        if isfile(s):
            some_summary = s
            break
    if some_summary is not None:
        labels = [int(i) for i in
                  load_json(some_summary)["results"]["mean"].keys()]
    else:
        labels = sorted(int(i) for i in np.unique(
            read_nifti(join(gt_labels_folder, niftis[0])).array))

    pred_gt_tuples = [[join(raw, f), join(gt_labels_folder, f)]
                      for f in niftis]
    aggregate_scores(pred_gt_tuples, labels=labels,
                     json_output_file=join(raw, "summary.json"),
                     num_threads=processes)

    return determine_postprocessing(
        output_folder_base, gt_labels_folder, "cv_niftis_raw",
        temp_folder="temp", final_subf_name="cv_niftis_postprocessed",
        processes=processes, advanced_postprocessing=advanced_postprocessing)
