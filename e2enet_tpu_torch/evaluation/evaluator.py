"""Label-wise metric evaluation over prediction/reference NIfTI pairs.

Parity: reference evaluator.py (root; same class at
e2enet/evaluation/evaluator.py): Evaluator (:31-240), NiftiEvaluator
(:243-305), run_evaluation/aggregate_scores (:308-402, summary.json with
md5 id), evaluate_folder/nnunet_evaluate_folder (:448-506, `_0000` name
stripping).

The port's own copy of e2enet_tpu/evaluation/evaluator.py, with two
changes that leave every score the same: aggregate_scores evaluates the
pairs on a pool of threads, each with its own copy of the evaluator, not
on a pool of forked processes (the trainer calls it from a process that
holds the card and its threads), and Evaluator.evaluate scores the labels
on a pool of threads, each with its own confusion matrix (numpy, scipy's
erosion, dilation and distance transform and zlib release the GIL in the
heavy parts; the surface Dice's border work per label dominates a case's
time, see metrics.py). The port imports nothing of the JAX package.
"""
import collections
import copy
import hashlib
import json
import os
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from datetime import datetime

import numpy as np

from ..io.nifti import read_nifti
from ..utils.files import save_json, subfiles
from .metrics import ALL_METRICS, ConfusionMatrix


class Evaluator:
    """Computes a configurable set of metrics per label on a (test,
    reference) segmentation pair."""

    default_metrics = [
        "False Positive Rate",
        "Dice",
        "Jaccard",
        "Precision",
        "Recall",
        "Accuracy",
        "False Omission Rate",
        "Negative Predictive Value",
        "False Negative Rate",
        "True Negative Rate",
        "False Discovery Rate",
        "Total Positives Test",
        "Total Positives Reference",
        "surface_dice_at_tolerance",
    ]

    default_advanced_metrics = [
        "Hausdorff Distance 95",
        "Avg. Surface Distance",
        "Avg. Symmetric Surface Distance",
    ]

    def __init__(self, test=None, reference=None, labels=None, metrics=None,
                 advanced_metrics=None, nan_for_nonexisting=True):
        self.test = None
        self.reference = None
        self.confusion_matrix = ConfusionMatrix()
        self.labels = None
        self.nan_for_nonexisting = nan_for_nonexisting
        self.result = None
        self.metrics = list(metrics) if metrics is not None \
            else list(self.default_metrics)
        self.advanced_metrics = list(advanced_metrics) \
            if advanced_metrics is not None \
            else list(self.default_advanced_metrics)
        self.set_reference(reference)
        self.set_test(test)
        if labels is not None:
            self.set_labels(labels)
        elif test is not None and reference is not None:
            self.construct_labels()

    def set_test(self, test):
        self.test = test

    def set_reference(self, reference):
        self.reference = reference

    def set_labels(self, labels):
        if isinstance(labels, dict):
            self.labels = collections.OrderedDict(labels)
        elif isinstance(labels, (set, np.ndarray)):
            self.labels = list(map(int, labels))
        elif isinstance(labels, (list, tuple)):
            self.labels = list(labels)
        else:
            raise TypeError(f"cannot handle labels of type {type(labels)}")

    def construct_labels(self):
        if self.test is None and self.reference is None:
            raise ValueError("No test or reference segmentations.")
        if self.test is None:
            labels = np.unique(self.reference)
        else:
            labels = np.union1d(np.unique(self.test),
                                np.unique(self.reference))
        self.labels = [int(i) for i in labels]

    def evaluate(self, test=None, reference=None, advanced=False,
                 **metric_kwargs):
        if test is not None:
            self.set_test(test)
        if reference is not None:
            self.set_reference(reference)
        if self.test is None or self.reference is None:
            raise ValueError("Need both test and reference segmentations.")
        if self.labels is None:
            self.construct_labels()
        self.metrics.sort()

        _funcs = {m: ALL_METRICS[m]
                  for m in self.metrics + self.advanced_metrics}
        self.result = OrderedDict()
        eval_metrics = list(self.metrics)
        if advanced:
            eval_metrics += self.advanced_metrics

        label_items = (self.labels.items() if isinstance(self.labels, dict)
                       else [(l, l) for l in self.labels])

        def label_scores(label):
            cm = ConfusionMatrix()
            if not hasattr(label, "__iter__"):
                cm.set_test(self.test == label)
                cm.set_reference(self.reference == label)
            else:
                current_test = 0
                current_reference = 0
                for l in label:
                    current_test = current_test + (self.test == l)
                    current_reference = current_reference + \
                        (self.reference == l)
                cm.set_test(current_test)
                cm.set_reference(current_reference)
            scores = OrderedDict(
                (metric, _funcs[metric](
                    confusion_matrix=cm,
                    nan_for_nonexisting=self.nan_for_nonexisting,
                    **metric_kwargs))
                for metric in eval_metrics)
            return cm, scores

        # the labels on a pool of threads: the surface distances' erosion
        # and distance transform release the GIL
        workers = max(1, min(len(label_items), os.cpu_count() or 1))
        with ThreadPoolExecutor(max_workers=workers) as pool:
            done = list(pool.map(label_scores,
                                 [label for label, _ in label_items]))
        for (_, name), (cm, scores) in zip(label_items, done):
            self.result[str(name)] = scores
            self.confusion_matrix = cm
        return self.result

    def to_dict(self):
        if self.result is None:
            self.evaluate()
        return self.result


class NiftiEvaluator(Evaluator):
    def __init__(self, *args, **kwargs):
        self.test_nifti = None
        self.reference_nifti = None
        super().__init__(*args, **kwargs)

    def set_test(self, test):
        if isinstance(test, str):
            self.test_nifti = read_nifti(test)
            super().set_test(self.test_nifti.array)
        else:
            self.test_nifti = None
            super().set_test(test)

    def set_reference(self, reference):
        if isinstance(reference, str):
            self.reference_nifti = read_nifti(reference)
            super().set_reference(self.reference_nifti.array)
        else:
            self.reference_nifti = None
            super().set_reference(reference)

    def evaluate(self, test=None, reference=None, voxel_spacing=None,
                 **metric_kwargs):
        if voxel_spacing is None and self.test_nifti is not None:
            # arrays are (z,y,x); spacing stored (x,y,z)
            voxel_spacing = np.array(self.test_nifti.spacing)[::-1]
        return super().evaluate(test, reference,
                                voxel_spacing=voxel_spacing,
                                **metric_kwargs)


def run_evaluation(args):
    test, ref, evaluator, metric_kwargs = args
    evaluator.set_test(test)
    evaluator.set_reference(ref)
    if evaluator.labels is None:
        evaluator.construct_labels()
    current_scores = evaluator.evaluate(**metric_kwargs)
    if isinstance(test, str):
        current_scores["test"] = test
    if isinstance(ref, str):
        current_scores["reference"] = ref
    return current_scores


def aggregate_scores(test_ref_pairs, evaluator=NiftiEvaluator, labels=None,
                     nanmean=True, json_output_file=None, json_name="",
                     json_description="", json_author="",
                     json_task="", num_threads=2, **metric_kwargs):
    """Evaluate every pair, aggregate (nan)means per label and write
    summary.json (md5-id'd)."""
    if isinstance(evaluator, type):
        evaluator = evaluator()
    if labels is not None:
        evaluator.set_labels(labels)

    all_scores = OrderedDict()
    all_scores["all"] = []
    all_scores["mean"] = OrderedDict()

    test = [i[0] for i in test_ref_pairs]
    ref = [i[1] for i in test_ref_pairs]
    args = list(zip(test, ref,
                    [copy.deepcopy(evaluator) for _ in ref],
                    [metric_kwargs] * len(ref)))
    if num_threads > 1 and (os.cpu_count() or 1) > 1:
        with ThreadPoolExecutor(max_workers=num_threads) as pool:
            all_res = list(pool.map(run_evaluation, args))
    else:
        all_res = [run_evaluation(a) for a in args]

    for res in all_res:
        all_scores["all"].append(res)
        for label, score_dict in res.items():
            if label in ("test", "reference"):
                continue
            if label not in all_scores["mean"]:
                all_scores["mean"][label] = OrderedDict()
            for score, value in score_dict.items():
                all_scores["mean"][label].setdefault(score, []).append(value)

    for label in all_scores["mean"]:
        for score in all_scores["mean"][label]:
            vals = all_scores["mean"][label][score]
            all_scores["mean"][label][score] = float(
                np.nanmean(vals) if nanmean else np.mean(vals))

    if json_output_file is not None:
        json_dict = OrderedDict()
        json_dict["name"] = json_name
        json_dict["description"] = json_description
        json_dict["timestamp"] = str(datetime.today())
        json_dict["task"] = json_task
        json_dict["author"] = json_author
        json_dict["results"] = all_scores
        json_dict["id"] = hashlib.md5(
            json.dumps(json_dict).encode("utf-8")).hexdigest()[:12]
        save_json(json_dict, json_output_file, sort_keys=False)
    return all_scores


def evaluate_folder(folder_with_gts: str, folder_with_predictions: str,
                    labels, **metric_kwargs):
    """Folder-vs-folder evaluation -> summary.json in the prediction folder
    (evaluator.py:448-468, incl. `_0000` stripping)."""
    files_gt = subfiles(folder_with_gts, suffix=".nii.gz", join=False)
    files_pred = subfiles(folder_with_predictions, suffix=".nii.gz",
                          join=False)
    files_gt = [i if i in files_pred else i.replace("_0000.nii.gz",
                                                    ".nii.gz")
                for i in files_gt]
    assert all(i in files_pred for i in files_gt), \
        "files missing in folder_with_predictions"
    assert all(i in files_gt for i in files_pred), \
        "files missing in folder_with_gts"
    test_ref_pairs = [(os.path.join(folder_with_predictions, i),
                       os.path.join(folder_with_gts, i)) for i in files_pred]
    return aggregate_scores(
        test_ref_pairs,
        json_output_file=os.path.join(folder_with_predictions,
                                      "summary.json"),
        num_threads=8, labels=labels, **metric_kwargs)
