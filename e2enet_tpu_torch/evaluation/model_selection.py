"""Model selection across configurations: rank trained configurations
(2d/3d_fullres/3d_lowres/cascade and their pairwise ensembles) by
cross-validation mean foreground Dice and pick what to submit.

Parity: reference e2enet/evaluation/model_selection/
(figure_out_what_to_submit.py:47+, ensemble.py:39, summarize results
collectors — 9 files, 1395 LoC). The ensemble step averages the validation
softmax (requires validate(save_softmax=True)).

The port's own copy of e2enet_tpu/evaluation/model_selection.py, with one
change: ensemble_validation_softmax reads the ground truth with the port's
io.nifti (the reference loads e2enet_tpu.io.nifti by name). The port
imports nothing of the JAX package. prediction_commands.txt names the
reference's e2enet_predict and e2enet_ensemble, as the JAX package writes
it, though no package installs either command; the port's own are
`python -m e2enet_tpu_torch.cli.predict` and
inference.ensemble_predictions.merge.
"""
import os
from collections import OrderedDict
from typing import Dict, Optional

import numpy as np

from .. import paths
from ..io.nifti import read_nifti
from ..utils.files import (isdir, isfile, join, load_json, maybe_mkdir_p, save_json)
from .evaluator import aggregate_scores


def get_mean_foreground_dice(json_file: str) -> float:
    results = load_json(json_file)["results"]["mean"]
    return foreground_mean_from_results(results)


def foreground_mean_from_results(results: Dict) -> float:
    dice_scores = [results[c]["Dice"] for c in results.keys()
                   if int(c) != 0]
    return float(np.nanmean(dice_scores))


def collect_cv_niftis(trained_model_folder: str, output_folder: str,
                      validation_folder_name: str = "validation_raw",
                      folds=(0, 1, 2, 3, 4)):
    """Gather the per-fold validation niftis into one folder (full CV set).
    Parity: model_selection/figure_out_what_to_submit collect step."""
    import shutil
    maybe_mkdir_p(output_folder)
    folders_folds = [join(trained_model_folder, f"fold_{f}") for f in folds]
    exist = [f for f in folders_folds if isdir(f)]
    for f in exist:
        val = join(f, validation_folder_name)
        if not isdir(val):
            continue
        for nii in os.listdir(val):
            if nii.endswith(".nii.gz"):
                shutil.copy(join(val, nii), output_folder)
    return output_folder


def summarize_configuration(trained_model_folder: str,
                            validation_folder_name: str = "validation_raw",
                            folds=(0, 1, 2, 3, 4)) -> Optional[dict]:
    """Mean fg Dice over all folds' validation summaries."""
    per_fold = []
    for f in folds:
        s = join(trained_model_folder, f"fold_{f}", validation_folder_name,
                 "summary.json")
        if isfile(s):
            per_fold.append(get_mean_foreground_dice(s))
    if not per_fold:
        return None
    return {"folder": trained_model_folder,
            "per_fold_mean_fg_dice": per_fold,
            "mean_fg_dice": float(np.mean(per_fold))}


def ensemble_validation_softmax(model1_folder: str, model2_folder: str,
                                output_folder: str, gt_folder: str,
                                folds=(0, 1, 2, 3, 4),
                                validation_folder_name: str = "validation_raw"):
    """Average the saved validation softmax of two configurations and score
    the result (ensemble.py:39)."""
    from ..inference.ensemble_predictions import merge_files
    maybe_mkdir_p(output_folder)
    pairs = []
    for f in folds:
        v1 = join(model1_folder, f"fold_{f}", validation_folder_name)
        v2 = join(model2_folder, f"fold_{f}", validation_folder_name)
        if not (isdir(v1) and isdir(v2)):
            continue
        npzs = [i for i in os.listdir(v1) if i.endswith(".npz")]
        for n in npzs:
            if not isfile(join(v2, n)):
                continue
            out_file = join(output_folder, n[:-4] + ".nii.gz")
            merge_files([join(v1, n), join(v2, n)],
                        [join(v1, n[:-4] + ".pkl"),
                         join(v2, n[:-4] + ".pkl")],
                        out_file, False)
            pairs.append([out_file, join(gt_folder, n[:-4] + ".nii.gz")])
    if pairs:
        labels = sorted(set(int(v) for p in pairs[:1] for v in
                            np.unique(read_nifti(p[1]).array)))
        aggregate_scores(pairs, labels=labels,
                         json_output_file=join(output_folder,
                                               "summary.json"),
                         num_threads=2)
    return output_folder


def ensemble_pair(folder1: str, folder2: str, output_folder_base: str,
                  gt_folder: str, folds=(0, 1, 2, 3, 4),
                  validation_folder_name: str = "validation_raw",
                  do_postprocessing: bool = True, processes: int = 2):
    """Build + score one pairwise ensemble, then determine its
    postprocessing (ensemble.py:39-120): average the two configurations'
    saved validation softmax into <base>/ensembled_raw (+ summary.json),
    then run determine_postprocessing producing <base>/postprocessing.json
    and <base>/ensembled_postprocessed/summary.json (dice_threshold=0, as
    the reference uses for ensembles)."""
    from ..postprocessing.connected_components import determine_postprocessing
    raw = join(output_folder_base, "ensembled_raw")
    ensemble_validation_softmax(folder1, folder2, raw, gt_folder,
                                folds=folds,
                                validation_folder_name=validation_folder_name)
    if do_postprocessing and isfile(join(raw, "summary.json")):
        determine_postprocessing(
            output_folder_base, gt_folder, "ensembled_raw", "temp",
            "ensembled_postprocessed", processes, dice_threshold=0)
    return output_folder_base


def figure_out_what_to_submit(task: str,
                              networks=("3d_fullres", "3d_lowres",
                                        "3d_cascade_fullres", "2d"),
                              trainer_plan="TPUTrainer__nnUNetPlansv2.1",
                              validation_folder_name="validation_raw",
                              folds=(0, 1, 2, 3, 4),
                              gt_folder: str = None,
                              disable_ensembling: bool = False,
                              disable_postprocessing: bool = False):
    """The full submission decision (figure_out_what_to_submit.py:47+):
    rank every trained configuration by CV mean foreground Dice, BUILD and
    score every pairwise ensemble (averaged validation softmax +
    determine_postprocessing on the winner candidates), pick the best, and
    write the decision JSON + prediction_commands.txt + summary.csv under
    RESULTS_FOLDER/ensembles/<task>/."""
    from itertools import combinations
    results_dir = paths.require(paths.get_results_dir(), "RESULTS_FOLDER")
    candidates = OrderedDict()
    folders = {}
    for net in networks:
        folder = join(results_dir, net, task, trainer_plan)
        if not isdir(folder):
            continue
        summary = summarize_configuration(folder, validation_folder_name,
                                          folds=folds)
        if summary is not None:
            candidates[net] = summary
            folders[net] = folder

    all_results = {}
    for net, v in candidates.items():
        s0 = join(folders[net], f"fold_{folds[0]}", validation_folder_name,
                  "summary.json")
        if isfile(s0):
            all_results[net] = load_json(s0)["results"]["mean"]

    # ---- pairwise ensembles (requires validate(save_softmax=True) npzs)
    if not disable_ensembling and len(candidates) > 1 \
            and gt_folder is not None:
        for m1, m2 in combinations(sorted(candidates.keys()), 2):
            ens_name = (f"ensemble_{m1}__{trainer_plan}--"
                        f"{m2}__{trainer_plan}")
            base = join(results_dir, "ensembles", task, ens_name)
            maybe_mkdir_p(base)
            try:
                ensemble_pair(folders[m1], folders[m2], base, gt_folder,
                              folds=folds,
                              validation_folder_name=validation_folder_name,
                              do_postprocessing=not disable_postprocessing)
            except Exception as e:  # missing npz etc: skip, keep ranking
                print(f"  ensemble {ens_name} skipped: {e}")
                continue
            s = join(base, "ensembled_raw", "summary.json")
            if isfile(s):
                candidates[ens_name] = {
                    "folder": base,
                    "mean_fg_dice": get_mean_foreground_dice(s)}
                all_results[ens_name] = load_json(s)["results"]["mean"]

    ranked = sorted(candidates.items(),
                    key=lambda kv: -kv[1]["mean_fg_dice"])
    best = ranked[0][0] if ranked else None

    # ---- prediction commands for the winner (reference prints + writes)
    predict_str = ""
    if best is not None:
        if best.startswith("ensemble_"):
            tmp = best[len("ensemble_"):]
            model1, model2 = tmp.split("--")
            m1 = model1.split("__")[0]
            m2 = model2.split("__")[0]
            pp = join(results_dir, "ensembles", task, best,
                      "postprocessing.json")
            predict_str += (f"e2enet_predict -i FOLDER_WITH_TEST_CASES -o "
                            f"OUTPUT_FOLDER_MODEL1 -m {m1} -t {task} -z\n")
            predict_str += (f"e2enet_predict -i FOLDER_WITH_TEST_CASES -o "
                            f"OUTPUT_FOLDER_MODEL2 -m {m2} -t {task} -z\n")
            predict_str += ("e2enet_ensemble -f OUTPUT_FOLDER_MODEL1 "
                            "OUTPUT_FOLDER_MODEL2 -o OUTPUT_FOLDER"
                            + (f" -pp {pp}\n" if not disable_postprocessing
                               else "\n"))
        else:
            predict_str += (f"e2enet_predict -i FOLDER_WITH_TEST_CASES -o "
                            f"OUTPUT_FOLDER -m {best} -t {task}\n")

    summary_folder = join(results_dir, "ensembles", task)
    maybe_mkdir_p(summary_folder)
    with open(join(summary_folder, "prediction_commands.txt"), "w") as f:
        f.write(predict_str)

    # ---- summary.csv (per-class Dice per candidate, reference format)
    if best is not None and best in all_results:
        classes = sorted(int(c) for c in all_results[best]
                         if c not in ("mean", "0"))
        with open(join(summary_folder, "summary.csv"), "w") as f:
            f.write("model" + "".join(f",class{c}" for c in classes)
                    + ",average\n")
            for m, res in all_results.items():
                row = [m] + [f"{res[str(c)]['Dice']:01.4f}"
                             for c in classes if str(c) in res]
                fg = foreground_mean_from_results(res)
                f.write(",".join(row) + f",{fg:01.4f}\n")

    report = {"task": task,
              "candidates": {k: v for k, v in candidates.items()},
              "ranking": [k for k, _ in ranked],
              "best": best,
              "prediction_commands": predict_str}
    out = join(results_dir, "model_selection_%s.json" % task)
    save_json(report, out)
    print("model selection report ->", out)
    for k, v in ranked:
        print(f"  {k}: mean fg Dice {v['mean_fg_dice']:.4f}")
    return report
