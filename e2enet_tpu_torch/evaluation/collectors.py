"""Result collectors, cross-fold summaries, CSV exports, and candidate
ranking.

Parity: reference e2enet/evaluation/add_mean_dice_to_json.py,
collect_results_files.py, model_selection/summarize_results_in_one_json.py,
model_selection/collect_all_fold0_results_and_summarize_in_one_csv.py,
model_selection/summarize_results_with_plans.py and
model_selection/rank_candidates.py (the ranking math; the reference file
hardcodes its 2019 trainer zoo — here it is parameterized).

Results layout: RESULTS_FOLDER/<network>/<TaskXXX_name>/<trainer__plans>/
fold_<f>/<validation_folder>/summary.json (same shape as the reference's
network_training_output_dir tree).

The port's own copy of e2enet_tpu/evaluation/collectors.py, unchanged but
for this note: write_plans_summary reads the port's plans.py. The port
imports nothing of the JAX package.
"""
import os
import shutil
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence

import numpy as np

from .. import paths
from ..utils.files import (isdir, isfile, join, load_json, maybe_mkdir_p,
                           save_json, subdirs, subfiles)


# ---------------------------------------------------------------------------
# add_mean_dice_to_json.py


def foreground_mean(filename: str) -> None:
    """Adds results.mean.mean = nanmean over foreground classes for every
    metric, in place (add_mean_dice_to_json.py:9-29; classes 0/-1/99
    excluded, a '99' entry is dropped)."""
    res = load_json(filename)
    mean_block = res["results"]["mean"]
    class_ids = [int(i) for i in mean_block.keys() if i != "mean"]
    class_ids = [i for i in class_ids if i not in (0, -1, 99)]
    mean_block.pop("99", None)
    if not class_ids:
        return
    metrics = mean_block[str(class_ids[0])].keys()
    mean_block["mean"] = OrderedDict(
        (m, float(np.nanmean([mean_block[str(i)][m] for i in class_ids])))
        for m in metrics)
    save_json(res, filename)


def run_in_folder(folder: str) -> None:
    """add_mean_dice_to_json.py:32-37."""
    for j in subfiles(folder, suffix=".json"):
        name = os.path.basename(j)
        if name.startswith(".") or name.endswith("_globalMean.json"):
            continue
        foreground_mean(j)


# ---------------------------------------------------------------------------
# collect_results_files.py


def crawl_and_copy(current_folder: str, out_folder: str,
                   prefix: str = "", suffix: str = "summary.json"):
    """Recursively copy every `*summary.json` found under a fold0 path into
    out_folder with a path-derived prefix (collect_results_files.py:5-25)."""
    maybe_mkdir_p(out_folder)
    for f in subfiles(current_folder, join=False):
        if f.endswith(suffix) and current_folder.find("fold_0") != -1:
            shutil.copy(join(current_folder, f),
                        join(out_folder, prefix + f))
    for su in subdirs(current_folder, join=False):
        add = su if prefix == "" else "__" + su
        crawl_and_copy(join(current_folder, su), out_folder,
                       prefix=prefix + add, suffix=suffix)


# ---------------------------------------------------------------------------
# summarize_results_in_one_json.py


def summarize(tasks: Sequence = ("all",),
              models: Sequence[str] = ("2d", "3d_lowres", "3d_fullres",
                                       "3d_cascade_fullres"),
              output_dir: Optional[str] = None,
              folds: Sequence[int] = (0, 1, 2, 3, 4),
              validation_prefix: str = "validation",
              results_dir: Optional[str] = None) -> List[str]:
    """One json per (model, task, trainer, validation folder): per-label
    metric means averaged over the requested folds
    (summarize_results_in_one_json.py summarize/summarize2). Written as
    <task>__<model>__<trainer>__<plans>__<valfolder>__<folds>.json; returns
    the list of files written."""
    results_dir = results_dir or paths.require(paths.get_results_dir(),
                                               "RESULTS_FOLDER")
    output_dir = output_dir or join(results_dir, "summary_jsons")
    maybe_mkdir_p(output_dir)
    task_ids = (list(range(1000)) if len(tasks) == 1 and tasks[0] == "all"
                else [int(t) for t in tasks])
    folds_str = "".join(str(f) for f in folds)
    written = []
    for model in models:
        if not isdir(join(results_dir, model)):
            continue
        for t in task_ids:
            names = subdirs(join(results_dir, model),
                            prefix="Task%03.0d" % t, join=False)
            if len(names) != 1:
                continue
            task_name = names[0]
            out_dir_task = join(results_dir, model, task_name)
            for trainer in subdirs(out_dir_task, join=False):
                if trainer.startswith("fold"):
                    continue
                out_dir = join(out_dir_task, trainer)
                val_folders = set()
                for fld in folds:
                    d = join(out_dir, "fold_%d" % fld)
                    if isdir(d):
                        val_folders.update(subdirs(
                            d, prefix=validation_prefix, join=False))
                for v in sorted(val_folders):
                    metrics = OrderedDict()
                    ok = True
                    for fld in folds:
                        s = join(out_dir, "fold_%d" % fld, v,
                                 "summary.json")
                        if not isfile(s):
                            ok = False
                            break
                        fold_means = load_json(s)["results"]["mean"]
                        for lab, per_metric in fold_means.items():
                            dst = metrics.setdefault(lab, OrderedDict())
                            for m, val in per_metric.items():
                                dst.setdefault(m, []).append(val)
                    if not ok:
                        continue
                    averaged = OrderedDict(
                        (lab, OrderedDict((m, float(np.nanmean(vals)))
                                          for m, vals in per.items()))
                        for lab, per in metrics.items())
                    out = OrderedDict()
                    out["results"] = OrderedDict(mean=averaged)
                    out["task"] = task_name
                    name = "__".join([task_name, model] + trainer.split(
                        "__") + [v, folds_str]) + ".json"
                    out["name"] = name[:-5]
                    path = join(output_dir, name)
                    save_json(out, path)
                    foreground_mean(path)
                    written.append(path)
    return written


# ---------------------------------------------------------------------------
# collect_all_fold0_results_and_summarize_in_one_csv.py


def collect_results_csv(output_csv: Optional[str] = None,
                        folds: Sequence[int] = (0,),
                        results_dir: Optional[str] = None,
                        output_dir: Optional[str] = None) -> Optional[str]:
    """Summaries -> one csv row per configuration:
    task,network,trainer,validation_folder,plans,mean_dice,median... the
    reference writes mean+median of the fg-mean Dice; our per-fold
    summaries carry means, so mean is written twice-compatible."""
    results_dir = results_dir or paths.require(paths.get_results_dir(),
                                               "RESULTS_FOLDER")
    tag = "fold" + "".join(str(f) for f in folds)
    output_dir = output_dir or join(results_dir, f"summary_jsons_{tag}")
    summaries = summarize(("all",), output_dir=output_dir, folds=folds,
                          results_dir=results_dir)
    output_csv = output_csv or join(results_dir, f"summary_{tag}.csv")
    with open(output_csv, "w") as f:
        f.write("task,network,trainer,validation_folder,plans,"
                "mean_fg_dice\n")
        for s in summaries:
            parts = os.path.basename(s)[:-5].split("__")
            if len(parts) < 5:
                continue
            task, network, trainer = parts[0], parts[1], parts[2]
            plans = parts[3] if len(parts) > 5 else ""
            valfolder = parts[-2]
            res = load_json(s)["results"]["mean"]
            mean_dice = res.get("mean", {}).get("Dice", float("nan"))
            f.write("%s,%s,%s,%s,%s,%02.4f\n" % (
                task, network, trainer, valfolder, plans, mean_dice))
    return output_csv


# ---------------------------------------------------------------------------
# summarize_results_with_plans.py


def write_plans_summary(plans_files: Sequence[str], output_csv: str,
                        stage: int = -1):
    """Architecture decisions of each plans artifact as csv
    (summarize_results_with_plans.py:12-36, on our typed-JSON plans)."""
    from ..plans import Plans
    with open(output_csv, "w") as f:
        f.write("identifier;stage;batch_size;patch_size;patch_size(mm);"
                "current_spacing;original_spacing;pool_op_kernel_sizes;"
                "conv_kernel_sizes\n")
        for pf in plans_files:
            plans = Plans.load(pf)
            keys = sorted(plans.plans_per_stage.keys())
            k = keys[stage] if stage >= 0 else keys[-1]
            st = plans.plans_per_stage[k]
            mm = [p * s for p, s in zip(st.patch_size, st.current_spacing)]
            f.write(";".join([
                os.path.basename(pf),
                str(k),
                str(st.batch_size),
                str(list(st.patch_size)),
                ",".join("%03.3f" % v for v in mm),
                ",".join("%03.3f" % v for v in st.current_spacing),
                ",".join("%03.3f" % v for v in st.original_spacing),
                str([list(q) for q in st.pool_op_kernel_sizes]),
                str([list(q) for q in st.conv_kernel_sizes]),
            ]) + "\n")
    return output_csv


# ---------------------------------------------------------------------------
# rank_candidates.py


def rank_candidates(results: Dict[str, Dict[str, float]]) -> List[tuple]:
    """Mean-rank aggregation across datasets
    (rank_candidates.py:120-156): results[trainer][dataset] = best metric
    across that trainer's configurations. Returns [(mean_rank, trainer)]
    sorted best (lowest mean rank) first; missing datasets score 0."""
    trainers = sorted(results.keys())
    datasets = sorted({d for r in results.values() for d in r})
    if not trainers or not datasets:
        return []
    all_res = np.zeros((len(trainers), len(datasets)))
    for i, tr in enumerate(trainers):
        for j, d in enumerate(datasets):
            all_res[i, j] = results[tr].get(d, 0.0)
    ranks_arr = np.zeros_like(all_res)
    for j in range(len(datasets)):
        order = np.argsort(all_res[:, j])[::-1]   # highest dice = rank 0
        ranks = np.empty_like(order)
        ranks[order] = np.arange(len(order))
        ranks_arr[:, j] = ranks
    mn = np.mean(ranks_arr, 1)
    return sorted(zip(mn.tolist(), trainers))


def rank_trained_candidates(task_names: Sequence[str],
                            networks: Sequence[str] = ("3d_fullres",),
                            folds: Sequence[int] = (0,),
                            validation_folder: str = "validation_raw",
                            results_dir: Optional[str] = None):
    """Ranks every <trainer__plans> configuration found for the given
    tasks by mean rank of CV mean fg Dice (the driveable end of
    rank_candidates.py)."""
    from .model_selection import get_mean_foreground_dice
    results_dir = results_dir or paths.require(paths.get_results_dir(),
                                               "RESULTS_FOLDER")
    table: Dict[str, Dict[str, float]] = {}
    for net in networks:
        for task in task_names:
            base = join(results_dir, net, task)
            if not isdir(base):
                continue
            for trainer in subdirs(base, join=False):
                vals = []
                for f in folds:
                    s = join(base, trainer, f"fold_{f}",
                             validation_folder, "summary.json")
                    if isfile(s):
                        vals.append(get_mean_foreground_dice(s))
                if vals:
                    d = table.setdefault(trainer, {})
                    d[task] = max(d.get(task, 0.0), float(np.mean(vals)))
    return rank_candidates(table)
