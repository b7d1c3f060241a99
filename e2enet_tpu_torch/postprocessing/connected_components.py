"""Connected-component postprocessing.

Parity: reference postprocessing/connected_components.py:
remove_all_but_the_largest_connected_component (:50-107),
load_remove_save (:32-47), determine_postprocessing (:124-430): on the
cross-validation predictions, try (a) keeping only the largest component of
the union of all foreground classes, then (b) per-class largest-component
removal; keep each choice iff it raises the mean foreground Dice by more
than `dice_threshold`; record decisions + minimum valid object sizes in
postprocessing.json. Prediction reads the decisions back
(load_postprocessing_fn).

The port's own copy of e2enet_tpu/postprocessing/connected_components.py,
with two changes. remove_all_but_the_largest_connected_component sizes and
removes the objects in one pass over the image each (np.bincount of the
label map), not one pass per object; the result is the same. On a barely
trained model's noisy 160³ prediction with thousands of specks per class
the reference's loop takes minutes. And determine_postprocessing's final
folder holds the raw predictions where the decision is empty, as
prediction and the ensembles' merge skip an empty decision; the JAX
package hands the empty list to load_remove_save, which reads it as every
class present. The port imports nothing of the JAX package.
"""
import shutil
from typing import List, Optional

import numpy as np
from scipy.ndimage import label

from ..io.nifti import NiftiImage, read_nifti, write_nifti
from ..utils.files import isfile, join, load_json, maybe_mkdir_p, save_json, subfiles


def remove_all_but_the_largest_connected_component(
        image: np.ndarray, for_which_classes: list,
        volume_per_voxel: float = 1.0,
        minimum_valid_object_size: Optional[dict] = None):
    """for_which_classes entries are ints (single class) or tuples (union of
    classes treated as one object). Returns (image, largest_removed,
    kept_size)."""
    if for_which_classes is None or len(for_which_classes) == 0:
        for_which_classes = [int(i) for i in np.unique(image) if i > 0]

    assert 0 not in for_which_classes, "cannot remove background"
    largest_removed = {}
    kept_size = {}
    for c in for_which_classes:
        if isinstance(c, (list, tuple)):
            c = tuple(c)
            mask = np.zeros_like(image, dtype=bool)
            for cl in c:
                mask[image == cl] = True
        else:
            mask = image == c
        lmap, num_objects = label(mask.astype(int))
        if num_objects > 0:
            # every object's size in one pass (the reference counts each
            # object over the whole image, quadratic in the objects)
            object_sizes = np.bincount(lmap.ravel(), minlength=num_objects
                                       + 1)[1:] * volume_per_voxel
            maximum_size = object_sizes.max()
            kept_size[c] = maximum_size
            remove = object_sizes != maximum_size
            if minimum_valid_object_size is not None:
                remove &= object_sizes < minimum_valid_object_size[c]
            if remove.any():
                gone = np.concatenate([[False], remove])[lmap]
                image[gone & mask] = 0
                largest_removed[c] = object_sizes[remove].max()
        else:
            kept_size[c] = None
            largest_removed[c] = None
    return image, largest_removed, kept_size


def load_remove_save(input_file: str, output_file: str,
                     for_which_classes: list,
                     minimum_valid_object_size: Optional[dict] = None):
    img = read_nifti(input_file)
    volume_per_voxel = float(np.prod(img.spacing))
    arr, largest_removed, kept_size = \
        remove_all_but_the_largest_connected_component(
            img.array.copy(), for_which_classes, volume_per_voxel,
            minimum_valid_object_size)
    write_nifti(output_file, NiftiImage(arr.astype(np.uint8), img.spacing,
                                        img.origin, img.direction))
    return largest_removed, kept_size


def _mean_fg_dice(scores: dict, classes: List[int]) -> float:
    return float(np.nanmean(
        [scores["mean"][str(c)]["Dice"] for c in classes]))


def determine_postprocessing(base: str, gt_labels_folder: str,
                             raw_subfolder_name: str = "validation_raw",
                             temp_folder: str = "temp",
                             final_subf_name: str = "validation_final",
                             processes: int = 4,
                             dice_threshold: float = 0.0,
                             debug: bool = False,
                             advanced_postprocessing: bool = False,
                             pp_filename: str = "postprocessing.json"):
    """Decide CC postprocessing on the validation set
    (connected_components.py:124-430)."""
    from ..evaluation.evaluator import aggregate_scores

    raw = join(base, raw_subfolder_name)
    assert isfile(join(raw, "summary.json")), \
        "validation_raw must contain summary.json (run validate first)"
    classes = [int(i) for i in
               load_json(join(raw, "summary.json"))["results"]["mean"].keys()
               if int(i) != 0]

    folder_all_classes = join(base, temp_folder + "_allClasses")
    folder_per_class = join(base, temp_folder + "_perClass")
    maybe_mkdir_p(folder_all_classes)
    maybe_mkdir_p(folder_per_class)

    pred_gt_tuples = []
    fnames = subfiles(raw, join=False, suffix=".nii.gz", sort=True)

    validation_result_raw = load_json(join(raw, "summary.json"))["results"]
    pp_results = {
        "dc_per_class_raw": {str(c): validation_result_raw["mean"][str(c)]
                             ["Dice"] for c in classes},
        "for_which_classes": [],
        "min_valid_object_sizes": None,
    }

    # ---- step 1: all foreground as one component
    kept_sizes_all = []
    for f in fnames:
        _, kept = load_remove_save(join(raw, f),
                                   join(folder_all_classes, f),
                                   [tuple(classes)] if len(classes) > 1
                                   else [classes[0]])
        kept_sizes_all.append(kept)
        pred_gt_tuples.append([join(folder_all_classes, f),
                               join(gt_labels_folder, f)])
    res_all = aggregate_scores(pred_gt_tuples, labels=classes,
                               json_output_file=join(folder_all_classes,
                                                     "summary.json"),
                               num_threads=processes)

    baseline_mean = _mean_fg_dice(validation_result_raw, classes)
    pp_all_mean = _mean_fg_dice(res_all, classes)
    do_fg_cc = pp_all_mean > (baseline_mean + dice_threshold)
    source_for_per_class = folder_all_classes if do_fg_cc else raw
    current_means = (res_all["mean"] if do_fg_cc
                     else validation_result_raw["mean"])
    if do_fg_cc and len(classes) > 1:
        pp_results["for_which_classes"].append([int(c) for c in classes])
    elif do_fg_cc:
        pp_results["for_which_classes"].append(int(classes[0]))
    print("Foreground-union CC removal:",
          "kept" if do_fg_cc else "rejected",
          f"(raw {baseline_mean:.5f} -> pp {pp_all_mean:.5f})")

    # ---- step 2: per-class CC removal on top
    if len(classes) > 1 or not do_fg_cc:
        pred_gt_tuples = []
        for f in fnames:
            load_remove_save(join(source_for_per_class, f),
                             join(folder_per_class, f), classes)
            pred_gt_tuples.append([join(folder_per_class, f),
                                   join(gt_labels_folder, f)])
        res_pc = aggregate_scores(pred_gt_tuples, labels=classes,
                                  json_output_file=join(folder_per_class,
                                                        "summary.json"),
                                  num_threads=processes)
        for c in classes:
            before = float(current_means[str(c)]["Dice"])
            after = float(res_pc["mean"][str(c)]["Dice"])
            if after > before + dice_threshold:
                pp_results["for_which_classes"].append(int(c))
                print(f"class {c}: per-class CC removal kept "
                      f"({before:.5f} -> {after:.5f})")

    # ---- final: apply decided postprocessing to raw preds
    final = join(base, final_subf_name)
    maybe_mkdir_p(final)
    pred_gt_tuples = []
    for f in fnames:
        if pp_results["for_which_classes"]:
            load_remove_save(join(raw, f), join(final, f),
                             pp_results["for_which_classes"])
        else:
            shutil.copy(join(raw, f), join(final, f))
        pred_gt_tuples.append([join(final, f), join(gt_labels_folder, f)])
    res_final = aggregate_scores(pred_gt_tuples, labels=classes,
                                 json_output_file=join(final,
                                                       "summary.json"),
                                 num_threads=processes)
    pp_results["dc_per_class_pp"] = {
        str(c): res_final["mean"][str(c)]["Dice"] for c in classes}
    save_json(pp_results, join(base, pp_filename))
    print("postprocessing decisions:", pp_results["for_which_classes"])
    return pp_results


def load_postprocessing(json_file: str):
    d = load_json(json_file)
    fwc = []
    for c in d.get("for_which_classes", []):
        fwc.append(tuple(c) if isinstance(c, list) else int(c))
    mvos = d.get("min_valid_object_sizes")
    if isinstance(mvos, str):
        mvos = None
    return fwc, mvos


def load_postprocessing_fn(json_file: str):
    fwc, mvos = load_postprocessing(json_file)
    if not fwc:
        return None
    return {"fn": lambda seg: remove_all_but_the_largest_connected_component(
                seg, fwc, 1.0, mvos)[0],
            "args": ()}
