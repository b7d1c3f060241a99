"""Ensemble saved softmax predictions of several models.

Parity: reference inference/ensemble_predictions.py (merge :56-98): average
the saved .npz softmax of 2+ model outputs per case, export, optionally
apply postprocessing from a chosen postprocessing.json.

The port's own copy of e2enet_tpu/inference/ensemble_predictions.py: the
average is taken in numpy on the host, as the JAX package takes it. Two
changes: an output is always written anew, as every caller of the JAX
package's merge_files asks it to (its override), and an empty decision (for_which_classes []) applies no postprocessing,
as prediction reads it (load_postprocessing_fn); the JAX package's merge
hands the empty list to load_remove_save, which then keeps only the
largest component of every class present. The port imports nothing of
the JAX package.
"""
from typing import List, Optional

import numpy as np

from ..utils.files import isfile, join, load_pickle, maybe_mkdir_p, subfiles
from .export import save_segmentation_nifti_from_softmax


def merge_files(files: List[str], properties_files: List[str],
                out_file: str, store_npz: bool):
    softmax = [np.load(f)["softmax"][None] for f in files]
    softmax = np.vstack(softmax)
    softmax = np.mean(softmax, 0)
    props = load_pickle(properties_files[0])

    reg_class_orders = [load_pickle(p).get("regions_class_order")
                        for p in properties_files]
    if not all(i is None for i in reg_class_orders):
        tmp = reg_class_orders[0]
        for r in reg_class_orders[1:]:
            assert tmp == r, (
                "regions_class_order mismatch between models: "
                f"{reg_class_orders} for files {files}")
        regions_class_order = tmp
    else:
        regions_class_order = None

    save_segmentation_nifti_from_softmax(
        softmax, out_file, props, 3, regions_class_order, None, None,
        out_file[:-7] + ".npz" if store_npz else None)


def merge(folders: List[str], output_folder: str,
          postprocessing_file: Optional[str] = None,
          store_npz: bool = False):
    maybe_mkdir_p(output_folder)

    if postprocessing_file is not None:
        from ..postprocessing.connected_components import (
            load_postprocessing)
        for_which_classes, min_valid = load_postprocessing(
            postprocessing_file)
        import shutil
        shutil.copy(postprocessing_file,
                    join(output_folder, "postprocessing.json"))
    else:
        for_which_classes = None

    patient_ids = [subfiles(i, suffix=".npz", join=False) for i in folders]
    patient_ids = [i for j in patient_ids for i in j]
    patient_ids = [i[:-4] for i in patient_ids]
    patient_ids = np.unique(patient_ids)

    for f in folders:
        assert all(isfile(join(f, p + ".npz")) for p in patient_ids), \
            f"not all patients available in {f}"
        assert all(isfile(join(f, p + ".pkl")) for p in patient_ids), \
            f"not all .pkl files available in {f}"

    for p in patient_ids:
        files = [join(f, p + ".npz") for f in folders]
        property_files = [join(f, p + ".pkl") for f in folders]
        out_file = join(output_folder, p + ".nii.gz")
        merge_files(files, property_files, out_file, store_npz)

    if for_which_classes:
        from ..postprocessing.connected_components import load_remove_save
        for p in patient_ids:
            f = join(output_folder, p + ".nii.gz")
            load_remove_save(f, f, for_which_classes)
