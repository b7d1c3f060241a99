"""Dataset conversion helpers.

Parity: reference e2enet/dataset_conversion/utils.py
(generate_dataset_json :27) used by all 36 per-challenge conversion scripts,
and the decathlon 4D->3D splitter
(experiment_planning/nnUNet_convert_decathlon_task.py +
common_utils.split_4d_nifti :23-47).

The port's own copy of e2enet_tpu/dataset_conversion/utils.py, unchanged but for this note:
the port imports nothing of the JAX package.
"""
import os
from typing import Dict, Optional, Tuple

import numpy as np

from ..io.nifti import NiftiImage, read_nifti, write_nifti
from ..utils.files import join, maybe_mkdir_p, save_json, subfiles


def get_identifiers_from_splitted_files(folder: str):
    return np.unique([i[:-12] for i in subfiles(folder, join=False,
                                                suffix="_0000.nii.gz")])


def generate_dataset_json(output_file: str, imagesTr_dir: str,
                          imagesTs_dir: Optional[str],
                          modalities: Tuple[str, ...],
                          labels: Dict[int, str], dataset_name: str,
                          license: str = "hands off!",
                          dataset_description: str = "",
                          dataset_reference: str = "",
                          dataset_release: str = "0.0",
                          sort_keys: bool = True):
    """Writes the dataset.json nnU-Net expects (same field inventory as the
    reference generate_dataset_json)."""
    train_identifiers = get_identifiers_from_splitted_files(imagesTr_dir)
    test_identifiers = (get_identifiers_from_splitted_files(imagesTs_dir)
                        if imagesTs_dir is not None else [])

    json_dict = {
        "name": dataset_name,
        "description": dataset_description,
        "tensorImageSize": "4D",
        "reference": dataset_reference,
        "licence": license,
        "release": dataset_release,
        "modality": {str(i): modalities[i] for i in range(len(modalities))},
        "labels": {str(i): labels[i] for i in labels.keys()},
        "numTraining": len(train_identifiers),
        "numTest": len(test_identifiers),
        "training": [
            {"image": f"./imagesTr/{i}.nii.gz",
             "label": f"./labelsTr/{i}.nii.gz"} for i in train_identifiers],
        "test": [f"./imagesTs/{i}.nii.gz" for i in test_identifiers],
    }
    if not output_file.endswith("dataset.json"):
        print("WARNING: output file name should end with dataset.json")
    save_json(json_dict, output_file, sort_keys=sort_keys)
    return json_dict


def split_4d_nifti(filename: str, output_folder: str):
    """Split a 4D NIfTI into per-modality 3D volumes named _0000.., or copy
    3D files with the _0000 suffix (common_utils.split_4d_nifti :23-47)."""
    import shutil
    img = read_nifti(filename)
    file_base = os.path.basename(filename)
    if img.array.ndim == 3:
        shutil.copy(filename, join(output_folder,
                                   file_base[:-7] + "_0000.nii.gz"))
        return
    assert img.array.ndim == 4, \
        f"unexpected dimensionality {img.array.ndim} of {filename}"
    for t in range(img.array.shape[0]):
        vol = NiftiImage(np.ascontiguousarray(img.array[t]), img.spacing,
                         img.origin, img.direction)
        write_nifti(join(output_folder,
                         file_base[:-7] + "_%04.0d.nii.gz" % t), vol)


def convert_decathlon_task(input_folder: str, output_base: str,
                           task_id_override: Optional[int] = None):
    """Medical Segmentation Decathlon task -> nnU-Net raw layout (reference
    nnUNet_convert_decathlon_task.py): splits 4D images, renames with _0000
    modality suffixes, copies labels and dataset.json."""
    import shutil

    task_name = os.path.basename(input_folder.rstrip("/"))
    assert task_name.startswith("Task"), \
        "decathlon tasks are named TaskXX_NAME"
    if task_id_override is not None:
        rest = task_name.split("_", 1)[1]
        task_name = "Task%03d_%s" % (task_id_override, rest)
    else:
        tid = int(task_name[4:6])
        rest = task_name.split("_", 1)[1]
        task_name = "Task%03d_%s" % (tid, rest)

    out = join(output_base, task_name)
    for sub in ("imagesTr", "labelsTr", "imagesTs"):
        maybe_mkdir_p(join(out, sub))

    for f in subfiles(join(input_folder, "imagesTr"), join=True,
                      suffix=".nii.gz"):
        if os.path.basename(f).startswith("."):
            continue
        split_4d_nifti(f, join(out, "imagesTr"))
    ts_dir = join(input_folder, "imagesTs")
    if os.path.isdir(ts_dir):
        for f in subfiles(ts_dir, join=True, suffix=".nii.gz"):
            if os.path.basename(f).startswith("."):
                continue
            split_4d_nifti(f, join(out, "imagesTs"))
    for f in subfiles(join(input_folder, "labelsTr"), join=True,
                      suffix=".nii.gz"):
        if os.path.basename(f).startswith("."):
            continue
        shutil.copy(f, join(out, "labelsTr"))
    shutil.copy(join(input_folder, "dataset.json"), out)
    print("converted ->", out)
    return out
