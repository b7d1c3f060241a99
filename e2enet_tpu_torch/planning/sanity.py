"""Dataset integrity verification.

Parity: reference preprocessing/sanity_checks.py:90
(verify_dataset_integrity): every training case must have all modality files
and a label; geometry (spacing/origin/direction) must match between image
and label; labels must be consecutive integers starting at 0 as declared in
dataset.json.

The port's own copy of e2enet_tpu/planning/sanity.py, unchanged but for this note:
the port imports nothing of the JAX package.
"""
import numpy as np

from ..io.nifti import read_nifti
from ..utils.files import isfile, join, load_json


def verify_dataset_integrity(folder: str):
    assert isfile(join(folder, "dataset.json")), \
        f"There needs to be a dataset.json in {folder}"
    dataset = load_json(join(folder, "dataset.json"))
    training_cases = dataset["training"]
    num_modalities = len(dataset["modality"].keys())
    expected_labels = sorted(int(k) for k in dataset["labels"].keys())
    assert expected_labels[0] == 0, "The first label must be 0 (background)"
    assert expected_labels == list(range(len(expected_labels))), \
        "Labels must be consecutive integers starting at 0"

    label_files_checked = []
    for tr in training_cases:
        ident = tr["image"].split("/")[-1].split(".nii.gz")[0]
        label_file = join(folder, "labelsTr", f"{ident}.nii.gz")
        assert isfile(label_file), f"missing label: {label_file}"
        image_files = [join(folder, "imagesTr",
                            f"{ident}_{m:04d}.nii.gz")
                       for m in range(num_modalities)]
        for f in image_files:
            assert isfile(f), f"missing image: {f}"

        lbl = read_nifti(label_file)
        found = np.unique(lbl.array)
        unexpected = [int(i) for i in found if int(i) not in expected_labels]
        assert len(unexpected) == 0, \
            f"{ident}: unexpected labels {unexpected}"

        geom = None
        for f in image_files:
            img = read_nifti(f)
            assert img.array.shape == lbl.array.shape, \
                f"{ident}: image/label shape mismatch"
            g = (tuple(np.round(img.spacing, 5)),
                 tuple(np.round(img.origin, 3)),
                 tuple(np.round(img.direction, 5)))
            lg = (tuple(np.round(lbl.spacing, 5)),
                  tuple(np.round(lbl.origin, 3)),
                  tuple(np.round(lbl.direction, 5)))
            assert g == lg, f"{ident}: image/label geometry mismatch"
            if geom is None:
                geom = g
            else:
                assert geom == g, f"{ident}: inter-modality geometry mismatch"
        label_files_checked.append(label_file)
    print(f"dataset integrity OK ({len(label_files_checked)} cases)")
    return True
