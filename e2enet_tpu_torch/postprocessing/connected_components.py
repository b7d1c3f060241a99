"""Connected-component postprocessing at prediction time.

Parity: reference postprocessing/connected_components.py:
remove_all_but_the_largest_connected_component (:50-107),
load_remove_save (:32-47), and reading the decisions of postprocessing.json.

The port's own copy of the prediction part of
e2enet_tpu/postprocessing/connected_components.py (determine_postprocessing,
which decides on the validation set, comes with the evaluation modules):
the port imports nothing of the JAX package.
"""
from typing import Optional

import numpy as np
from scipy.ndimage import label

from ..io.nifti import NiftiImage, read_nifti, write_nifti
from ..utils.files import load_json


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
            object_sizes = {i: (lmap == i).sum() * volume_per_voxel
                            for i in range(1, num_objects + 1)}
            maximum_size = max(object_sizes.values())
            kept_size[c] = maximum_size
            for obj in object_sizes:
                if object_sizes[obj] != maximum_size:
                    remove = True
                    if minimum_valid_object_size is not None:
                        remove = object_sizes[obj] < \
                            minimum_valid_object_size[c]
                    if remove:
                        image[(lmap == obj) & mask] = 0
                        lr = largest_removed.get(c)
                        largest_removed[c] = (object_sizes[obj] if lr is None
                                              else max(lr, object_sizes[obj]))
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
