"""Crop-to-nonzero stage: bounding-box crop around the union nonzero mask,
labeling outside-body voxels -1 in the seg channel.

Parity: reference e2enet/preprocessing/cropping.py (create_nonzero_mask
:33-48, get_bbox_from_mask :51-57, crop_to_nonzero :84-116,
load_case_from_list_of_files :60-82, ImageCropper :123-217).

The port's own copy of e2enet_tpu/preprocessing/cropping.py (the port
imports nothing of the JAX package), with one change: run_cropping's worker
processes are spawned, not forked, so that no worker inherits the threads
or a CUDA context of the process that calls it. Every case is written by
one worker from its own inputs, so the files are the same either way.
"""
import multiprocessing
import os
from collections import OrderedDict
from concurrent.futures import ProcessPoolExecutor
from typing import List, Optional

import numpy as np
from scipy.ndimage import binary_fill_holes

from ..configuration import default_num_threads
from ..io.nifti import read_nifti
from ..utils.files import (isfile, join, load_pickle, maybe_mkdir_p, save_pickle)


def create_nonzero_mask(data: np.ndarray) -> np.ndarray:
    """Union of per-modality nonzero masks, holes filled."""
    assert data.ndim == 4, "data must have shape (C, X, Y, Z)"
    nonzero_mask = np.zeros(data.shape[1:], dtype=bool)
    for c in range(data.shape[0]):
        nonzero_mask = nonzero_mask | (data[c] != 0)
    return binary_fill_holes(nonzero_mask)


def get_bbox_from_mask(mask: np.ndarray, outside_value: int = 0):
    mask_voxel_coords = np.where(mask != outside_value)
    minz, maxz = int(np.min(mask_voxel_coords[0])), int(np.max(mask_voxel_coords[0])) + 1
    minx, maxx = int(np.min(mask_voxel_coords[1])), int(np.max(mask_voxel_coords[1])) + 1
    miny, maxy = int(np.min(mask_voxel_coords[2])), int(np.max(mask_voxel_coords[2])) + 1
    return [[minz, maxz], [minx, maxx], [miny, maxy]]


def crop_to_bbox(image: np.ndarray, bbox) -> np.ndarray:
    assert image.ndim == 3
    return image[bbox[0][0]:bbox[0][1], bbox[1][0]:bbox[1][1],
                 bbox[2][0]:bbox[2][1]]


def crop_to_nonzero(data: np.ndarray, seg: Optional[np.ndarray] = None,
                    nonzero_label: int = -1):
    nonzero_mask = create_nonzero_mask(data)
    bbox = get_bbox_from_mask(nonzero_mask, 0)

    data = np.stack([crop_to_bbox(data[c], bbox)
                     for c in range(data.shape[0])])
    if seg is not None:
        seg = np.stack([crop_to_bbox(seg[c], bbox)
                        for c in range(seg.shape[0])])

    nonzero_mask = crop_to_bbox(nonzero_mask, bbox)[None]
    if seg is not None:
        seg[(seg == 0) & (nonzero_mask == 0)] = nonzero_label
    else:
        nonzero_mask = nonzero_mask.astype(int)
        nonzero_mask[nonzero_mask == 0] = nonzero_label
        nonzero_mask[nonzero_mask > 0] = 0
        seg = nonzero_mask
    return data, seg, bbox


def load_case_from_list_of_files(data_files: List[str],
                                 seg_file: Optional[str] = None):
    """Reads modalities + optional seg, recording the ITK-style geometry the
    export stage restores later (cropping.py:60-82)."""
    assert isinstance(data_files, (list, tuple)), "case must be list/tuple"
    properties = OrderedDict()
    imgs = [read_nifti(f) for f in data_files]
    # ITK GetSize is (x,y,z); arrays here are (z,y,x)
    properties["original_size_of_raw_data"] = np.array(imgs[0].array.shape)
    properties["original_spacing"] = np.array(imgs[0].spacing)[[2, 1, 0]]
    properties["list_of_data_files"] = list(data_files)
    properties["seg_file"] = seg_file
    properties["itk_origin"] = imgs[0].origin
    properties["itk_spacing"] = imgs[0].spacing
    properties["itk_direction"] = imgs[0].direction

    data_npy = np.stack([img.array for img in imgs]).astype(np.float32)
    if seg_file is not None:
        seg_npy = read_nifti(seg_file).array[None].astype(np.float32)
    else:
        seg_npy = None
    return data_npy, seg_npy, properties


class ImageCropper:
    def __init__(self, num_threads: int = default_num_threads,
                 output_folder: Optional[str] = None):
        self.output_folder = output_folder
        self.num_threads = num_threads
        if self.output_folder is not None:
            maybe_mkdir_p(self.output_folder)

    @staticmethod
    def crop(data, properties, seg=None):
        shape_before = data.shape
        data, seg, bbox = crop_to_nonzero(data, seg, nonzero_label=-1)
        shape_after = data.shape
        print("before crop:", shape_before, "after crop:", shape_after,
              "spacing:", np.array(properties["original_spacing"]), "\n")
        properties["crop_bbox"] = bbox
        properties["classes"] = np.unique(seg)
        seg[seg < -1] = 0
        properties["size_after_cropping"] = data[0].shape
        return data, seg, properties

    @staticmethod
    def crop_from_list_of_files(data_files, seg_file=None):
        data, seg, properties = load_case_from_list_of_files(data_files,
                                                             seg_file)
        return ImageCropper.crop(data, properties, seg)

    def load_crop_save(self, case, case_identifier,
                       overwrite_existing=False):
        try:
            print(case_identifier)
            if (overwrite_existing
                    or (not isfile(join(self.output_folder,
                                        f"{case_identifier}.npz"))
                        or not isfile(join(self.output_folder,
                                           f"{case_identifier}.pkl")))):
                data, seg, properties = self.crop_from_list_of_files(
                    case[:-1], case[-1])
                all_data = np.vstack((data, seg))
                np.savez_compressed(
                    join(self.output_folder, f"{case_identifier}.npz"),
                    data=all_data)
                save_pickle(properties,
                            join(self.output_folder,
                                 f"{case_identifier}.pkl"))
        except Exception as e:
            print("Exception in", case_identifier, ":", e)
            raise e

    def run_cropping(self, list_of_files, overwrite_existing=False,
                     output_folder=None):
        """Crop every case (list of [mod0, mod1, ..., seg] file lists)."""
        if output_folder is not None:
            self.output_folder = output_folder
            maybe_mkdir_p(self.output_folder)

        output_folder_gt = join(self.output_folder, "gt_segmentations")
        maybe_mkdir_p(output_folder_gt)
        import shutil
        for case in list_of_files:
            case_identifier = get_case_identifier(case)
            shutil.copy(case[-1], output_folder_gt)

        # process pool only helps with >1 CPU; sequential otherwise
        if self.num_threads > 1 and os.cpu_count() and os.cpu_count() > 1:
            with ProcessPoolExecutor(
                    max_workers=self.num_threads,
                    mp_context=multiprocessing.get_context("spawn")) as pool:
                futures = [
                    pool.submit(self.load_crop_save, case,
                                get_case_identifier(case),
                                overwrite_existing)
                    for case in list_of_files]
                for f in futures:
                    f.result()
        else:
            for case in list_of_files:
                self.load_crop_save(case, get_case_identifier(case),
                                    overwrite_existing)

    def load_properties(self, case_identifier):
        return load_pickle(join(self.output_folder,
                                f"{case_identifier}.pkl"))

    def save_properties(self, case_identifier, properties):
        save_pickle(properties,
                    join(self.output_folder, f"{case_identifier}.pkl"))


def get_case_identifier(case) -> str:
    return os.path.basename(case[0]).split(".nii")[0][:-5]


def get_case_identifier_from_npz(case: str) -> str:
    return os.path.basename(case)[:-4]
