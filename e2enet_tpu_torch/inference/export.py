"""Segmentation export: softmax (post-preprocessing geometry) -> original
image geometry NIfTI.

Parity: reference inference/segmentation_export.py
(save_segmentation_nifti_from_softmax :27-160, save_segmentation_nifti
:163-240): resample softmax back to the post-crop shape (spline,
separate-z-aware), argmax (or region thresholds), paste into the pre-crop
canvas at crop_bbox, write with the original ITK geometry.

The port's own copy of e2enet_tpu/inference/export.py, unchanged but for this note:
the port imports nothing of the JAX package.
"""
from copy import deepcopy
from typing import Optional, Sequence, Union

import numpy as np

from ..io.nifti import NiftiImage, write_nifti
from ..preprocessing.resampling import (get_do_separate_z, get_lowres_axis,
                                        resample_data_or_seg)
from ..utils.files import save_pickle


def save_segmentation_nifti_from_softmax(
        segmentation_softmax: Union[str, np.ndarray], out_fname: str,
        properties_dict: dict, order: int = 1,
        region_class_order: Optional[Sequence[int]] = None,
        seg_postprogess_fn=None, seg_postprocess_args=None,
        resampled_npz_fname: Optional[str] = None,
        non_postprocessed_fname: Optional[str] = None,
        force_separate_z: Optional[bool] = None,
        interpolation_order_z: int = 0, verbose: bool = False):
    if verbose:
        print("force_separate_z:", force_separate_z,
              "interpolation order:", order)
    if isinstance(segmentation_softmax, str):
        npy = segmentation_softmax
        segmentation_softmax = np.load(npy)

    # resample to size after cropping (pre-resampling)
    current_shape = segmentation_softmax.shape
    shape_original_after_cropping = properties_dict.get("size_after_cropping")
    shape_original_before_cropping = properties_dict.get(
        "original_size_of_raw_data")

    if np.any([i != j for i, j in zip(np.array(current_shape[1:]),
                                      np.array(
                                          shape_original_after_cropping))]):
        if force_separate_z is None:
            if get_do_separate_z(properties_dict.get("original_spacing")):
                do_separate_z = True
                lowres_axis = get_lowres_axis(
                    properties_dict.get("original_spacing"))
            elif get_do_separate_z(properties_dict.get(
                    "spacing_after_resampling")):
                do_separate_z = True
                lowres_axis = get_lowres_axis(
                    properties_dict.get("spacing_after_resampling"))
            else:
                do_separate_z = False
                lowres_axis = None
        else:
            do_separate_z = force_separate_z
            lowres_axis = (get_lowres_axis(
                properties_dict.get("original_spacing"))
                if do_separate_z else None)
        if lowres_axis is not None and len(lowres_axis) != 1:
            do_separate_z = False
        if verbose:
            print("separate z:", do_separate_z, "lowres axis:", lowres_axis)
        seg_old_spacing = resample_data_or_seg(
            segmentation_softmax, shape_original_after_cropping,
            is_seg=False, axis=lowres_axis, order=order,
            do_separate_z=do_separate_z, order_z=interpolation_order_z)
    else:
        if verbose:
            print("no resampling necessary")
        seg_old_spacing = segmentation_softmax

    if resampled_npz_fname is not None:
        np.savez_compressed(resampled_npz_fname,
                            softmax=seg_old_spacing.astype(np.float16))
        props = deepcopy(properties_dict)
        if region_class_order is not None:
            props["regions_class_order"] = region_class_order
        save_pickle(props, resampled_npz_fname[:-4] + ".pkl")

    if region_class_order is None:
        seg_old_spacing = seg_old_spacing.argmax(0)
    else:
        seg_old_spacing_final = np.zeros(seg_old_spacing.shape[1:])
        for i, c in enumerate(region_class_order):
            seg_old_spacing_final[seg_old_spacing[i] > 0.5] = c
        seg_old_spacing = seg_old_spacing_final

    # paste into pre-crop canvas
    bbox = properties_dict.get("crop_bbox")
    if bbox is not None:
        seg_old_size = np.zeros(shape_original_before_cropping,
                                dtype=np.uint8)
        for c in range(3):
            bbox[c][1] = np.min((bbox[c][0] + seg_old_spacing.shape[c],
                                 shape_original_before_cropping[c]))
        seg_old_size[bbox[0][0]:bbox[0][1], bbox[1][0]:bbox[1][1],
                     bbox[2][0]:bbox[2][1]] = seg_old_spacing
    else:
        seg_old_size = seg_old_spacing

    if seg_postprogess_fn is not None:
        seg_old_size_postprocessed = seg_postprogess_fn(
            np.copy(seg_old_size), *(seg_postprocess_args or ()))
    else:
        seg_old_size_postprocessed = seg_old_size

    img = NiftiImage(array=seg_old_size_postprocessed.astype(np.uint8),
                     spacing=properties_dict["itk_spacing"],
                     origin=properties_dict["itk_origin"],
                     direction=properties_dict["itk_direction"])
    write_nifti(out_fname, img)

    if (non_postprocessed_fname is not None
            and seg_postprogess_fn is not None):
        img2 = NiftiImage(array=seg_old_size.astype(np.uint8),
                          spacing=properties_dict["itk_spacing"],
                          origin=properties_dict["itk_origin"],
                          direction=properties_dict["itk_direction"])
        write_nifti(non_postprocessed_fname, img2)


def save_segmentation_nifti(segmentation: Union[str, np.ndarray],
                            out_fname: str, properties_dict: dict,
                            order: int = 0,
                            force_separate_z: Optional[bool] = None,
                            order_z: int = 0):
    """Label-map-only fast path (segmentation_export.py:163-240): resample
    the hard labels with resize_segmentation semantics."""
    if isinstance(segmentation, str):
        segmentation = np.load(segmentation)
    segmentation = segmentation[None].astype(float)

    shape_original_after_cropping = properties_dict.get("size_after_cropping")
    shape_original_before_cropping = properties_dict.get(
        "original_size_of_raw_data")

    if np.any(np.array(segmentation.shape[1:])
              != np.array(shape_original_after_cropping)):
        if force_separate_z is None:
            if get_do_separate_z(properties_dict.get("original_spacing")):
                do_separate_z = True
                lowres_axis = get_lowres_axis(
                    properties_dict.get("original_spacing"))
            elif get_do_separate_z(
                    properties_dict.get("spacing_after_resampling")):
                do_separate_z = True
                lowres_axis = get_lowres_axis(
                    properties_dict.get("spacing_after_resampling"))
            else:
                do_separate_z = False
                lowres_axis = None
        else:
            do_separate_z = force_separate_z
            lowres_axis = (get_lowres_axis(
                properties_dict.get("original_spacing"))
                if do_separate_z else None)
        if lowres_axis is not None and len(lowres_axis) != 1:
            do_separate_z = False
        seg_old_spacing = resample_data_or_seg(
            segmentation, shape_original_after_cropping, is_seg=True,
            axis=lowres_axis, order=order, do_separate_z=do_separate_z,
            order_z=order_z)[0]
    else:
        seg_old_spacing = segmentation[0]

    bbox = properties_dict.get("crop_bbox")
    if bbox is not None:
        seg_old_size = np.zeros(shape_original_before_cropping,
                                dtype=np.uint8)
        for c in range(3):
            bbox[c][1] = np.min((bbox[c][0] + seg_old_spacing.shape[c],
                                 shape_original_before_cropping[c]))
        seg_old_size[bbox[0][0]:bbox[0][1], bbox[1][0]:bbox[1][1],
                     bbox[2][0]:bbox[2][1]] = seg_old_spacing
    else:
        seg_old_size = seg_old_spacing

    img = NiftiImage(array=seg_old_size.astype(np.uint8),
                     spacing=properties_dict["itk_spacing"],
                     origin=properties_dict["itk_origin"],
                     direction=properties_dict["itk_direction"])
    write_nifti(out_fname, img)
