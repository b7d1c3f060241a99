"""2D-image / TIFF <-> NIfTI conversion helpers.

Parity: reference e2enet/utilities/file_conversions.py (skimage/tifffile/
SimpleITK based). Here built on io.images2d (PIL) + io.nifti.

The port's own copy of e2enet_tpu/dataset_conversion/file_conversions.py,
unchanged but for this note and an unused import left out: the port
imports nothing of the JAX package.
"""
from typing import List, Union

import numpy as np

from ..io.images2d import (read_2d_image, read_tiff_stack, write_2d_image,
                           write_tiff_stack)
from ..io.nifti import NiftiImage, read_nifti, write_nifti


def convert_2d_image_to_nifti(input_filename: str,
                              output_filename_truncated: str,
                              spacing=(999, 1, 1), transform=None,
                              is_seg: bool = False) -> None:
    """2D image (any PIL-readable format) -> pseudo-3D nifti(s), one per
    color channel (file_conversions.py:8-60). Channel j is written to
    `{output}_{j:04d}.nii.gz` for images, `{output}.nii.gz` for segs.
    spacing is (z, y, x) with z large so the 2D pipeline treats slices as
    independent."""
    img = read_2d_image(input_filename)
    if transform is not None:
        img = transform(img)

    if img.ndim == 2:
        img = img[None, None]
    else:
        assert img.ndim == 3, f"expected 2D(+C) image, got {img.shape}"
        img = img.transpose((2, 0, 1))[:, None]

    if is_seg:
        assert img.shape[0] == 1, \
            "segmentations can only have one color channel"

    for j, channel in enumerate(img):
        if is_seg:
            channel = channel.astype(np.uint32)
        out = NiftiImage(array=channel, spacing=tuple(spacing)[::-1])
        if not is_seg:
            write_nifti(output_filename_truncated + "_%04.0d.nii.gz" % j,
                        out)
        else:
            write_nifti(output_filename_truncated + ".nii.gz", out)


def convert_3d_tiff_to_nifti(filenames: List[str], output_name: str,
                             spacing: Union[tuple, list], transform=None,
                             is_seg: bool = False) -> None:
    """One 3D tiff per modality -> nifti (file_conversions.py:63-96).
    spacing is (z, y, x)."""
    if is_seg:
        assert len(filenames) == 1
    for j, fname in enumerate(filenames):
        img = read_tiff_stack(fname)
        if transform is not None:
            img = transform(img)
        out = NiftiImage(array=img, spacing=tuple(spacing)[::-1])
        if not is_seg:
            write_nifti(output_name + "_%04.0d.nii.gz" % j, out)
        else:
            write_nifti(output_name + ".nii.gz", out)


def convert_2d_segmentation_nifti_to_img(nifti_file: str,
                                         output_filename: str,
                                         transform=None,
                                         export_dtype=np.uint8):
    """file_conversions.py:99-106."""
    img = read_nifti(nifti_file).array
    assert img.shape[0] == 1, "can only export 2D segmentations"
    img = img[0]
    if transform is not None:
        img = transform(img)
    write_2d_image(output_filename, img.astype(export_dtype))


def convert_3d_segmentation_nifti_to_tiff(nifti_file: str,
                                          output_filename: str,
                                          transform=None,
                                          export_dtype=np.uint8):
    """file_conversions.py:109-115."""
    img = read_nifti(nifti_file).array
    assert img.ndim == 3, "can only export 3D segmentations"
    if transform is not None:
        img = transform(img)
    write_tiff_stack(output_filename, img.astype(export_dtype))
