"""Spacing resampling for volumes and segmentations.

Parity: reference e2enet/preprocessing/preprocessing.py:28-202
(get_do_separate_z, get_lowres_axis, resample_patient, resample_data_or_seg).
The reference uses skimage.transform.resize + scipy map_coordinates; skimage
is absent here, so `resize` re-implements its exact semantics (coordinate map
(i+0.5)*scale-0.5, spline order N with edge mode, clip to input range, no
anti-aliasing) on scipy.ndimage.map_coordinates. Segmentations resample
one-hot-wise with a 0.5 threshold (batchgenerators resize_segmentation
semantics, used at preprocessing.py:127).

Rules (preprocessing.py:28-35,113-202):
  * data: cubic spline (order 3); seg: linear one-hot (order 1);
  * if max(spacing)/min(spacing) > 3 the volume is resampled slice-wise
    in-plane and nearest (order 0) along the low-res axis.

The port's own copy of e2enet_tpu/preprocessing/resampling.py (the port
imports nothing of the JAX package), with one repair: the separate-z
branch resamples along the low-res axis in float64, as the rest of the
function does, where the copied code handed map_coordinates the input's
dtype, which scipy refuses for float16 (a float16 softmax, the fast mode's,
of an anisotropic case). For float32 and float64 input the result is the
same.
"""
from typing import Optional, Sequence

import numpy as np
from scipy.ndimage import map_coordinates

from ..configuration import RESAMPLING_SEPARATE_Z_ANISO_THRESHOLD


def resize(image: np.ndarray, output_shape: Sequence[int], order: int = 3,
           mode: str = "edge", clip: bool = True) -> np.ndarray:
    """skimage.transform.resize equivalent (anti_aliasing=False,
    preserve_range=True)."""
    image = np.asarray(image)
    in_shape = image.shape
    output_shape = tuple(int(i) for i in output_shape)
    if tuple(in_shape) == output_shape:
        return image.astype(float)
    scales = [i / o for i, o in zip(in_shape, output_shape)]
    grids = np.meshgrid(*[(np.arange(o) + 0.5) * s - 0.5
                          for o, s in zip(output_shape, scales)],
                        indexing="ij")
    ndi_mode = {"edge": "nearest", "constant": "constant"}[mode]
    out = map_coordinates(image.astype(float), np.array(grids), order=order,
                          mode=ndi_mode)
    if clip:
        out = np.clip(out, image.min(), image.max())
    return out


def resize_segmentation(segmentation: np.ndarray, new_shape: Sequence[int],
                        order: int = 3) -> np.ndarray:
    """Label-safe resize: order 0 is a plain nearest resize; higher orders
    resample each label's indicator and threshold at 0.5."""
    tpe = segmentation.dtype
    unique_labels = np.unique(segmentation)
    assert len(segmentation.shape) == len(new_shape), \
        "new shape must have same dimensionality as segmentation"
    if order == 0:
        return resize(segmentation.astype(float), new_shape, order,
                      mode="edge", clip=True).astype(tpe)
    reshaped = np.zeros(new_shape, dtype=tpe)
    for c in unique_labels:
        mask = segmentation == c
        reshaped_multihot = resize(mask.astype(float), new_shape, order,
                                   mode="edge", clip=True)
        reshaped[reshaped_multihot >= 0.5] = c
    return reshaped


def get_do_separate_z(spacing, anisotropy_threshold=RESAMPLING_SEPARATE_Z_ANISO_THRESHOLD):
    return (np.max(spacing) / np.min(spacing)) > anisotropy_threshold


def get_lowres_axis(new_spacing):
    return np.where(max(new_spacing) / np.array(new_spacing) == 1)[0]


def resample_data_or_seg(data: np.ndarray, new_shape, is_seg: bool,
                         axis=None, order: int = 3,
                         do_separate_z: bool = False,
                         order_z: int = 0) -> np.ndarray:
    """data: (c, x, y, z). When do_separate_z, resample each slice along the
    anisotropic axis in-plane with `order`, then the axis itself with
    `order_z` via the half-pixel coordinate map (reference
    preprocessing.py:113-202)."""
    assert len(data.shape) == 4, "data must be (c, x, y, z)"
    resize_fn = resize_segmentation if is_seg else resize
    kwargs = {} if is_seg else {"mode": "edge"}
    dtype_data = data.dtype
    shape = np.array(data[0].shape)
    new_shape = np.array([int(i) for i in new_shape])
    if np.all(shape == new_shape):
        return data

    data = data.astype(float)
    if do_separate_z:
        assert len(axis) == 1, "only one anisotropic axis supported"
        ax = int(axis[0])
        if ax == 0:
            new_shape_2d = new_shape[1:]
        elif ax == 1:
            new_shape_2d = new_shape[[0, 2]]
        else:
            new_shape_2d = new_shape[:-1]

        reshaped_final = []
        for c in range(data.shape[0]):
            slices = []
            for slice_id in range(shape[ax]):
                if ax == 0:
                    sl = data[c, slice_id]
                elif ax == 1:
                    sl = data[c, :, slice_id]
                else:
                    sl = data[c, :, :, slice_id]
                slices.append(resize_fn(sl, new_shape_2d, order,
                                        **kwargs).astype(dtype_data))
            stacked = np.stack(slices, ax)
            if shape[ax] != new_shape[ax]:
                # resample along the low-res axis with order_z using the
                # half-pixel coordinate map (reference :141-180)
                rows, cols, dim = new_shape
                orig_rows, orig_cols, orig_dim = stacked.shape
                row_scale = float(orig_rows) / rows
                col_scale = float(orig_cols) / cols
                dim_scale = float(orig_dim) / dim
                map_rows, map_cols, map_dims = np.mgrid[:rows, :cols, :dim]
                map_rows = row_scale * (map_rows + 0.5) - 0.5
                map_cols = col_scale * (map_cols + 0.5) - 0.5
                map_dims = dim_scale * (map_dims + 0.5) - 0.5
                coord_map = np.array([map_rows, map_cols, map_dims])
                if not is_seg or order_z == 0:
                    reshaped_final.append(
                        map_coordinates(stacked.astype(float), coord_map,
                                        order=order_z, mode="nearest"
                                        )[None].astype(dtype_data))
                else:
                    unique_labels = np.unique(stacked)
                    reshaped = np.zeros(new_shape, dtype=dtype_data)
                    for cl in unique_labels:
                        rm = np.round(map_coordinates(
                            (stacked == cl).astype(float), coord_map,
                            order=order_z, mode="nearest"))
                        reshaped[rm > 0.5] = cl
                    reshaped_final.append(reshaped[None].astype(dtype_data))
            else:
                reshaped_final.append(stacked[None].astype(dtype_data))
        return np.vstack(reshaped_final).astype(dtype_data)

    reshaped = [resize_fn(data[c], new_shape, order,
                          **kwargs)[None].astype(dtype_data)
                for c in range(data.shape[0])]
    return np.vstack(reshaped).astype(dtype_data)


def resample_patient(data: Optional[np.ndarray], seg: Optional[np.ndarray],
                     original_spacing, target_spacing,
                     order_data: int = 3, order_seg: int = 0,
                     force_separate_z=False, order_z_data: int = 0,
                     order_z_seg: int = 0,
                     separate_z_anisotropy_threshold=RESAMPLING_SEPARATE_Z_ANISO_THRESHOLD):
    """Decide separate-z handling and resample data+seg to target spacing
    (reference resample_patient, preprocessing.py:38-109)."""
    assert not (data is None and seg is None)
    if data is not None:
        assert len(data.shape) == 4, "data must be c x y z"
        shape = np.array(data[0].shape)
    else:
        assert len(seg.shape) == 4, "seg must be c x y z"
        shape = np.array(seg[0].shape)

    new_shape = np.round(
        (np.array(original_spacing) / np.array(target_spacing)).astype(float)
        * shape).astype(int)

    if force_separate_z is not None:
        do_separate_z = force_separate_z
        axis = get_lowres_axis(original_spacing) if force_separate_z else None
    else:
        if get_do_separate_z(original_spacing,
                             separate_z_anisotropy_threshold):
            do_separate_z = True
            axis = get_lowres_axis(original_spacing)
        elif get_do_separate_z(target_spacing,
                               separate_z_anisotropy_threshold):
            do_separate_z = True
            axis = get_lowres_axis(target_spacing)
        else:
            do_separate_z = False
            axis = None

    if axis is not None and len(axis) in (2, 3):
        # 2+ axes tied for lowest resolution -> no meaningful separate axis
        do_separate_z = False
        axis = None

    data_r = (resample_data_or_seg(data, new_shape, False, axis, order_data,
                                   do_separate_z, order_z=order_z_data)
              if data is not None else None)
    seg_r = (resample_data_or_seg(seg, new_shape, True, axis, order_seg,
                                  do_separate_z, order_z=order_z_seg)
             if seg is not None else None)
    return data_r, seg_r
