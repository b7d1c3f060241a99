"""Host-side training augmentation pipeline (numpy/scipy).

Parity: the reference "moreDA" pipeline
(data_augmentation_moreDA.py:41-209 with default_3D_augmentation_params and
the nnUNetTrainer_simple.setup_DA_params overrides :682-733):
  spatial (rot ±30° p=0.2, scale 0.7-1.4 p=0.2, NO elastic; sampled from the
  enlarged generator patch then center-cropped) -> gaussian noise p=0.1 ->
  gaussian blur p=0.2 (σ 0.5-1, per-channel p=0.5) -> brightness ×(0.75-1.25)
  p=0.15 -> contrast (0.75-1.25) p=0.15 -> simulated low-res p=0.25
  (per-channel 0.5, zoom 0.5-1) -> inverted gamma p=0.1 -> gamma (0.7-1.5)
  p=0.3 (retain stats) -> mirror all axes -> zero-outside-mask ->
  relabel -1->0 -> deep-supervision target downsampling.

The reference runs this in a process pool (MultiThreadedAugmenter); here a
background thread pipeline (data/pipeline.py) hides it behind device compute.

The port's own copy of e2enet_tpu/data/augment.py: the same draws in the
same order, so that one RandomState gives both packages the same batch.
One change: the symmetry-only import of ops.shift is gone. The cascade's
step (move_last_seg_channel_to_data: the previous stage's seg as one-hot
data channels, corrupted on training batches by
training/cascade.cascade_augment_onehot) and the region trainers' targets
(regions: every deep-supervision target one float32 channel per region,
channels-last, training/regions.convert_seg_to_regions) are the JAX
package's. The port imports nothing of the JAX package.
"""
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
from scipy.ndimage import affine_transform, gaussian_filter


@dataclass
class AugmentParams:
    patch_size: Tuple[int, ...] = (64, 128, 128)   # final network patch
    do_rotation: bool = True
    rotation_x: Tuple[float, float] = (-30 / 360 * 2 * np.pi,
                                       30 / 360 * 2 * np.pi)
    rotation_y: Tuple[float, float] = (-30 / 360 * 2 * np.pi,
                                       30 / 360 * 2 * np.pi)
    rotation_z: Tuple[float, float] = (-30 / 360 * 2 * np.pi,
                                       30 / 360 * 2 * np.pi)
    p_rot: float = 0.2
    do_scaling: bool = True
    scale_range: Tuple[float, float] = (0.7, 1.4)
    p_scale: float = 0.2
    # DA3/DA5 / nnUNetTrainerV2_independentScalePerAxis: per-axis scale
    independent_scale_per_axis: bool = False
    p_independent_scale_per_axis: float = 0.3
    do_dummy_2D: bool = False
    do_mirror: bool = True
    mirror_axes: Tuple[int, ...] = (0, 1, 2)
    do_gamma: bool = True
    gamma_range: Tuple[float, float] = (0.7, 1.5)
    p_gamma: float = 0.3
    gamma_retain_stats: bool = True
    # DA3/DA5 additive brightness (BrightnessTransform)
    do_additive_brightness: bool = False
    additive_brightness_mu: float = 0.0
    additive_brightness_sigma: float = 0.2
    additive_brightness_p_per_sample: float = 0.3
    additive_brightness_p_per_channel: float = 1.0
    mask_was_used_for_normalization: Optional[Dict[int, bool]] = None
    move_last_seg_channel_to_data: bool = False       # cascade
    all_segmentation_labels: Optional[List[int]] = None
    cascade_do_cascade_augmentations: bool = False
    # cascade DA-variant knobs (nnUNetTrainerV2CascadeFullRes_DAVariants)
    cascade_random_binary_transform_p: float = 0.4
    cascade_random_binary_transform_p_per_label: float = 1.0
    cascade_random_binary_transform_size: Tuple[int, int] = (1, 8)
    cascade_remove_conn_comp_p: float = 0.2
    cascade_remove_conn_comp_max_size_percent_threshold: float = 0.15
    border_val_seg: int = -1
    order_data: int = 3
    order_seg: int = 1
    deep_supervision_scales: Optional[List[List[float]]] = None
    # region-based training (BraTS trainers): targets become one binary
    # channel per region (channels-last float), training/regions.py
    regions: Optional[Tuple[Tuple[int, ...], ...]] = None


def get_patch_size(final_patch_size, rot_x, rot_y, rot_z, scale_range):
    """Enlarged sampling patch so rotation+scaling never reads outside.
    Parity: default_data_augmentation.get_patch_size (:111-130)."""
    if isinstance(rot_x, (tuple, list)):
        rot_x = max(np.abs(rot_x))
    if isinstance(rot_y, (tuple, list)):
        rot_y = max(np.abs(rot_y))
    if isinstance(rot_z, (tuple, list)):
        rot_z = max(np.abs(rot_z))
    rot_x = min(np.pi / 2, rot_x)
    rot_y = min(np.pi / 2, rot_y)
    rot_z = min(np.pi / 2, rot_z)
    coords = np.array(final_patch_size)
    final_shape = np.copy(coords)
    if len(coords) == 3:
        final_shape = np.max(np.vstack(
            (np.abs(_rotate_coords_3d(coords, rot_x, 0, 0)), final_shape)), 0)
        final_shape = np.max(np.vstack(
            (np.abs(_rotate_coords_3d(coords, 0, rot_y, 0)), final_shape)), 0)
        final_shape = np.max(np.vstack(
            (np.abs(_rotate_coords_3d(coords, 0, 0, rot_z)), final_shape)), 0)
    final_shape /= min(scale_range)
    return final_shape.astype(int)


def _rot_matrix(angle_x, angle_y, angle_z) -> np.ndarray:
    cx, sx = np.cos(angle_x), np.sin(angle_x)
    cy, sy = np.cos(angle_y), np.sin(angle_y)
    cz, sz = np.cos(angle_z), np.sin(angle_z)
    Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return Rx @ Ry @ Rz


def _rotate_coords_3d(coords, angle_x, angle_y, angle_z):
    return _rot_matrix(angle_x, angle_y, angle_z) @ np.asarray(coords)


def spatial_augment_sample(data: np.ndarray, seg: np.ndarray,
                           params: AugmentParams, rng: np.random.RandomState):
    """Rotation+scaling with center crop to the final patch. data/seg:
    (C, X, Y, Z) one sample. Returns final-patch-sized arrays."""
    patch = np.array(params.patch_size, int)
    in_shape = np.array(data.shape[1:])
    M = np.eye(3)
    did_transform = False

    if params.do_rotation and rng.uniform() < params.p_rot:
        ax = rng.uniform(*params.rotation_x)
        ay = 0.0 if params.do_dummy_2D else rng.uniform(*params.rotation_y)
        az = 0.0 if params.do_dummy_2D else rng.uniform(*params.rotation_z)
        if params.do_dummy_2D:
            # rotate in-plane only: axis 0 fixed
            M = np.array([[1, 0, 0], [0, np.cos(ax), -np.sin(ax)],
                          [0, np.sin(ax), np.cos(ax)]]) @ M
        else:
            M = _rot_matrix(ax, ay, az) @ M
        did_transform = True

    if params.do_scaling and rng.uniform() < params.p_scale:
        def draw_scale():
            if rng.uniform() < 0.5 and params.scale_range[0] < 1:
                return rng.uniform(params.scale_range[0], 1.0)
            return rng.uniform(max(params.scale_range[0], 1.0),
                               params.scale_range[1])
        if (params.independent_scale_per_axis
                and rng.uniform() < params.p_independent_scale_per_axis):
            # SpatialTransform independent_scale_for_each_axis (DA3/DA5,
            # nnUNetTrainerV2_independentScalePerAxis)
            M = M @ np.diag([draw_scale() for _ in range(3)])
        else:
            M = M * draw_scale()
        did_transform = True

    center_in = (in_shape - 1) / 2.0
    center_out = (patch - 1) / 2.0

    if not did_transform:
        # plain center crop
        lo = ((in_shape - patch) // 2).astype(int)
        sl = tuple(slice(l, l + p) for l, p in zip(lo, patch))
        return (data[(slice(None),) + sl].copy(),
                seg[(slice(None),) + sl].copy())

    offset = center_in - M @ center_out

    # native single-pass C++ warp when available (e2enet_tpu/native):
    # ~order-of-magnitude faster than scipy on this 1-CPU host, which is
    # what keeps the device fed (reference hides this cost behind worker
    # processes, data_augmentation_moreDA.py:163)
    from ..native import native_available
    if native_available():
        from ..native import affine_warp, affine_warp_seg
        out_data = affine_warp(data.astype(np.float32, copy=False), M,
                               offset, tuple(patch),
                               order=params.order_data, cval=0.0)
        out_seg = np.zeros((seg.shape[0], *patch), np.float32)
        for c in range(seg.shape[0]):
            if params.order_seg == 0:
                out_seg[c] = affine_warp(seg[c].astype(np.float32), M,
                                         offset, tuple(patch), order=0,
                                         cval=params.border_val_seg)
            else:
                out_seg[c] = affine_warp_seg(seg[c].astype(np.float32), M,
                                             offset, tuple(patch),
                                             cval=params.border_val_seg)
        return out_data, out_seg

    out_data = np.zeros((data.shape[0], *patch), np.float32)
    out_seg = np.zeros((seg.shape[0], *patch), np.float32)
    for c in range(data.shape[0]):
        out_data[c] = affine_transform(
            data[c].astype(float), M, offset=offset,
            output_shape=tuple(patch), order=params.order_data,
            mode="constant", cval=0.0)
    for c in range(seg.shape[0]):
        # order-1 seg interpolation + round (batchgenerators
        # interpolate_img(is_seg) semantics: per-label linear + threshold;
        # plain rounding is the fast equivalent for label maps)
        out_seg[c] = _interpolate_seg(seg[c].astype(float), M, offset,
                                      tuple(patch), params.order_seg,
                                      params.border_val_seg)
    return out_data, out_seg


def _interpolate_seg(seg, M, offset, out_shape, order, cval):
    if order == 0:
        return affine_transform(seg, M, offset=offset, output_shape=out_shape,
                                order=0, mode="constant", cval=cval)
    unique_labels = np.unique(seg)
    result = np.ones(out_shape, seg.dtype) * cval
    for c in unique_labels:
        res_new = affine_transform((seg == c).astype(float), M, offset=offset,
                                   output_shape=out_shape, order=order,
                                   mode="constant", cval=0)
        result[res_new >= 0.5] = c
    return result


# ------------------------------------------------------------- intensity
def gaussian_noise(data, rng, p=0.1, variance=(0, 0.1)):
    for b in range(data.shape[0]):
        if rng.uniform() < p:
            v = rng.uniform(*variance)
            data[b] += rng.normal(0.0, np.sqrt(v), size=data[b].shape)
    return data


def gaussian_blur(data, rng, p_sample=0.2, p_channel=0.5, sigma=(0.5, 1.0)):
    for b in range(data.shape[0]):
        if rng.uniform() < p_sample:
            for c in range(data.shape[1]):
                if rng.uniform() < p_channel:
                    s = rng.uniform(*sigma)
                    data[b, c] = gaussian_filter(data[b, c], s)
    return data


def brightness_multiplicative(data, rng, p=0.15, rng_mult=(0.75, 1.25)):
    for b in range(data.shape[0]):
        if rng.uniform() < p:
            for c in range(data.shape[1]):
                data[b, c] *= rng.uniform(*rng_mult)
    return data


def additive_brightness(data, rng, mu=0.0, sigma=0.2, p_sample=0.3,
                        p_channel=1.0):
    """BrightnessTransform (additive gaussian shift; DA3/DA5 + the MMS /
    fullEvals trainers set these knobs)."""
    for b in range(data.shape[0]):
        if rng.uniform() < p_sample:
            for c in range(data.shape[1]):
                if rng.uniform() < p_channel:
                    data[b, c] += rng.normal(mu, sigma)
    return data


def contrast_augmentation(data, rng, p=0.15, contrast_range=(0.75, 1.25)):
    for b in range(data.shape[0]):
        if rng.uniform() < p:
            for c in range(data.shape[1]):
                factor = rng.uniform(*contrast_range)
                x = data[b, c]
                mn = x.mean()
                minm, maxm = x.min(), x.max()
                x = (x - mn) * factor + mn
                data[b, c] = np.clip(x, minm, maxm)
    return data


def simulate_low_resolution(data, rng, p_sample=0.25, p_channel=0.5,
                            zoom_range=(0.5, 1.0)):
    from .. preprocessing.resampling import resize
    for b in range(data.shape[0]):
        if rng.uniform() < p_sample:
            for c in range(data.shape[1]):
                if rng.uniform() < p_channel:
                    zoom = rng.uniform(*zoom_range)
                    shp = np.array(data.shape[2:])
                    target = np.round(shp * zoom).astype(int)
                    target = np.maximum(target, 1)
                    down = resize(data[b, c], target, order=0,
                                  mode="edge", clip=True)
                    data[b, c] = resize(down, shp, order=3, mode="edge",
                                        clip=True)
    return data


def gamma_augmentation(data, rng, p=0.3, gamma_range=(0.7, 1.5),
                       invert_image=False, retain_stats=True, epsilon=1e-7):
    for b in range(data.shape[0]):
        if rng.uniform() < p:
            for c in range(data.shape[1]):
                x = data[b, c]
                if invert_image:
                    x = -x
                if retain_stats:
                    mn, sd = x.mean(), x.std()
                if rng.uniform() < 0.5 and gamma_range[0] < 1:
                    gamma = rng.uniform(gamma_range[0], 1)
                else:
                    gamma = rng.uniform(max(gamma_range[0], 1),
                                        gamma_range[1])
                minm = x.min()
                rnge = x.max() - minm
                x = np.power(((x - minm) / float(rnge + epsilon)),
                             gamma) * rnge + minm
                if retain_stats:
                    x = x - x.mean()
                    x = x / (x.std() + 1e-8) * sd
                    x = x + mn
                if invert_image:
                    x = -x
                data[b, c] = x
    return data


def mirror(data, seg, rng, axes=(0, 1, 2)):
    for b in range(data.shape[0]):
        for ax in axes:
            if rng.uniform() < 0.5:
                data[b] = np.flip(data[b], ax + 1)
                seg[b] = np.flip(seg[b], ax + 1)
    return data, seg


def apply_mask_norm_zeroing(data, seg, use_mask: Dict[int, bool]):
    """MaskTransform: zero data outside the nonzero mask (seg == -1 marks
    outside after cropping)."""
    for c, use in use_mask.items():
        if use:
            data[:, c][seg[:, 0] < 0] = 0
    return data


def downsample_targets(seg: np.ndarray,
                       scales: Optional[List[List[float]]]):
    """Strided nearest downsampling of (B, X, Y, Z) int targets per DS scale
    (see ops/losses.downsample_seg_for_ds for the exact-grid argument)."""
    if scales is None:
        return [seg]
    outs = []
    for s in scales:
        f = [int(round(1.0 / x)) for x in s]
        outs.append(seg[:, ::f[0], ::f[1], ::f[2]])
    return outs


def augment_batch(batch: dict, params: AugmentParams,
                  rng: np.random.RandomState, validation: bool = False):
    """Full train-time pipeline. batch: {'data': (B,C,bx,by,bz),
    'seg': (B,1,bx,by,bz)} with the enlarged generator patch; returns
    {'data': (B,C,*patch), 'target': [per-DS-level (B, ...)]} float32."""
    data, seg = batch["data"], batch["seg"]
    if not validation:
        out_d = np.zeros((data.shape[0], data.shape[1], *params.patch_size),
                         np.float32)
        out_s = np.zeros((seg.shape[0], seg.shape[1], *params.patch_size),
                         np.float32)
        for b in range(data.shape[0]):
            out_d[b], out_s[b] = spatial_augment_sample(
                data[b], seg[b], params, rng)
        data, seg = out_d, out_s

        data = gaussian_noise(data, rng)
        data = gaussian_blur(data, rng)
        data = brightness_multiplicative(data, rng)
        if params.do_additive_brightness:
            data = additive_brightness(
                data, rng, params.additive_brightness_mu,
                params.additive_brightness_sigma,
                params.additive_brightness_p_per_sample,
                params.additive_brightness_p_per_channel)
        data = contrast_augmentation(data, rng)
        data = simulate_low_resolution(data, rng)
        data = gamma_augmentation(data, rng, p=0.1, invert_image=True,
                                  gamma_range=params.gamma_range,
                                  retain_stats=params.gamma_retain_stats)
        if params.do_gamma:
            data = gamma_augmentation(data, rng, p=params.p_gamma,
                                      invert_image=False,
                                      gamma_range=params.gamma_range,
                                      retain_stats=params.gamma_retain_stats)
        if params.do_mirror:
            data, seg = mirror(data, seg, rng, params.mirror_axes)

    if params.mask_was_used_for_normalization is not None:
        data = apply_mask_norm_zeroing(data, seg,
                                       params.mask_was_used_for_normalization)

    if params.move_last_seg_channel_to_data:
        # cascade: prev-stage seg (seg channel 1) -> one-hot data channels
        # (MoveSegAsOneHotToData, custom_transforms.py)
        from ..training.cascade import (cascade_augment_onehot,
                                        move_seg_as_onehot_to_data)
        labels = params.all_segmentation_labels
        data = move_seg_as_onehot_to_data(data, seg[:, -1], labels)
        if params.cascade_do_cascade_augmentations and not validation:
            data[:, -len(labels):] = cascade_augment_onehot(
                data[:, -len(labels):], rng,
                p_binary_op=params.cascade_random_binary_transform_p,
                p_per_label=(
                    params.cascade_random_binary_transform_p_per_label),
                strel_size=params.cascade_random_binary_transform_size,
                p_remove_component=params.cascade_remove_conn_comp_p,
                max_size_percent=(
                    params.cascade_remove_conn_comp_max_size_percent_threshold))
        seg = seg[:, :1]

    seg = np.where(seg == -1, 0, seg)
    targets = downsample_targets(seg[:, 0].astype(np.int32),
                                 params.deep_supervision_scales)
    if params.regions is not None:
        from ..training.regions import convert_seg_to_regions
        targets = [convert_seg_to_regions(t, params.regions)
                   for t in targets]
    return {"data": np.ascontiguousarray(data, np.float32),
            "target": [np.ascontiguousarray(t) for t in targets]}
