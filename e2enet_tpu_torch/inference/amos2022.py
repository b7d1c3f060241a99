"""AMOS2022 competition inference variant.

Parity: reference inference/amos2022/inference_code.py
(predict_cases_amos2022 :15+): resample the softmax to the original
geometry on the device instead of the host's spline path, the
speed-oriented competition setup.

The port's counterpart of e2enet_tpu/inference/amos2022.py. The JAX package
resamples with jax.image.resize, which is F.interpolate's trilinear only
when it upsamples: when it downsamples an axis it filters with a triangle
as wide as the scale (antialias), and its "nearest" takes
floor((i + 0.5) * in / out), the rule of F.interpolate's "nearest-exact".
The port computes the same function: per axis an (out, in) weight matrix
built as jax's compute_weight_mat builds it, applied as one contraction
per axis of the (C, X, Y, Z) tensor on the device in float32 (nearest: one
gather per axis by jax's indices), then the argmax; the host
receives only the uint8 label map. An axis whose size stays is left as it
is, as jax leaves it. Every entry point takes `device`: "cuda" without a
card raises, "cpu" runs the same contractions on the host.
"""
import os
from typing import Sequence

import numpy as np
import torch

from ..io.nifti import NiftiImage, write_nifti
from ..utils.files import join, maybe_mkdir_p, subfiles
from .predictor import (ModelBundle, check_input_folder_and_return_caseIDs,
                        predict_case, require_device)

METHODS = {"trilinear": "linear", "linear": "linear", "nearest": "nearest"}


def linear_weights(in_size: int, out_size: int,
                   device="cpu") -> torch.Tensor:
    """(out, in) float32 weights of jax.image.resize's "linear" method
    along one axis (jax/_src/image/scale.py, compute_weight_mat with the
    triangle kernel, antialias on, no translation): sample positions
    (i + 0.5) / scale - 0.5, the kernel widened by 1 / scale when
    downsampling, each output's weights normalised to sum 1, outputs whose
    sample falls outside [-0.5, in - 0.5] zero."""
    inv_scale = 1.0 / (out_size / in_size)
    kernel_scale = max(inv_scale, 1.0)
    sample = ((torch.arange(out_size, dtype=torch.float32, device=device)
               + 0.5) * inv_scale - 0.5)
    src = torch.arange(in_size, dtype=torch.float32, device=device)
    x = (sample[:, None] - src[None, :]).abs() / kernel_scale
    w = torch.clamp(1.0 - x.abs(), min=0.0)
    total = w.sum(1, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[:, None], w, torch.zeros_like(w))


def nearest_indices(in_size: int, out_size: int,
                    device="cpu") -> torch.Tensor:
    """The source index of each output of jax.image.resize's "nearest"
    along one axis: floor((i + 0.5) * in / out), which float32 computes
    exactly here (an exact product, one correctly rounded division). Where
    (i + 0.5) * in / out is a whole number, jax on XLA:CPU, whose division
    by a constant is not correctly rounded, takes the index below at some
    sizes (223 of the 3878 such outputs over the sizes 1-69 in and out),
    and F.interpolate's "nearest-exact", which rounds in / out first, at
    others (56); everywhere else all three agree."""
    pos = ((torch.arange(out_size, dtype=torch.float32, device=device)
            + 0.5) * in_size) / out_size
    return torch.floor(pos).to(torch.long)


def resize_softmax(softmax, target_shape: Sequence[int],
                   method: str = "trilinear", device="cuda") -> torch.Tensor:
    """softmax (C, X, Y, Z) resized to (C, *target_shape) on `device` in
    float32, as jax.image.resize(softmax, (C, *target_shape), method)
    computes it (see the module's note). Returns the tensor on `device`."""
    dev = require_device(device)
    method = METHODS[method]
    x = (softmax if isinstance(softmax, torch.Tensor)
         else torch.from_numpy(np.ascontiguousarray(softmax)))
    x = x.to(dev, torch.float32)
    target = [int(i) for i in target_shape]
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False   # jax's HIGHEST
    try:
        for axis, n in enumerate(target, start=1):
            m = x.shape[axis]
            if m == n:
                continue
            if method == "nearest":
                x = torch.index_select(x, axis, nearest_indices(m, n, dev))
                continue
            w = linear_weights(m, n, dev)
            x = torch.movedim(torch.tensordot(x, w, dims=([axis], [1])),
                              -1, axis)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return x


def resample_softmax_on_device(softmax, target_shape: Sequence[int],
                               method: str = "trilinear",
                               device="cuda") -> np.ndarray:
    """softmax (C, X, Y, Z) -> uint8 argmax label map at target_shape, the
    resize and the argmax on `device`, one copy to the host."""
    y = resize_softmax(softmax, target_shape, method, device)
    return torch.argmax(y, dim=0).to(torch.uint8).cpu().numpy()


def export_softmax_amos2022(softmax, out_fname: str, properties: dict,
                            device="cuda"):
    """Device-resampled export: softmax (an array, or a tensor) at network
    geometry -> label map at original geometry -> paste into pre-crop
    canvas -> write."""
    target_shape = properties["size_after_cropping"]
    seg = resample_softmax_on_device(softmax, target_shape, device=device)

    bbox = properties.get("crop_bbox")
    shape_original = properties["original_size_of_raw_data"]
    if bbox is not None:
        canvas = np.zeros([int(i) for i in shape_original], np.uint8)
        for c in range(3):
            bbox[c][1] = np.min((bbox[c][0] + seg.shape[c],
                                 int(shape_original[c])))
        canvas[bbox[0][0]:bbox[0][1], bbox[1][0]:bbox[1][1],
               bbox[2][0]:bbox[2][1]] = seg
    else:
        canvas = seg
    d = os.path.dirname(out_fname)
    if d:
        maybe_mkdir_p(d)
    write_nifti(out_fname, NiftiImage(canvas, properties["itk_spacing"],
                                      properties["itk_origin"],
                                      properties["itk_direction"]))


def predict_from_folder_amos2022(model_folder: str, input_folder: str,
                                 output_folder: str, folds,
                                 tconv: str = "shiftConvPP",
                                 do_tta: bool = True,
                                 step_size: float = 0.5,
                                 device="cuda"):
    """predict_cases_amos2022 equivalent: fold-ensemble sliding window with
    device-side softmax resampling export. The softmax goes to the device
    as predict_case returns it (contiguous), and is transposed back to the
    image's axis order there."""
    maybe_mkdir_p(output_folder)
    bundle = ModelBundle(model_folder, folds, tconv, device=device)
    case_ids = check_input_folder_and_return_caseIDs(
        input_folder, bundle.plans.num_modalities)
    all_files = subfiles(input_folder, join=False, suffix=".nii.gz",
                         sort=True)
    preprocessor = bundle.make_preprocessor()
    target_spacing = bundle.stage_plan.current_spacing
    for c in case_ids:
        files = [join(input_folder, f) for f in all_files
                 if f.startswith(c) and len(f) == len(c) + 12]
        d, s, props = preprocessor.preprocess_test_case(files,
                                                        target_spacing)
        softmax = torch.from_numpy(predict_case(
            bundle, d, do_tta=do_tta, step_size=step_size)).to(bundle.device)
        softmax = softmax.permute(
            [0] + [int(i) + 1 for i in bundle.plans.transpose_backward])
        export_softmax_amos2022(softmax, join(output_folder, f"{c}.nii.gz"),
                                props, device=device)
        print("amos2022 export:", c)
