"""Cascade (3d_lowres -> 3d_cascade_fullres) support on the port: its copy
of e2enet_tpu/training/cascade.py (the port imports nothing of the JAX
package).

Parity: reference training/cascade_stuff/predict_next_stage.py (:31-100:
each lowres fold predicts its VALIDATION cases, softmax is resampled to the
fullres stage geometry, argmaxed and stored as
<case>_segFromPrevStage.npz next to the fullres data; run for all 5 folds to
cover the whole training set), nnUNetTrainerV2_CascadeFullRes (the fullres
trainer consumes the prev-stage seg as extra one-hot input channels —
MoveSegAsOneHotToData in data_augmentation/custom_transforms.py) and the
cascade branch of the predict CLI (simple_predict.py:194-211: auto-predict
lowres first; cli/predict.py).

predict_next_stage runs the trainer's tile loop on its model and device
(the path of Trainer.validate: on the card the forward kernels). The
one-hot moves and the cascade augmentation draw from `rng` in the JAX
package's order, so one seed gives both packages the same arrays.
"""
import os
from typing import Sequence

import numpy as np
import torch

from ..data.dataset import load_case
from ..inference.predictor import mirror_apply_fns_for
from ..ops.sliding import predict_volume_tiled
from ..preprocessing.resampling import resample_data_or_seg
from ..utils.files import join, maybe_mkdir_p


def resample_and_save(predicted_probabilities: np.ndarray, target_shape,
                      output_file: str, force_separate_z=False,
                      interpolation_order: int = 1,
                      interpolation_order_z: int = 0):
    predicted_new_shape = resample_data_or_seg(
        predicted_probabilities, target_shape, False,
        order=interpolation_order, do_separate_z=force_separate_z,
        order_z=interpolation_order_z)
    seg_new_shape = predicted_new_shape.argmax(0)
    np.savez_compressed(output_file, data=seg_new_shape.astype(np.uint8))


def predict_next_stage(trainer, stage_to_be_predicted_folder: str,
                       do_mirroring: bool = True, step_size: float = 0.5):
    """Predict the lowres trainer's validation cases and store them at the
    next stage's geometry, as <case>_segFromPrevStage.npz in that stage's
    preprocessed folder (the JAX package's deviation from the reference,
    which writes them under the lowres results: the sampler finds them
    next to the data files). Running all folds covers the full training
    set without train-set leakage."""
    maybe_mkdir_p(stage_to_be_predicted_folder)
    net = trainer.network
    patch = tuple(int(i) for i in trainer.patch_size)
    # flip-free TTA where the network has mirrored operators
    fns = (mirror_apply_fns_for(net)
           if do_mirroring and net.mirrored_operators() else None)
    for pat in trainer.dataset_val.keys():
        print("pred_next_stage:", pat)
        data = np.asarray(load_case(trainer.dataset_val[pat]))[:-1]
        with torch.no_grad():
            probs = predict_volume_tiled(
                lambda x: net(x, do_ds=False), data, patch,
                trainer.num_classes, device=trainer.device,
                step_size=step_size, do_mirroring=do_mirroring,
                mirror_apply_fns=fns)
        data_file_nofolder = os.path.basename(
            trainer.dataset_val[pat]["data_file"])
        data_file_nextstage = join(stage_to_be_predicted_folder,
                                   data_file_nofolder)
        target_shp = np.load(data_file_nextstage)["data"].shape[1:]
        output_file = join(stage_to_be_predicted_folder,
                           data_file_nofolder[:-4] + "_segFromPrevStage.npz")
        resample_and_save(probs, target_shp, output_file)


def seg_from_prev_stage_file(folder: str, case_identifier: str) -> str:
    return join(folder, f"{case_identifier}_segFromPrevStage.npz")


def move_seg_as_onehot_to_data(data: np.ndarray, seg_prev: np.ndarray,
                               all_seg_labels: Sequence[int]) -> np.ndarray:
    """Append one-hot channels of the prev-stage seg to the data
    (MoveSegAsOneHotToData semantics). data: (B, C, ...);
    seg_prev: (B, ...)."""
    onehot = np.stack([(seg_prev == l).astype(data.dtype)
                       for l in all_seg_labels], axis=1)
    return np.concatenate([data, onehot], axis=1)


def cascade_augment_onehot(data_onehot_channels: np.ndarray,
                           rng: np.random.RandomState,
                           p_binary_op: float = 0.4,
                           strel_size=(1, 8),
                           p_remove_component: float = 0.2,
                           max_size_percent: float = 0.15,
                           p_per_label: float = 1.0):
    """Cascade-specific corruption of the prev-stage one-hot channels so the
    fullres net does not blindly trust them (pyramid_augmentations.py:
    ApplyRandomBinaryOperatorTransform +
    RemoveRandomConnectedComponentFromOneHotEncodingTransform).
    data_onehot_channels: (B, L, x, y, z) in-place."""
    from scipy.ndimage import (binary_closing, binary_dilation,
                               binary_erosion, binary_opening, label)
    ops = [binary_dilation, binary_erosion, binary_closing, binary_opening]
    B, L = data_onehot_channels.shape[:2]
    for b in range(B):
        if rng.uniform() < p_binary_op:
            for l in range(L):
                if rng.uniform() >= p_per_label:
                    continue
                op = ops[rng.randint(len(ops))]
                size = rng.randint(strel_size[0], strel_size[1])
                strel = np.ones((size,) * 3, bool)
                data_onehot_channels[b, l] = op(
                    data_onehot_channels[b, l].astype(bool),
                    strel).astype(data_onehot_channels.dtype)
        if rng.uniform() < p_remove_component:
            for l in range(L):
                m = data_onehot_channels[b, l].astype(bool)
                lmap, n = label(m)
                if n < 2:
                    continue
                sizes = [(lmap == i).sum() for i in range(1, n + 1)]
                total = m.sum()
                candidates = [i for i, s in enumerate(sizes, start=1)
                              if s < max_size_percent * total]
                if candidates:
                    rm = candidates[rng.randint(len(candidates))]
                    data_onehot_channels[b, l][lmap == rm] = 0
    return data_onehot_channels
