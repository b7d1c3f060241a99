"""GenericPreprocessor for prediction: transpose -> resample to target
spacing -> normalize per modality.

Parity: reference e2enet/preprocessing/preprocessing.py:205-407
(resample_and_normalize :231-319, preprocess_test_case :321-328).
Normalization schemes (:281-318):
  CT    : clip to global foreground [0.5, 99.5] percentiles + global z-score
  CT2   : clip to global bounds, per-case stats within the clip mask
  noNorm: passthrough
  else  : per-case z-score (within the nonzero mask when configured)

The port's own copy of the prediction part of
e2enet_tpu/preprocessing/preprocessor.py (its GenericPreprocessor without
_run_internal and run, which write the training set; the two resampling
subclasses come with the preprocessing CLI): the port imports nothing of
the JAX package.
"""
import os
from typing import Dict, Optional

import numpy as np

from ..configuration import RESAMPLING_SEPARATE_Z_ANISO_THRESHOLD
from ..utils.files import load_pickle
from ..utils.registry import PREPROCESSORS
from .cropping import ImageCropper
from .resampling import resample_patient


@PREPROCESSORS.register()
class GenericPreprocessor:
    def __init__(self, normalization_scheme_per_modality: Dict[int, str],
                 use_nonzero_mask: Dict[int, bool], transpose_forward,
                 intensityproperties: Optional[Dict] = None):
        self.transpose_forward = transpose_forward
        self.intensityproperties = intensityproperties
        self.normalization_scheme_per_modality = \
            normalization_scheme_per_modality
        self.use_nonzero_mask = use_nonzero_mask
        self.resample_separate_z_anisotropy_threshold = \
            RESAMPLING_SEPARATE_Z_ANISO_THRESHOLD
        self.resample_order_data = 3
        self.resample_order_seg = 1

    @staticmethod
    def load_cropped(cropped_output_dir, case_identifier):
        all_data = np.load(os.path.join(
            cropped_output_dir, f"{case_identifier}.npz"))["data"]
        data = all_data[:-1].astype(np.float32)
        seg = all_data[-1:]
        properties = load_pickle(os.path.join(
            cropped_output_dir, f"{case_identifier}.pkl"))
        return data, seg, properties

    def resample_and_normalize(self, data, target_spacing, properties,
                               seg=None, force_separate_z=None):
        original_spacing_transposed = np.array(
            properties["original_spacing"])[self.transpose_forward]
        before = {"spacing": properties["original_spacing"],
                  "spacing_transposed": original_spacing_transposed,
                  "data.shape (data is transposed)": data.shape}

        data[np.isnan(data)] = 0

        data, seg = resample_patient(
            data, seg, np.array(original_spacing_transposed), target_spacing,
            self.resample_order_data, self.resample_order_seg,
            force_separate_z=force_separate_z, order_z_data=0, order_z_seg=0,
            separate_z_anisotropy_threshold=
            self.resample_separate_z_anisotropy_threshold)
        after = {"spacing": target_spacing,
                 "data.shape (data is resampled)": data.shape}
        print("before:", before, "\nafter:", after, "\n")

        if seg is not None:
            seg[seg < -1] = 0

        properties["size_after_resampling"] = data[0].shape
        properties["spacing_after_resampling"] = target_spacing
        use_nonzero_mask = self.use_nonzero_mask

        assert len(self.normalization_scheme_per_modality) == len(data)
        assert len(self.use_nonzero_mask) == len(data)

        for c in range(len(data)):
            scheme = self.normalization_scheme_per_modality[c]
            if scheme == "CT":
                assert self.intensityproperties is not None, \
                    "CT normalization requires intensity properties"
                props = self.intensityproperties[c]
                mean_intensity = props["mean"]
                std_intensity = props["sd"]
                lower_bound = props["percentile_00_5"]
                upper_bound = props["percentile_99_5"]
                data[c] = np.clip(data[c], lower_bound, upper_bound)
                data[c] = (data[c] - mean_intensity) / std_intensity
                if use_nonzero_mask[c]:
                    data[c][seg[-1] < 0] = 0
            elif scheme == "CT2":
                assert self.intensityproperties is not None
                props = self.intensityproperties[c]
                lower_bound = props["percentile_00_5"]
                upper_bound = props["percentile_99_5"]
                mask = (data[c] > lower_bound) & (data[c] < upper_bound)
                data[c] = np.clip(data[c], lower_bound, upper_bound)
                mn = data[c][mask].mean()
                sd = data[c][mask].std()
                data[c] = (data[c] - mn) / sd
                if use_nonzero_mask[c]:
                    data[c][seg[-1] < 0] = 0
            elif scheme == "noNorm":
                pass
            else:
                if use_nonzero_mask[c]:
                    mask = seg[-1] >= 0
                    data[c][mask] = (data[c][mask] - data[c][mask].mean()) \
                        / (data[c][mask].std() + 1e-8)
                    data[c][mask == 0] = 0
                else:
                    mn = data[c].mean()
                    std = data[c].std()
                    data[c] = (data[c] - mn) / (std + 1e-8)
        return data, seg, properties

    def preprocess_test_case(self, data_files, target_spacing, seg_file=None,
                             force_separate_z=None):
        data, seg, properties = ImageCropper.crop_from_list_of_files(
            data_files, seg_file)
        data = data.transpose(
            (0, *[i + 1 for i in self.transpose_forward]))
        seg = seg.transpose((0, *[i + 1 for i in self.transpose_forward]))
        data, seg, properties = self.resample_and_normalize(
            data, target_spacing, properties, seg,
            force_separate_z=force_separate_z)
        return data.astype(np.float32), seg, properties
