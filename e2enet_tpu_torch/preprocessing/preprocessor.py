"""GenericPreprocessor: transpose -> resample to target spacing -> normalize
per modality -> sample per-class foreground locations -> save npz+pkl.

Parity: reference e2enet/preprocessing/preprocessing.py:205-407
(resample_and_normalize :231-319, preprocess_test_case :321-328,
_run_internal :330-366 incl. the seeded 10k class-location sampling
:344-361, run :369-407). Normalization schemes (:281-318):
  CT    : clip to global foreground [0.5, 99.5] percentiles + global z-score
  CT2   : clip to global bounds, per-case stats within the clip mask
  noNorm: passthrough
  else  : per-case z-score (within the nonzero mask when configured)

The port's own copy of e2enet_tpu/preprocessing/preprocessor.py (the port
imports nothing of the JAX package), with one change: run's worker
processes are spawned, not forked, so that no worker inherits the threads
or a CUDA context of the process that calls it. Every case is written by
one worker from its own inputs, so the files are the same either way.
"""
import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor
from typing import Dict, Optional

import numpy as np

from ..configuration import (RESAMPLING_SEPARATE_Z_ANISO_THRESHOLD,
                             default_num_threads)
from ..utils.files import (join, load_pickle, maybe_mkdir_p, save_pickle,
                           subfiles)
from ..utils.registry import PREPROCESSORS
from .cropping import ImageCropper, get_case_identifier_from_npz
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

    def _run_internal(self, target_spacing, case_identifier,
                      output_folder_stage, cropped_output_dir,
                      force_separate_z, all_classes):
        data, seg, properties = self.load_cropped(cropped_output_dir,
                                                  case_identifier)
        data = data.transpose((0, *[i + 1 for i in self.transpose_forward]))
        seg = seg.transpose((0, *[i + 1 for i in self.transpose_forward]))
        data, seg, properties = self.resample_and_normalize(
            data, target_spacing, properties, seg, force_separate_z)
        all_data = np.vstack((data, seg)).astype(np.float32)

        # 10k per-class foreground coordinates for oversampling (seed 1234,
        # >=1% coverage; preprocessing.py:344-361)
        num_samples = 10000
        min_percent_coverage = 0.01
        rndst = np.random.RandomState(1234)
        class_locs = {}
        for c in all_classes:
            all_locs = np.argwhere(all_data[-1] == c)
            if len(all_locs) == 0:
                class_locs[c] = []
                continue
            target_num_samples = min(num_samples, len(all_locs))
            target_num_samples = max(
                target_num_samples,
                int(np.ceil(len(all_locs) * min_percent_coverage)))
            selected = all_locs[rndst.choice(len(all_locs),
                                             target_num_samples,
                                             replace=False)]
            class_locs[c] = selected
            print(c, target_num_samples)
        properties["class_locations"] = class_locs

        print("saving:", os.path.join(output_folder_stage,
                                      f"{case_identifier}.npz"))
        np.savez_compressed(
            os.path.join(output_folder_stage, f"{case_identifier}.npz"),
            data=all_data.astype(np.float32))
        save_pickle(properties, os.path.join(output_folder_stage,
                                             f"{case_identifier}.pkl"))

    def run(self, target_spacings, input_folder_with_cropped_npz,
            output_folder, data_identifier,
            num_threads=default_num_threads, force_separate_z=None):
        """Per stage: resample+normalize every cropped case into
        <output>/<data_identifier>_stage<N>/ (preprocessing.py:369-407)."""
        print("Initializing to run preprocessing")
        print("npz folder:", input_folder_with_cropped_npz)
        print("output_folder:", output_folder)
        list_of_cropped_npz_files = subfiles(input_folder_with_cropped_npz,
                                             True, None, ".npz", True)
        maybe_mkdir_p(output_folder)
        num_stages = len(target_spacings)
        if not isinstance(num_threads, (list, tuple, np.ndarray)):
            num_threads = [num_threads] * num_stages
        assert len(num_threads) == num_stages

        all_classes = load_pickle(
            join(input_folder_with_cropped_npz,
                 "dataset_properties.pkl"))["all_classes"]

        for i in range(num_stages):
            output_folder_stage = os.path.join(
                output_folder, data_identifier + "_stage%d" % i)
            maybe_mkdir_p(output_folder_stage)
            spacing = target_spacings[i]
            args = []
            for case in list_of_cropped_npz_files:
                case_identifier = get_case_identifier_from_npz(case)
                args.append((spacing, case_identifier, output_folder_stage,
                             input_folder_with_cropped_npz, force_separate_z,
                             all_classes))
            if num_threads[i] > 1 and (os.cpu_count() or 1) > 1:
                with ProcessPoolExecutor(
                        max_workers=num_threads[i],
                        mp_context=multiprocessing.get_context("spawn")
                ) as pool:
                    futures = [pool.submit(self._run_internal, *a)
                               for a in args]
                    for f in futures:
                        f.result()
            else:
                for a in args:
                    self._run_internal(*a)


@PREPROCESSORS.register()
class GenericPreprocessor_linearResampling(GenericPreprocessor):
    """Order-1 data resampling variant
    (preprocessing.py:410 GenericPreprocessor_linearResampling)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.resample_order_data = 1
        self.resample_order_seg = 1


@PREPROCESSORS.register()
class Preprocessor3DDifferentResampling(GenericPreprocessor):
    """Same orders as Generic but never separate-z
    (preprocessing.py:418 forces force_separate_z=False downstream)."""

    def resample_and_normalize(self, data, target_spacing, properties,
                               seg=None, force_separate_z=None):
        return super().resample_and_normalize(data, target_spacing,
                                              properties, seg,
                                              force_separate_z=False)
