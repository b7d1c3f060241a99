"""Experiment planner: fingerprints -> target spacing -> patch/topology/batch
size under a memory budget -> stages -> plans.json.

Parity: reference ExperimentPlanner
(experiment_planner_baseline_3DUNet.py:32-445) with the
ExperimentPlanner3D_v21 refinements (experiment_planner_baseline_3DUNet_v21.py:24-184):
  * target spacing = dataset median; when the worst axis is >3x anisotropic
    in both spacing and voxel count, it uses that axis' 10th-percentile
    spacing instead (v21 get_target_spacing :38-84);
  * transpose so the worst-spacing axis comes first (:267-271);
  * patch-size search: start from an isotropic-mm 512^3 patch clipped to the
    median shape, solve the pool/conv topology, and shrink the largest
    axis-vs-median until the VRAM proxy fits the reference budget
    (v21 get_properties_for_stage :86-184);
  * batch size = budget ratio floor, capped at 5% of dataset voxels, min 2;
  * optional 3d_lowres stage when the median patient is >4 patches
    (:292-327).

The port's own copy of e2enet_tpu/planning/planner.py, unchanged but for this note:
the port imports nothing of the JAX package.
"""
import shutil
from collections import OrderedDict
from copy import deepcopy

import numpy as np

from ..configuration import default_num_threads
from ..models import vram
from ..plans import Plans, StagePlan, _to_jsonable
from ..utils.files import (isdir, join, load_pickle, maybe_mkdir_p, subfiles)
from ..utils.registry import PLANNERS, PREPROCESSORS
# importing the module registers the preprocessor classes
from ..preprocessing import preprocessor as _preprocessor_module  # noqa: F401
from .topology import get_pool_and_conv_props


@PLANNERS.register()
class ExperimentPlanner3D_v21:
    def __init__(self, folder_with_cropped_data, preprocessed_output_folder):
        self.folder_with_cropped_data = folder_with_cropped_data
        self.preprocessed_output_folder = preprocessed_output_folder
        self.list_of_cropped_npz_files = subfiles(
            self.folder_with_cropped_data, True, None, ".npz", True)
        self.preprocessor_name = "GenericPreprocessor"

        self.dataset_properties = load_pickle(
            join(self.folder_with_cropped_data, "dataset_properties.pkl"))

        self.plans_per_stage = OrderedDict()
        self.plans = None
        self.plans_fname = join(self.preprocessed_output_folder,
                                "nnUNetPlansv2.1_plans_3D.json")
        self.data_identifier = "nnUNetData_plans_v2.1"

        self.transpose_forward = [0, 1, 2]
        self.transpose_backward = [0, 1, 2]

        self.unet_base_num_features = 32
        self.unet_max_num_filters = 320
        self.unet_max_numpool = 999
        self.unet_min_batch_size = 2
        self.unet_featuremap_min_edge_length = 4

        self.target_spacing_percentile = 50
        self.anisotropy_threshold = 3
        self.how_much_of_a_patient_must_the_network_see_at_stage0 = 4
        self.batch_size_covers_max_percent_of_dataset = 0.05
        self.conv_per_stage = 2

    # ------------------------------------------------------------ spacing
    def get_target_spacing(self):
        spacings = self.dataset_properties["all_spacings"]
        sizes = self.dataset_properties["all_sizes"]

        target = np.percentile(np.vstack(spacings),
                               self.target_spacing_percentile, 0)
        target_size = np.percentile(np.vstack(sizes),
                                    self.target_spacing_percentile, 0)
        worst_spacing_axis = np.argmax(target)
        other_axes = [i for i in range(len(target))
                      if i != worst_spacing_axis]
        other_spacings = [target[i] for i in other_axes]
        other_sizes = [target_size[i] for i in other_axes]

        has_aniso_spacing = target[worst_spacing_axis] > (
            self.anisotropy_threshold * max(other_spacings))
        has_aniso_voxels = target_size[worst_spacing_axis] * \
            self.anisotropy_threshold < min(other_sizes)

        if has_aniso_spacing and has_aniso_voxels:
            spacings_of_that_axis = np.vstack(spacings)[:, worst_spacing_axis]
            target_spacing_of_that_axis = np.percentile(
                spacings_of_that_axis, 10)
            if target_spacing_of_that_axis < max(other_spacings):
                target_spacing_of_that_axis = max(
                    max(other_spacings), target_spacing_of_that_axis) + 1e-5
            target[worst_spacing_axis] = target_spacing_of_that_axis
        return target

    # ------------------------------------------------------------- stage
    def get_properties_for_stage(self, current_spacing, original_spacing,
                                 original_shape, num_cases, num_modalities,
                                 num_classes) -> StagePlan:
        new_median_shape = np.round(
            original_spacing / current_spacing * original_shape).astype(int)
        dataset_num_voxels = np.prod(new_median_shape) * num_cases

        # isotropic 512mm starting patch, clipped to the median shape
        input_patch_size = 1 / np.array(current_spacing)
        input_patch_size /= input_patch_size.mean()
        input_patch_size *= 1 / min(input_patch_size) * 512
        input_patch_size = np.round(input_patch_size).astype(int)
        input_patch_size = [min(i, j) for i, j in
                            zip(input_patch_size, new_median_shape)]

        (network_num_pool_per_axis, pool_op_kernel_sizes, conv_kernel_sizes,
         new_shp, shape_must_be_divisible_by) = get_pool_and_conv_props(
            current_spacing, input_patch_size,
            self.unet_featuremap_min_edge_length, self.unet_max_numpool)

        ref = (vram.use_this_for_batch_size_computation_3D
               * self.unet_base_num_features / vram.BASE_NUM_FEATURES_3D)
        here = vram.compute_approx_vram_consumption(
            new_shp, network_num_pool_per_axis, self.unet_base_num_features,
            self.unet_max_num_filters, num_modalities, num_classes,
            pool_op_kernel_sizes, conv_per_stage=self.conv_per_stage)
        while here > ref:
            axis_to_be_reduced = np.argsort(
                new_shp / new_median_shape)[-1]
            tmp = deepcopy(new_shp)
            tmp[axis_to_be_reduced] -= shape_must_be_divisible_by[
                axis_to_be_reduced]
            _, _, _, _, shape_must_be_divisible_by_new = \
                get_pool_and_conv_props(
                    current_spacing, tmp,
                    self.unet_featuremap_min_edge_length,
                    self.unet_max_numpool)
            new_shp[axis_to_be_reduced] -= shape_must_be_divisible_by_new[
                axis_to_be_reduced]

            (network_num_pool_per_axis, pool_op_kernel_sizes,
             conv_kernel_sizes, new_shp, shape_must_be_divisible_by) = \
                get_pool_and_conv_props(
                    current_spacing, new_shp,
                    self.unet_featuremap_min_edge_length,
                    self.unet_max_numpool)
            here = vram.compute_approx_vram_consumption(
                new_shp, network_num_pool_per_axis,
                self.unet_base_num_features, self.unet_max_num_filters,
                num_modalities, num_classes, pool_op_kernel_sizes,
                conv_per_stage=self.conv_per_stage)

        input_patch_size = new_shp
        batch_size = vram.DEFAULT_BATCH_SIZE_3D
        batch_size = int(np.floor(max(ref / here, 1) * batch_size))
        max_batch_size = np.round(
            self.batch_size_covers_max_percent_of_dataset
            * dataset_num_voxels
            / np.prod(input_patch_size, dtype=np.int64)).astype(int)
        max_batch_size = max(max_batch_size, self.unet_min_batch_size)
        batch_size = max(1, min(batch_size, max_batch_size))

        do_dummy_2D_data_aug = bool(
            (max(input_patch_size) / input_patch_size[0])
            > self.anisotropy_threshold)

        return StagePlan(
            batch_size=int(batch_size),
            num_pool_per_axis=[int(i) for i in network_num_pool_per_axis],
            patch_size=[int(i) for i in input_patch_size],
            median_patient_size_in_voxels=[int(i) for i in new_median_shape],
            current_spacing=[float(i) for i in current_spacing],
            original_spacing=[float(i) for i in original_spacing],
            do_dummy_2D_data_aug=do_dummy_2D_data_aug,
            pool_op_kernel_sizes=[list(map(int, p))
                                  for p in pool_op_kernel_sizes],
            conv_kernel_sizes=[list(map(int, c))
                               for c in conv_kernel_sizes])

    # ----------------------------------------------------------- masks
    def determine_whether_to_use_mask_for_norm(self):
        modalities = self.dataset_properties["modalities"]
        num_modalities = len(list(modalities.keys()))
        use_nonzero_mask_for_norm = OrderedDict()
        for i in range(num_modalities):
            if "CT" in modalities[i]:
                use_nonzero_mask_for_norm[i] = False
            else:
                all_size_reductions = [
                    self.dataset_properties["size_reductions"][k]
                    for k in self.dataset_properties["size_reductions"]]
                # if cropping removed >=25% of the volume, normalize within
                # the nonzero region only (brain-extracted data like BraTS)
                use_nonzero_mask_for_norm[i] = bool(
                    np.median(all_size_reductions) < 3 / 4.)
        return use_nonzero_mask_for_norm

    def determine_normalization_scheme(self):
        schemes = OrderedDict()
        modalities = self.dataset_properties["modalities"]
        for i in range(len(modalities)):
            if modalities[i] in ("CT", "ct"):
                schemes[i] = "CT"
            elif modalities[i] == "noNorm":
                schemes[i] = "noNorm"
            else:
                schemes[i] = "nonCT"
        return schemes

    # ------------------------------------------------------------ plan
    def plan_experiment(self) -> Plans:
        use_nonzero_mask_for_normalization = \
            self.determine_whether_to_use_mask_for_norm()
        spacings = self.dataset_properties["all_spacings"]
        sizes = self.dataset_properties["all_sizes"]
        all_classes = self.dataset_properties["all_classes"]
        modalities = self.dataset_properties["modalities"]
        num_modalities = len(list(modalities.keys()))

        target_spacing = self.get_target_spacing()
        new_shapes = [np.array(i) / target_spacing * np.array(j)
                      for i, j in zip(spacings, sizes)]

        max_spacing_axis = int(np.argmax(target_spacing))
        remaining_axes = [i for i in range(3) if i != max_spacing_axis]
        self.transpose_forward = [max_spacing_axis] + remaining_axes
        self.transpose_backward = [
            int(np.argwhere(np.array(self.transpose_forward) == i)[0][0])
            for i in range(3)]

        median_shape = np.median(np.vstack(new_shapes), 0)
        target_spacing_transposed = np.array(
            target_spacing)[self.transpose_forward]
        median_shape_transposed = np.array(
            median_shape)[self.transpose_forward]

        stages = [self.get_properties_for_stage(
            target_spacing_transposed, target_spacing_transposed,
            median_shape_transposed, len(self.list_of_cropped_npz_files),
            num_modalities, len(all_classes) + 1)]

        architecture_input_voxels_here = np.prod(
            stages[-1].patch_size, dtype=np.int64)
        more = (np.prod(median_shape) / architecture_input_voxels_here
                >= self.how_much_of_a_patient_must_the_network_see_at_stage0)

        if more:
            # 3d_lowres: inflate spacing until the median patient fits in 4
            # patches (experiment_planner_baseline_3DUNet.py:292-327)
            lowres_stage_spacing = deepcopy(target_spacing)
            num_voxels = np.prod(median_shape, dtype=np.float64)
            new = None
            while num_voxels > (
                    self.how_much_of_a_patient_must_the_network_see_at_stage0
                    * architecture_input_voxels_here):
                max_spacing = max(lowres_stage_spacing)
                if np.any((max_spacing / lowres_stage_spacing) > 2):
                    lowres_stage_spacing[
                        (max_spacing / lowres_stage_spacing) > 2] *= 1.01
                else:
                    lowres_stage_spacing *= 1.01
                num_voxels = np.prod(
                    target_spacing / lowres_stage_spacing * median_shape,
                    dtype=np.float64)
                lowres_stage_spacing_transposed = np.array(
                    lowres_stage_spacing)[self.transpose_forward]
                new = self.get_properties_for_stage(
                    lowres_stage_spacing_transposed,
                    target_spacing_transposed, median_shape_transposed,
                    len(self.list_of_cropped_npz_files), num_modalities,
                    len(all_classes) + 1)
                architecture_input_voxels_here = np.prod(
                    new.patch_size, dtype=np.int64)
                if len(new.pool_op_kernel_sizes) == 0:
                    # patch degenerated below any poolable size — stop
                    # (safety net the reference lacks; only reachable on
                    # unusually tiny datasets)
                    new = None
                    break
            if new is not None and 2 * np.prod(
                    new.median_patient_size_in_voxels,
                    dtype=np.int64) < np.prod(
                    stages[0].median_patient_size_in_voxels, dtype=np.int64):
                stages.append(new)

        stages = stages[::-1]
        self.plans_per_stage = {i: stages[i] for i in range(len(stages))}

        normalization_schemes = self.determine_normalization_scheme()

        self.plans = Plans(
            num_stages=len(stages),
            num_modalities=num_modalities,
            modalities={int(k): v for k, v in modalities.items()},
            normalization_schemes=normalization_schemes,
            dataset_properties=_to_jsonable(self.dataset_properties),
            list_of_npz_files=self.list_of_cropped_npz_files,
            original_spacings=_to_jsonable(spacings),
            original_sizes=_to_jsonable(sizes),
            preprocessed_data_folder=self.preprocessed_output_folder,
            num_classes=len(all_classes),
            all_classes=[int(c) for c in all_classes],
            base_num_features=self.unet_base_num_features,
            use_mask_for_norm=use_nonzero_mask_for_normalization,
            keep_only_largest_region=None,
            min_region_size_per_class=None,
            min_size_per_class=None,
            transpose_forward=self.transpose_forward,
            transpose_backward=self.transpose_backward,
            data_identifier=self.data_identifier,
            plans_per_stage=self.plans_per_stage,
            preprocessor_name=self.preprocessor_name,
            conv_per_stage=self.conv_per_stage,
            intensity_properties=_to_jsonable(
                self.dataset_properties.get("intensityproperties")),
        )
        maybe_mkdir_p(self.preprocessed_output_folder)
        self.plans.save(self.plans_fname)
        print("saved plans to", self.plans_fname)
        return self.plans

    # --------------------------------------------------------- preprocess
    def run_preprocessing(self, num_threads=default_num_threads):
        gt_out = join(self.preprocessed_output_folder, "gt_segmentations")
        if isdir(gt_out):
            shutil.rmtree(gt_out)
        shutil.copytree(join(self.folder_with_cropped_data,
                             "gt_segmentations"), gt_out)
        preprocessor_class = PREPROCESSORS.get(self.preprocessor_name)
        preprocessor = preprocessor_class(
            self.plans.normalization_schemes,
            self.plans.use_mask_for_norm,
            self.plans.transpose_forward,
            self.plans.intensity_properties)
        target_spacings = [s.current_spacing
                           for s in self.plans.plans_per_stage.values()]
        if self.plans.num_stages > 1 and not isinstance(
                num_threads, (list, tuple)):
            num_threads = (default_num_threads, num_threads)
        elif self.plans.num_stages == 1 and isinstance(
                num_threads, (list, tuple)):
            num_threads = num_threads[-1]
        preprocessor.run(target_spacings, self.folder_with_cropped_data,
                         self.preprocessed_output_folder,
                         self.plans.data_identifier, num_threads)
