"""2D experiment planner.

Parity: reference ExperimentPlanner2D_v21 (experiment_planning/
experiment_planner_baseline_2DUNet_v21 semantics referenced by the '2d'
network option of the CLIs): in-plane patch from the median shape, 2D VRAM
budget (Generic_UNet 2D constants: DEFAULT_BATCH_SIZE_2D, BASE_NUM_FEATURES_2D
30, MAX_FILTERS_2D 480, use_this_for_batch_size_computation_2D 19739648,
generic_UNet.py:218-224), PreprocessorFor2D (no resampling along the
out-of-plane axis, preprocessing.py PreprocessorFor2D).

TPU design: 2D is embedded as D=1 volumes — patch (1, py, px), pool kernels
(1, a, b) — so the 3D sampler (a (1,py,px) patch IS a random slice with fg
oversampling), augmentation, model (depth-shift auto-disabled at D==1),
sliding window (steps over every slice) and export all apply unchanged.

The port's own copy of e2enet_tpu/planning/planner2d.py, unchanged but for this note:
the port imports nothing of the JAX package.
"""
from copy import deepcopy

import numpy as np

from ..plans import Plans, StagePlan
from ..utils.files import join
from ..utils.registry import PLANNERS, PREPROCESSORS
from .planner import ExperimentPlanner3D_v21
from .topology import get_pool_and_conv_props
from ..preprocessing.preprocessor import GenericPreprocessor

# Generic_UNet 2D constants (generic_UNet.py:218-224)
DEFAULT_BATCH_SIZE_2D = 50
BASE_NUM_FEATURES_2D = 30
MAX_FILTERS_2D = 480
use_this_for_batch_size_computation_2D = 19739648


def compute_approx_vram_consumption_2d(patch_size, num_pool_per_axis,
                                       base_num_features, max_num_features,
                                       num_modalities, num_classes,
                                       pool_op_kernel_sizes,
                                       conv_per_stage=2):
    npool = len(pool_op_kernel_sizes)
    map_size = np.array(patch_size)
    tmp = np.int64((conv_per_stage * 2 + 1) * np.prod(map_size,
                                                      dtype=np.int64)
                   * base_num_features
                   + num_modalities * np.prod(map_size, dtype=np.int64)
                   + num_classes * np.prod(map_size, dtype=np.int64))
    num_feat = base_num_features
    for p in range(npool):
        for pi in range(len(num_pool_per_axis)):
            map_size[pi] /= pool_op_kernel_sizes[p][pi]
        num_feat = min(num_feat * 2, max_num_features)
        num_blocks = (conv_per_stage * 2 + 1) if p < (npool - 1) \
            else conv_per_stage
        tmp += num_blocks * np.prod(map_size, dtype=np.int64) * num_feat
    return tmp


@PREPROCESSORS.register()
class PreprocessorFor2D(GenericPreprocessor):
    """No resampling along the out-of-plane (first, transposed) axis
    (preprocessing.py PreprocessorFor2D)."""

    def resample_and_normalize(self, data, target_spacing, properties,
                               seg=None, force_separate_z=None):
        original_spacing_transposed = np.array(
            properties["original_spacing"])[self.transpose_forward]
        target = list(target_spacing)
        target[0] = float(original_spacing_transposed[0])
        return super().resample_and_normalize(data, target, properties, seg,
                                              force_separate_z)


@PLANNERS.register()
class ExperimentPlanner2D_v21(ExperimentPlanner3D_v21):
    def __init__(self, folder_with_cropped_data, preprocessed_output_folder):
        super().__init__(folder_with_cropped_data,
                         preprocessed_output_folder)
        self.data_identifier = "nnUNetData_plans_v2.1_2D"
        self.plans_fname = join(preprocessed_output_folder,
                                "nnUNetPlansv2.1_plans_2D.json")
        self.preprocessor_name = "PreprocessorFor2D"
        self.unet_base_num_features = 32
        self.unet_max_num_filters = MAX_FILTERS_2D

    def get_properties_for_stage(self, current_spacing, original_spacing,
                                 original_shape, num_cases, num_modalities,
                                 num_classes) -> StagePlan:
        new_median_shape = np.round(
            original_spacing / current_spacing * original_shape).astype(int)
        dataset_num_voxels = np.prod(new_median_shape, dtype=np.int64) \
            * num_cases

        # in-plane patch starts at the median slice shape
        input_patch_size = new_median_shape[1:]
        (network_num_pool_per_axis, pool_op_kernel_sizes, conv_kernel_sizes,
         new_shp, shape_must_be_divisible_by) = get_pool_and_conv_props(
            current_spacing[1:], input_patch_size,
            self.unet_featuremap_min_edge_length, self.unet_max_numpool)

        ref = (use_this_for_batch_size_computation_2D
               * self.unet_base_num_features / BASE_NUM_FEATURES_2D)
        here = compute_approx_vram_consumption_2d(
            new_shp, network_num_pool_per_axis, self.unet_base_num_features,
            self.unet_max_num_filters, num_modalities, num_classes,
            pool_op_kernel_sizes, conv_per_stage=self.conv_per_stage)
        while here > ref:
            axis_to_be_reduced = np.argsort(
                new_shp / new_median_shape[1:])[-1]
            tmp = deepcopy(new_shp)
            tmp[axis_to_be_reduced] -= shape_must_be_divisible_by[
                axis_to_be_reduced]
            (_, _, _, _, shape_must_be_divisible_by_new) = \
                get_pool_and_conv_props(
                    current_spacing[1:], tmp,
                    self.unet_featuremap_min_edge_length,
                    self.unet_max_numpool)
            new_shp[axis_to_be_reduced] -= shape_must_be_divisible_by_new[
                axis_to_be_reduced]
            (network_num_pool_per_axis, pool_op_kernel_sizes,
             conv_kernel_sizes, new_shp, shape_must_be_divisible_by) = \
                get_pool_and_conv_props(
                    current_spacing[1:], new_shp,
                    self.unet_featuremap_min_edge_length,
                    self.unet_max_numpool)
            here = compute_approx_vram_consumption_2d(
                new_shp, network_num_pool_per_axis,
                self.unet_base_num_features, self.unet_max_num_filters,
                num_modalities, num_classes, pool_op_kernel_sizes,
                conv_per_stage=self.conv_per_stage)

        batch_size = int(np.floor(max(ref / here, 1)
                                  * DEFAULT_BATCH_SIZE_2D))
        max_batch_size = np.round(
            self.batch_size_covers_max_percent_of_dataset
            * dataset_num_voxels
            / np.prod(new_shp, dtype=np.int64)).astype(int)
        batch_size = max(1, min(batch_size,
                                max(max_batch_size,
                                    self.unet_min_batch_size)))

        # embed as D=1 3D
        return StagePlan(
            batch_size=int(batch_size),
            num_pool_per_axis=[0] + [int(i) for i in
                                     network_num_pool_per_axis],
            patch_size=[1] + [int(i) for i in new_shp],
            median_patient_size_in_voxels=[int(i) for i in new_median_shape],
            current_spacing=[float(i) for i in current_spacing],
            original_spacing=[float(i) for i in original_spacing],
            do_dummy_2D_data_aug=False,
            pool_op_kernel_sizes=[[1] + list(map(int, p))
                                  for p in pool_op_kernel_sizes],
            conv_kernel_sizes=[[1] + list(map(int, c))
                               for c in conv_kernel_sizes])

    def plan_experiment(self) -> Plans:
        # identical to the 3D planner but always exactly one stage (no
        # lowres cascade in 2D)
        saved = self.how_much_of_a_patient_must_the_network_see_at_stage0
        self.how_much_of_a_patient_must_the_network_see_at_stage0 = 10 ** 12
        try:
            plans = super().plan_experiment()
        finally:
            self.how_much_of_a_patient_must_the_network_see_at_stage0 = saved
        return plans
