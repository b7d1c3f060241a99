"""Alternative experiment planners.

Parity: reference experiment_planning/alternative_experiment_planning/
(9 files, 671 LoC): memory-budget variants (11/16/32 GB targets scale the
VRAM proxy budget), a 3-convs-per-stage variant, and custom target-spacing /
normalization planners. Each writes plans under its own identifier so
several plans can coexist per task.

The port's own copy of e2enet_tpu/planning/alternative_planners.py, unchanged but for this note:
the port imports nothing of the JAX package.
"""
import numpy as np

from ..models import vram
from ..utils.files import join
from ..utils.registry import PLANNERS
from .planner import ExperimentPlanner3D_v21


def _budget_planner(name: str, identifier: str, budget_factor: float):
    @PLANNERS.register(name)
    class _Planner(ExperimentPlanner3D_v21):
        def __init__(self, folder_with_cropped_data,
                     preprocessed_output_folder):
            super().__init__(folder_with_cropped_data,
                             preprocessed_output_folder)
            self.data_identifier = f"nnUNetData_{identifier}"
            self.plans_fname = join(preprocessed_output_folder,
                                    f"{identifier}_plans_3D.json")
            self._budget_factor = budget_factor

        def get_properties_for_stage(self, *args, **kwargs):
            original = vram.use_this_for_batch_size_computation_3D
            vram.use_this_for_batch_size_computation_3D = int(
                original * self._budget_factor)
            try:
                return super().get_properties_for_stage(*args, **kwargs)
            finally:
                vram.use_this_for_batch_size_computation_3D = original

    _Planner.__name__ = name
    return _Planner


# reference: experiment_planner_baseline_3DUNet_v21_{11,16,32}GB.py — the
# default budget targets ~8GB; these scale it to larger devices
ExperimentPlanner3D_v21_11GB = _budget_planner(
    "ExperimentPlanner3D_v21_11GB", "nnUNetPlansv2.1_11GB", 11.0 / 8.0)
ExperimentPlanner3D_v21_16GB = _budget_planner(
    "ExperimentPlanner3D_v21_16GB", "nnUNetPlansv2.1_16GB", 16.0 / 8.0)
ExperimentPlanner3D_v21_32GB = _budget_planner(
    "ExperimentPlanner3D_v21_32GB", "nnUNetPlansv2.1_32GB", 32.0 / 8.0)


@PLANNERS.register()
class ExperimentPlanner3D_v21_3convs(ExperimentPlanner3D_v21):
    """3 convs per stage (reference
    experiment_planner_baseline_3DUNet_v21_3convperstage.py)."""

    def __init__(self, folder_with_cropped_data, preprocessed_output_folder):
        super().__init__(folder_with_cropped_data,
                         preprocessed_output_folder)
        self.conv_per_stage = 3
        self.data_identifier = "nnUNetData_plans_v2.1_3convs"
        self.plans_fname = join(preprocessed_output_folder,
                                "nnUNetPlansv2.1_3convs_plans_3D.json")


@PLANNERS.register()
class ExperimentPlanner3D_v21_customTargetSpacing(ExperimentPlanner3D_v21):
    """Fixed target spacing (reference
    alternative_experiment_planning/target_spacing/*). Subclass or set
    `custom_spacing` before plan_experiment()."""
    custom_spacing = (1.0, 1.0, 1.0)

    def __init__(self, folder_with_cropped_data, preprocessed_output_folder):
        super().__init__(folder_with_cropped_data,
                         preprocessed_output_folder)
        self.data_identifier = "nnUNetData_plans_v2.1_customSpacing"
        self.plans_fname = join(preprocessed_output_folder,
                                "nnUNetPlansv2.1_customSpacing_plans_3D.json")

    def get_target_spacing(self):
        return np.array(self.custom_spacing, float)


@PLANNERS.register()
class ExperimentPlanner3D_v21_noResampling(ExperimentPlanner3D_v21):
    """Keep native spacing: median spacing == per-case spacing assumption
    (reference alternative planning 'nonCT'/no-resampling variants)."""

    def __init__(self, folder_with_cropped_data, preprocessed_output_folder):
        super().__init__(folder_with_cropped_data,
                         preprocessed_output_folder)
        self.data_identifier = "nnUNetData_plans_v2.1_noRes"
        self.plans_fname = join(preprocessed_output_folder,
                                "nnUNetPlansv2.1_noRes_plans_3D.json")
        self.preprocessor_name = "Preprocessor3DDifferentResampling"
