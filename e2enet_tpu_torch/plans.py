"""The plans artifact — the single configuration contract of the pipeline.

Parity: the reference's `plans.pkl`
(e2enet/experiment_planning/experiment_planner_baseline_3DUNet.py:341-357,
consumed by nnUNetTrainer_simple.py:1029-1103 and inference/predict.py:705).
We serialize it as typed JSON ("plans.json") instead of a pickle, with the
same field inventory, and read either format.

The port's own copy of e2enet_tpu/plans.py, unchanged but for this note:
the port imports nothing of the JAX package.
"""
import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np

from .utils.files import load_json, load_pickle, save_json


@dataclass
class StagePlan:
    """Per-resolution-stage configuration (one of 3d_fullres / 3d_lowres)."""
    batch_size: int
    num_pool_per_axis: List[int]
    patch_size: List[int]
    median_patient_size_in_voxels: List[int]
    current_spacing: List[float]
    original_spacing: List[float]
    do_dummy_2D_data_aug: bool
    pool_op_kernel_sizes: List[List[int]]
    conv_kernel_sizes: List[List[int]]


@dataclass
class Plans:
    num_stages: int
    num_modalities: int
    modalities: Dict[int, str]
    normalization_schemes: Dict[int, str]
    dataset_properties: Dict[str, Any]
    list_of_npz_files: List[str]
    original_spacings: List[List[float]]
    original_sizes: List[List[int]]
    preprocessed_data_folder: Optional[str]
    num_classes: int                      # number of foreground classes
    all_classes: List[int]
    base_num_features: int
    use_mask_for_norm: Dict[int, bool]
    keep_only_largest_region: Any
    min_region_size_per_class: Any
    min_size_per_class: Any
    transpose_forward: List[int]
    transpose_backward: List[int]
    data_identifier: str
    plans_per_stage: Dict[int, StagePlan]
    preprocessor_name: str = "GenericPreprocessor"
    conv_per_stage: int = 2
    intensity_properties: Optional[Dict[int, Dict[str, float]]] = field(default=None)

    # ------------------------------------------------------------------ io
    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["plans_per_stage"] = {
            int(k): dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v
            for k, v in self.plans_per_stage.items()}
        return d

    def save(self, path: str):
        save_json(_to_jsonable(self.to_dict()), path)

    @classmethod
    def from_dict(cls, d: dict) -> "Plans":
        d = dict(d)
        pps = {}
        for k, v in d.get("plans_per_stage", {}).items():
            v = {kk: vv for kk, vv in v.items() if kk in
                 {f.name for f in dataclasses.fields(StagePlan)}}
            pps[int(k)] = StagePlan(**v)
        d["plans_per_stage"] = pps
        for key in ("modalities", "normalization_schemes", "use_mask_for_norm"):
            if key in d and isinstance(d[key], dict):
                d[key] = {int(kk): vv for kk, vv in d[key].items()}
        ip = d.get("intensity_properties")
        if isinstance(ip, dict):
            d["intensity_properties"] = {int(kk): vv for kk, vv in ip.items()}
        known = {f.name for f in dataclasses.fields(cls)}
        d = {k: v for k, v in d.items() if k in known}
        return cls(**d)

    @classmethod
    def load(cls, path: str) -> "Plans":
        if str(path).endswith(".json"):
            return cls.from_dict(load_json(path))
        # reference-format pickle (plans.pkl): translate field names
        raw = load_pickle(path)
        return cls.from_reference_pickle(raw)

    @classmethod
    def from_reference_pickle(cls, raw: dict) -> "Plans":
        """Ingest a reference nnU-Net V1 plans.pkl dict (for checkpoints
        trained with the reference; field names from
        experiment_planner_baseline_3DUNet.py:341-357)."""
        pps = {}
        for k, v in raw["plans_per_stage"].items():
            pps[int(k)] = StagePlan(
                batch_size=int(v["batch_size"]),
                num_pool_per_axis=list(map(int, v["num_pool_per_axis"])),
                patch_size=list(map(int, v["patch_size"])),
                median_patient_size_in_voxels=list(
                    map(int, v["median_patient_size_in_voxels"])),
                current_spacing=list(map(float, v["current_spacing"])),
                original_spacing=list(map(float, v["original_spacing"])),
                do_dummy_2D_data_aug=bool(v["do_dummy_2D_data_aug"]),
                pool_op_kernel_sizes=[list(map(int, p))
                                      for p in v["pool_op_kernel_sizes"]],
                conv_kernel_sizes=[list(map(int, c))
                                   for c in v["conv_kernel_sizes"]],
            )
        return cls(
            num_stages=len(pps),
            num_modalities=int(raw["num_modalities"]),
            modalities={int(k): v for k, v in raw["modalities"].items()},
            normalization_schemes={int(k): v for k, v in
                                   raw["normalization_schemes"].items()},
            dataset_properties=_to_jsonable(raw.get("dataset_properties", {})),
            list_of_npz_files=[],
            original_spacings=[list(map(float, s)) for s in
                               raw.get("original_spacings", [])],
            original_sizes=[list(map(int, s)) for s in
                            raw.get("original_sizes", [])],
            preprocessed_data_folder=raw.get("preprocessed_data_folder"),
            num_classes=int(raw["num_classes"]),
            all_classes=list(map(int, raw["all_classes"])),
            base_num_features=int(raw["base_num_features"]),
            use_mask_for_norm={int(k): bool(v) for k, v in
                               raw["use_mask_for_norm"].items()},
            keep_only_largest_region=raw.get("keep_only_largest_region"),
            min_region_size_per_class=raw.get("min_region_size_per_class"),
            min_size_per_class=raw.get("min_size_per_class"),
            transpose_forward=list(map(int, raw["transpose_forward"])),
            transpose_backward=list(map(int, raw["transpose_backward"])),
            data_identifier=raw["data_identifier"],
            plans_per_stage=pps,
            preprocessor_name=raw.get("preprocessor_name",
                                      "GenericPreprocessor"),
            conv_per_stage=int(raw.get("conv_per_stage", 2)),
            intensity_properties=_to_jsonable(
                raw.get("dataset_properties", {}).get(
                    "intensityproperties", None)),
        )


def _to_jsonable(x):
    if isinstance(x, dict):
        return {_key(k): _to_jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple, set)):
        return [_to_jsonable(v) for v in x]
    if isinstance(x, np.ndarray):
        return _to_jsonable(x.tolist())
    if isinstance(x, np.integer):
        return int(x)
    if isinstance(x, np.floating):
        return float(x)
    if isinstance(x, np.bool_):
        return bool(x)
    return x


def _key(k):
    if isinstance(k, (np.integer, np.floating)):
        return _to_jsonable(k)
    return k
