"""Filesystem layout of raw / cropped / preprocessed data and trained models.

Parity: reference e2enet/paths.py:19-62, but restored to environment-variable
indirection (the reference fork hard-coded paths; the env version was
commented out at paths.py:29-31).

Environment variables (same contract as nnU-Net V1):
  nnUNet_raw_data_base   -> <base>/nnUNet_raw_data, <base>/nnUNet_cropped_data
  nnUNet_preprocessed    -> preprocessed output dir
  RESULTS_FOLDER         -> trained models dir

The port's own copy of e2enet_tpu/paths.py, unchanged but for this note:
the port imports nothing of the JAX package.
"""
import os

default_plans_identifier = "nnUNetPlansv2.1"
default_data_identifier = "nnUNetData_plans_v2.1"
default_trainer = "TPUTrainer"


def _env(name):
    v = os.environ.get(name)
    return os.path.abspath(v) if v else None


def get_raw_data_base():
    return _env("nnUNet_raw_data_base")


def get_raw_data_dir():
    base = get_raw_data_base()
    return os.path.join(base, "nnUNet_raw_data") if base else None


def get_cropped_data_dir():
    base = get_raw_data_base()
    return os.path.join(base, "nnUNet_cropped_data") if base else None


def get_preprocessing_output_dir():
    return _env("nnUNet_preprocessed")


def get_results_dir():
    base = _env("RESULTS_FOLDER")
    return os.path.join(base, "nnUNet") if base else None


def require(path, what):
    if path is None:
        raise RuntimeError(
            f"{what} is not configured. Set nnUNet_raw_data_base / "
            f"nnUNet_preprocessed / RESULTS_FOLDER environment variables.")
    return path
