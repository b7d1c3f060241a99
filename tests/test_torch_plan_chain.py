"""The port's users' chain from raw data on the CPU, the port's counterpart
of tests/test_end_to_end.py: in a process where jax, jaxlib, flax and
e2enet_tpu cannot be imported, a seeded raw task (chip_smoke.write_raw_task:
six 20 x 24 x 22 cases at 1 mm, one CT modality, 3 classes) goes through
the port's plan CLI (spawned workers), cli.train --device cpu (width 8,
one short epoch, kernel-granular DSFF), cli.predict --device cpu on two
held-out cases and cli.evaluate against their labels. Checks the plan,
the trained fold's files, the predictions' geometry and labels, and a
Dice per label in summary.json."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import chip_smoke
from e2enet_tpu_torch.io.nifti import NiftiImage, read_nifti, write_nifti

REPO = Path(__file__).resolve().parents[1]
TASK = "Task779_TinyChain"
CASES = {f"case_{i:03d}": (20, 24, 22) for i in range(6)}
HELD_OUT = {"held_000": (22, 24, 20), "held_001": (20, 26, 22)}
SPACING = (1.0, 1.0, 1.0)

CHAIN = """
import os, sys
for m in ("jax", "jaxlib", "flax", "e2enet_tpu"):
    sys.modules[m] = None
import torch
torch.set_num_threads(2)
from e2enet_tpu_torch.cli import evaluate, plan_and_preprocess, predict, train
base, held = sys.argv[1], sys.argv[2]
plan_and_preprocess.main(["-t", "779", "--verify_dataset_integrity",
                          "-tf", "2", "-tl", "2"])
train.main(["--task", "Task779_TinyChain", "--fold", "0", "--epochs", "1",
            "--batches", "2", "--val_batches", "1", "--base_features", "8",
            "--fp32", "--sparse", "true", "--density", "0.3",
            "--update_frequency", "2", "--device", "cpu"])
out = os.path.join(base, "predictions")
predict.main(["-i", os.path.join(held, "images"), "-o", out, "-t", "779",
              "-f", "0", "--device", "cpu"])
evaluate.main(["-ref", os.path.join(held, "labels"), "-pred", out,
               "-l", "1", "2"])
bad = [k for k in sys.modules if k.split(".")[0] in
       ("jax", "jaxlib", "flax", "e2enet_tpu") and sys.modules[k] is not None]
assert not bad, bad
print("CHAIN OK")
"""


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("chain"))
    raw = os.path.join(base, "raw")
    chip_smoke.write_raw_task(raw, TASK, CASES, 3)
    held = os.path.join(base, "held_out")
    rng = np.random.RandomState(7)
    for sub in ("images", "labels"):
        os.makedirs(os.path.join(held, sub))
    for name, shape in HELD_OUT.items():
        vol, seg = chip_smoke.synthetic_case(rng, shape, 3)
        write_nifti(os.path.join(held, "images", f"{name}_0000.nii.gz"),
                    NiftiImage(vol, SPACING))
        write_nifti(os.path.join(held, "labels", f"{name}.nii.gz"),
                    NiftiImage(seg, SPACING))
    env = {**os.environ, "PYTHONPATH": str(REPO),
           "nnUNet_raw_data_base": raw,
           "nnUNet_preprocessed": os.path.join(base, "preprocessed"),
           "RESULTS_FOLDER": os.path.join(base, "results")}
    r = subprocess.run([sys.executable, "-c", CHAIN, base, held], cwd=REPO,
                       env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0 and "CHAIN OK" in r.stdout, \
        r.stdout[-3000:] + r.stderr[-5000:]
    return base, held


def test_chain_plans_and_trains(chain):
    base, _ = chain
    pre = Path(base) / "preprocessed" / TASK
    plans = json.loads((pre / "nnUNetPlansv2.1_plans_3D.json").read_text())
    assert plans["num_stages"] == 1 and plans["num_classes"] == 2
    assert plans["normalization_schemes"] == {"0": "CT"}
    stage = pre / "nnUNetData_plans_v2.1_stage0"
    assert sorted(p.name for p in stage.glob("*.npz")) == \
        [f"{c}.npz" for c in CASES]
    fold = (Path(base) / "results" / "nnUNet" / "3d_fullres" / TASK
            / "TPUTrainer__nnUNetPlansv2.1" / "fold_0")
    for name in ("shiftConvPP_model_final_checkpoint.model",
                 "postprocessing.json"):
        assert (fold / name).exists(), name
    assert (fold / "validation_raw" / "summary.json").exists()


def test_chain_predicts_and_evaluates(chain):
    base, held = chain
    out = Path(base) / "predictions"
    for name, shape in HELD_OUT.items():
        pred = read_nifti(str(out / f"{name}.nii.gz"))
        assert pred.array.shape == shape
        assert pred.spacing == pytest.approx(SPACING)
        assert set(np.unique(pred.array)) <= {0, 1, 2}
    summary = json.loads((out / "summary.json").read_text())
    mean = summary["results"]["mean"]
    for label in ("1", "2"):
        dice = mean[label]["Dice"]
        assert np.isfinite(dice) and 0.0 <= dice <= 1.0, (label, dice)
