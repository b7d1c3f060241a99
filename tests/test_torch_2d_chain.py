"""The users' 2D chain on the port, the counterpart of
tests/test_end_to_end.py::test_2d_pipeline: in a process where jax,
jaxlib, flax and e2enet_tpu cannot be imported, a seeded raw task
(chip_smoke.write_raw_task: six 20 x 24 x 22 cases at 1 mm, one CT
modality, 3 classes) goes through the port's plan CLI with `-pl3d None
-pl2d ExperimentPlanner2D_v21`, cli.train --network 2d (width 8, one epoch
of 2 batches, --fp32, --device cpu), cli.predict -m 2d on two held-out
cases and cli.evaluate. Checks the 2D plan (patch depth 1, (1, a, b)
pools), the fold under 2d/, the predictions and a Dice per label. Then
both packages predict with the trained fold: float32 through
predict_from_folder, the network-resolution probabilities held by
tests/test_torch_predict.py's check_probs rule (within 1e-4, the same
argmax where the reference's top two differ by more); both CLIs in
bfloat16 by its check_bf16_probs rule against the reference's float32
run."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import chip_smoke  # noqa: E402
import e2enet_tpu.inference.predictor as jpred  # noqa: E402
import e2enet_tpu_torch.inference.predictor as tpred  # noqa: E402
from e2enet_tpu.cli import predict as jcli  # noqa: E402
from e2enet_tpu_torch.cli import predict as tcli  # noqa: E402
from e2enet_tpu_torch.io.nifti import (NiftiImage, read_nifti,  # noqa: E402
                                      write_nifti)
from test_torch_predict import record, top_two_gap  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
F32_TOL = 1e-4
CASES = {f"case_{i:03d}": (20, 24, 22) for i in range(6)}


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


CHAIN_TASK = "Task775_Tiny2DChain"
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
plan_and_preprocess.main(["-t", "775", "-pl3d", "None",
                          "-pl2d", "ExperimentPlanner2D_v21",
                          "-tf", "1", "-tl", "1"])
tr = train.main(["--task", "775", "--network", "2d", "--fold", "0",
                 "--Tconv", "shiftConvPP", "--epochs", "1", "--batches", "2",
                 "--val_batches", "1", "--base_features", "8", "--fp32",
                 "--device", "cpu"])
assert not tr.network.do_shift and not tr.batch_dice
out = os.path.join(base, "predictions")
predict.main(["-i", os.path.join(held, "images"), "-o", out, "-t", "775",
              "-m", "2d", "-f", "0", "--Tconv", "shiftConvPP",
              "--disable_postprocessing", "--mode", "fast", "--device", "cpu"])
evaluate.main(["-ref", os.path.join(held, "labels"), "-pred", out,
               "-l", "1", "2"])
bad = [k for k in sys.modules if k.split(".")[0] in
       ("jax", "jaxlib", "flax", "e2enet_tpu") and sys.modules[k] is not None]
assert not bad, bad
print("CHAIN OK")
"""


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("chain2d"))
    raw = os.path.join(base, "raw")
    chip_smoke.write_raw_task(raw, CHAIN_TASK, CASES, 3)
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


def test_2d_chain_plans_trains_predicts(chain):
    base, _ = chain
    pre = Path(base) / "preprocessed" / CHAIN_TASK
    plans = json.loads((pre / "nnUNetPlansv2.1_plans_2D.json").read_text())
    stage = plans["plans_per_stage"]["0"]
    assert stage["patch_size"][0] == 1
    assert all(p[0] == 1 for p in stage["pool_op_kernel_sizes"])
    fold = (Path(base) / "results" / "nnUNet" / "2d" / CHAIN_TASK
            / "TPUTrainer__nnUNetPlansv2.1" / "fold_0")
    assert (fold / "shiftConvPP_model_final_checkpoint.model").exists()
    assert (fold / "validation_raw" / "summary.json").exists()
    out = Path(base) / "predictions"
    for name, shape in HELD_OUT.items():
        pred = read_nifti(str(out / f"{name}.nii.gz"))
        assert pred.array.shape == shape
        assert set(np.unique(pred.array)) <= {0, 1, 2}
    mean = json.loads((out / "summary.json").read_text())["results"]["mean"]
    for label in ("1", "2"):
        assert 0.0 <= mean[label]["Dice"] <= 1.0


def test_2d_chain_predictions_match_jax_cli(chain, monkeypatch):
    """Both packages on the fold the chain trained, -m 2d, TTA on: float32
    through predict_from_folder, the network-resolution probabilities held
    by tests/test_torch_predict.py's check_probs (within 1e-4, the same
    argmax where the reference's top two differ by more); then both CLIs
    (bfloat16, fast mode) by its check_bf16_probs against the reference's
    float32 run (the port's error at most 1.25x the reference's)."""
    base, held = chain
    monkeypatch.setenv("RESULTS_FOLDER", os.path.join(base, "results"))
    folder = os.path.join(base, "results", "nnUNet", "2d", CHAIN_TASK,
                          "TPUTrainer__nnUNetPlansv2.1")
    images = os.path.join(held, "images")
    exact, port32 = record(monkeypatch, jpred), record(monkeypatch, tpred)
    jpred.predict_from_folder(folder, images, os.path.join(base, "j32"),
                              [0], False, compute_dtype=jnp.float32)
    tpred.predict_from_folder(folder, images, os.path.join(base, "t32"),
                              [0], False, compute_dtype=torch.float32,
                              device="cpu")
    assert len(port32) == len(exact) == len(HELD_OUT)
    for a, b in zip(port32, exact):
        assert a.shape == b.shape and a.shape[0] == 3
        np.testing.assert_allclose(a, b, rtol=0, atol=F32_TOL)
        assert (a.argmax(0) == b.argmax(0))[top_two_gap(b) > F32_TOL].all()
    ref_p, port_p = record(monkeypatch, jpred), record(monkeypatch, tpred)
    args = ["-i", images, "-t", CHAIN_TASK, "-m", "2d", "-f", "0",
            "--disable_postprocessing", "--mode", "fast"]
    jcli.main(args + ["-o", os.path.join(base, "jpred")])
    tcli.main(args + ["-o", os.path.join(base, "tpred"), "--device", "cpu"])
    assert len(port_p) == len(ref_p) == len(HELD_OUT)
    for a, b, e in zip(port_p, ref_p, exact):
        err_a, err_b = np.abs(a - e), np.abs(b - e)
        assert err_a.max() <= 1.25 * err_b.max()
        assert err_a.mean() <= 1.25 * err_b.mean()
        gap = top_two_gap(e)
        assert (a.argmax(0) == e.argmax(0))[gap > 2 * err_a.max()].all()
    for name, shape in HELD_OUT.items():
        for out in ("jpred", "tpred"):
            seg = read_nifti(os.path.join(base, out, f"{name}.nii.gz")).array
            assert seg.shape == shape
