"""The port's model packaging (inference/pretrained_models.py) against the
JAX package's: the registry and its listing, the download that raises
without a network call, and a fold that the port's train CLI trained at
a tiny width (chip_smoke.write_train_task's task: six 20 x 24 x 22 cases,
3 classes, 16^3 patches, width 8, kernel DSFF, one epoch and the fold's
validation), consolidated by the port's consolidate_folds, packed by
both packages' export_pretrained_model into zips of the same member
names and bytes. Each package's zip installs with the
other's install_model_from_zip_file, the installed files equal to the
trained ones, and the installed fold predicts a case through the port's
predict CLI on the CPU as the trained one does."""
import os
import shutil
import socket
import zipfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
import e2enet_tpu.inference.pretrained_models as jpre  # noqa: E402
import e2enet_tpu_torch.inference.pretrained_models as tpre  # noqa: E402
from e2enet_tpu_torch.cli import predict as tpredict  # noqa: E402
from e2enet_tpu_torch.cli import train as ttrain  # noqa: E402
from e2enet_tpu_torch.io.nifti import read_nifti  # noqa: E402
from e2enet_tpu_torch.postprocessing.consolidate import (  # noqa: E402
    consolidate_folds)

TASK = "Task779_TinyPack"
CASES = {f"case_{i:03d}": (20, 24, 22) for i in range(6)}
MODEL = os.path.join("3d_fullres", TASK, "TPUTrainer__nnUNetPlansv2.1")
ARGS = ["--task", TASK, "--fold", "0", "--Tconv", "shiftConvPP",
        "--batches", "2", "--val_batches", "1", "--base_features", "8",
        "--fp32", "--sparse", "true", "--density", "0.3",
        "--update_frequency", "2", "--epochs", "1", "--device", "cpu"]
PACKAGES = {"jax": jpre, "port": tpre}


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The fold the port's train CLI writes, consolidated (the model
    folder's postprocessing.json), with the plans beside it as
    plans.json."""
    base = str(tmp_path_factory.mktemp("pretrained"))
    paths = chip_smoke.write_train_task(base, TASK, CASES, (16, 16, 16),
                                        [[2, 2, 2]] * 2, 3)
    old = {k: os.environ.get(k) for k in ("nnUNet_preprocessed",
                                          "RESULTS_FOLDER")}
    os.environ["nnUNet_preprocessed"] = paths["preprocessed"]
    os.environ["RESULTS_FOLDER"] = paths["results"]
    try:
        ttrain.main(ARGS)
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    model = os.path.join(paths["results"], "nnUNet", MODEL)
    consolidate_folds(model, os.path.join(paths["task"], "gt_segmentations"),
                      folds=(0,))
    shutil.copy(os.path.join(paths["task"], "nnUNetPlansv2.1_plans_3D.json"),
                os.path.join(model, "plans.json"))
    return paths


def read_bytes(path):
    with open(path, "rb") as f:
        return f.read()


def export(pkg, results, out, monkeypatch):
    monkeypatch.setenv("RESULTS_FOLDER", results)
    got = PACKAGES[pkg].export_pretrained_model(TASK, out, folds=(0, 1))
    assert got == out
    with zipfile.ZipFile(out) as zf:
        return {m: zf.read(m) for m in zf.namelist()}


def test_registry_matches(capsys):
    assert tpre.PRETRAINED_MODEL_REGISTRY == jpre.PRETRAINED_MODEL_REGISTRY
    assert len(tpre.PRETRAINED_MODEL_REGISTRY) == 26
    listed = []
    for mod in (jpre, tpre):
        mod.print_available_pretrained_models()
        listed.append(capsys.readouterr().out)
    assert listed[0] == listed[1] and "Task004_Hippocampus ->" in listed[1]


@pytest.mark.parametrize("task,error", [("Task999_Unknown", KeyError),
                                        ("Task004_Hippocampus", RuntimeError)])
def test_download_raises_without_a_network_call(monkeypatch, task, error):
    def no_network(*a, **k):
        raise AssertionError("a network call")
    monkeypatch.setattr(socket, "socket", no_network)
    monkeypatch.setattr(socket, "create_connection", no_network)
    for mod in PACKAGES.values():
        with pytest.raises(error):
            mod.download_and_install_pretrained_model_by_name(task)


def test_export_zips_match(trained, monkeypatch, tmp_path):
    """Both packages pack the same members with the same bytes: the plans
    and the model folder's postprocessing.json, the fold's checkpoint and
    sidecar, debug.json and progress.png where matplotlib wrote it; fold
    1, absent, is skipped. The fold's own postprocessing.json (its
    validation's) is not packed: the installed model takes the model
    folder's, which consolidate_folds writes."""
    zips = {pkg: export(pkg, trained["results"], str(tmp_path / f"{pkg}.zip"),
                        monkeypatch) for pkg in PACKAGES}
    assert list(zips["jax"]) == list(zips["port"])
    assert zips["jax"] == zips["port"]
    fold = os.path.join(MODEL, "fold_0")
    for m in (os.path.join(MODEL, "plans.json"),
              os.path.join(MODEL, "postprocessing.json"),
              os.path.join(fold, "shiftConvPP_model_final_checkpoint.model"),
              os.path.join(fold,
                           "shiftConvPP_model_final_checkpoint.model.pkl"),
              os.path.join(fold, "debug.json")):
        assert m in zips["port"], m
    assert os.path.join(fold, "postprocessing.json") not in zips["port"]
    for m, data in zips["port"].items():
        assert data == read_bytes(os.path.join(trained["results"], "nnUNet",
                                               m)), m


@pytest.mark.parametrize("packer,installer", [("port", "jax"),
                                              ("jax", "port")])
def test_zip_installs_across_packages(trained, monkeypatch, tmp_path, packer,
                                      installer):
    members = export(packer, trained["results"], str(tmp_path / "m.zip"),
                     monkeypatch)
    installed = str(tmp_path / "installed")
    monkeypatch.setenv("RESULTS_FOLDER", installed)
    PACKAGES[installer].install_model_from_zip_file(str(tmp_path / "m.zip"))
    for m, data in members.items():
        assert read_bytes(os.path.join(installed, "nnUNet", m)) == data, m


def test_installed_fold_predicts_as_trained(trained, monkeypatch, tmp_path):
    """The port's predict CLI on one case with the installed fold gives
    the labels it gives with the trained fold."""
    export("port", trained["results"], str(tmp_path / "m.zip"), monkeypatch)
    installed = str(tmp_path / "installed")
    monkeypatch.setenv("RESULTS_FOLDER", installed)
    tpre.install_model_from_zip_file(str(tmp_path / "m.zip"))
    inp = tmp_path / "in"
    inp.mkdir()
    os.symlink(os.path.join(trained["raw"], "case_000_0000.nii.gz"),
               inp / "case_000_0000.nii.gz")
    seg = {}
    for name, results in (("installed", installed),
                          ("trained", trained["results"])):
        monkeypatch.setenv("RESULTS_FOLDER", results)
        out = tmp_path / name
        tpredict.main(["-i", str(inp), "-o", str(out), "-t", TASK, "-f",
                       "0", "--device", "cpu"])
        seg[name] = read_nifti(str(out / "case_000.nii.gz")).array
    assert seg["installed"].shape == CASES["case_000"]
    assert int(seg["installed"].max()) < 3
    np.testing.assert_array_equal(seg["installed"], seg["trained"])
