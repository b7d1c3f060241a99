"""The port's bench (python -m e2enet_tpu_torch.bench) on the CPU, in the
reference's smoke geometry, with its group and repetition counts lowered
to 1: exactly one JSON line on stdout with the reference bench.py's keys
and unit format. The reference runs once, in a subprocess, at its default
flags (the sparse model at density 0.2); its --dense unit is the same
string without the sparse suffix (bench.py:173, :287)."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from e2enet_tpu_torch import bench  # noqa: E402

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two torch threads while this module runs (the suite runs its files
    side by side)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def reference_line():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "bench.py"], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def run_port(monkeypatch, capsys, *argv):
    monkeypatch.setattr(bench, "GROUPS", 1)
    monkeypatch.setattr(bench, "REPS", 1)
    bench.main(["--device", "cpu", *argv])
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1, out
    return json.loads(out[0])


def test_sparse_default_matches_reference_line(monkeypatch, capsys,
                                               reference_line):
    line = run_port(monkeypatch, capsys)
    assert list(line) == list(reference_line)
    assert line["metric"] == reference_line["metric"]
    assert line["unit"] == reference_line["unit"] == \
        "32^3_patches_per_sec_per_chip_tta8_rowsparse0.2"
    assert line["value"] > 0 and line["vs_baseline"] == 0.0


def test_dense_and_data_flip(monkeypatch, capsys, reference_line):
    dense = run_port(monkeypatch, capsys, "--dense")
    assert list(dense) == list(reference_line)
    assert dense["unit"] == reference_line["unit"].replace(
        "_rowsparse0.2", "") == "32^3_patches_per_sec_per_chip_tta8"
    flip = run_port(monkeypatch, capsys, "--flip_free", "0", "--accum",
                    "bf16")
    assert flip["unit"] == reference_line["unit"] and flip["value"] > 0


def test_masks_from_checkpoint(monkeypatch, capsys, tmp_path):
    """--masks_from a .model checkpoint (the port's save_checkpoint, the
    reference's format) gives the density of its masks in the unit."""
    from e2enet_tpu_torch.models.masks import masked_params
    from e2enet_tpu_torch.models.unetpp import ShiftUNetPlusPlus
    from e2enet_tpu_torch.models.weights import to_jax_params
    from e2enet_tpu_torch.training.checkpoint import save_checkpoint
    from e2enet_tpu_torch.training.dsff import init_masks_row
    net = ShiftUNetPlusPlus(1, 16, ((2, 2, 2),) * 5, base_num_features=8,
                            device="cpu")
    masks = init_masks_row(net, 0.5, torch.Generator().manual_seed(1),
                           density_48_override=0.5)
    assert set(masks) == set(masked_params(net))
    path = str(tmp_path / "m.model")
    save_checkpoint(path, to_jax_params(net.state_dict()), 1,
                    masks={k.replace(".", "|"): v.numpy()
                           for k, v in masks.items()})
    line = run_port(monkeypatch, capsys, "--masks_from", path)
    assert line["unit"].startswith("32^3_patches_per_sec_per_chip_tta8"
                                   "_rowsparse0.")


def test_refuses_without_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main([])
