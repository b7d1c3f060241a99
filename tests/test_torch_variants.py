"""The port's -tr presets (e2enet_tpu_torch/training/variants.py and the
train CLI's mapping, cli/train.variant_kwargs) against the JAX package's
(e2enet_tpu/training/variants.py, e2enet_tpu/cli/train.py):

- the table equal, and for every preset the trainer arguments each CLI
  builds from it equal (both CLIs run with the trainer replaced by a stub
  that records its arguments);
- each of the 53 presets that set only knobs the port trains (losses,
  optimizers, learning rates and their schedules, momentum and its
  reduction, epochs, precision, batch dice, dummy_load, the cascade)
  runs through the port's CLI on the CPU on a tiny task
  (chip_smoke.write_train_task, width 8, one batch and one validation
  batch an epoch, at most two epochs: the warmup and cycle presets' 1050
  and 1100 and the cascade presets' 500 are cut; every case has a
  <case>_segFromPrevStage.npz for the cascade presets), each trainer
  holding the preset's options, a finite loss, an optimizer state of the
  preset's optimizer and a final checkpoint; the fold's validation, which
  no preset changes, is left to tests/test_torch_train_cli.py;
- each of the other 42 raises NotImplementedError naming ROADMAP item 4e
  or item 6 (the five cascade presets with an augmentation level by
  da_level, item 4e).
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
from e2enet_tpu.cli import train as jcli  # noqa: E402
from e2enet_tpu.training.variants import VARIANTS as JVARIANTS  # noqa
from e2enet_tpu_torch.cli import train as tcli  # noqa: E402
from e2enet_tpu_torch.training.trainer import Trainer  # noqa: E402
from e2enet_tpu_torch.training.variants import VARIANTS  # noqa: E402

TASK = "Task776_Variants"
CASES = {f"case_{i:03d}": (20, 24, 22) for i in range(6)}
# the preset keys the port trains
PORTED = {"loss", "optimizer", "initial_lr", "lr_schedule",
          "momentum_schedule", "momentum", "max_num_epochs", "fp16",
          "batch_dice", "dummy_load", "loss_kwargs", "loss_schedule",
          "cascade"}
RUNS = sorted(k for k, v in VARIANTS.items() if set(v) <= PORTED)
REFUSED = sorted(k for k in VARIANTS if k not in RUNS)
MAX_EPOCHS = 2


class _Captured(Exception):
    pass


def _capture(module, monkeypatch, name, argv):
    """The keyword arguments module.main(argv) gives its trainer class
    `name`, with the task's configuration stubbed."""
    got = {}

    def trainer(plans, fold, output_folder, **kw):
        got.update(kw)
        raise _Captured
    monkeypatch.setattr(module, name, trainer)
    monkeypatch.setattr(module, "get_default_configuration",
                        lambda *a, **k: (None, "out", "pre", 0, True))
    with pytest.raises(_Captured):
        module.main(argv)
    return got


def test_table_equals_the_reference():
    assert VARIANTS == JVARIANTS
    assert len(RUNS) == 53 and len(REFUSED) == 42


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_preset_maps_to_the_reference_s_trainer_arguments(name,
                                                          monkeypatch):
    argv = ["--task", "Task001_X", "-tr", name]
    want = _capture(jcli, monkeypatch, "TPUTrainer", argv)
    got = _capture(tcli, monkeypatch, "Trainer", argv + ["--device", "cpu"])
    assert got.pop("device") == torch.device("cpu")
    # the JAX CLI also passes its XLA switches
    for k in ("fused", "remat"):
        assert want.pop(k) is None
    assert got == want


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    base = str(tmp_path_factory.mktemp("variants"))
    paths = chip_smoke.write_train_task(base, TASK, CASES, (16, 16, 16),
                                        [[2, 2, 2]] * 2, 3)
    # the previous stage's segmentation of every case, for the cascade
    # presets (a stage's own labels: any labels of its shape will do)
    rng = np.random.RandomState(3)
    for case, shape in CASES.items():
        np.savez_compressed(os.path.join(
            paths["task"], "nnUNetData_plans_v2.1_stage0",
            f"{case}_segFromPrevStage.npz"),
            data=rng.randint(0, 3, shape).astype(np.uint8))
    yield paths
    torch.set_num_threads(n)


@pytest.fixture
def environ(env, monkeypatch):
    monkeypatch.setenv("nnUNet_preprocessed", env["preprocessed"])
    monkeypatch.setenv("RESULTS_FOLDER", env["results"])
    return env


def _args(name, fold):
    return ["--task", TASK, "--fold", str(fold), "--epochs", "1",
            "--batches", "1", "--val_batches", "1", "--base_features", "8",
            "--fp32", "--device", "cpu", "-tr", name]


@pytest.mark.parametrize("name", RUNS)
def test_ported_preset_trains(name, environ, monkeypatch):
    real_init = Trainer.initialize

    def init(self, training=True):
        real_init(self, training)
        self.max_num_epochs = min(self.max_num_epochs, MAX_EPOCHS)
    monkeypatch.setattr(Trainer, "initialize", init)
    monkeypatch.setattr(Trainer, "validate", lambda self, *a, **k: None)
    tr = tcli.main(_args(name, RUNS.index(name) % 5))
    preset = VARIANTS[name]
    assert tr.optimizer == preset.get("optimizer", "sgd")
    assert tr.loss_name == preset.get("loss", "dc_ce")
    assert tr.lr_schedule == preset.get("lr_schedule", "poly")
    assert tr.momentum == preset.get("momentum", 0.99)
    assert tr.loss_kwargs == preset.get("loss_kwargs")
    assert tr.fp16 == preset.get("fp16", False)
    assert tr.initial_lr == preset.get("initial_lr", 1e-2)
    assert tr.batch_dice == preset.get("batch_dice", True)
    assert tr.cascade == preset.get("cascade", False)
    assert tr.network.context0.block0.kernel.shape[1] == (
        3 if tr.cascade else 1)
    kind = {"sgd": dict, "ranger": "RangerState", "adam": "AdamState"}[
        tr.optimizer]
    assert (type(tr.state.momentum) is dict if kind is dict
            else type(tr.state.momentum).__name__ == kind)
    assert tr.epoch == min(preset.get("max_num_epochs", 1), MAX_EPOCHS)
    assert all(np.isfinite(tr.all_tr_losses + tr.all_val_losses))
    assert os.path.isfile(tr.checkpoint_path("final_checkpoint"))


CASCADE_DA = ["nnUNetTrainerV2CascadeFullRes_noConnComp",
              "nnUNetTrainerV2CascadeFullRes_smallerBinStrel",
              "nnUNetTrainerV2CascadeFullRes_EducatedGuess",
              "nnUNetTrainerV2CascadeFullRes_EducatedGuess2",
              "nnUNetTrainerV2CascadeFullRes_EducatedGuess3"]


def test_cascade_presets_split():
    """Of the nine cascade presets, the four without an augmentation level
    train; the five with one are refused by da_level."""
    cascade = sorted(k for k, v in VARIANTS.items() if v.get("cascade"))
    assert len(cascade) == 9
    assert sorted(set(cascade) - set(CASCADE_DA)) == [
        n for n in RUNS if n in cascade] == [
        "nnUNetTrainerV2CascadeFullRes_lowerLR",
        "nnUNetTrainerV2CascadeFullRes_shorter",
        "nnUNetTrainerV2CascadeFullRes_shorter_lowerLR",
        "nnUNetTrainerV2_CascadeFullRes"]
    for name in CASCADE_DA:
        with pytest.raises(NotImplementedError, match="^da_level="):
            Trainer(None, 0, "unused", device="cpu",
                    **{k: v for k, v in tcli.variant_kwargs(name).items()
                       if k != "tconv"})


@pytest.mark.parametrize("name", REFUSED)
def test_unported_preset_names_its_item(name, environ):
    with pytest.raises(NotImplementedError, match="item (4e|6)"):
        tcli.main(_args(name, 0))
