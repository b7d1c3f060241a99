"""The port's -tr presets (e2enet_tpu_torch/training/variants.py and the
train CLI's mapping, cli/train.variant_kwargs) against the JAX package's
(e2enet_tpu/training/variants.py, e2enet_tpu/cli/train.py):

- the table equal, and for every preset the trainer arguments each CLI
  builds from it equal (both CLIs run with the trainer replaced by a stub
  that records its arguments);
- each of the 95 presets (losses, optimizers, learning rates and their
  schedules, momentum and its reduction, epochs, precision, batch dice,
  dummy_load, the cascade, augmentation levels, the deep-supervision
  mode, per-epoch validation, export options, regions, and the
  architecture switches and Tconvs of Queue 1 item 6: norms,
  nonlinearities, nonlin_before_norm, seg_bias, 3 convs per stage,
  allConv3x3, resenc) runs through the port's CLI on the CPU on a
  tiny task (chip_smoke.write_train_task, labels 0-3 for the region
  presets, width 8, one batch and one validation batch an epoch, at most
  two epochs: the warmup and cycle presets' 1050 and 1100 and the cascade
  presets' 500 are cut; every case has a <case>_segFromPrevStage.npz for
  the cascade presets), each trainer holding the preset's options, its
  augmentation parameters those the JAX package's apply_da_level makes
  of the trainer's own, a finite loss, an optimizer state of the preset's
  optimizer, its network built with the preset's Tconv and switches
  (recorded in the checkpoint sidecar's init) and a final checkpoint; the
  fold's validation is left to tests/test_torch_train_cli.py and, for the
  region trainers, to tests/test_torch_regions_chain.py; no preset is
  refused;
- apply_da_level equal to the JAX package's on every field for every
  level, and seeded batches at da3, da5, insane and cascade_eg equal to
  the JAX pipeline's;
- the noDeepSupervision step (make_train_step with do_ds=False, one loss
  weight and one target) within 1e-4 of the JAX package's loss over two
  steps, on the same float32 weights; a probs head refused;
- the resample33 export (orders 3 in-plane and across z) equal to the
  JAX package's export of the same softmax, byte for byte.
"""
import copy
import dataclasses
import gzip
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
from e2enet_tpu.cli import train as jcli  # noqa: E402
from e2enet_tpu.data import augment as jaug  # noqa: E402
from e2enet_tpu.training.variants import VARIANTS as JVARIANTS  # noqa
from e2enet_tpu.training.variants import apply_da_level as japply  # noqa
from e2enet_tpu_torch.cli import train as tcli  # noqa: E402
from e2enet_tpu_torch.data import augment as taug  # noqa: E402
from e2enet_tpu_torch.training import trainer as ttrainer  # noqa: E402
from e2enet_tpu_torch.training.trainer import Trainer  # noqa: E402
from e2enet_tpu_torch.training.variants import VARIANTS  # noqa: E402
from e2enet_tpu_torch.training.variants import apply_da_level  # noqa: E402
from e2enet_tpu_torch.utils.files import load_pickle  # noqa: E402

TASK = "Task776_Variants"
CASES = {f"case_{i:03d}": (20, 24, 22) for i in range(6)}
# the preset keys the port trains
ARCH = ("norm_op", "nonlin", "num_conv_per_stage", "seg_bias",
        "nonlin_before_norm", "conv_kernel")
PORTED = {"loss", "optimizer", "initial_lr", "lr_schedule",
          "momentum_schedule", "momentum", "max_num_epochs", "fp16",
          "batch_dice", "dummy_load", "loss_kwargs", "loss_schedule",
          "cascade", "da", "ds_mode", "validate_every", "export_kwargs",
          "regions", "tconv", "base_num_features", *ARCH}
# labels 0-3: the BraTS regions' labels
NUM_CLASSES = 4
LEVELS = sorted({v["da"] for v in VARIANTS.values() if "da" in v})
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
    assert len(RUNS) == 95 and len(REFUSED) == 0


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
                                        [[2, 2, 2]] * 2, NUM_CLASSES)
    # the previous stage's segmentation of every case, for the cascade
    # presets (a stage's own labels: any labels of its shape will do)
    rng = np.random.RandomState(3)
    for case, shape in CASES.items():
        np.savez_compressed(os.path.join(
            paths["task"], "nnUNetData_plans_v2.1_stage0",
            f"{case}_segFromPrevStage.npz"),
            data=rng.randint(0, NUM_CLASSES, shape).astype(np.uint8))
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
    levels = []

    def level(params, lvl):
        levels.append((copy.deepcopy(params), lvl))
        return apply_da_level(params, lvl)
    monkeypatch.setattr(ttrainer, "apply_da_level", level)

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
    first = (tr.network.initial_conv if preset.get("tconv") == "resenc"
             else tr.network.context0.block0.kernel)
    assert first.shape[1] == (NUM_CLASSES if tr.cascade else 1)
    assert type(tr.network).__name__ == {
        "resenc": "ResidualUNet"}.get(preset.get("tconv"),
                                      "ShiftUNetPlusPlus")
    arch = {k: preset[k] for k in ARCH if k in preset}
    assert {k: tr.arch[k] for k in arch} == arch
    assert tr.base_num_features == preset.get("base_num_features", 8)
    init = load_pickle(tr.checkpoint_path("final_checkpoint")
                       + ".pkl")["init"]
    assert {k: init[k] for k in arch} == arch
    assert tr.da_level == preset.get("da")
    assert tr.ds_mode == preset.get("ds_mode", "standard")
    assert tr.validate_every == preset.get("validate_every")
    assert tr.export_kwargs == preset.get("export_kwargs")
    regions = preset.get("regions")
    assert (tr.regions is None if regions is None
            else list(tr.regions) == ["whole tumor", "tumor core",
                                      "enhancing tumor"])
    assert tr.network.seg_head0.kernel.shape[0] == (3 if regions
                                                    else NUM_CLASSES)
    assert tr.da_params.regions == (None if regions is None
                                    else ((1, 2, 3), (2, 3), (3,)))
    if tr.ds_mode == "none":
        assert tr.ds_weights == [1.0] and tr.ds_scales is None
    # the trainer's level is the JAX package's apply_da_level on the
    # trainer's own parameters
    assert [lvl for _, lvl in levels] == ([preset["da"]] if "da" in preset
                                          else [])
    for before, lvl in levels:
        want = japply(jaug.AugmentParams(**dataclasses.asdict(before)), lvl)
        assert dataclasses.asdict(tr.da_params) == dataclasses.asdict(want)
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
    """All nine cascade presets train (refused by da_level before the
    levels were ported); the five with an augmentation level set the
    cascade augmentation's knobs of their cascade_* level."""
    cascade = sorted(k for k, v in VARIANTS.items() if v.get("cascade"))
    assert len(cascade) == 9 and set(cascade) <= set(RUNS)
    assert sorted(set(cascade) - set(CASCADE_DA)) == [
        "nnUNetTrainerV2CascadeFullRes_lowerLR",
        "nnUNetTrainerV2CascadeFullRes_shorter",
        "nnUNetTrainerV2CascadeFullRes_shorter_lowerLR",
        "nnUNetTrainerV2_CascadeFullRes"]
    knobs = set()
    for name in CASCADE_DA:
        lvl = tcli.variant_kwargs(name)["da_level"]
        assert lvl.startswith("cascade_")
        p = apply_da_level(taug.AugmentParams(), lvl)
        assert p.cascade_do_cascade_augmentations
        knobs.add((p.cascade_random_binary_transform_p,
                   p.cascade_random_binary_transform_p_per_label,
                   tuple(p.cascade_random_binary_transform_size),
                   p.cascade_remove_conn_comp_p,
                   p.cascade_remove_conn_comp_max_size_percent_threshold))
    assert len(knobs) == 5


def test_no_message_names_item_4e():
    """No refusal of the port names item 4e, now ported."""
    root = os.path.dirname(ttrainer.__file__)
    root = os.path.dirname(root)
    for folder, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(folder, f)) as fh:
                    assert "item 4e" not in fh.read(), f


@pytest.mark.parametrize("level", LEVELS)
def test_da_level_equals_the_reference(level):
    """Every field of the parameters apply_da_level makes, from the
    defaults and from a cascade trainer's, equal to the JAX package's."""
    for kw in ({}, dict(patch_size=(16, 16, 16),
                        move_last_seg_channel_to_data=True,
                        all_segmentation_labels=[1, 2, 3],
                        cascade_do_cascade_augmentations=True)):
        got = apply_da_level(taug.AugmentParams(**kw), level)
        want = japply(jaug.AugmentParams(**kw), level)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("level", ["da3", "da5", "insane", "cascade_eg"])
def test_da_level_batches_equal(level):
    """Seeded training batches at the level (the enlarged patch, every
    transform on, the cascade's one-hot channels for cascade_eg) equal to
    the JAX pipeline's, to the bit."""
    rng = np.random.RandomState(11)
    patch = (16, 16, 16)
    big = taug.get_patch_size(patch, (-0.5236, 0.5236), (-0.5236, 0.5236),
                              (-0.5236, 0.5236), (0.7, 1.4))
    cascade = level.startswith("cascade_")
    seg = rng.randint(0, NUM_CLASSES, (2, 1 + cascade, *big))
    kw = dict(patch_size=patch,
              deep_supervision_scales=[[1.0] * 3, [0.5] * 3])
    if cascade:
        kw.update(move_last_seg_channel_to_data=True,
                  all_segmentation_labels=[1, 2, 3],
                  cascade_do_cascade_augmentations=True)
    for seed in range(3):
        batch = {"data": rng.randn(2, 1, *big).astype(np.float32),
                 "seg": seg.astype(np.float32)}
        got = taug.augment_batch(
            dict(batch), apply_da_level(taug.AugmentParams(**kw), level),
            np.random.RandomState(seed))
        want = jaug.augment_batch(
            dict(batch), japply(jaug.AugmentParams(**kw), level),
            np.random.RandomState(seed))
        assert set(got) == set(want)
        np.testing.assert_array_equal(got["data"], want["data"])
        for a, b in zip(got["target"], want["target"]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_no_deep_supervision_step_matches_the_reference():
    """make_train_step(do_ds=False) with one loss weight and the
    full-resolution target: both steps' losses within 1e-4 of the JAX
    package's make_train_step(do_ds=False) on the same float32 weights and
    batch; a probs head (head_probs_dtype) is refused, not taken as
    logits."""
    import jax.numpy as jnp
    from e2enet_tpu.models.unetpp import ShiftUNetPlusPlus as JaxNet
    from e2enet_tpu.training import train_state as jts
    from e2enet_tpu_torch.models.unetpp import (
        kernel_launches_per_train_step)
    from e2enet_tpu_torch.training import train_state as tts
    from test_torch_train_step import KW, SHAPE, _batch, _params, \
        _port_model
    params = _params(KW, SHAPE, 0)
    x, targets = _batch(1, SHAPE, 1, 3)
    jnet = JaxNet(**KW, compute_dtype=jnp.float32, remat=False,
                  quadrant=False)
    jstate = jts.create_train_state(params)
    jstep = jts.make_train_step(jnet, [1.0], donate=False, do_ds=False)
    net = _port_model(KW, params, torch.float32)
    state = tts.create_train_state(net)
    step = tts.make_train_step(net, [1.0], do_ds=False)
    for lr in (0.01, 0.009):
        jstate, jm = jstep(jstate, jnp.asarray(x),
                           (jnp.asarray(targets[0]),), jnp.float32(lr))
        state, m = step(state, torch.from_numpy(x),
                        (torch.from_numpy(targets[0]),), lr)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-4)
    per = kernel_launches_per_train_step(net, do_ds=False)
    assert per["forward"]["seghead"] == 1
    assert kernel_launches_per_train_step(net)["forward"]["seghead"] == 2
    net.head_probs_dtype = torch.bfloat16
    with pytest.raises(TypeError, match="float32 logits"):
        step(state, torch.from_numpy(x), (torch.from_numpy(targets[0]),),
             0.01)


def test_resample33_export_equals_the_reference(tmp_path):
    """nnUNetTrainerV2_resample33's export options (order 3 in-plane and
    across z, separate z from the spacing) on a softmax that resamples
    along an anisotropic axis: the port's NIfTI equal to the JAX
    package's, byte for byte once unzipped."""
    from e2enet_tpu.inference.export import \
        save_segmentation_nifti_from_softmax as jsave
    from e2enet_tpu_torch.inference.export import \
        save_segmentation_nifti_from_softmax as tsave
    ek = VARIANTS["nnUNetTrainerV2_resample33"]["export_kwargs"]
    rng = np.random.RandomState(4)
    logits = rng.randn(NUM_CLASSES, 6, 24, 22).astype(np.float32)
    softmax = np.exp(logits) / np.exp(logits).sum(0)
    props = {"size_after_cropping": (18, 24, 22),
             "original_size_of_raw_data": (20, 26, 22),
             "original_spacing": np.array([5.0, 1.0, 1.0]),
             "spacing_after_resampling": np.array([15.0, 1.0, 1.0]),
             "crop_bbox": [[1, 19], [1, 25], [0, 22]],
             "itk_spacing": (1.0, 1.0, 5.0), "itk_origin": (2.0, -3.0, 4.5),
             "itk_direction": (1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0)}
    out = {}
    for tag, save in (("port", tsave), ("jax", jsave)):
        f = str(tmp_path / f"{tag}.nii.gz")
        save(softmax, f, copy.deepcopy(props), ek["interpolation_order"],
             None, None, None, None, None,
             force_separate_z=ek["force_separate_z"],
             interpolation_order_z=ek["interpolation_order_z"])
        with gzip.open(f, "rb") as fh:
            out[tag] = fh.read()
    assert out["port"] == out["jax"]
    base = str(tmp_path / "order1.nii.gz")
    tsave(softmax, base, copy.deepcopy(props), 1)
    with gzip.open(base, "rb") as fh:
        assert fh.read() != out["port"]
