"""The port's train CLI (e2enet_tpu_torch/cli/train.py) end to end on the
CPU, on a tiny preprocessed task (chip_smoke.write_train_task: six 20 x 24
x 22 cases, 3 classes, 16^3 patches, batch 2) in a temporary results
folder: training with kernel-granular DSFF (width 8, --fp32), the fold's
validation and postprocessing, the files tests/test_end_to_end.py asks of
the JAX CLI, a continued run (-c) from 'latest', and the port's predict
CLI reading the trained fold (the JAX package's ModelBundle reads it too).
Also the variants' options: Ranger and Adam presets (-tr) with DSFF grown
by gradient train a fold, their optimizer state kept in the checkpoint.
The element DSFF settings (ERK, the global prune, GMP, the lottery
ticket at element granularity) train a fold, their masks and fired masks
written in the flax layout. The cascade's two networks train on a
two-stage plan, and raise the JAX CLI's message on a one-stage one. And
--device_augment trains a fold, and is refused with the presets the JAX
trainer cannot train so. And the refusals: no card without --device cpu,
and every option the port does not train, each naming its ROADMAP item;
and that no module of the port imports jax or e2enet_tpu (a
subprocess in which both are blocked imports every module of the package
and chip_smoke.py)."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
from e2enet_tpu_torch.cli import predict as tpredict  # noqa: E402
from e2enet_tpu_torch.cli import train as ttrain  # noqa: E402
from e2enet_tpu_torch.io.nifti import read_nifti  # noqa: E402
from e2enet_tpu_torch.models.unetpp import ARCH_DEFAULTS  # noqa: E402
from e2enet_tpu_torch.models.weights import from_jax_params  # noqa: E402
from e2enet_tpu_torch.training import checkpoint as tckpt  # noqa: E402
from e2enet_tpu_torch.training.trainer import Trainer  # noqa: E402
from e2enet_tpu_torch.utils.files import load_pickle  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
TASK = "Task778_TinyCli"
CASES = {f"case_{i:03d}": (20, 24, 22) for i in range(6)}
ARGS = ["--task", TASK, "--fold", "0", "--Tconv", "shiftConvPP",
        "--batches", "2", "--val_batches", "1", "--base_features", "8",
        "--fp32", "--sparse", "true", "--density", "0.3",
        "--update_frequency", "2"]


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("train_cli"))
    paths = chip_smoke.write_train_task(base, TASK, CASES, (16, 16, 16),
                                        [[2, 2, 2]] * 2, 3)
    return paths


@pytest.fixture
def environ(env, monkeypatch):
    monkeypatch.setenv("nnUNet_preprocessed", env["preprocessed"])
    monkeypatch.setenv("RESULTS_FOLDER", env["results"])
    return env


def _fold(env):
    return Path(env["results"]) / "nnUNet" / "3d_fullres" / TASK / \
        "TPUTrainer__nnUNetPlansv2.1" / "fold_0"


@pytest.fixture(scope="module")
def trained(env):
    """Two epochs, then -c to a third, through cli.train.main."""
    old = {k: os.environ.get(k) for k in ("nnUNet_preprocessed",
                                          "RESULTS_FOLDER")}
    os.environ["nnUNet_preprocessed"] = env["preprocessed"]
    os.environ["RESULTS_FOLDER"] = env["results"]
    real_init = Trainer.initialize

    def every_epoch(self, training=True):
        real_init(self, training)
        self.save_every = 1   # 'latest' after each epoch, for -c
    Trainer.initialize = every_epoch
    try:
        first = ttrain.main(ARGS + ["--epochs", "2", "--device", "cpu"])
        latest = tckpt.load_checkpoint(first.checkpoint_path("latest"))
        loaded = []
        real = Trainer.load_checkpoint_file

        def spy(self, which, train=True):
            real(self, which, train)
            loaded.append((which, self.epoch, int(self.state.step),
                           {n: p.detach().clone()
                            for n, p in self.state.params.items()},
                           {n: m.clone()
                            for n, m in self.state.momentum.items()},
                           {n: m.clone()
                            for n, m in self.state.masks.items()}))
        Trainer.load_checkpoint_file = spy
        try:
            second = ttrain.main(ARGS + ["--epochs", "3", "-c",
                                         "--device", "cpu"])
        finally:
            Trainer.load_checkpoint_file = real
    finally:
        Trainer.initialize = real_init
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return first, latest, loaded, second


def test_train_writes_the_fold(trained, env):
    """The files test_end_to_end.py asks of the JAX CLI, a finite Dice
    for every foreground label, progress.png where matplotlib imports."""
    first, _, _, second = trained
    fold = _fold(env)
    for name in ("shiftConvPP_model_final_checkpoint.model",
                 "shiftConvPP_model_final_checkpoint.model.pkl",
                 "shiftConvPP_model_latest.model",
                 "shiftConvPP_model_best.model", "postprocessing.json",
                 "debug.json"):
        assert (fold / name).is_file(), name
    summary = json.load(open(fold / "validation_raw" / "summary.json"))
    for label in ("1", "2"):
        assert np.isfinite(summary["results"]["mean"][label]["Dice"])
    assert len(summary["results"]["all"]) == 2
    try:
        import matplotlib  # noqa: F401
        assert (fold / "progress.png").is_file()
    except ImportError:
        pass
    assert any(f.startswith("training_log_") for f in os.listdir(fold))
    assert first.epoch == 2 and int(first.state.step) == 4
    assert all(np.isfinite(first.all_tr_losses + second.all_tr_losses))
    assert len(first.validation_timings) == 2


def test_continue_from_latest(trained):
    """-c loads 'latest' (epoch 2, step 4) with the parameters, momentum
    and masks equal to the bit, and the epoch counter goes on from 2."""
    first, latest, loaded, second = trained
    assert len(loaded) == 1
    which, epoch, step, params, momentum, masks = loaded[0]
    assert which == "latest" and epoch == 2 and step == 4
    state, ep, meta = latest
    assert ep == 2 and state["step"] == 4
    from e2enet_tpu_torch.models.weights import from_jax_params
    for what, got, want in (("params", params, from_jax_params(
            state["params"])), ("momentum", momentum,
                               from_jax_params(state["momentum"]))):
        for n, t in got.items():
            assert torch.equal(t, want[n]), f"{what} {n}"
    for n, m in masks.items():
        np.testing.assert_array_equal(m.numpy(),
                                      state["masks"][n.replace(".", "|")])
    assert second.epoch == 3 and int(second.state.step) == 6
    assert second.all_tr_losses[:2] == first.all_tr_losses
    assert len(second.all_tr_losses) == 3


def test_predict_cli_reads_the_trained_fold(trained, environ, tmp_path):
    """The port's predict CLI on one validation case with the trained
    fold (the continued run's); the JAX package's ModelBundle restores
    the same weights."""
    _, _, _, second = trained
    inp = tmp_path / "in"
    inp.mkdir()
    case = list(second.dataset_val)[0]
    os.symlink(os.path.join(environ["raw"], f"{case}_0000.nii.gz"),
               inp / f"{case}_0000.nii.gz")
    out = tmp_path / "out"
    tpredict.main(["-i", str(inp), "-o", str(out), "-t", TASK, "-f", "0",
                   "--device", "cpu"])
    seg = read_nifti(str(out / f"{case}.nii.gz")).array
    assert seg.shape == CASES[case]
    assert int(seg.min()) >= 0 and int(seg.max()) < 3
    from e2enet_tpu.inference.predictor import ModelBundle
    from e2enet_tpu_torch.models.weights import to_jax_params
    bundle = ModelBundle(str(_fold(environ).parent), [0], "shiftConvPP")
    want = to_jax_params(second.state.params)

    def leaves(tree, prefix=()):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from leaves(v, prefix + (k,))
            else:
                yield prefix + (k,), v
    got = dict(leaves(bundle.fold_params[0]))
    for path, v in leaves(want):
        np.testing.assert_array_equal(np.asarray(got[path]), v)


def test_refuses_without_a_card(environ, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.main(ARGS + ["--epochs", "1"])


@pytest.mark.parametrize("extra, item", [
    (["--num_devices", "2", "--device", "cuda"], "only .* present"),
    (["--num_devices", "2", "--spatial_parallel", "3"],
     "spatial_parallel=3 does not divide num_devices=2")])
def test_unported_options_raise(environ, extra, item):
    """--spatial_parallel that does not divide --num_devices raises naming
    both, before any rank starts (it trains: test_torch_spatial.py);
    --num_devices asks for no more cards than there are (it trains:
    test_num_devices_trains)."""
    if "--device" in extra and torch.cuda.device_count() >= 2:
        pytest.skip("two cards present: --num_devices 2 trains there")
    exc = RuntimeError if "--device" in extra else ValueError
    with pytest.raises(exc, match=item):
        ttrain.main(ARGS + ["--epochs", "1", "--device", "cpu"] + extra)


def test_num_devices_takes_one_da_thread(environ):
    """--num_devices 2 with --da_threads 2 is refused before any rank
    starts: only one augmentation thread gives every rank the same
    batches."""
    with pytest.raises(SystemExit):
        ttrain.main(ARGS + ["--epochs", "1", "--device", "cpu",
                            "--num_devices", "2", "--da_threads", "2"])


def test_num_devices_trains(environ, monkeypatch):
    """--num_devices 2 --device cpu spawns two gloo ranks that train one
    short epoch of a fold; rank 0 alone writes its checkpoints, its log
    and its validation, and the final checkpoint loads back."""
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    assert ttrain.main(ARGS + ["--epochs", "1", "--fold", "1", "--device",
                               "cpu", "--num_devices", "2"]) is None
    fold = _fold(environ).parent / "fold_1"
    logs = [f for f in os.listdir(fold) if f.startswith("training_log_")]
    assert len(logs) == 1
    log = open(fold / logs[0]).read()
    assert "data parallel over 2 ranks (gloo)" in log
    assert (fold / "validation_raw" / "summary.json").is_file()
    tr = Trainer(ttrain.Plans.load(str(Path(environ["preprocessed"]) / TASK
                                       / "nnUNetPlansv2.1_plans_3D.json")),
                 1, str(fold.parent),
                 dataset_directory=str(Path(environ["preprocessed"]) / TASK),
                 device="cpu", base_num_features=8, fp16=False,
                 dsff_config=ttrain.DSFFConfig(sparse=True, density=0.3))
    tr.load_checkpoint_file("final_checkpoint", train=False)
    assert tr.epoch == 1 and int(tr.state.step) == 2
    assert np.all(np.isfinite(tr.all_tr_losses + tr.all_val_losses))


def test_device_augment_trains(environ, monkeypatch):
    """--device_augment, refused before it was ported, trains a fold (kernel
    DSFF, one epoch of 2 batches, validation included) with its training
    batches augmented by ops/device_augment.py from a raw pipeline; the
    validation pipeline augments on the host."""
    calls = []
    real = Trainer._augment_on_device

    def spy(self, batch):
        out = real(self, batch)
        calls.append((tuple(batch["data"].shape), out))
        return out
    monkeypatch.setattr(Trainer, "_augment_on_device", spy)
    tr = ttrain.main(ARGS + ["--epochs", "1", "--fold", "4", "--device",
                             "cpu", "--device_augment"])
    assert tr.device_augment and tr.tr_gen.raw and not tr.val_gen.raw
    assert len(calls) == 2
    big = tuple(int(i) for i in tr.basic_generator_patch_size)
    for shape, (data, targets) in calls:
        assert shape == (2, 1) + big
        assert data.shape == (2, 16, 16, 16, 1)
        assert [tuple(t.shape) for t in targets] == [(2, 16, 16, 16),
                                                     (2, 8, 8, 8)]
    assert all(np.isfinite(tr.all_tr_losses + tr.all_val_losses))
    assert os.path.isfile(os.path.join(tr.output_folder, "validation_raw",
                                       "summary.json"))


@pytest.mark.parametrize("extra, mode", [
    (["-tr", "nnUNetTrainerV2BraTSRegions"], "regions"),
    (["-tr", "nnUNetTrainerV2_noDeepSupervision"], "ds_mode none"),
    (["-tr", "nnUNetTrainerV2_dummyLoad"], "dummy_load")])
def test_device_augment_refused_modes(environ, extra, mode):
    """--device_augment with a preset the JAX trainer cannot train so
    raises at initialize, naming the mode (the cascade:
    tests/test_torch_device_augment_modes.py)."""
    with pytest.raises(ValueError, match=f"device_augment with {mode}"):
        ttrain.main(ARGS + ["--epochs", "1", "--device", "cpu",
                            "--device_augment"] + extra)


@pytest.mark.parametrize("extra, tconv", [
    (["-tr", "nnUNetTrainerV2_ResencUNet_DA3"], "resenc"),
    (["-tr", "nnUNetTrainerV2BraTSRegions_BN"], "shiftConvPP"),
    (["-tr", "nnUNetTrainerV2_MMS"], "shiftConvPP"),
    (["-tr", "nnUNetTrainerV2_BN"], "shiftConvPP"),
    (["--Tconv", "ori"], "ori"), (["--Tconv", "shiftConvPP_nodff"],
                                  "shiftConvPP_nodff"),
    (["--Tconv", "shiftConvPP_313"], "shiftConvPP_313"),
    (["--Tconv", "shiftConvPP_331"], "shiftConvPP_331")])
def test_architecture_presets_and_tconvs_train(environ, monkeypatch, extra,
                                               tconv):
    """The presets once refused for Queue 1 item 6, and every Tconv, train
    a fold through the CLI (one epoch; the fold's validation is the
    default network's, above), their checkpoint named by the Tconv, its
    sidecar holding the preset's switches; the port's predict CLI serves
    the fold with the network of its sidecar (TTA on: flip-free, or data
    flips for resenc)."""
    monkeypatch.setattr(Trainer, "validate", lambda self, *a, **k: None)
    tr = ttrain.main(["--task", TASK, "--fold", "4", "--epochs", "1",
                      "--batches", "1", "--val_batches", "1",
                      "--base_features", "8", "--fp32", "--device", "cpu"]
                     + extra)
    assert tr.tconv == tconv and tr.epoch == 1
    assert all(np.isfinite(tr.all_tr_losses))
    ckpt = Path(tr.checkpoint_path("final_checkpoint"))
    assert ckpt.name == f"{tconv}_model_final_checkpoint.model"
    init = load_pickle(str(ckpt) + ".pkl")["init"]
    assert init["tconv"] == tconv
    for k, v in tr.arch.items():     # a default switch is not written
        assert init.get(k, ARCH_DEFAULTS[k]) == v
    if "BraTS" in " ".join(extra):
        return          # a region fold: predicted by its own chain test
    model_folder = ckpt.parent.parent
    calls = []
    import e2enet_tpu_torch.inference.predictor as tpred
    real = tpred.predict_volume_tiled

    def spy(*a, **k):
        calls.append(k.get("mirror_apply_fns") is not None)
        return real(*a, **k)
    monkeypatch.setattr(tpred, "predict_volume_tiled", spy)
    from e2enet_tpu_torch.inference.predictor import ModelBundle
    bundle = ModelBundle(str(model_folder), [4], tconv, device="cpu",
                         compute_dtype=torch.float32)
    net = bundle.fold_models[0]
    for n, p in tr.network.state_dict().items():
        torch.testing.assert_close(net.state_dict()[n], p.cpu(), rtol=0,
                                   atol=0)
    data = np.random.RandomState(0).standard_normal(
        (1, 16, 16, 16)).astype(np.float32)
    probs = tpred.predict_case(bundle, data, do_tta=True, step_size=1.0)
    assert probs.shape == (3, 16, 16, 16) and np.all(np.isfinite(probs))
    assert calls == [tconv != "resenc"]


@pytest.mark.parametrize("network, message", [
    ("3d_lowres", "3d_lowres only applies to multi-stage plans"),
    ("3d_cascade_fullres", "3d_cascade_fullres requires multi-stage plans")])
def test_cascade_networks_need_two_stages(environ, network, message):
    """On the task's one-stage plan both cascade networks raise the JAX
    CLI's message."""
    with pytest.raises(RuntimeError, match=message):
        ttrain.main(ARGS + ["--epochs", "1", "--device", "cpu", "--network",
                            network])


def test_cascade_networks_train(tmp_path, monkeypatch):
    """--network 3d_lowres and 3d_cascade_fullres, refused before they
    were ported, train on a two-stage plan (both stages the task's 16^3
    plan on its data): the lowres run (--fold all) writes a uint8
    <case>_segFromPrevStage.npz of the last stage's shape for every case
    into the last stage's folder, and the cascade run (kernel DSFF) trains
    a model with one-hot input channels for the two foreground labels,
    validates and records cascade in its checkpoint's sidecar."""
    import shutil
    from e2enet_tpu_torch.plans import Plans
    from e2enet_tpu_torch.utils.files import load_pickle
    task = "Task770_TinyCascadeCli"
    paths = chip_smoke.write_train_task(str(tmp_path), task, CASES,
                                        (16, 16, 16), [[2, 2, 2]] * 2, 3)
    pre = paths["task"]
    plans_file = os.path.join(pre, "nnUNetPlansv2.1_plans_3D.json")
    plans = Plans.load(plans_file)
    plans.plans_per_stage = {0: plans.plans_per_stage[0],
                             1: plans.plans_per_stage[0]}
    plans.num_stages = 2
    plans.save(plans_file)
    stage1 = os.path.join(pre, "nnUNetData_plans_v2.1_stage1")
    shutil.copytree(os.path.join(pre, "nnUNetData_plans_v2.1_stage0"),
                    stage1)
    monkeypatch.setenv("nnUNet_preprocessed", paths["preprocessed"])
    monkeypatch.setenv("RESULTS_FOLDER", paths["results"])
    args = ["--task", task, "--fold", "all", "--epochs", "1", "--batches",
            "2", "--val_batches", "1", "--base_features", "8", "--fp32",
            "--device", "cpu"]
    low = ttrain.main(args + ["--network", "3d_lowres"])
    assert low.stage == 0 and not low.cascade
    for case, shape in CASES.items():
        seg = np.load(os.path.join(stage1, f"{case}_segFromPrevStage.npz"))[
            "data"]
        assert seg.dtype == np.uint8 and seg.shape == shape
        assert int(seg.max()) < 3
    tr = ttrain.main(args + ["--network", "3d_cascade_fullres", "--sparse",
                             "true", "--density", "0.3"])
    assert tr.stage == 1 and tr.cascade
    assert tr.network.context0.block0.kernel.shape[1] == 3
    assert all(np.isfinite(tr.all_tr_losses + tr.all_val_losses))
    fold = (Path(paths["results"]) / "nnUNet" / "3d_cascade_fullres" / task
            / "TPUTrainer__nnUNetPlansv2.1" / "fold_all")
    assert (fold / "validation_raw" / "summary.json").exists()
    sidecar = load_pickle(str(fold / "shiftConvPP_model_final_checkpoint"
                                     ".model.pkl"))
    assert sidecar["init"]["cascade"] is True and sidecar["init"][
        "stage"] == 1


def test_network_2d_trains(environ, tmp_path):
    """--network 2d, refused before it was ported, trains one epoch of 2
    batches (width 8, --fp32, kernel DSFF) on the task's 2D plan (the
    stage data of its 3D plan at patch (1, 16, 16) with two (1, 2, 2)
    pools) without the shift or batch dice, and writes the fold under
    2d/; the predict CLI's -m 2d serves the fold with its masks."""
    from e2enet_tpu_torch.plans import Plans
    pre = os.path.join(environ["preprocessed"], TASK)
    plans = Plans.load(os.path.join(pre, "nnUNetPlansv2.1_plans_3D.json"))
    st = plans.plans_per_stage[0]
    st.patch_size, st.pool_op_kernel_sizes = [1, 16, 16], [[1, 2, 2]] * 2
    plans.save(os.path.join(pre, "nnUNetPlansv2.1_plans_2D.json"))
    tr = ttrain.main(ARGS + ["--epochs", "1", "--network", "2d", "--fold",
                             "2", "--device", "cpu"])
    assert not tr.network.do_shift and not tr.batch_dice
    assert [int(i) for i in tr.patch_size] == [1, 16, 16]
    assert all(np.isfinite(tr.all_tr_losses + tr.all_val_losses))
    fold = (Path(environ["results"]) / "nnUNet" / "2d" / TASK
            / "TPUTrainer__nnUNetPlansv2.1" / "fold_2")
    assert (fold / "shiftConvPP_model_final_checkpoint.model").exists()
    assert (fold / "validation_raw" / "summary.json").exists()
    assert tr.state.masks is not None
    inp = tmp_path / "in"
    inp.mkdir()
    case = list(tr.dataset_val)[0]
    os.symlink(os.path.join(environ["raw"], f"{case}_0000.nii.gz"),
               inp / f"{case}_0000.nii.gz")
    out = tmp_path / "out"
    tpredict.main(["-i", str(inp), "-o", str(out), "-t", TASK, "-m", "2d",
                   "-f", "2", "--device", "cpu"])
    seg = read_nifti(str(out / f"{case}.nii.gz")).array
    assert seg.shape == CASES[case]
    assert int(seg.min()) >= 0 and int(seg.max()) < 3


@pytest.mark.parametrize("extra", [
    ["--sparse_init", "ERK"],
    ["--prune_mode", "global", "--sparse_init", "uniform_ori",
     "--final_density", "0.2", "--final-prune-epoch", "1"],
    ["--sparse_init", "GMP", "--init-prune-epoch", "0",
     "--final-prune-epoch", "1"],
    ["--granularity", "element", "--sparse_init", "lottery_ticket",
     "--growth", "gradient"]])
def test_element_dsff_options_train(environ, extra, monkeypatch):
    """The DSFF settings of the element engine, refused before they were
    ported, train a fold for one epoch (validation included); the
    'latest' checkpoint holds element masks and fired masks in the flax
    layout, which load back equal to the bit."""
    real_init = Trainer.initialize

    def every_epoch(self, training=True):
        real_init(self, training)
        self.save_every = 1
    monkeypatch.setattr(Trainer, "initialize", every_epoch)
    tr = ttrain.main(ARGS + ["--epochs", "1", "--fold", "3", "--device",
                             "cpu"] + extra)
    assert tr.mask_granularity == "element"
    assert all(np.isfinite(tr.all_tr_losses + tr.all_val_losses))
    state, _, meta = tckpt.load_checkpoint(tr.checkpoint_path("latest"))
    params = dict(tr.network.named_parameters())
    for what, saved, sep, live in (
            ("masks", state["masks"], "|", tr.state.masks),
            ("fired", meta["fired_masks"], "/", tr.fired_masks)):
        assert set(saved) == {n.replace(".", sep) for n in live}, what
        for n, m in live.items():
            flax = saved[n.replace(".", sep)]
            assert flax.ndim == params[n].dim() and m.shape == params[n].shape
            np.testing.assert_array_equal(
                flax, np.transpose(m.numpy(), {4: (2, 3, 1, 0),
                                               5: (2, 3, 4, 0, 1)}[m.dim()]))
    log = open(tr.logger.log_file).read()
    if "GMP" in extra:
        assert "GMP prune at epoch 0" in log
    else:
        assert "DSFF update at step 2" in log
        assert ("regrow_ratio=" in log) == ("global" in extra)
    tr2 = ttrain.Trainer(tr.plans, 3, tr.output_folder_base,
                         dataset_directory=tr.dataset_directory,
                         device="cpu", base_num_features=8, fp16=False,
                         dsff_config=tr.dsff_config)
    tr2.load_checkpoint_file("latest", train=False)
    for n, m in tr.state.masks.items():
        assert torch.equal(tr2.state.masks[n], m), n
        assert torch.equal(tr2.fired_masks[n], tr.fired_masks[n]), n


@pytest.mark.parametrize("extra", [
    ["-tr", "nnUNetTrainerV2_Ranger_lr3en4", "--growth", "gradient",
     "--granularity", "kernel"],
    ["-tr", "nnUNetTrainerV2_Adam", "--growth", "gradient",
     "--granularity", "row"]])
def test_ported_options_train(environ, extra):
    """-tr with Ranger and Adam and --growth gradient, refused before they
    were ported, train a fold (validation included); the 'latest'
    checkpoint's optimizer state loads back equal to the bit."""
    tr = ttrain.main(ARGS + ["--epochs", "1", "--fold", "2", "--device",
                             "cpu"] + extra)
    assert tr.optimizer == {"nnUNetTrainerV2_Ranger_lr3en4": "ranger",
                            "nnUNetTrainerV2_Adam": "adam"}[extra[1]]
    assert tr.dsff_config.growth == "gradient"
    assert tr._dsff_grad_step is not None
    assert all(np.isfinite(tr.all_tr_losses + tr.all_val_losses))
    state, _, _ = tckpt.load_checkpoint(tr.checkpoint_path(
        "final_checkpoint"))
    mom = state["momentum"]
    assert type(mom) is type(tr.state.momentum)
    assert int(mom.step) == tr.state.momentum.step == 2
    for f in mom._fields[1:]:
        want = getattr(tr.state.momentum, f)
        for n, t in from_jax_params(getattr(mom, f)).items():
            assert torch.equal(t, want[n]), (f, n)
    assert os.path.isfile(os.path.join(tr.output_folder, "validation_raw",
                                       "summary.json"))


@pytest.mark.parametrize("flag", [["--fused"], ["--no_fused"],
                                  ["--remat", "off"]])
def test_xla_flags_rejected(environ, flag, capsys):
    with pytest.raises(SystemExit):
        ttrain.main(ARGS + ["--epochs", "1", "--device", "cpu"] + flag)
    assert "XLA programs" in capsys.readouterr().err


def test_no_module_imports_jax():
    """Every module of e2enet_tpu_torch, and chip_smoke.py, imports in a
    process where jax, jaxlib, flax and e2enet_tpu cannot be imported."""
    code = """
import sys, pkgutil, importlib
for m in ("jax", "jaxlib", "flax", "e2enet_tpu"):
    sys.modules[m] = None
import e2enet_tpu_torch
names = [m.name for m in pkgutil.walk_packages(e2enet_tpu_torch.__path__,
                                                "e2enet_tpu_torch.")]
for n in names:
    importlib.import_module(n)
import chip_smoke
assert not any(k.split(".")[0] in ("jax", "jaxlib", "flax", "e2enet_tpu")
               and sys.modules[k] is not None for k in sys.modules)
print(len(names))
"""
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=300,
                       env={**os.environ, "PYTHONPATH": str(REPO)})
    assert r.returncode == 0, r.stderr[-3000:]
    assert int(r.stdout.split()[-1]) > 40
