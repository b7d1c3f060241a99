"""The cascade on the port, the counterpart of tests/test_cascade.py: a
seeded raw task (chip_smoke.write_raw_task: six 20 x 24 x 22 cases at 1 mm,
one CT modality, 3 classes) planned by the port's plan CLI, a second stage
built by hand as tests/test_cascade.py builds it (2 mm, half the patch, one
pool) and both stages preprocessed by the port's preprocessor; then
cli.train --network 3d_lowres --fold all, cli.train --network
3d_cascade_fullres --fold all (width 8, --fp32, one epoch of 2 batches,
--device cpu) and cli.predict -m 3d_cascade_fullres on a held-out case.

The JAX package's train CLI runs the same two stages on a copy of the
preprocessed task, each of its trainers' initial weights carried into the
port's trainer (models/weights.from_jax_params). Held:
- every train and validation loss of both stages within 1e-4 relative of
  the JAX trainer's (as tests/test_torch_trainer.py holds them);
- the lowres run's <case>_segFromPrevStage.npz for every case, uint8 at
  the last stage's shape, equal to the JAX package's wherever the top two
  of the resampled float32 probabilities differ by more than 1e-4;
- the files crossing: the JAX package's sampler reads the port's files
  and the port's reads the JAX package's, equal batches; the port's
  cascade stage trains on the JAX package's files;
- the cascade checkpoints crossing: each package's ModelBundle loads the
  other's fold (3 input channels, the sidecar's cascade) with the
  parameters equal to the bit, and the port's cascade trainer resumes the
  JAX package's checkpoint;
- the predicted NIfTI: the input's shape, spacing and origin, labels in
  {0, 1, 2}, the lowres stage's output beside it.
"""
import copy
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import chip_smoke  # noqa: E402
from e2enet_tpu.cli import train as jcli  # noqa: E402
from e2enet_tpu.data import sampler as jsamp  # noqa: E402
from e2enet_tpu.inference.predictor import ModelBundle as JBundle  # noqa
from e2enet_tpu.training import cascade as jcas  # noqa: E402
from e2enet_tpu.training.trainer import TPUTrainer  # noqa: E402
from e2enet_tpu_torch.cli import plan_and_preprocess as tplan  # noqa: E402
from e2enet_tpu_torch.cli import predict as tpcli  # noqa: E402
from e2enet_tpu_torch.cli import train as tcli  # noqa: E402
from e2enet_tpu_torch.data import dataset as tds  # noqa: E402
from e2enet_tpu_torch.data import sampler as tsamp  # noqa: E402
from e2enet_tpu_torch.inference.predictor import ModelBundle  # noqa: E402
from e2enet_tpu_torch.io.nifti import (NiftiImage, read_nifti,  # noqa: E402
                                      write_nifti)
from e2enet_tpu_torch.models.weights import (from_jax_params,  # noqa: E402
                                             to_jax_params)
from e2enet_tpu_torch.plans import Plans  # noqa: E402
from e2enet_tpu_torch.preprocessing.resampling import \
    resample_data_or_seg  # noqa: E402
from e2enet_tpu_torch.training.trainer import Trainer  # noqa: E402
from e2enet_tpu_torch.utils.registry import PREPROCESSORS  # noqa: E402
from test_torch_data import _assert_batches_equal  # noqa: E402
from test_torch_predict import top_two_gap  # noqa: E402

TASK = "Task774_CascadeChain"
CASES = {f"case_{i:03d}": (20, 24, 22) for i in range(6)}
HELD_OUT = {"held_000": (22, 26, 20)}
LOSS_RTOL = 1e-4
MARGIN = 1e-4
ARGS = ["--task", TASK, "--fold", "all", "--Tconv", "shiftConvPP",
        "--epochs", "1", "--batches", "2", "--val_batches", "1",
        "--base_features", "8", "--fp32"]
STAGE1 = "nnUNetData_plans_v2.1_stage1"


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _two_stages(raw, pre):
    """The raw task under `raw` planned by the port's CLI into `pre`, a
    stage 0 at twice the spacing built by hand (tests/test_cascade.py's
    rule) and both stages preprocessed by the port's preprocessor."""
    tplan.main(["-t", "774", "-tf", "1", "-tl", "1"])
    plans_file = os.path.join(pre, TASK, "nnUNetPlansv2.1_plans_3D.json")
    plans = Plans.load(plans_file)
    assert plans.num_stages == 1
    stage0 = copy.deepcopy(plans.plans_per_stage[0])
    stage0.current_spacing = [2 * s for s in stage0.current_spacing]
    stage0.patch_size = [max(2, (p // 2 // (2 if i == 0 else 4)
                                 * (2 if i == 0 else 4)))
                         for i, p in enumerate(stage0.patch_size)]
    stage0.pool_op_kernel_sizes = [[2, 2, 2]]
    stage0.conv_kernel_sizes = [[3, 3, 3]] * 2
    stage0.num_pool_per_axis = [1, 1, 1]
    plans.plans_per_stage = {0: stage0, 1: plans.plans_per_stage[0]}
    plans.num_stages = 2
    plans.save(plans_file)
    pp = PREPROCESSORS.get(plans.preprocessor_name)(
        plans.normalization_schemes, plans.use_mask_for_norm,
        plans.transpose_forward, plans.intensity_properties)
    pp.run([stage0.current_spacing,
            plans.plans_per_stage[1].current_spacing],
           os.path.join(raw, "nnUNet_cropped_data", TASK),
           os.path.join(pre, TASK), plans.data_identifier, 1)
    return Plans.load(plans_file)


def _spy_jax(monkeypatch, log):
    """TPUTrainer: its initial parameters and every iteration's loss into
    `log`; validation left out (the port's runs validate)."""
    real_init = TPUTrainer.initialize

    def init(self, training=True):
        real_init(self, training)
        log["p0"] = jax.tree_util.tree_map(lambda a: np.array(a, copy=True),
                                           self.state.params)
        log["trainer"] = self
        _record(self, log)
    monkeypatch.setattr(TPUTrainer, "initialize", init)
    monkeypatch.setattr(TPUTrainer, "validate", lambda self, *a, **k: None)


def _spy_port(monkeypatch, log, p0):
    """Trainer: the JAX trainer's initial parameters `p0` loaded after
    initialize, every iteration's loss into `log`."""
    real_init = Trainer.initialize

    def init(self, training=True):
        real_init(self, training)
        self.network.load_state_dict(from_jax_params(p0), strict=True)
        log["trainer"] = self
        _record(self, log)
    monkeypatch.setattr(Trainer, "initialize", init)


def _record(trainer, log):
    log.setdefault("train", [])
    log.setdefault("val", [])
    real = trainer.run_iteration

    def spy(gen, lr, do_backprop=True, run_online_evaluation=False):
        out = real(gen, lr, do_backprop, run_online_evaluation)
        log["train" if do_backprop else "val"].append(
            float(np.asarray(out)))
        return out
    trainer.run_iteration = spy


def _input_channels(net):
    return net.context0.block0.kernel.shape[1]


def _env(monkeypatch, base, which):
    monkeypatch.setenv("nnUNet_raw_data_base", os.path.join(base, "raw"))
    monkeypatch.setenv("nnUNet_preprocessed",
                       os.path.join(base, which, "preprocessed"))
    monkeypatch.setenv("RESULTS_FOLDER", os.path.join(base, which,
                                                      "results"))


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    """Both packages' lowres and cascade runs, then the port's predict
    CLI. Returns the folders and what the spies recorded."""
    mp = pytest.MonkeyPatch()
    base = str(tmp_path_factory.mktemp("cascade_chain"))
    chip_smoke.write_raw_task(os.path.join(base, "raw"), TASK, CASES, 3)
    held = os.path.join(base, "held_out")
    os.makedirs(held)
    rng = np.random.RandomState(7)
    geom = dict(origin=(3.0, -5.5, 12.25))
    for name, shape in HELD_OUT.items():
        vol, _ = chip_smoke.synthetic_case(rng, shape, 3)
        write_nifti(os.path.join(held, f"{name}_0000.nii.gz"),
                    NiftiImage(vol, (1.0, 1.0, 1.0), **geom))
    out = {"base": base, "held": held, "geom": geom}
    try:
        _env(mp, base, "port")
        out["plans"] = _two_stages(os.path.join(base, "raw"),
                                   os.path.join(base, "port", "preprocessed"))
        pre = {w: os.path.join(base, w, "preprocessed", TASK)
               for w in ("port", "jax")}
        shutil.copytree(pre["port"], pre["jax"])
        out["pre"] = pre
        for net in ("3d_lowres", "3d_cascade_fullres"):
            jlog, tlog = {}, {}
            with pytest.MonkeyPatch.context() as m:
                _env(m, base, "jax")
                _spy_jax(m, jlog)
                if net == "3d_lowres":
                    probs = {}
                    real = jcas.resample_and_save

                    def spy(p, shape, f, *a, **k):
                        probs[os.path.basename(f)] = (np.array(p), shape)
                        return real(p, shape, f, *a, **k)
                    m.setattr(jcas, "resample_and_save", spy)
                    out["jax_probs"] = probs
                jcli.main(["--network", net] + ARGS)
            with pytest.MonkeyPatch.context() as m:
                _env(m, base, "port")
                _spy_port(m, tlog, jlog["p0"])
                tcli.main(["--network", net] + ARGS + ["--device", "cpu"])
            out[net] = (jlog, tlog)
            if net == "3d_lowres":
                # keep the port's files; the cascade stages of both
                # packages then train on the JAX package's
                seg = os.path.join(base, "port_segs")
                os.makedirs(seg)
                for f in os.listdir(os.path.join(pre["port"], STAGE1)):
                    if f.endswith("_segFromPrevStage.npz"):
                        shutil.move(os.path.join(pre["port"], STAGE1, f), seg)
                        shutil.copy(os.path.join(pre["jax"], STAGE1, f),
                                    os.path.join(pre["port"], STAGE1))
                out["port_segs"] = seg
        pred = os.path.join(base, "predictions")
        tpcli.main(["-i", held, "-o", pred, "-t", TASK, "-m",
                    "3d_cascade_fullres", "-f", "all", "--Tconv",
                    "shiftConvPP", "--disable_postprocessing", "--device",
                    "cpu"])
        out["pred"] = pred
        yield out
    finally:
        mp.undo()


def test_two_stage_plan(chain):
    plans = chain["plans"]
    s0, s1 = plans.plans_per_stage[0], plans.plans_per_stage[1]
    assert plans.num_stages == 2
    assert [2 * s for s in s1.current_spacing] == s0.current_spacing
    for stage, st in ((0, s0), (1, s1)):
        folder = os.path.join(chain["pre"]["port"],
                              f"nnUNetData_plans_v2.1_stage{stage}")
        shape = np.load(os.path.join(folder, "case_000.npz"))["data"].shape
        want = [int(round(c / s)) for c, s in zip((20, 24, 22),
                                                  st.current_spacing)]
        assert list(shape[1:]) == want


@pytest.mark.parametrize("net", ["3d_lowres", "3d_cascade_fullres"])
def test_losses_match_the_jax_trainer(chain, net):
    jlog, tlog = chain[net]
    tt, jt = tlog["trainer"], jlog["trainer"]
    assert tt.cascade == jt.cascade == (net == "3d_cascade_fullres")
    assert tt.stage == jt.stage == (0 if net == "3d_lowres" else 1)
    assert _input_channels(tt.network) == (3 if tt.cascade else 1)
    assert len(tlog["train"]) == 2 and len(tlog["val"]) == 1
    np.testing.assert_allclose(tlog["train"], jlog["train"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(tlog["val"], jlog["val"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(tt.all_tr_losses, jt.all_tr_losses,
                               rtol=LOSS_RTOL)
    fold = tt.output_folder
    assert os.path.isfile(os.path.join(fold, "validation_raw",
                                       "summary.json"))


def test_seg_from_prev_stage_matches_jax(chain):
    """Every case's file, uint8 at the last stage's shape with labels in
    {0, 1, 2}, the same label as the JAX package's wherever the top two of
    the JAX run's resampled probabilities differ by more than 1e-4."""
    probs = chain["jax_probs"]
    names = sorted(f"{c}_segFromPrevStage.npz" for c in CASES)
    assert sorted(os.listdir(chain["port_segs"])) == sorted(probs) == names
    for name in names:
        a = np.load(os.path.join(chain["port_segs"], name))["data"]
        b = np.load(os.path.join(chain["pre"]["jax"], STAGE1, name))["data"]
        p, shape = probs[name]
        data = np.load(os.path.join(chain["pre"]["jax"], STAGE1,
                                    name.replace("_segFromPrevStage", "")))
        assert a.dtype == b.dtype == np.uint8
        assert a.shape == b.shape == tuple(shape) == data["data"].shape[1:]
        assert set(np.unique(a)) <= {0, 1, 2}
        gap = top_two_gap(resample_data_or_seg(p, shape, False, order=1))
        assert (a == b)[gap > MARGIN].all()
        assert (gap > MARGIN).mean() > 0.9


def test_seg_files_cross_packages(chain):
    """The JAX package's sampler on the port's files and the port's on the
    JAX package's, each against the other package's sampler: equal
    batches, the second seg channel the previous stage's labels."""
    for folder in (chain["port_segs"], os.path.join(chain["pre"]["jax"],
                                                    STAGE1)):
        stage = os.path.join(chain["base"], "cross",
                             os.path.basename(folder))
        shutil.copytree(os.path.join(chain["pre"]["jax"], STAGE1), stage,
                        ignore=shutil.ignore_patterns("*.npy", "*_seg*"))
        for f in os.listdir(folder):
            if f.endswith("_segFromPrevStage.npz"):
                shutil.copy(os.path.join(folder, f), stage)
        dataset = tds.load_dataset(stage)
        patch = [int(p) for p in chain["plans"].plans_per_stage[1].patch_size]
        a = tsamp.PatchSampler3D(dataset, patch, patch, 2,
                                 has_prev_stage=True, seed=1)
        b = jsamp.PatchSampler3D(dataset, patch, patch, 2,
                                 has_prev_stage=True, seed=1)
        for _ in range(2):
            x, y = a.generate_train_batch(), b.generate_train_batch()
            _assert_batches_equal(x, y)
            assert x["seg"].shape[1] == 2
            assert set(np.unique(x["seg"][:, 1])) <= {-1, 0, 1, 2}


def _fold(chain, which):
    return os.path.join(chain["base"], which, "results", "nnUNet",
                        "3d_cascade_fullres", TASK,
                        "TPUTrainer__nnUNetPlansv2.1")


def _leaves(tree):
    return jax.tree_util.tree_leaves(tree)


def test_cascade_checkpoints_cross_packages(chain):
    jt = chain["3d_cascade_fullres"][0]["trainer"]
    tt = chain["3d_cascade_fullres"][1]["trainer"]
    # the port's bundle on the JAX package's fold
    bundle = ModelBundle(_fold(chain, "jax"), ["all"], "shiftConvPP",
                         compute_dtype=torch.float32, device="cpu")
    assert bundle.sidecar_init["cascade"] is True
    net = bundle.fold_models[0]
    assert _input_channels(net) == 3
    want = jax.device_get(jt.state.params)
    for a, b in zip(_leaves(to_jax_params(net.state_dict())), _leaves(want)):
        np.testing.assert_array_equal(a, np.asarray(b))
    # the JAX package's bundle on the port's fold
    jb = JBundle(_fold(chain, "port"), ["all"], "shiftConvPP")
    for a, b in zip(_leaves(jb.fold_params[0]),
                    _leaves(to_jax_params(tt.state.params))):
        np.testing.assert_array_equal(np.asarray(a), b)
    # the port's cascade trainer resumes the JAX package's checkpoint
    plans = Plans.load(os.path.join(chain["pre"]["port"],
                                    "nnUNetPlansv2.1_plans_3D.json"))
    resumed = Trainer(plans, "all", os.path.join(chain["base"], "resumed"),
                      dataset_directory=chain["pre"]["port"], stage=1,
                      cascade=True, base_num_features=8, fp16=False,
                      device="cpu")
    resumed.load_checkpoint_file(os.path.join(
        _fold(chain, "jax"), "fold_all",
        "shiftConvPP_model_final_checkpoint.model"), train=False)
    assert resumed.epoch == 1 and int(resumed.state.step) == 2
    for a, b in zip(_leaves(to_jax_params(resumed.state.params)),
                    _leaves(want)):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_cascade_prediction(chain):
    for name, shape in HELD_OUT.items():
        img = read_nifti(os.path.join(chain["pred"], f"{name}.nii.gz"))
        low = read_nifti(os.path.join(chain["pred"] + "_lowres",
                                      f"{name}.nii.gz"))
        assert img.array.shape == low.array.shape == shape
        assert set(np.unique(img.array)) <= {0, 1, 2}
        np.testing.assert_allclose(img.spacing, (1.0, 1.0, 1.0))
        np.testing.assert_allclose(img.origin, chain["geom"]["origin"])
