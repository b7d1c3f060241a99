"""The region trainers on the port, end to end beside the JAX package's: a
seeded BraTS-like raw task (chip_smoke.write_raw_task: six 20 x 24 x 22
cases at 1 mm, four MR modalities, labels 0-3) planned by the port's plan
CLI, then `cli.train -tr nnUNetTrainerV2_fullEvals` (regions "brats",
the DC + BCE loss, per-sample Dice, a validation without mirroring after
every epoch; width 8, --fp32, two epochs of 2 + 1 batches, --device cpu)
beside the JAX package's train CLI on a copy of the preprocessed task, the
JAX trainer's initial weights carried into the port's
(models/weights.from_jax_params). Held:

- every train and validation loss, and the online region Dice, within
  1e-4 relative of the JAX trainer's;
- the model: four input channels, three sigmoid region heads; the
  validation batches' targets one 0/1 channel per region;
- validation_ep001/, validation_ep002/ (no mirroring) and validation_raw/
  (8 mirror passes): the region probabilities each validation exports
  within 1e-3 of the JAX package's (after four SGD steps whose float32
  sums run in another order the weights differ slightly: 4e-5 to 1.9e-4
  seen); the exported label maps equal to the JAX package's wherever
  every region's JAX probability is more than 1e-3 from the 0.5
  threshold (a barely trained model puts 2-3 % of the voxels there, and
  up to one voxel of 10560 flipped in the runs made), those voxels under
  5 %; summary.csv with the three region columns and the same cases, each
  region Dice within 1e-3 of the JAX package's (equal to the printed
  four decimals in every run made; one flipped voxel can move it by
  ~1e-4); no postprocessing.

The JAX trainer gives its validation batches the labels instead of the
region targets (its val AugmentParams has no `regions`), on which its
region loss cannot run; the port gives them the region targets. The JAX
side runs here with its validation pipeline given the regions, as the
reference trainer it ports (nnUNetTrainerV2BraTSRegions) does.
"""
import dataclasses
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
from e2enet_tpu.cli import train as jcli  # noqa: E402
from e2enet_tpu.data import pipeline as jpipe  # noqa: E402
from e2enet_tpu.inference import export as jexport  # noqa: E402
from e2enet_tpu.training import trainer as jtrainer  # noqa: E402
from e2enet_tpu_torch.cli import plan_and_preprocess as tplan  # noqa: E402
from e2enet_tpu_torch.cli import train as tcli  # noqa: E402
from e2enet_tpu_torch.inference import export as texport  # noqa: E402
from e2enet_tpu_torch.io.nifti import read_nifti  # noqa: E402
from e2enet_tpu_torch.plans import Plans  # noqa: E402
from test_torch_cascade_chain import (_env, _spy_jax,  # noqa: E402
                                      _spy_port)

TASK = "Task775_RegionsChain"
CASES = {f"case_{i:03d}": (20, 24, 22) for i in range(6)}
MODALITIES = ("t1", "t1ce", "t2", "flair")
REGIONS = ((1, 2, 3), (2, 3), (3,))
LOSS_RTOL = 1e-4
PROB_ATOL = 1e-3
MARGIN = 1e-3
DICE_ATOL = 1e-3
ARGS = ["--task", TASK, "--fold", "0", "--epochs", "2", "--batches", "2",
        "--val_batches", "1", "--base_features", "8", "--fp32", "-tr",
        "nnUNetTrainerV2_fullEvals"]
FOLDERS = ("validation_ep001", "validation_ep002", "validation_raw")


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _spy_export(monkeypatch, module, probs):
    """The probabilities each validation exports, by (folder, case)."""
    real = module.save_segmentation_nifti_from_softmax

    def spy(softmax, out_fname, props, *a, **k):
        folder, name = out_fname.split(os.sep)[-2:]
        probs[(folder, name)] = np.array(softmax)
        return real(softmax, out_fname, props, *a, **k)
    monkeypatch.setattr(module, "save_segmentation_nifti_from_softmax", spy)


def _jax_val_regions(monkeypatch):
    """The JAX trainer's validation pipeline with the region targets."""
    def pipeline(sampler, params, validation=False, **kw):
        if validation and params.regions is None:
            params = dataclasses.replace(params, regions=REGIONS)
        return jpipe.BatchPipeline(sampler, params, validation, **kw)
    monkeypatch.setattr(jtrainer, "BatchPipeline", pipeline)


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    base = str(tmp_path_factory.mktemp("regions_chain"))
    chip_smoke.write_raw_task(os.path.join(base, "raw"), TASK, CASES, 4,
                              modalities=MODALITIES)
    out = {"base": base}
    try:
        _env(mp, base, "port")
        tplan.main(["-t", "775", "-tf", "1", "-tl", "1"])
        pre = {w: os.path.join(base, w, "preprocessed", TASK)
               for w in ("port", "jax")}
        shutil.copytree(pre["port"], pre["jax"])
        out["plans"] = Plans.load(os.path.join(
            pre["port"], "nnUNetPlansv2.1_plans_3D.json"))
        jlog, tlog = {}, {}
        with pytest.MonkeyPatch.context() as m:
            _env(m, base, "jax")
            _spy_jax(m, jlog)
            # the spy leaves validation out; the region runs validate
            m.setattr(jtrainer.TPUTrainer, "validate",
                      _REAL_JAX_VALIDATE)
            _jax_val_regions(m)
            jlog["probs"] = {}
            _spy_export(m, jexport, jlog["probs"])
            jcli.main(ARGS)
        with pytest.MonkeyPatch.context() as m:
            _env(m, base, "port")
            _spy_port(m, tlog, jlog["p0"])
            seen = []
            real_it = None

            def record(tr):
                nonlocal real_it
                real_it = tr._to_device

                def to_device(batch):
                    if len(seen) < 4:
                        seen.append([np.array(t) for t in batch["target"]])
                    return real_it(batch)
                tr._to_device = to_device
            real_init = tcli.Trainer.initialize

            def init(self, training=True):
                real_init(self, training)
                record(self)
            m.setattr(tcli.Trainer, "initialize", init)
            tlog["probs"] = {}
            _spy_export(m, texport, tlog["probs"])
            tcli.main(ARGS + ["--device", "cpu"])
        out.update(jax=jlog, port=tlog, seen=seen)
        yield out
    finally:
        mp.undo()


_REAL_JAX_VALIDATE = jtrainer.TPUTrainer.validate


def _fold(chain, which):
    return os.path.join(chain["base"], which, "results", "nnUNet",
                        "3d_fullres", TASK, "TPUTrainer__nnUNetPlansv2.1",
                        "fold_0")


def test_task_has_four_modalities(chain):
    plans = chain["plans"]
    assert plans.num_modalities == 4
    assert set(plans.normalization_schemes.values()) == {"nonCT"}


def test_losses_match_the_jax_trainer(chain):
    jlog, tlog = chain["jax"], chain["port"]
    tt, jt = tlog["trainer"], jlog["trainer"]
    assert list(tt.regions.values()) == list(REGIONS)
    assert tt.regions_class_order == jt.regions_class_order == (1, 2, 3)
    assert tt.network.context0.block0.kernel.shape[1] == 4
    assert tt.network.seg_head0.kernel.shape[0] == 3
    assert tt.loss_name == "dc_bce" and not tt.batch_dice
    assert len(tlog["train"]) == 4 and len(tlog["val"]) == 2
    np.testing.assert_allclose(tlog["train"], jlog["train"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(tlog["val"], jlog["val"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(tt.all_tr_losses, jt.all_tr_losses,
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(tt.all_val_eval_metrics,
                               jt.all_val_eval_metrics, rtol=LOSS_RTOL)


def test_batches_carry_region_targets(chain):
    """Training and validation batches: every target (B, x, y, z, 3)
    float32 of 0/1, the deep-supervision scales of the plan."""
    assert len(chain["seen"]) == 4
    for targets in chain["seen"]:
        assert len(targets) > 1
        for t in targets:
            assert t.dtype == np.float32 and t.ndim == 5
            assert t.shape[-1] == 3 and set(np.unique(t)) <= {0.0, 1.0}


def _csv(path):
    with open(path) as f:
        rows = [line.split(",") for line in f.read().splitlines()]
    return rows[0], {r[0]: np.array(r[1:], float) for r in rows[1:]}


@pytest.mark.parametrize("folder", FOLDERS)
def test_validations_match_the_jax_trainer(chain, folder):
    """Each validation's exported probabilities, label maps and
    summary.csv (the region Dice per case, mean and median) against the
    JAX package's; no postprocessing."""
    port, jx = (os.path.join(_fold(chain, w), folder)
                for w in ("port", "jax"))
    files = sorted(f for f in os.listdir(port) if f.endswith(".nii.gz"))
    assert files and files == sorted(
        f for f in os.listdir(jx) if f.endswith(".nii.gz"))
    near = []
    for f in files:
        pt, pj = (chain[w]["probs"][(folder, f)] for w in ("port", "jax"))
        assert pt.shape == pj.shape and pt.shape[0] == 3
        assert pt.min() >= 0 and pt.max() <= 1
        np.testing.assert_allclose(pt, pj, rtol=0, atol=PROB_ATOL)
        a = read_nifti(os.path.join(port, f)).array
        b = read_nifti(os.path.join(jx, f)).array
        assert a.shape == b.shape == CASES[f[:-7]] == pj.shape[1:]
        assert set(np.unique(a)) <= {0, 1, 2, 3}
        sure = (np.abs(pj - 0.5) > MARGIN).all(0)
        np.testing.assert_array_equal(a[sure], b[sure])
        near.append(1.0 - sure.mean())
    assert max(near) < 0.05
    head_a, rows_a = _csv(os.path.join(port, "summary.csv"))
    head_b, rows_b = _csv(os.path.join(jx, "summary.csv"))
    assert head_a == head_b == ["casename", "whole tumor", "tumor core",
                                "enhancing tumor"]
    assert list(rows_a) == list(rows_b) == [f[:-7] for f in files] + [
        "mean", "median"]
    for k in rows_a:
        np.testing.assert_allclose(rows_a[k], rows_b[k], rtol=0,
                                   atol=DICE_ATOL, equal_nan=True)
    fold = _fold(chain, "port")
    assert not os.path.exists(os.path.join(fold, "postprocessing.json"))
    assert not os.path.exists(os.path.join(port, "summary.json"))
