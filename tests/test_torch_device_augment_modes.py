"""The trainer's device_augment mode in each trainer mode, the port
(e2enet_tpu_torch/training/trainer.py) beside the JAX package's TPUTrainer
with device_augment=True on the CPU, on chip_smoke.write_train_task's six
20 x 24 x 22 cases (3 classes, width 8, float32).

Where the JAX trainer trains so (a 3D plan, the DA5 level, a 2D plan of
patch depth 1), the port builds its augmenter with the same arguments
(patch, generator patch, classes, deep-supervision scales, the mirror,
rotation, scaling and gamma switches after the level) and takes a step:
tests/test_torch_device_augment.py holds the augmenter to the JAX one at
these 3D and 2D shapes. Where the JAX trainer cannot (the cascade: no
one-hot channels; the BraTS regions: label targets; ds_mode none: no
scales; dummy_load: no 'seg'), it raises, at initialize or at its first
step, and the port refuses at initialize naming the mode. A plan with
do_dummy_2D_data_aug raises in both before any augmenter is built
(get_patch_size on a two-element patch, ROADMAP Queue 3).
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import flax  # noqa: E402

import chip_smoke  # noqa: E402
from e2enet_tpu.ops import device_augment as jda  # noqa: E402
from e2enet_tpu.plans import Plans as JPlans  # noqa: E402
from e2enet_tpu.training.trainer import TPUTrainer  # noqa: E402
from e2enet_tpu_torch.plans import Plans  # noqa: E402
from e2enet_tpu_torch.training import trainer as ttrainer  # noqa: E402

CASES = {f"case_{i:03d}": (20, 24, 22) for i in range(6)}
KW = dict(fold=0, base_num_features=8, fp16=False, max_num_epochs=1,
          num_batches_per_epoch=1, num_val_batches_per_epoch=1, seed=0,
          device_augment=True)
BRATS = dict(regions="brats", loss_name="dc_bce",
             loss_kwargs={"smooth": 0.0}, batch_dice=False)


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tasks(tmp_path_factory):
    """{'3d': the 16^3 task, with a segFromPrevStage file per case for the
    cascade; '2d': its 2D twin at patch (1, 16, 16), batch 4}: plans file
    and task folder of each."""
    base = str(tmp_path_factory.mktemp("device_augment_modes"))
    out = {}
    for name, patch, pools, batch in (("3d", (16, 16, 16), [[2, 2, 2]] * 2,
                                       2),
                                      ("2d", (1, 16, 16), [[1, 2, 2]] * 2,
                                       4)):
        paths = chip_smoke.write_train_task(
            os.path.join(base, name), f"Task77{len(out)}_DevAug", CASES,
            patch, pools, 3, batch_size=batch)
        out[name] = (os.path.join(paths["task"],
                                  "nnUNetPlansv2.1_plans_3D.json"),
                     paths["task"])
    folder = os.path.join(out["3d"][1], "nnUNetData_plans_v2.1_stage0")
    rng = np.random.RandomState(3)
    for case, shape in CASES.items():
        np.savez_compressed(os.path.join(folder,
                                         f"{case}_segFromPrevStage.npz"),
                            data=rng.randint(0, 3, shape).astype(np.uint8))
    return out, base


def _both(tasks, name, plan, kw):
    (plans_file, task_dir), base = tasks[0][plan], tasks[1]
    out = os.path.join(base, name)
    jt = TPUTrainer(JPlans.load(plans_file), output_folder=out + "_jax",
                    dataset_directory=task_dir, **{**KW, **kw})
    tt = ttrainer.Trainer(Plans.load(plans_file), output_folder=out + "_port",
                          dataset_directory=task_dir, device="cpu",
                          **{**KW, **kw})
    return jt, tt


def _recorder(module, monkeypatch):
    """Record each make_device_augmenter call's arguments in `module`."""
    calls = []
    real = module.make_device_augmenter

    def rec(patch, in_patch, num_classes, ds_scales, **kw):
        calls.append(dict(patch=tuple(int(p) for p in patch),
                          in_patch=tuple(int(p) for p in in_patch),
                          num_classes=num_classes,
                          ds_scales=[[float(x) for x in sc]
                                     for sc in ds_scales], **kw))
        return real(patch, in_patch, num_classes, ds_scales, **kw)
    monkeypatch.setattr(module, "make_device_augmenter", rec)
    return calls


@pytest.mark.parametrize("name, plan, kw", [
    ("standard", "3d", {}), ("da5", "3d", dict(da_level="DA5")),
    ("2d", "2d", dict(batch_dice=False))])
def test_modes_that_train(tasks, monkeypatch, name, plan, kw):
    jcalls = _recorder(jda, monkeypatch)
    tcalls = _recorder(ttrainer, monkeypatch)
    jt, tt = _both(tasks, name, plan, kw)
    try:
        jt.initialize(True)
        tt.initialize(True)
        assert len(jcalls) == len(tcalls) == 1
        assert tcalls[0] == jcalls[0]
        assert tt.tr_gen.raw and jt.tr_gen.raw and not tt.val_gen.raw
        loss = tt.run_iteration(tt.tr_gen, 0.01, True)
        assert np.isfinite(float(loss)) and tt.state.step == 1
    finally:
        for t in (jt, tt):
            if hasattr(t, "tr_gen"):
                t.tr_gen.stop()
                t.val_gen.stop()
    if name == "2d":
        assert tcalls[0]["patch"] == (1, 16, 16)
        assert tcalls[0]["in_patch"][0] > 1   # rotated in 3D, as in JAX


@pytest.mark.parametrize("name, kw, jax_error, when", [
    ("cascade", dict(cascade=True), flax.errors.ScopeParamShapeError,
     "step"),
    ("regions", BRATS, ValueError, "step"),
    ("ds_mode none", dict(ds_mode="none"), TypeError, "initialize"),
    ("dummy_load", dict(dummy_load=True), KeyError, "step")])
def test_modes_the_jax_trainer_cannot_train(tasks, name, kw, jax_error,
                                            when):
    jt, tt = _both(tasks, name.replace(" ", "_"), "3d", kw)
    with pytest.raises(ValueError, match=f"device_augment with {name}"):
        tt.initialize(True)
    assert not hasattr(tt, "network")
    try:
        with pytest.raises(jax_error):
            jt.initialize(True)
            assert when == "step"
            jt.run_iteration(jt.tr_gen, 0.01, True)
    finally:
        if hasattr(jt, "tr_gen"):
            jt.tr_gen.stop()
            jt.val_gen.stop()


def test_dummy_2d_plan_raises_in_both(tasks):
    """A plan with do_dummy_2D_data_aug: both trainers' get_patch_size
    raises on the in-plane patch, device_augment or not."""
    (plans_file, task_dir), base = tasks[0]["3d"], tasks[1]
    jp, tp = JPlans.load(plans_file), Plans.load(plans_file)
    jp.plans_per_stage[0].do_dummy_2D_data_aug = True
    tp.plans_per_stage[0].do_dummy_2D_data_aug = True
    jt = TPUTrainer(jp, output_folder=os.path.join(base, "dummy2d_jax"),
                    dataset_directory=task_dir, **KW)
    tt = ttrainer.Trainer(tp, output_folder=os.path.join(base,
                                                         "dummy2d_port"),
                          dataset_directory=task_dir, device="cpu", **KW)
    errors = []
    for t in (jt, tt):
        with pytest.raises(TypeError) as e:
            t.initialize(True)
        errors.append(str(e.value))
    assert errors[0] == errors[1] and "divide" in errors[0]
