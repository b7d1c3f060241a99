"""Gradient-fed DSFF on the port against the reference:

- gradient growth at row and kernel granularity (e2enet_tpu_torch/
  training/dsff.py death_growth_update(growth="gradient"), and through
  train_state.make_mask_update_step on a train state) fed the same numpy
  gradient as the reference's death_growth_update(growth_mode="gradient")
  (flax layout there, the port's layout through models/weights.py): the
  new masks equal, every kernel's alive count held, the parameters and
  the optimizer state zero where the masks are;
- make_grad_step (train_state.py) within 1e-4 relative L2 per leaf of the
  reference's make_grad_step (jax.grad of the deep-supervision loss) on
  the tiny model of test_torch_train_step.py, float32, the biases ahead of
  an instance norm held by that file's rule (their gradient is rounding);
- the trainer with Ranger, the warmup schedule, the DC + top-k loss and
  kernel-granular DSFF grown by gradient every 2 steps, against the JAX
  TPUTrainer with the same options on the same tiny task, weights and
  batches (as tests/test_torch_trainer.py holds the default trainer):
  every train and validation loss within 1e-4 relative, the learning
  rates equal, the masks and fired masks equal after the run.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import chip_smoke  # noqa: E402
from e2enet_tpu.models.unetpp import ShiftUNetPlusPlus as JaxNet  # noqa
from e2enet_tpu.models.unetpp import ds_loss_weights  # noqa: E402
from e2enet_tpu.plans import Plans as JPlans  # noqa: E402
from e2enet_tpu.training import dsff as jd  # noqa: E402
from e2enet_tpu.training import train_state as jts  # noqa: E402
from e2enet_tpu.training.trainer import TPUTrainer  # noqa: E402
from e2enet_tpu_torch.models.masks import broadcast_mask  # noqa: E402
from e2enet_tpu_torch.models.weights import from_jax_params  # noqa: E402
from e2enet_tpu_torch.plans import Plans  # noqa: E402
from e2enet_tpu_torch.training import dsff as td  # noqa: E402
from e2enet_tpu_torch.training import train_state as tts  # noqa: E402
from e2enet_tpu_torch.training.trainer import Trainer  # noqa: E402
from test_torch_train_step import (BIAS_ZERO, KW, SHAPE,  # noqa: E402
                                   _batch, _bias_ahead_of_norm, _params,
                                   _port_model)

GRAD_RTOL = 1e-4
LOSS_RTOL = 1e-4


def _fed(granularity, seed):
    """(reference params, masks, a numpy gradient tree) of the tiny model:
    masks at density 0.4 of the granularity, the gradient seeded."""
    params = _params(KW, SHAPE, seed)
    key = jax.random.PRNGKey(seed + 1)
    if granularity == "row":
        masks = jd.init_masks_row(params, 0.4, key,
                                  density_48_override=0.4)
    else:
        masks = jd.init_masks(params, 0.4, key, density_48_override=0.4)
    params = jax.tree_util.tree_map(np.asarray,
                                    jd.apply_masks(params, masks))
    rng = np.random.RandomState(seed + 2)
    grads = jax.tree_util.tree_map(
        lambda a: rng.randn(*a.shape).astype(np.float32), params)
    return params, masks, grads


@pytest.mark.parametrize("granularity", ["row", "kernel"])
@pytest.mark.parametrize("rate", [0.5, 0.2])
def test_gradient_growth_matches_reference(granularity, rate):
    params, masks, grads = _fed(granularity, 3 + int(rate * 10))
    want, wstats = jd.death_growth_update(
        params, grads, masks, jax.random.PRNGKey(9), jnp.float32(rate),
        growth_mode="gradient", granularity=granularity)
    net = _port_model(KW, params, torch.float32)
    tmasks = {".".join(k): torch.from_numpy(np.array(m))
              for k, m in masks.items()}
    tgrads = from_jax_params(grads)
    got, stats = td.death_growth_update(net, tmasks, rate,
                                        granularity=granularity,
                                        growth="gradient", grads=tgrads)
    assert stats["total_death"] == int(wstats["total_death"]) > 0
    moved = 0
    for k, m in want.items():
        g = got[".".join(k)].numpy()
        np.testing.assert_array_equal(g, np.asarray(m), err_msg=str(k))
        assert g.sum() == float(np.asarray(masks[k]).sum())
        moved += int((g != np.asarray(masks[k])).sum())
    assert moved > 0
    # the same through the mask update on a Ranger train state
    state = tts.create_train_state(net, tmasks, optimizer="ranger")
    with torch.no_grad():
        for d in (state.momentum.exp_avg, state.momentum.exp_avg_sq):
            for t in d.values():
                t.add_(1.0)
    update = tts.make_mask_update_step(net, "gradient",
                                       granularity=granularity)
    state = update(state, rate, tgrads)
    for k, m in want.items():
        n = ".".join(k)
        np.testing.assert_array_equal(state.masks[n].numpy(), np.asarray(m))
        dead = broadcast_mask(1.0 - state.masks[n], state.params[n])
        for t in (state.params[n].detach(), state.momentum.exp_avg[n],
                  state.momentum.exp_avg_sq[n], state.momentum.slow[n]):
            assert float((t * dead).abs().max()) == 0.0, n


def test_gradient_growth_needs_the_gradients():
    params, masks, _ = _fed("row", 1)
    net = _port_model(KW, params, torch.float32)
    tmasks = {".".join(k): torch.from_numpy(np.array(m))
              for k, m in masks.items()}
    with pytest.raises(ValueError, match="needs the gradients"):
        td.death_growth_update(net, tmasks, 0.5, growth="gradient")
    with pytest.raises(ValueError, match="unknown growth 'momentum'"):
        td.death_growth_update(net, tmasks, 0.5, growth="momentum")


def test_grad_step_matches_jax_grad():
    params = _params(KW, SHAPE, 0)
    x, targets = _batch(1, SHAPE, 3, 3)
    weights = ds_loss_weights(3, 3)
    jnet = JaxNet(**KW, compute_dtype=jnp.float32, remat=False,
                  quadrant=False)
    jgrads = jts.make_grad_step(jnet, weights)(
        params, jnp.asarray(x), tuple(jnp.asarray(t) for t in targets))
    want = from_jax_params(jax.tree_util.tree_map(np.asarray, jgrads))
    net = _port_model(KW, params, torch.float32)
    got = tts.make_grad_step(net, weights)(
        torch.from_numpy(x), [torch.from_numpy(t).long() for t in targets])
    assert set(got) == set(want)
    for n, g in got.items():
        g, w = g.numpy(), want[n].numpy()
        if _bias_ahead_of_norm(n):
            kernel = np.linalg.norm(want[n.replace(".bias", ".kernel")])
            assert np.linalg.norm(g) <= BIAS_ZERO * kernel, n
            assert np.linalg.norm(w) <= BIAS_ZERO * kernel, n
            continue
        if not np.any(w):                  # a head of loss weight 0
            assert not np.any(g), n
            continue
        err = np.linalg.norm(g - w) / np.linalg.norm(w)
        assert err <= GRAD_RTOL, (n, err)


# ---- the trainer with the options, against the JAX trainer
CASES = {f"case_{i:03d}": (20, 24, 22) for i in range(6)}
OPTIONS = dict(optimizer="ranger", lr_schedule="warmup", loss_name="dc_topk",
               initial_lr=3e-3)
KW_T = dict(fold=0, base_num_features=8, fp16=False, max_num_epochs=2,
            num_batches_per_epoch=2, num_val_batches_per_epoch=2, seed=0)
DSFF = dict(sparse=True, density=0.3, update_frequency=2,
            growth="gradient", granularity="kernel")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    base = str(tmp_path_factory.mktemp("grad_growth"))
    paths = chip_smoke.write_train_task(base, "Task775_Grow", CASES,
                                        (16, 16, 16), [[2, 2, 2]] * 2, 3)
    plans = os.path.join(paths["task"], "nnUNetPlansv2.1_plans_3D.json")
    logs = {}

    def record(tr, kind):
        log = logs.setdefault(kind, {"train": [], "val": [], "lr": []})
        real = tr.run_iteration

        def spy(gen, lr, do_backprop=True, run_online_evaluation=False):
            out = real(gen, lr, do_backprop, run_online_evaluation)
            log["train" if do_backprop else "val"].append(
                float(np.asarray(out)))
            if do_backprop:
                log["lr"].append(float(lr))
            return out
        tr.run_iteration = spy

    jt = TPUTrainer(JPlans.load(plans), output_folder=os.path.join(
        base, "jax"), dataset_directory=paths["task"],
        dsff_config=jd.DSFFConfig(**DSFF), **KW_T, **OPTIONS)
    jt.initialize(True)
    p0 = jax.tree_util.tree_map(lambda a: np.array(a, copy=True),
                                jt.state.params)
    record(jt, "jax")
    jt.run_training()
    tt = Trainer(Plans.load(plans), output_folder=os.path.join(base, "port"),
                 dataset_directory=paths["task"], device="cpu",
                 dsff_config=td.DSFFConfig(**DSFF), **KW_T, **OPTIONS)
    tt.initialize(True)
    tt.network.load_state_dict(from_jax_params(p0), strict=True)
    # the same initial masks (the packages draw them differently)
    tt.state.masks = {".".join(k): torch.from_numpy(np.array(m))
                      for k, m in jd.init_masks(
                          p0, 0.3, jax.random.PRNGKey(1)).items()}
    tt.fired_masks = {k: v.clone() for k, v in tt.state.masks.items()}
    tts.mask_opt_state(tt.state.momentum, tt.state.masks)
    from e2enet_tpu_torch.models.masks import apply_masks_to
    apply_masks_to(tt.state.params, tt.state.masks)
    record(tt, "port")
    tt.run_training()
    torch.set_num_threads(n)
    return jt, tt, logs


def test_trainer_with_options_matches_reference(runs):
    jt, tt, logs = runs
    assert type(tt.state.momentum).__name__ == "RangerState"
    assert tt.state.momentum.step == int(jt.state.momentum.step) == 4
    np.testing.assert_allclose(logs["port"]["train"], logs["jax"]["train"],
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(logs["port"]["val"], logs["jax"]["val"],
                               rtol=LOSS_RTOL)
    assert logs["port"]["lr"] == logs["jax"]["lr"]
    for k, m in jt.state.masks.items():
        np.testing.assert_array_equal(tt.state.masks[".".join(k)].numpy(),
                                      np.asarray(m), err_msg=str(k))
        np.testing.assert_array_equal(
            tt.fired_masks[".".join(k)].numpy(),
            np.asarray(jt.fired_masks[k]))
    moved = sum(int((np.asarray(jt.fired_masks[k]) != np.asarray(m)).sum())
                for k, m in jt.state.masks.items())
    assert moved > 0, "no kernel grew"
