"""The global prune, its grow schedule and the DSFF trainer modes on the port
(e2enet_tpu_torch/training/{dsff,train_state,trainer}.py) against the JAX
package's on the same numpy weights (models/weights.from_jax_params):

- grow_schedule_ratio over the cases of tests/test_training_parity.py::
  test_grow_schedule_matches_reference, equal;
- truncate_weights_global with the reference's draws handed over (its
  _uniform_draws, transposed to the port's layout): masks equal to the
  bit, both stats entries equal;
- the Trainer per mode (ERK with the global prune and its schedule, GMP,
  the lottery ticket and uniform_ori with random growth) on the
  hand-made task of tests/test_torch_trainer.py, against the JAX
  TPUTrainer from the same weights and initial masks, the reference's
  mask-update draws handed to the port's updates: every train and
  validation loss within 1e-4 relative, the masks and fired masks equal
  to the bit after the run, the regrow ratio and the GMP densities the
  reference's. (Local gradient growth of single elements ranks |grad|
  from two implementations, whose near-ties may order apart over a run:
  tests/test_torch_dsff_element.py holds it on the same gradients.)
- element-masked checkpoints continued across the packages both ways,
  masks and fired masks equal to the bit;
- the refusals the JAX trainer makes (the global prune on kernel masks,
  a granularity the init does not make), raised at initialize.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import chip_smoke  # noqa: E402
from e2enet_tpu.plans import Plans as JPlans  # noqa: E402
from e2enet_tpu.training import dsff as jd  # noqa: E402
from e2enet_tpu.training.trainer import TPUTrainer  # noqa: E402
from e2enet_tpu_torch.models import masks as tm  # noqa: E402
from e2enet_tpu_torch.models.weights import from_jax_params  # noqa: E402
from e2enet_tpu_torch.plans import Plans  # noqa: E402
from e2enet_tpu_torch.training import dsff as td  # noqa: E402
from e2enet_tpu_torch.training import train_state as tts  # noqa: E402
from e2enet_tpu_torch.training.trainer import Trainer  # noqa: E402
from test_torch_dsff_element import (_assert_masks_equal,  # noqa: E402
                                     _element_draws, _grads, _setup,
                                     _to_port)

LOSS_RTOL = 1e-4
CASES = {f"case_{i:03d}": (20, 24, 22) for i in range(6)}
KW_T = dict(fold=0, base_num_features=6, fp16=False, max_num_epochs=2,
            num_batches_per_epoch=2, num_val_batches_per_epoch=1, seed=0)
MODES = {
    "ERK_global": dict(sparse_init="ERK", prune_mode="global",
                       growth="gradient", density=0.3, final_density=0.2,
                       final_prune_epoch=2, update_frequency=2),
    "GMP": dict(sparse_init="GMP", density=0.3, final_density=0.3,
                init_prune_epoch=0, final_prune_epoch=1),
    "lottery_ticket": dict(sparse_init="lottery_ticket", density=0.3,
                           final_density=0.3, growth="random",
                           update_frequency=2),
    "uniform_ori": dict(sparse_init="uniform_ori", density=0.3,
                        final_density=0.3, growth="random",
                        update_frequency=1),
}


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_grow_schedule_matches_reference():
    """The cases of test_training_parity's schedule test, the live counts
    of seeded masks: the port's ratio equal to the reference's at every
    update, the latch carried along."""
    rng = np.random.RandomState(7)
    update_freq, iters_per_epoch = 5, 10
    for density, final_density in [(0.3, 0.05), (0.5, 0.2), (0.2, 0.1),
                                   (0.1, 0.3)]:
        m = rng.rand(12, 8, 1, 3, 3) < density
        tw, tn = float(m.size), float(m.sum())
        prev_t = prev_j = 1.01
        for steps in range(update_freq, update_freq * 20, update_freq):
            args = (steps, update_freq, iters_per_epoch, density,
                    final_density, 0.5, tw, tn, tn / tw)
            got = td.grow_schedule_ratio(*args, prev_t, 0, 8)
            want = jd.grow_schedule_ratio(*args, prev_j, 0, 8)
            assert got == want, (steps, density, got, want)
            prev_t, prev_j = got, want


@pytest.mark.parametrize("rate, regrow", [(0.4, 0.9), (0.3, 1.6),
                                          (0.5, 1.0)])
def test_truncate_weights_global_matches_reference(rate, regrow):
    params, masks, net = _setup(20 + int(rate * 10), density=0.35,
                                mode="ERK")
    grads = _grads(params, 21)
    key = jax.random.PRNGKey(22)
    draws = _element_draws(key, masks)
    uniform = {k: np.asarray(draws[".".join(k)].numpy().transpose(
        {4: (2, 3, 1, 0), 5: (2, 3, 4, 0, 1)}[v.ndim]))
        for k, v in masks.items()}
    want, wstats = jd.truncate_weights_global(
        params, grads, masks, key, jnp.float32(rate), jnp.float32(regrow),
        _uniform_draws=uniform)
    tmasks = {".".join(k): _to_port(m) for k, m in masks.items()}
    got, stats = td.truncate_weights_global(
        net, tmasks, rate, regrow, from_jax_params(grads), draws=draws)
    _assert_masks_equal(got, want)
    assert stats["total_death"] == int(wstats["total_death"]) > 0
    assert stats["total_grown"] == int(wstats["total_grown"]) > 0
    # the port's own draws: the budget's count within 5 sigma
    state = tts.create_train_state(net, tmasks)
    update = tts.make_mask_update_step(net, "gradient", "global", "element")
    before = sum(float(m.sum()) for m in tmasks.values())
    state = update(state, rate, from_jax_params(grads), regrow)
    after = sum(float(m.sum()) for m in state.masks.values())
    total = sum(m.numel() for m in tmasks.values())
    p = regrow * before * rate / (total - before)
    grown = after - (before - stats["total_death"])
    sigma = np.sqrt((total - before) * p * (1 - p))
    assert abs(grown - regrow * before * rate) <= 5 * sigma
    for n, m in state.masks.items():
        assert float((state.params[n].detach() * (1 - m)).abs().max()) == 0
        assert float((state.momentum[n] * (1 - m)).abs().max()) == 0


# ---- the trainer per mode, against the JAX trainer
@pytest.fixture(scope="module")
def task(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("dsff_global"))
    paths = chip_smoke.write_train_task(base, "Task774_Dsff", CASES,
                                        (16, 16, 16), [[2, 2, 2]] * 2, 3)
    return base, paths["task"]


def _plans_file(task_dir):
    return os.path.join(task_dir, "nnUNetPlansv2.1_plans_3D.json")


def _record(trainer, log):
    real = trainer.run_iteration

    def spy(gen, lr, do_backprop=True, run_online_evaluation=False):
        out = real(gen, lr, do_backprop, run_online_evaluation)
        log["train" if do_backprop else "val"].append(
            float(np.asarray(out)))
        return out
    trainer.run_iteration = spy


def _masks_of(jmasks):
    return {".".join(k): _to_port(m) for k, m in jmasks.items()}


class _Fed:
    """Hands the reference's mask-update draws, recorded in order, to the
    port's updates (dsff.death_growth_update's random growth and
    truncate_weights_global, patched on the module for the port's run)."""

    def __init__(self):
        self.draws = []
        self.real = (td.death_growth_update, td.truncate_weights_global)

    def record(self, jt):
        """Record each update's draws from the JAX state's key before the
        jitted update splits it (make_mask_update_step, train_state.py:253;
        one split per masked kernel in sorted order after that)."""
        real = jt.mask_update

        def spy(state, *args):
            _, sub = jax.random.split(state.rng)
            self.draws.append(_element_draws(sub, state.masks))
            return real(state, *args)
        jt.mask_update = spy

    def __enter__(self):
        dg, tw = self.real

        def death_growth(model, masks, death_rate, generator=None,
                         scores=None, granularity="row", growth="random",
                         grads=None):
            draws = self.draws.pop(0)
            return dg(model, masks, death_rate, None,
                      draws if growth == "random" else None, granularity,
                      growth, grads)

        def truncate(model, masks, death_rate, regrow_ratio, grads,
                     generator=None, draws=None):
            return tw(model, masks, death_rate, regrow_ratio, grads,
                      draws=self.draws.pop(0))
        td.death_growth_update, td.truncate_weights_global = (death_growth,
                                                              truncate)
        return self

    def __exit__(self, *exc):
        td.death_growth_update, td.truncate_weights_global = self.real


@pytest.fixture(scope="module")
def runs(task):
    """Per mode: the JAX trainer and the port's, from the same weights and
    initial masks, with their logs. The JAX trainers after the first reuse
    its compiled train, eval and gradient steps (the same network and
    mask shapes)."""
    base, task_dir = task
    out, first = {}, None
    for mode, cfg in MODES.items():
        logs = {k: {"train": [], "val": []} for k in ("jax", "port")}
        jt = TPUTrainer(JPlans.load(_plans_file(task_dir)),
                        output_folder=os.path.join(base, "jax_" + mode),
                        dataset_directory=task_dir,
                        dsff_config=jd.DSFFConfig(sparse=True, **cfg),
                        **KW_T)
        jt.initialize(True)
        if first is None:
            first = jt
        else:
            jt.train_step, jt.eval_step = first.train_step, first.eval_step
            if jt._dsff_grad_step is not None:
                jt._dsff_grad_step = first._dsff_grad_step
        p0 = jax.tree_util.tree_map(lambda a: np.array(a, copy=True),
                                    jt.state.params)
        m0 = {k: np.array(v, copy=True) for k, v in jt.state.masks.items()}
        fed = _Fed()
        fed.record(jt)
        _record(jt, logs["jax"])
        jt.run_training()
        tt = Trainer(Plans.load(_plans_file(task_dir)),
                     output_folder=os.path.join(base, "port_" + mode),
                     dataset_directory=task_dir, device="cpu",
                     dsff_config=td.DSFFConfig(sparse=True, **cfg), **KW_T)
        tt.initialize(True)
        assert tt.mask_granularity == jt.mask_granularity == "element"
        tt.network.load_state_dict(from_jax_params(p0), strict=True)
        tt.state.masks = _masks_of(m0)
        tt.fired_masks = {k: v.clone() for k, v in tt.state.masks.items()}
        tts.mask_opt_state(tt.state.momentum, tt.state.masks)
        _record(tt, logs["port"])
        with fed:
            tt.run_training()
        assert not fed.draws
        out[mode] = (jt, tt, logs)
    return out


@pytest.mark.parametrize("mode", list(MODES))
def test_trainer_mode_matches_reference(runs, mode):
    jt, tt, logs = runs[mode]
    assert len(logs["port"]["train"]) == 4 and len(logs["port"]["val"]) == 2
    np.testing.assert_allclose(logs["port"]["train"], logs["jax"]["train"],
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(logs["port"]["val"], logs["jax"]["val"],
                               rtol=LOSS_RTOL)
    _assert_masks_equal(tt.state.masks, jt.state.masks)
    _assert_masks_equal(tt.fired_masks, jt.fired_masks)
    for n, m in tt.state.masks.items():
        for t in (tt.state.params[n].detach(), tt.state.momentum[n]):
            assert float((t * (1.0 - m)).abs().max()) == 0.0, n
    dens = tm.masks_density(tt.state.masks, tt.network)
    assert dens == pytest.approx(float(jd.masks_density(
        jt.state.masks, jt.state.params)), rel=1e-6)
    if mode == "ERK_global":
        assert tt._regrow_ratio == pytest.approx(jt._regrow_ratio,
                                                 rel=1e-9)
        assert tt._regrow_ratio != 1.01
    if mode == "GMP":
        assert dens < 0.5
    log = open(tt.logger.log_file).read()
    if mode == "GMP":
        assert log.count("GMP prune at epoch") == 2
        assert "DSFF update" not in log
    else:
        assert "DSFF update at step" in log
        assert ("regrow_ratio=" in log) == (mode == "ERK_global")


def _assert_states_cross(jstate, jfired, tstate, tfired):
    want = from_jax_params(jax.tree_util.tree_map(np.asarray,
                                                  jstate.params))
    for n, p in tstate.params.items():
        assert torch.equal(p.detach(), want[n]), n
    _assert_masks_equal(tstate.masks, jstate.masks)
    _assert_masks_equal(tfired, jfired)
    assert int(jstate.step) == int(tstate.step)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_element_checkpoint_continues_across_packages(runs, task, writer):
    """The ERK + global run's final checkpoint of one package loads in the
    other: parameters, element masks and fired masks equal to the bit."""
    base, task_dir = task
    jt, tt, _ = runs["ERK_global"]
    cfg = MODES["ERK_global"]
    if writer == "port":
        jt2 = TPUTrainer(JPlans.load(_plans_file(task_dir)),
                         output_folder=os.path.join(base, "jax_cont"),
                         dataset_directory=task_dir,
                         dsff_config=jd.DSFFConfig(sparse=True, **cfg),
                         **KW_T)
        jt2.load_checkpoint_file(tt.checkpoint_path("final_checkpoint"),
                                 train=False)
        _assert_states_cross(jt2.state, jt2.fired_masks, tt.state,
                             tt.fired_masks)
    else:
        tt2 = Trainer(Plans.load(_plans_file(task_dir)),
                      output_folder=os.path.join(base, "port_cont"),
                      dataset_directory=task_dir, device="cpu",
                      dsff_config=td.DSFFConfig(sparse=True, **cfg), **KW_T)
        tt2.load_checkpoint_file(jt.checkpoint_path("final_checkpoint"),
                                 train=False)
        _assert_states_cross(jt.state, jt.fired_masks, tt2.state,
                             tt2.fired_masks)
        assert tt2._regrow_ratio == 1.01    # not in the checkpoint


@pytest.mark.parametrize("cfg, match", [
    (dict(prune_mode="global"), "element-granular"),
    (dict(prune_mode="global", granularity="row"), "element-granular"),
    (dict(sparse_init="ERK", granularity="kernel"), "makes element"),
    (dict(granularity="element"), "makes kernel")])
def test_trainer_refuses_at_initialize(task, cfg, match):
    base, task_dir = task
    tt = Trainer(Plans.load(_plans_file(task_dir)),
                 output_folder=os.path.join(base, "refused"),
                 dataset_directory=task_dir, device="cpu",
                 dsff_config=td.DSFFConfig(sparse=True, **cfg), **KW_T)
    with pytest.raises(ValueError, match=match):
        tt.initialize(False)
