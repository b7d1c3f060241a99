"""The port's trainer (e2enet_tpu_torch/training/trainer.py) against the JAX
package's TPUTrainer on one tiny preprocessed task (chip_smoke.
write_train_task: six 20 x 24 x 22 cases, 3 classes, 16^3 patches, batch
2, two (2, 2, 2) pools), width 8, float32 (the JAX trainer on its XLA
path), the same seeds, the JAX trainer's initial parameters carried
across through models/weights.from_jax_params.

Both trainers read the same augmented batches (their pipelines draw from
numpy RandomStates seeded alike; tests/test_torch_data.py holds the data
to the bit). Over 2 epochs x 2 batches (2 validation batches each):
every iteration's train loss within 1e-4 relative; every validation
loss within 1e-4 relative and each epoch's online foreground Dice within
1e-4; the parameters after the run held per leaf as
tests/test_torch_train_step.py holds two dense steps (the change over
the run within DENSE_STEP2_RTOL of the reference's in relative L2, the
biases ahead of an instance norm by its rule). Checkpoints cross-load
both ways with the parameters, momentum, masks, step and histories equal
to the bit. Kernel-granular DSFF: the death set of each masked kernel
equal to the reference's kernel_death_survive on the same weights, the
whole update (the reference's draws fed in) equal to its
death_growth_update, alive counts held.
"""
import copy
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
from e2enet_tpu_torch.models.masks import broadcast_mask  # noqa: E402
from e2enet_tpu_torch.models.weights import (from_jax_params,  # noqa: E402
                                             to_jax_params)
from e2enet_tpu_torch.plans import Plans  # noqa: E402
from e2enet_tpu_torch.training import dsff as td  # noqa: E402
from e2enet_tpu_torch.training.trainer import Trainer  # noqa: E402
from e2enet_tpu_torch.utils.files import load_pickle  # noqa: E402
from test_torch_train_step import (DENSE_STEP2_RTOL,  # noqa: E402
                                   _bias_ahead_of_norm)

LOSS_RTOL = 1e-4
DICE_ATOL = 1e-4
BIAS_ZERO = 1e-4        # a bias's change / its block kernel's, both sides
CASES = {f"case_{i:03d}": (20, 24, 22) for i in range(6)}
KW = dict(fold=0, base_num_features=8, fp16=False, max_num_epochs=2,
          num_batches_per_epoch=2, num_val_batches_per_epoch=2, seed=0)


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two torch threads while this module runs (the suite runs its files
    side by side)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def task(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("trainer"))
    paths = chip_smoke.write_train_task(base, "Task777_Trainer", CASES,
                                        (16, 16, 16), [[2, 2, 2]] * 2, 3)
    return base, paths["task"]


def _plans_file(task_dir):
    return os.path.join(task_dir, "nnUNetPlansv2.1_plans_3D.json")


def _jax_trainer(task_dir, out, **kw):
    # remat at its default: TPUTrainer.initialize reads a local `jax`
    # bound only where remat is None (e2enet_tpu/training/trainer.py:196)
    return TPUTrainer(JPlans.load(_plans_file(task_dir)),
                      output_folder=out, dataset_directory=task_dir,
                      **{**KW, **kw})


def _port_trainer(task_dir, out, **kw):
    return Trainer(Plans.load(_plans_file(task_dir)), output_folder=out,
                   dataset_directory=task_dir, device="cpu", **{**KW, **kw})


def _record(trainer):
    """Each iteration's loss, by kind, as run_iteration returns it."""
    log = {"train": [], "val": []}
    real = trainer.run_iteration

    def spy(gen, lr, do_backprop=True, run_online_evaluation=False):
        out = real(gen, lr, do_backprop, run_online_evaluation)
        log["train" if do_backprop else "val"].append(
            float(np.asarray(out)))
        return out
    trainer.run_iteration = spy
    return log


def _numpy_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, copy=True), tree)


@pytest.fixture(scope="module")
def runs(task):
    """Both trainers' runs: (JAX trainer, its log, its initial params),
    (port trainer, its log)."""
    base, task_dir = task
    jt = _jax_trainer(task_dir, os.path.join(base, "jax"))
    jt.initialize(True)
    p0 = _numpy_tree(jt.state.params)
    jlog = _record(jt)
    jt.run_training()
    tt = _port_trainer(task_dir, os.path.join(base, "port"))
    tt.initialize(True)
    tt.network.load_state_dict(from_jax_params(p0), strict=True)
    tlog = _record(tt)
    tt.run_training()
    return jt, jlog, p0, tt, tlog


def test_losses_and_online_dice_match(runs):
    jt, jlog, _, tt, tlog = runs
    assert len(tlog["train"]) == 4 and len(tlog["val"]) == 4
    np.testing.assert_allclose(tlog["train"], jlog["train"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(tlog["val"], jlog["val"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(tt.all_tr_losses, jt.all_tr_losses,
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(tt.all_val_losses, jt.all_val_losses,
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(tt.all_val_eval_metrics,
                               jt.all_val_eval_metrics, atol=DICE_ATOL)
    assert tt.epoch == jt.epoch == 2
    assert int(tt.state.step) == int(jt.state.step) == 4
    assert tt.lr == pytest.approx(jt.lr)


def test_params_after_the_run_match(runs):
    """The change of every parameter over the run within DENSE_STEP2_RTOL
    of the reference's (relative L2, two float32 spacings a step of slack
    as test_torch_train_step allows); a bias ahead of an instance norm
    (its gradient rounding) moves by its weight decay alone: under
    BIAS_ZERO of its block kernel's change on both sides."""
    jt, _, p0, tt, _ = runs
    start = {k: v.numpy() for k, v in from_jax_params(p0).items()}
    want = {k: v.numpy() for k, v in from_jax_params(
        _numpy_tree(jt.state.params)).items()}
    got = {n: p.detach().numpy() for n, p in tt.state.params.items()}
    assert set(got) == set(want)
    for n in got:
        dg, dw = got[n] - start[n], want[n] - start[n]
        if _bias_ahead_of_norm(n):
            kernel = np.linalg.norm(want[n.replace(".bias", ".kernel")]
                                    - start[n.replace(".bias", ".kernel")])
            for d in (dg, dw):
                assert np.linalg.norm(d) <= BIAS_ZERO * kernel, n
            continue
        slack = 4.0 * np.linalg.norm(np.spacing(np.abs(want[n])))
        err = np.linalg.norm(dg - dw)
        assert err <= DENSE_STEP2_RTOL * np.linalg.norm(dw) + slack, (
            f"{n}: |diff| {err:.3e} > {DENSE_STEP2_RTOL} x "
            f"{np.linalg.norm(dw):.3e}")


def _assert_states_equal(jstate, tstate, masks=True):
    """A JAX TrainState and a port TrainState, to the bit."""
    for what, jtree, ttree in (("params", jstate.params, tstate.params),
                               ("momentum", jstate.momentum,
                                tstate.momentum)):
        want = from_jax_params(_numpy_tree(jtree))
        assert set(want) == set(ttree), what
        for n, t in ttree.items():
            np.testing.assert_array_equal(t.detach().numpy(),
                                          want[n].numpy(),
                                          err_msg=f"{what} {n}")
    assert int(jstate.step) == int(tstate.step)
    np.testing.assert_array_equal(np.asarray(jstate.rng), tstate.rng)
    if masks:
        assert (jstate.masks is None) == (tstate.masks is None)
        if tstate.masks is not None:
            assert {".".join(k) for k in jstate.masks} == set(tstate.masks)
            for k, m in jstate.masks.items():
                np.testing.assert_array_equal(
                    tstate.masks[".".join(k)].numpy(), np.asarray(m))


def _assert_histories_equal(jt, tt):
    for k in ("epoch", "all_tr_losses", "all_val_losses",
              "all_val_eval_metrics", "best_val_eval_criterion_MA",
              "val_eval_criterion_MA"):
        assert getattr(jt, k) == getattr(tt, k), k


def test_port_checkpoint_continues_in_jax(runs, task):
    """The JAX trainer loads the port's final checkpoint: parameters and
    momentum (written in the flax layout through to_jax_params), step,
    key and histories equal to the bit; so does the port's own reload."""
    base, task_dir = task
    _, _, _, tt, _ = runs
    jt2 = _jax_trainer(task_dir, os.path.join(base, "jax_cont"))
    jt2.load_checkpoint_file(tt.checkpoint_path("final_checkpoint"),
                             train=False)
    _assert_states_equal(jt2.state, tt.state)
    _assert_histories_equal(jt2, tt)
    assert jt2.epoch == 2


def test_jax_checkpoint_continues_in_port(runs, task):
    base, task_dir = task
    jt, _, _, _, _ = runs
    tt2 = _port_trainer(task_dir, os.path.join(base, "port_cont"))
    tt2.load_checkpoint_file(jt.checkpoint_path("final_checkpoint"),
                             train=False)
    _assert_states_equal(jt.state, tt2.state)
    _assert_histories_equal(jt, tt2)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_dsff_checkpoint_cross_loads(task, writer):
    """Kernel-granular DSFF state across packages: masks by '|'-joined
    path, fired masks by '/'-joined path; the port's generator state in
    the metadata, which the JAX loader ignores."""
    base, task_dir = task
    cfg = dict(sparse=True, density=0.3, update_frequency=2)
    jt = _jax_trainer(task_dir, os.path.join(base, f"jdsff_{writer}"),
                      dsff_config=jd.DSFFConfig(**cfg))
    tt = _port_trainer(task_dir, os.path.join(base, f"tdsff_{writer}"),
                       dsff_config=td.DSFFConfig(**cfg))
    jt.initialize(False)
    tt.initialize(False)
    assert tt.mask_granularity == jt.mask_granularity == "kernel"
    if writer == "port":
        gen = torch.Generator().manual_seed(1)
        with torch.no_grad():
            for m in tt.state.momentum.values():
                m.normal_(generator=gen)
        tt.state.generator.manual_seed(123)
        torch.rand(3, generator=tt.state.generator)
        tt.state.step = 7
        tt.save_checkpoint("latest")
        jt.load_checkpoint_file(tt.checkpoint_path("latest"), train=False)
        _assert_states_equal(jt.state, tt.state)
        assert {"/".join(k) for k in jt.fired_masks} == {
            n.replace(".", "/") for n in tt.fired_masks}
        # the port's own reload restores its generator; the JAX trainer's
        # save keeps the state but not the port's metadata, and the port
        # then seeds its generator from the key
        tt2 = _port_trainer(task_dir, os.path.join(base, "tdsff_reload"),
                            dsff_config=td.DSFFConfig(**cfg))
        tt2.load_checkpoint_file(tt.checkpoint_path("latest"), train=False)
        assert torch.equal(tt2.state.generator.get_state(),
                           tt.state.generator.get_state())
        jt.save_checkpoint("again")
        tt3 = _port_trainer(task_dir, os.path.join(base, "tdsff_again"),
                            dsff_config=td.DSFFConfig(**cfg))
        tt3.load_checkpoint_file(jt.checkpoint_path("again"), train=False)
        _assert_states_equal(jt.state, tt3.state)
        key = np.asarray(jt.state.rng).astype(np.uint64)
        seeded = torch.Generator().manual_seed(int(key[0]) << 32
                                               | int(key[1]))
        assert torch.equal(tt3.state.generator.get_state(),
                           seeded.get_state())
    else:
        jt.save_checkpoint("latest")
        tt.load_checkpoint_file(jt.checkpoint_path("latest"), train=False)
        _assert_states_equal(jt.state, tt.state)
        for k, v in jt.fired_masks.items():
            np.testing.assert_array_equal(
                tt.fired_masks[".".join(k)].numpy(), np.asarray(v))


def test_kernel_granular_death_and_growth_match(task):
    """Kernel granularity on the same weights and masks: per masked kernel
    the death set of kernel_death_survive equal to the reference's, the
    update with the reference's draws fed in equal to its
    death_growth_update, the alive count of every kernel held; and the
    port's own update (make_mask_update_step) holds the counts and zeroes
    parameters and momentum where the masks are zero."""
    base, task_dir = task
    tt = _port_trainer(task_dir, os.path.join(base, "death"),
                       dsff_config=td.DSFFConfig(sparse=True, density=0.3))
    tt.initialize(False)
    params = to_jax_params(tt.network.state_dict())
    rng = np.random.RandomState(4)
    params = jax.tree_util.tree_map(
        lambda a: (a * (1.0 + rng.rand(*a.shape))).astype(np.float32),
        params)
    masks = jd.init_masks(params, 0.3, jax.random.PRNGKey(2))
    params = _numpy_tree(jd.apply_masks(params, masks))
    tt.network.load_state_dict(from_jax_params(params), strict=True)
    tmasks = {".".join(k): torch.from_numpy(np.array(m))
              for k, m in masks.items()}
    w = {n: p for n, p in tt.network.named_parameters()}
    sel = jd.select_masked(params)
    for dr in (0.5, 0.25):
        for k, m in masks.items():
            want, wd = jd.kernel_death_survive(jnp.asarray(sel[k]), m,
                                               jnp.float32(dr))
            got, gd = td.kernel_death_survive(w[".".join(k)],
                                              tmasks[".".join(k)], dr)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                          err_msg=".".join(k))
            assert gd == int(wd) and gd > 0
    key = jax.random.PRNGKey(3)
    want, _ = jd.death_growth_update(params, None, masks, key,
                                     jnp.float32(0.5), "random", "kernel")
    scores, sub = {}, key
    for k in sorted(masks):
        sub, s = jax.random.split(sub)
        scores[".".join(k)] = torch.from_numpy(np.asarray(
            jax.random.uniform(s, masks[k].shape)))
    got, stats = td.death_growth_update(tt.network, tmasks, 0.5,
                                        scores=scores, granularity="kernel")
    for k, m in want.items():
        np.testing.assert_array_equal(got[".".join(k)].numpy(),
                                      np.asarray(m))
        assert float(got[".".join(k)].sum()) == float(masks[k].sum())
    assert stats["total_death"] > 0
    # the port's own update on the trainer's state
    state = tt.state
    before = {n: float(m.sum()) for n, m in state.masks.items()}
    with torch.no_grad():
        for n, m in state.momentum.items():
            m.copy_(torch.randn(m.shape, generator=torch.Generator()
                                .manual_seed(5)))
    old = copy.deepcopy(state.masks)
    state = tt.mask_update(state, 0.5)
    assert any(not torch.equal(old[n], state.masks[n]) for n in old)
    for n, m in state.masks.items():
        assert float(m.sum()) == before[n]
        dead = broadcast_mask(1.0 - m, state.params[n])
        assert float((state.params[n].detach() * dead).abs().max()) == 0.0
        assert float((state.momentum[n] * dead).abs().max()) == 0.0


def test_unported_options_raise(task):
    base, task_dir = task
    out = os.path.join(base, "refused")
    # data parallel runs inside a process group (test_num_devices_two_
    # ranks); outside one it says how to launch; spatial parallel raises
    with pytest.raises(RuntimeError, match="launch"):
        _port_trainer(task_dir, out, num_devices=2)
    with pytest.raises(NotImplementedError, match=r"item 7 \(ii\)"):
        _port_trainer(task_dir, out, spatial_parallel=2)
    # the DSFF settings the reference trainer refuses, at initialize
    for kw, match in ((dict(sparse_init="snip"), "need a data batch"),
                      (dict(sparse_init="GraSP"), "need a data batch"),
                      (dict(prune_mode="global"), "element-granular"),
                      (dict(growth="momentum"), "unknown growth")):
        tt = _port_trainer(task_dir, out,
                           dsff_config=td.DSFFConfig(sparse=True, **kw))
        with pytest.raises(ValueError, match=match):
            tt.initialize(False)
    with pytest.raises(ValueError, match="XLA programs"):
        _port_trainer(task_dir, out, fused=True)
    # the cascade builds its trainer: one-hot input channels for the two
    # foreground labels; training asks for the previous stage's files
    tt = _port_trainer(task_dir, out, cascade=True)
    tt.initialize(False)
    assert tt.network.context0.block0.kernel.shape[1] == 3
    assert tt.da_params.move_last_seg_channel_to_data
    assert tt.da_params.all_segmentation_labels == [1, 2]
    with pytest.raises(AssertionError, match="segFromPrevStage"):
        _port_trainer(task_dir, out, cascade=True).initialize(True)


def _dummy_losses(task_dir, out, num_devices):
    """Two train iterations and one validation iteration of a dummy-load
    trainer: (train losses, validation loss, online tp/fp/fn)."""
    tr = _port_trainer(task_dir, out, dummy_load=True,
                       num_devices=num_devices)
    tr.initialize(True)
    losses = [float(tr.run_iteration(tr.tr_gen, 1e-2, True))
              for _ in range(2)]
    tr._online_tp, tr._online_fp, tr._online_fn = [], [], []
    val = float(tr.run_iteration(tr.val_gen, 1e-2, False, True))
    counts = [float(t.sum()) for t in (tr._online_tp[0], tr._online_fp[0],
                                       tr._online_fn[0])]
    return losses, val, counts


def _rank_dummy_losses(task_dir, out):
    torch.set_num_threads(2)
    return _dummy_losses(task_dir, out, 2)


def test_num_devices_two_ranks(task):
    """Trainer(num_devices=2) on two gloo ranks of one row each (dummy
    load: each rank draws the whole batch from the same seed and keeps its
    row): the same losses and online counts on both ranks, and as one
    device's on the whole batch, within 1e-5."""
    from e2enet_tpu_torch.parallel import mesh
    base, task_dir = task
    got = mesh.launch(_rank_dummy_losses, 2, "cpu", task_dir,
                      os.path.join(base, "two_ranks"))
    assert got[0] == got[1]
    want = _dummy_losses(task_dir, os.path.join(base, "one_rank"), None)
    np.testing.assert_allclose(got[0][0], want[0], rtol=1e-5)
    np.testing.assert_allclose(got[0][1], want[1], rtol=1e-5)
    assert got[0][2] == want[2]


def test_num_devices_takes_one_da_thread(task):
    """Data parallel needs the same seeded batches on every rank, which
    only one augmentation thread gives: several raise."""
    base, task_dir = task
    with pytest.raises(ValueError, match="num_da_threads=2"):
        _port_trainer(task_dir, os.path.join(base, "threads"),
                      num_devices=2, num_da_threads=2)


@pytest.mark.parametrize("kw, dsff_kw", [
    (dict(optimizer="ranger"), None),
    (dict(optimizer="adam", lr_schedule="plateau"), None),
    (dict(lr_schedule="warmup", momentum_schedule="reduce",
          loss_schedule="ce_to_dice"), None),
    (dict(loss_name="gdl_ce", loss_kwargs={"smooth": 1e-5}),
     dict(growth="gradient", granularity="kernel")),
    (dict(optimizer="ranger"), dict(growth="gradient", granularity="row"))])
def test_ported_options_run(task, kw, dsff_kw):
    """The options that raised before they were ported (the optimizers,
    schedules, losses and gradient growth) now build and take a step."""
    base, task_dir = task
    cfg = None if dsff_kw is None else td.DSFFConfig(
        sparse=True, density=0.3, update_frequency=1, **dsff_kw)
    tt = _port_trainer(task_dir, os.path.join(base, "options"),
                       dsff_config=cfg, **kw)
    tt.initialize(True)
    tt.maybe_update_lr(0)
    loss = tt.run_iteration(tt.tr_gen, tt.lr, True)
    tt.tr_gen.stop()
    tt.val_gen.stop()
    assert np.isfinite(float(loss)) and tt.state.step == 1
    if cfg is not None:
        assert tt._dsff_grad_step is not None
    if kw.get("optimizer", "sgd") != "sgd":
        assert tt.state.momentum.step == 1


def test_device_augment_trains(task):
    """device_augment=True, refused before it was ported: 2 epochs of 2
    steps on the CPU from raw batches (the training pipeline raw at the
    generator patch, the validation pipeline augmented on the host), each
    augmented by ops/device_augment.py into channels-last data at the
    patch and int64 targets at the deep-supervision shapes; finite
    losses; the DSFF update reads the augmented batch."""
    base, task_dir = task
    cfg = td.DSFFConfig(sparse=True, density=0.3, update_frequency=2,
                        growth="gradient", granularity="kernel")
    tt = _port_trainer(task_dir, os.path.join(base, "device_augment"),
                       device_augment=True, dsff_config=cfg)
    tt.initialize(True)
    assert tt.tr_gen.raw and not tt.val_gen.raw
    raw = next(tt.tr_gen)
    assert set(raw) == {"data", "seg"}
    assert raw["data"].shape == (2, 1) + tuple(
        int(i) for i in tt.basic_generator_patch_size)
    seen, dsff_batches = [], []
    real_aug, real_grad = tt.device_aug, tt._dsff_grad_step

    def aug(gen, noise_gen, data, seg):
        out = real_aug(gen, noise_gen, data, seg)
        seen.append((data.dtype, seg.dtype, out))
        return out

    def grad(data, targets):
        dsff_batches.append((data, targets))
        return real_grad(data, targets)
    tt.device_aug, tt._dsff_grad_step = aug, grad
    tt.run_training()
    assert len(seen) == 4
    for dtype, seg_dtype, (data, targets) in seen:
        assert (dtype, seg_dtype) == (torch.float32, torch.int8)
        assert data.shape == (2, 16, 16, 16, 1)
        assert [tuple(t.shape) for t in targets] == [
            (2, 16, 16, 16), (2, 8, 8, 8)]
        assert all(t.dtype == torch.int64 for t in targets)
    assert [id(b[0]) for b in dsff_batches] == [id(seen[1][2][0]),
                                                id(seen[3][2][0])]
    assert np.all(np.isfinite(tt.all_tr_losses + tt.all_val_losses))


@pytest.mark.parametrize("granularity", ["kernel", "row"])
def test_growth_keeps_the_alive_count_on_tied_draws(granularity):
    """Draws that tie at the growth threshold (float32 draws over the
    ~10^5 dead pairs of a bench-width kernel do): the port revives exactly
    as many pairs as it killed, the lowest-indexed of the tied; without a
    tie it revives the reference's set."""
    cin, cout = 12, 10
    rng = np.random.RandomState(0)
    w = torch.from_numpy(rng.rand(cout, cin, 3, 3).astype(np.float32) + 0.1)
    if granularity == "kernel":
        mask = torch.from_numpy((rng.rand(cin, cout) < 0.5)
                                .astype(np.float32))
        draws = torch.full((cin, cout), 0.5)
        fn = td.layer_death_growth
    else:
        mask = torch.from_numpy(np.repeat((np.arange(cin) % 2 == 0)[:, None],
                                          cout, 1).astype(np.float32))
        draws = torch.full((cin,), 0.5)
        fn = td.layer_death_growth_row
    w = w * broadcast_mask(mask, w)
    new, killed = fn(w, mask, 0.5, scores=draws)
    assert killed > 0
    assert float(new.sum()) == float(mask.sum())
    # distinct draws: the top ones, as the reference's threshold picks
    distinct = torch.from_numpy(rng.permutation(draws.numel()).reshape(
        draws.shape).astype(np.float32))
    new2, _ = fn(w, mask, 0.5, scores=distinct)
    assert float(new2.sum()) == float(mask.sum())


@pytest.mark.parametrize("kw", [
    dict(seg_bias=True), dict(conv_kernel=(3, 3, 3)), dict(nonlin="relu"),
    dict(norm_op="batch")], ids=["seg_bias", "allConv3x3", "relu", "bn"])
def test_architecture_switches_train(task, kw):
    """The switches once refused for Queue 1 item 6 train: one epoch,
    finite losses, the network built with the switch, the checkpoint
    sidecar's init recording it under the JAX trainer's name, and the
    checkpoint restoring into a fresh trainer of the same switches."""
    base, task_dir = task
    out = os.path.join(base, "arch_" + "_".join(kw))
    tt = _port_trainer(task_dir, out, max_num_epochs=1,
                       num_batches_per_epoch=1, num_val_batches_per_epoch=1,
                       **kw)
    tt.initialize(True)
    tt.run_training()
    assert np.all(np.isfinite(tt.all_tr_losses + tt.all_val_losses))
    blk = tt.network.context0.block0
    assert (blk.kernel_size, blk.norm_op, blk.nonlin) == (
        kw.get("conv_kernel", (1, 3, 3)), kw.get("norm_op", "instance"),
        kw.get("nonlin", "lrelu"))
    assert tt.network.seg_head0.use_bias == kw.get("seg_bias", False)
    path = tt.checkpoint_path("final_checkpoint")
    init = load_pickle(path + ".pkl")["init"]
    for k, v in kw.items():
        assert init[k] == v
    again = _port_trainer(task_dir, out, max_num_epochs=1, **kw)
    again.load_checkpoint_file(path, train=False)
    for n, p in tt.network.state_dict().items():
        torch.testing.assert_close(again.network.state_dict()[n], p,
                                   rtol=0, atol=0)
