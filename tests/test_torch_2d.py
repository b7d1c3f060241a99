"""2D plans and shiftConvPP_noshift in the port against the JAX package, on
the same seeded numpy inputs and weights (models/weights.from_jax_params).

The shift off is one channel group of shift 0 at every kernel site, as the
reference's fused ops take it (e2enet_tpu/ops/fused_block.py:997-998,
qfused.py:1541-1542); a 2D plan (patch depth 1, pools (1, a, b)) builds
shiftConvPP_noshift and runs the materialised up-link route.

- build_network on a 2D stage and shiftConvPP_noshift on a 3D stage:
  names, shapes, a strict load, the divisibility; the float32 forward
  against the reference's XLA path in all 8 mirror passes (the port's
  mirrored model against the reference's model on mirrored data) and with
  deep supervision, within the 1e-3 of tests/test_torch_unetpp.py.
- shiftConvPP_noshift on the reference's quadrant kernels in interpret
  mode, float32, within 1e-3. XLA:CPU cannot run the reference's bfloat16
  model (no bf16 x bf16 -> f32 dot outside the kernels), so the port's
  bfloat16 plain path (the lazy up-link route with the one-group table)
  is held to that float32 output by bf16 steps of the largest |logit|:
  at most BF16_MAX_STEPS in max, BF16_MEAN_STEPS in mean, and equal to
  its own materialised route to the bit.
- The ops with the one-group table: the fused block's plain version and
  its backward at D = 1 and D > 1 against the reference's Pallas block
  (interpret mode) and its XLA backward with do_shift=False, float32,
  1e-4 of the largest |value| (tests/test_torch_fused_block_bwd.py's
  rule); the strided transition at stride (1, 2, 2) against
  quadrant_strided_fused with do_shift=False, 1e-4.
- The trainers on a 2D task (chip_smoke.write_train_task: six 20 x 24 x 22
  cases, patch (1, 16, 16), two (1, 2, 2) pools, batch 4, width 8,
  float32, batch_dice False as the CLIs set it for 2d): the same
  generator patch, the first batches equal to the bit, and one train step
  from the JAX trainer's initial weights: the loss within 1e-5 relative
  and every step-1 gradient within tests/test_torch_train_step.py's
  GRAD_RTOL per leaf. Checkpoints of the 2D fold and of
  shiftConvPP_noshift load in the other package equal to the bit, with
  the sidecar (Tconv, plans) the JAX trainer writes.
The users' 2D chain from raw data: tests/test_torch_2d_chain.py.
"""
import itertools
import os
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import chip_smoke  # noqa: E402
import e2enet_tpu.plans as jplans  # noqa: E402
import e2enet_tpu_torch.inference.predictor as tpred  # noqa: E402
import e2enet_tpu_torch.models.unetpp as tunetpp  # noqa: E402
import e2enet_tpu_torch.ops.blocks as tblocks  # noqa: E402
import e2enet_tpu_torch.plans as tplans  # noqa: E402
from e2enet_tpu.models.unetpp import ShiftUNetPlusPlus as JaxNet  # noqa
from e2enet_tpu.models.unetpp import build_network as jbuild  # noqa: E402
from e2enet_tpu.ops import fused_block as jfb  # noqa: E402
from e2enet_tpu.ops import qfused as jqf  # noqa: E402
from e2enet_tpu.ops.qstride import QSStatic, quadrant_strided_fused  # noqa
from e2enet_tpu.training import checkpoint as jckpt  # noqa: E402
from e2enet_tpu.training.trainer import TPUTrainer  # noqa: E402
from e2enet_tpu_torch.models.weights import (from_jax_params,  # noqa: E402
                                             to_jax_params)
from e2enet_tpu_torch.ops import fused_block as tfb  # noqa: E402
from e2enet_tpu_torch.ops import qstride as tqs  # noqa: E402
from e2enet_tpu_torch.training import checkpoint as tckpt  # noqa: E402
from e2enet_tpu_torch.training.trainer import Trainer  # noqa: E402
from test_torch_predict import make_plans, numpy_params  # noqa: E402
from test_torch_train_step import (GRAD_RTOL, _assert_leaves,  # noqa: E402
                                   _bias_ahead_of_norm)
from test_torch_unetpp import _stage  # noqa: E402

FWD_TOL = 1e-3
OP_RTOL = 1e-4
BF16_MAX_STEPS = 4
BF16_MEAN_STEPS = 0.5
COMBOS = list(itertools.product([False, True], repeat=3))
# (pools, patch, Tconv, lazy route at bf16)
STAGES = {"2d": (((1, 2, 2), (1, 2, 2)), (1, 32, 32), "shiftConvPP", False),
          "noshift": (((2, 2, 2), (2, 2, 2)), (8, 16, 16),
                      "shiftConvPP_noshift", True)}


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two torch threads while this module runs (the suite runs its files
    side by side)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------- a. model

@pytest.mark.parametrize("name", sorted(STAGES))
def test_build_network_forward_matches_reference(name):
    pools, patch, tconv, lazy = STAGES[name]
    jnet = jbuild(_stage(jplans, pools, patch), 1, 3, tconv=tconv,
                  base_num_features=4, compute_dtype=jnp.float32)
    assert jnet.do_shift is False
    N = 3 if patch[0] == 1 else 1
    shape = (N, *patch, 1)
    params = {"params": numpy_params(jnet, patch, 1)}
    net = tunetpp.build_network(_stage(tplans, pools, patch), 1, 3,
                                tconv=tconv, base_num_features=4,
                                compute_dtype=torch.float32, device="cpu")
    want = from_jax_params(params)
    assert {k: tuple(v.shape) for k, v in net.state_dict().items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
    net.load_state_dict(want, strict=True)
    assert net.do_shift is False
    np.testing.assert_array_equal(net.input_shape_must_be_divisible_by,
                                  jnet.input_shape_must_be_divisible_by)
    bf16 = tunetpp.build_network(_stage(tplans, pools, patch), 1, 3,
                                 tconv=tconv, base_num_features=4,
                                 device="cpu")
    assert bf16.lazy_up_route() == lazy
    x = np.random.RandomState(2).randn(*shape).astype(np.float32)
    # one compiled reference: the mirrored model equals the model on
    # mirrored data, flip_c(net(flip_c(x)))
    apply = jax.jit(lambda p, v: jnet.apply(p, v, do_ds=False))
    for c in COMBOS:
        ax = tuple(a + 1 for a, f in enumerate(c) if f)
        xf = np.flip(x, ax) if ax else x
        ref = np.asarray(apply(params, jnp.asarray(np.ascontiguousarray(xf))))
        ref = np.flip(ref, ax) if ax else ref
        with torch.no_grad():
            out = net(torch.from_numpy(x), do_ds=False, flips=c)
        np.testing.assert_allclose(out.numpy(), ref, rtol=FWD_TOL,
                                   atol=FWD_TOL, err_msg=f"flips={c}")
    ref_ds = jnet.apply(params, jnp.asarray(x), do_ds=True)
    with torch.no_grad():
        out_ds = net(torch.from_numpy(x), do_ds=True)
    assert len(out_ds) == len(ref_ds) == 2
    for a, b in zip(out_ds, ref_ds):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=FWD_TOL,
                                   atol=FWD_TOL)


KWQ = dict(input_channels=1, num_classes=3,
           pool_op_kernel_sizes=((2, 2, 2),) * 2, base_num_features=4)
SHAPEQ = (1, 8, 8, 16, 1)


def test_noshift_matches_quadrant_kernel_path():
    flips = (True, False, True)
    params = {"params": numpy_params(JaxNet(**KWQ, compute_dtype=jnp.float32,
                                            remat=False, quadrant=False),
                                     SHAPEQ[1:4], 9)}
    x = np.random.RandomState(10).randn(*SHAPEQ).astype(np.float32)
    jnet = JaxNet(**KWQ, do_shift=False, compute_dtype=jnp.float32,
                  remat=False, fused=True, fused_interpret=True,
                  quadrant=True, quadrant_logits=True, flips=flips)
    lq = jnet.apply(params, jnp.asarray(x), do_ds=False)
    _, D, H, W, _ = SHAPEQ
    ref = np.asarray(jqf.from_quadrant_cf(lq, (2, 2, 2), H // 2, W // 2, 3))
    outs = {}
    for dtype in (torch.float32, torch.bfloat16):
        net = tunetpp.ShiftUNetPlusPlus(**KWQ, compute_dtype=dtype,
                                        do_shift=False, device="cpu")
        net.load_state_dict(from_jax_params(params), strict=True)
        with torch.no_grad():
            outs[dtype] = net(torch.from_numpy(x), do_ds=False,
                              flips=flips).float().numpy()
        if dtype == torch.bfloat16:
            calls = []
            real = tblocks.lazy_up_fused_block

            def spy(*a, **k):
                calls.append(a[-1])
                return real(*a, **k)
            tblocks.lazy_up_fused_block = spy
            try:
                with torch.no_grad():
                    lazy = net(torch.from_numpy(x), do_ds=False,
                               flips=flips).float().numpy()
            finally:
                tblocks.lazy_up_fused_block = real
            # the one-group table reaches the lazy block
            assert len(calls) == 2 and all(
                g[0][0] == 0 and {s for *_, s in g} == {0} for g in calls)
            net.lazy_up = False
            with torch.no_grad():
                mat = net(torch.from_numpy(x), do_ds=False,
                          flips=flips).float().numpy()
            np.testing.assert_array_equal(lazy, mat)
    np.testing.assert_allclose(outs[torch.float32], ref, rtol=FWD_TOL,
                               atol=FWD_TOL)
    step = 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7)
    err = np.abs(outs[torch.bfloat16] - ref)
    assert err.max() <= BF16_MAX_STEPS * step, (err.max(), step)
    assert err.mean() <= BF16_MEAN_STEPS * step, (err.mean(), step)


# ------------------------------------------------------------------ c. ops

def _rand(rng, *shape, scale=1.0, shift=0.0):
    return (rng.randn(*shape) * scale + shift).astype(np.float32)


# (N, D, H, W, part channels, pending affine per part, CO)
BLOCKS = {"d1": (3, 1, 6, 8, (5, 3), (True, False), 4),
          "d4": (1, 4, 5, 8, (6,), (True,), 5)}


@pytest.mark.parametrize("case", sorted(BLOCKS))
def test_fused_block_one_group_matches_reference(case, monkeypatch):
    """Forward (Pallas in interpret mode) and backward (the XLA VJP) of
    the reference's block with do_shift=False against the port's plain
    versions with the one-group table, every mirror of the depth."""
    monkeypatch.setattr(jfb, "_USE_PALLAS_BWD", False)
    N, D, H, W, part_c, affine, CO = BLOCKS[case]
    rng = np.random.RandomState(len(case))
    parts = [_rand(rng, N, D, H, W, c) for c in part_c]
    affs = [(_rand(rng, N, c, scale=0.3, shift=1.0),
             _rand(rng, N, c, scale=0.2)) if a else None
            for c, a in zip(part_c, affine)]
    C = sum(part_c)
    kernel = _rand(rng, CO, C, 3, 3, scale=0.3)
    bias = _rand(rng, CO, scale=0.1)
    gy = _rand(rng, N, D, H, W, CO)
    gstats = _rand(rng, N, CO, 2, scale=0.05)
    groups = tfb.shift_groups(C, False)
    assert groups == ((0, C, 0),)
    has = [a is not None for a in affs]
    flat = list(parts) + [kernel, bias] + [t for a in affs if a for t in a]
    Wp = jfb.choose_wp(H, W)
    for flips in ((False, False, False), (True, True, False)):
        def loss(*fl):
            P = len(parts)
            ps, (k, b), rest = fl[:P], fl[P:P + 2], list(fl[P + 2:])
            jaff = [(rest.pop(0), rest.pop(0)) if h else None for h in has]
            cf = [jfb.to_padded_cf(p, W, Wp) for p in ps]
            y, stats = jfb.fused_shift_conv_block(
                cf, jnp.transpose(k, (2, 3, 1, 0)), b, jaff, H, W,
                do_shift=False, interpret=True, flips=flips)
            y = jfb.from_padded_cf(y, H, W)
            return jnp.sum(y * gy) + jnp.sum(stats * gstats), (y, stats)
        (_, (ref_y, ref_s)), want = jax.value_and_grad(
            loss, argnums=tuple(range(len(flat))), has_aux=True)(
                *[jnp.asarray(a) for a in flat])
        t = [torch.from_numpy(a).requires_grad_() for a in flat]
        tp, (tk, tb), rest = t[:len(parts)], t[len(parts):len(parts) + 2], \
            list(t[len(parts) + 2:])
        ta = [(rest.pop(0), rest.pop(0)) if h else None for h in has]
        y, stats = tfb.fused_shift_conv_block(tp, tk, tb, ta, flips, groups)
        got = torch.autograd.grad(
            (y * torch.from_numpy(gy)).sum()
            + (stats * torch.from_numpy(gstats)).sum(), t)
        for a, b in [(y.detach().numpy(), ref_y),
                     (stats.detach().numpy(), ref_s)] + [
                (g.numpy(), w) for g, w in zip(got, want)]:
            b = np.asarray(b)
            assert a.shape == b.shape
            np.testing.assert_allclose(a, b, rtol=0, atol=OP_RTOL * float(
                np.abs(b).max()) + 1e-12, err_msg=f"flips={flips}")


@pytest.mark.parametrize("flips", [(False, False, False), (True, True, True)])
def test_strided_one_group_matches_reference(flips):
    """The strided transition at stride (1, 2, 2) without the shift, D = 1
    and D = 3, against quadrant_strided_fused with do_shift=False."""
    for D in (1, 3):
        rng = np.random.RandomState(D)
        N, H, W, C, CO = 2, 8, 8, 12, 6
        x = _rand(rng, N, D, H, W, C)
        mult = _rand(rng, N, C, scale=0.5, shift=1.0)
        off = _rand(rng, N, C, scale=0.3)
        kern = _rand(rng, 3, 3, C, CO, scale=0.3)          # HWIO
        bias = _rand(rng, CO, scale=0.2)
        q = (1, 2, 2)
        Hq, Wq = H // 2, W // 2
        Wqp = jqf.choose_wqp(Hq, Wq)
        static = QSStatic(q, C, CO, D, Hq, Wq, Wqp, 5, False, True, flips)
        y, s = quadrant_strided_fused(
            jqf.to_quadrant_cf(jnp.asarray(x), q, Wqp), jnp.asarray(mult),
            jnp.asarray(off), jnp.asarray(kern), jnp.asarray(bias), static)
        ref_y = np.asarray(jqf.from_quadrant_cf(y, (1, 1, 1), Hq, Wq, CO))
        with torch.no_grad():
            ty, ts = tqs.strided_fused(
                torch.from_numpy(x), torch.from_numpy(mult),
                torch.from_numpy(off),
                torch.from_numpy(kern.transpose(3, 2, 0, 1).copy()),
                torch.from_numpy(bias), q, flips, ((0, C, 0),))
        np.testing.assert_allclose(ty.numpy(), ref_y, rtol=OP_RTOL,
                                   atol=OP_RTOL)
        np.testing.assert_allclose(ts.numpy(), np.asarray(s), rtol=OP_RTOL,
                                   atol=OP_RTOL * np.abs(ref_y).sum())


# ----------------------------------------------- d-f. trainers, checkpoints

TASK = "Task776_Tiny2D"
CASES = {f"case_{i:03d}": (20, 24, 22) for i in range(6)}
KW = dict(fold=0, base_num_features=8, fp16=False, max_num_epochs=1,
          num_batches_per_epoch=2, num_val_batches_per_epoch=1, seed=0,
          batch_dice=False)
LR = 0.01


@pytest.fixture(scope="module")
def trainers(tmp_path_factory):
    """Both trainers on the 2D task: the first two batches of each
    pipeline, then one train step each from the JAX trainer's initial
    weights: (JAX trainer, its initial params, port trainer, batches,
    losses)."""
    base = str(tmp_path_factory.mktemp("trainer2d"))
    paths = chip_smoke.write_train_task(base, TASK, CASES, (1, 16, 16),
                                        [[1, 2, 2]] * 2, 3, batch_size=4)
    plans_file = os.path.join(paths["task"], "nnUNetPlansv2.1_plans_3D.json")
    jt = TPUTrainer(jplans.Plans.load(plans_file),
                    output_folder=os.path.join(base, "jax"),
                    dataset_directory=paths["task"], **KW)
    jt.initialize(True)
    p0 = jax.tree_util.tree_map(lambda a: np.array(a, copy=True),
                                jt.state.params)
    tt = Trainer(tplans.Plans.load(plans_file),
                 output_folder=os.path.join(base, "port"),
                 dataset_directory=paths["task"], device="cpu", **KW)
    tt.initialize(True)
    tt.network.load_state_dict(from_jax_params(p0), strict=True)
    batches = [[next(t.tr_gen) for _ in range(2)] for t in (tt, jt)]
    losses = [float(np.asarray(t.run_iteration(t.tr_gen, LR)))
              for t in (tt, jt)]
    yield jt, p0, tt, batches, losses
    for t in (tt, jt):
        t.tr_gen.stop()
        t.val_gen.stop()


def test_2d_trainer_batches_equal(trainers):
    jt, _, tt, (tb, jb), _ = trainers
    assert not tt.network.do_shift and not tt.batch_dice
    np.testing.assert_array_equal(tt.basic_generator_patch_size,
                                  jt.basic_generator_patch_size)
    assert tt.da_params.do_dummy_2D == jt.da_params.do_dummy_2D
    for a, b in zip(tb, jb):
        assert a["data"].shape == (4, 1, 1, 16, 16)
        np.testing.assert_array_equal(a["data"], b["data"])
        assert len(a["target"]) == len(b["target"]) == 2
        for x, y in zip(a["target"], b["target"]):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)


def test_2d_train_step_matches_reference(trainers):
    """The loss and each step-1 gradient (the momentum less the weight
    decay's term: the norm is under the clip) of one step."""
    jt, p0, tt, _, (loss_t, loss_j) = trainers
    np.testing.assert_allclose(loss_t, loss_j, rtol=1e-5)
    port_p0 = {k: v.numpy() for k, v in from_jax_params(p0).items()}
    want = {k: v.numpy() for k, v in from_jax_params(
        jax.tree_util.tree_map(np.asarray, jt.state.momentum)).items()}
    got = {n: m.numpy() for n, m in tt.state.momentum.items()}
    names = [n for n in port_p0 if not _bias_ahead_of_norm(n)]
    _assert_leaves(got, want, GRAD_RTOL, "step-1 momentum", names)


def _flat(tree, prefix=()):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def test_2d_checkpoints_cross_load(trainers, tmp_path):
    """The 2D fold's checkpoint each trainer writes loads in the other
    package equal to the bit, with the same sidecar."""
    jt, _, tt, _, _ = trainers
    tt.save_checkpoint("latest")
    jt.save_checkpoint("latest")
    state, epoch, _ = jckpt.load_checkpoint(tt.checkpoint_path("latest"))
    mine = to_jax_params({n: p.detach() for n, p in tt.state.params.items()})
    a, b = list(_flat(mine)), list(_flat(jax.tree_util.tree_map(
        np.asarray, state.params)))
    assert [k for k, _ in a] == [k for k, _ in b]
    for (k, x), (_, y) in zip(a, b):
        np.testing.assert_array_equal(x, y, err_msg="/".join(k))
    tstate, _, _ = tckpt.load_checkpoint(jt.checkpoint_path("latest"))
    net = tunetpp.build_network(tt.stage_plan, 1, 3, base_num_features=8,
                                compute_dtype=torch.float32, device="cpu")
    net.load_state_dict(from_jax_params(tstate["params"]), strict=True)
    for (k, x), (_, y) in zip(_flat(tstate["params"]), _flat(
            jax.tree_util.tree_map(np.asarray, jt.state.params))):
        np.testing.assert_array_equal(x, y, err_msg="/".join(k))
    sides = []
    for t in (tt, jt):
        with open(t.checkpoint_path("latest") + ".pkl", "rb") as f:
            sides.append(pickle.load(f))
    assert sides[0]["init"] == sides[1]["init"]
    assert sides[0]["init"]["tconv"] == "shiftConvPP"
    assert sides[0]["plans"] == sides[1]["plans"]
    assert sides[0]["name"] == sides[1]["name"] == "TPUTrainer"


def test_noshift_checkpoint_cross_loads(tmp_path):
    """A shiftConvPP_noshift checkpoint the JAX package writes loads in the
    port's model bundle (build_network by the Tconv of its name), and the
    port's checkpoint of it in the JAX package, equal to the bit."""
    from e2enet_tpu.training.train_state import create_train_state
    from test_torch_predict import NUM_FG, WIDTH
    pools, patch = [[2, 2, 2], [2, 2, 2]], [8, 16, 16]
    plans = make_plans(pools, patch)
    jnet = jbuild(plans.plans_per_stage[0], 1, NUM_FG + 1,
                  tconv="shiftConvPP_noshift", base_num_features=WIDTH,
                  compute_dtype=jnp.float32)
    params = numpy_params(jnet, patch, 3)
    fold = tmp_path / "fold_0"
    fold.mkdir()
    name = "shiftConvPP_noshift_model_final_checkpoint.model"
    jckpt.save_checkpoint(str(fold / name), create_train_state(params), 2,
                          {"all_tr_losses": [0.5]},
                          {"init": {"stage": 0, "base_num_features": WIDTH,
                                    "tconv": "shiftConvPP_noshift"},
                           "name": "TPUTrainer", "class": "T",
                           "plans": plans.to_dict()})
    bundle = tpred.ModelBundle(str(tmp_path), [0], "shiftConvPP_noshift",
                               compute_dtype=torch.float32, device="cpu")
    net = bundle.fold_models[0]
    assert net.do_shift is False
    want = from_jax_params(jax.tree_util.tree_map(np.asarray, params))
    for k, v in net.state_dict().items():
        assert torch.equal(v, want[k]), k
    path = str(tmp_path / "port.model")
    tckpt.save_checkpoint(path, to_jax_params(net.state_dict()), 3,
                          sidecar={"init": {"stage": 0}, "plans": {}})
    state, epoch, _ = jckpt.load_checkpoint(path)
    assert epoch == 3
    for (k, x), (_, y) in zip(_flat(jax.tree_util.tree_map(
            np.asarray, params)), _flat(jax.tree_util.tree_map(
                np.asarray, state.params))):
        np.testing.assert_array_equal(x, y, err_msg="/".join(k))
