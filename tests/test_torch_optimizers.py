"""The port's optimizers (e2enet_tpu_torch/training/ranger.py, Adam in
training/train_state.py) against the reference's (e2enet_tpu/training/
ranger.py, train_state.py), and the cases of tests/test_optimizers.py on
the port.

- ranger_update and adam_update over 12 steps on identical float32 trees
  and gradients: every parameter and state leaf within 1e-6 relative L2
  after every step (both sides compute the step's scalars in float32 and
  the elementwise updates in the same order). Ranger crosses its
  n_sma threshold (no variance term before it) and Lookahead fires at
  steps 6 and 12.
- Adam against torch.optim.Adam(amsgrad=True).
- A masked train step per optimizer on the tiny model of
  test_torch_train_step.py (row masks at density 0.5, float32, the
  reference's XLA path): the loss within 1e-5 relative, the gradient norm
  within 1e-4, every optimizer leaf and the parameters' change within
  OPT_RTOL = 1e-4 relative L2 (leaves mapped through models/weights.py);
  a second step as test_torch_train_step.py holds its masked second step
  (MASKED_STEP2_RTOL: the port takes the fused levels' one-pass norm
  statistics, as the reference's fused path does, not its XLA path's two
  passes). The biases ahead of an instance norm are left out (their
  gradient is rounding, test_torch_train_step's rule, which Adam's and
  Ranger's normalised steps magnify). Adam's parameter change is held
  where the first gradient is at least ADAM_G_MIN = 100 eps (over 90 % of
  the alive entries): its first step is lr g / (|g| + eps), whose
  relative change with g is eps / |g|, and the deep levels of a
  random-weight model have gradient entries near eps whose rounding
  (float32 sums in another order) that step turns into 1e-3-scale
  changes; every Adam state leaf is held whole. Dead rows zero
  in the parameters and in every optimizer buffer.
- Checkpoints of a Ranger and an Adam state cross both ways equal to the
  bit (the port writes the JAX package's NamedTuple names without
  importing it; a process with jax blocked reads both packages' files).
"""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from e2enet_tpu.models.unetpp import ShiftUNetPlusPlus as JaxNet  # noqa
from e2enet_tpu.models.unetpp import ds_loss_weights  # noqa: E402
from e2enet_tpu.training import checkpoint as jckpt  # noqa: E402
from e2enet_tpu.training import dsff as jd  # noqa: E402
from e2enet_tpu.training import ranger as jranger  # noqa: E402
from e2enet_tpu.training import train_state as jts  # noqa: E402
from e2enet_tpu_torch.models.masks import broadcast_mask  # noqa: E402
from e2enet_tpu_torch.models.weights import from_jax_params  # noqa: E402
from e2enet_tpu_torch.training import checkpoint as tckpt  # noqa: E402
from e2enet_tpu_torch.training import ranger as tranger  # noqa: E402
from e2enet_tpu_torch.training import train_state as tts  # noqa: E402
from test_torch_train_step import (KW, LRS,  # noqa: E402
                                   MASKED_STEP2_RTOL, SHAPE, _batch,
                                   _bias_ahead_of_norm, _params,
                                   _port_model)

REPO = Path(__file__).resolve().parents[1]
UPDATE_RTOL = 1e-6
OPT_RTOL = 1e-4
ADAM_G_MIN = 1e-6
SHAPES = {"conv": (4, 3, 3, 3), "up": (3, 5, 2, 2, 2), "bias": (7,),
          "head": (4, 6)}


def _trees(seed):
    rng = np.random.RandomState(seed)
    return {k: rng.randn(*s).astype(np.float32) for k, s in SHAPES.items()}


def _rel(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("opt", ["ranger", "adam"])
def test_update_matches_reference_over_12_steps(opt):
    p0 = _trees(0)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    if opt == "ranger":
        jst, tst = jranger.ranger_init(jp), tranger.ranger_init(tp)
        jup, tup = jranger.ranger_update, tranger.ranger_update
    else:
        jst, tst = jts.adam_init(jp), tts.adam_init(tp)
        jup, tup = jts.adam_update, tts.adam_update
    use_var = []
    for i in range(12):
        g = _trees(100 + i)
        lr = 1e-2 * (1 - i / 12) ** 0.9
        jp, jst = jup(jp, jst, {k: jnp.asarray(v) for k, v in g.items()},
                      jnp.float32(lr), weight_decay=3e-5)
        tp, tst = tup(tp, tst, {k: torch.from_numpy(v) for k, v in
                                g.items()}, lr, weight_decay=3e-5)
        assert tst.step == int(jst.step) == i + 1
        for f in tst._fields:
            if f == "step":
                continue
            for k in SHAPES:
                assert _rel(getattr(tst, f)[k].numpy(), np.asarray(
                    getattr(jst, f)[k])) <= UPDATE_RTOL, (i, f, k)
        for k in SHAPES:
            assert _rel(tp[k].numpy(), np.asarray(jp[k])) <= UPDATE_RTOL
        if opt == "ranger":
            use_var.append(tranger.radam_scalars(i + 1, 0.95, 0.999, 5)[0])
    if opt == "ranger":
        # the variance term only past the threshold; Lookahead at 6, 12
        assert not use_var[0] and use_var[-1]
        for k in SHAPES:
            np.testing.assert_array_equal(tst.slow[k].numpy(),
                                          tp[k].numpy())


def test_adam_matches_torch():
    w0 = np.random.RandomState(1).randn(4, 3).astype(np.float32)
    tw = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    opt = torch.optim.Adam([tw], lr=1e-2, weight_decay=3e-5, amsgrad=True)
    params = {"w": torch.from_numpy(w0.copy())}
    st = tts.adam_init(params)
    for i in range(7):
        g = np.random.RandomState(10 + i).randn(4, 3).astype(np.float32)
        opt.zero_grad()
        tw.grad = torch.from_numpy(g.copy())
        opt.step()
        params, st = tts.adam_update(params, st, {"w": torch.from_numpy(g)},
                                     lr=1e-2, weight_decay=3e-5)
    np.testing.assert_allclose(params["w"].numpy(), tw.detach().numpy(),
                               atol=1e-6)


def _flat(tree):
    return {k: v.numpy() for k, v in from_jax_params(
        jax.tree_util.tree_map(np.asarray, tree)).items()}


def _opt_leaves_ref(opt, momentum):
    """{field: {port name: numpy}} of a reference optimizer state."""
    if opt == "sgd":
        return {"momentum": _flat(momentum)}
    return {f: _flat(getattr(momentum, f)) for f in momentum._fields
            if f != "step"}


def _opt_leaves_port(opt, momentum):
    if opt == "sgd":
        return {"momentum": {n: b.numpy().copy()
                             for n, b in momentum.items()}}
    return {f: {n: b.numpy().copy() for n, b in getattr(momentum, f).items()}
            for f in momentum._fields if f != "step"}


@pytest.fixture(scope="module")
def setup():
    params = _params(KW, SHAPE, 0)
    masks = jd.init_masks_row(params, 0.5, jax.random.PRNGKey(1),
                              density_48_override=0.5)
    x, targets = _batch(1, SHAPE, 3, 3)
    return params, masks, x, targets


@pytest.mark.parametrize("opt", ["sgd", "ranger", "adam"])
def test_masked_train_step_matches_reference(setup, opt):
    params, masks, x, targets = setup
    weights = ds_loss_weights(3, 3)
    jnet = JaxNet(**KW, compute_dtype=jnp.float32, remat=False,
                  quadrant=False)
    jstate = jts.create_train_state(params, masks, optimizer=opt)
    jstep = jts.make_train_step(jnet, weights, donate=False, optimizer=opt)
    net = _port_model(KW, params, torch.float32)
    tmasks = {".".join(p): torch.from_numpy(np.array(m))
              for p, m in masks.items()}
    tstate = tts.create_train_state(net, tmasks, optimizer=opt)
    tstep = tts.make_train_step(net, weights, optimizer=opt)
    p0 = {n: p.detach().numpy().copy() for n, p in tstate.params.items()}
    others = [n for n in p0 if not _bias_ahead_of_norm(n)]
    held = {n: np.ones(p0[n].shape, bool) for n in others}
    tx = torch.from_numpy(x)
    tt = [torch.from_numpy(t).long() for t in targets]
    for i, lr in enumerate(LRS):
        jstate, jm = jstep(jstate, jnp.asarray(x),
                           tuple(jnp.asarray(t) for t in targets),
                           jnp.float32(lr))
        tstate, tm = tstep(tstate, tx, tt, lr)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5, err_msg=f"loss, step {i + 1}")
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4)
        rtol = OPT_RTOL if i == 0 else MASKED_STEP2_RTOL
        want = _opt_leaves_ref(opt, jstate.momentum)
        got = _opt_leaves_port(opt, tstate.momentum)
        if opt == "adam" and i == 0:      # exp_avg = (1 - b1) g
            held = {n: np.abs(want["exp_avg"][n]) / 0.1 >= ADAM_G_MIN
                    for n in others}
            alive = sum(int((want["exp_avg"][n] != 0).sum())
                        for n in others)
            assert sum(int(h.sum()) for h in held.values()) >= 0.9 * alive
        for f in want:
            for n in others:
                if not np.any(want[f][n]):
                    assert not np.any(got[f][n]), (f, n)
                    continue
                assert _rel(got[f][n], want[f][n]) <= rtol, (
                    i + 1, f, n, _rel(got[f][n], want[f][n]))
        wp = _flat(jstate.params)
        for n in others:
            dg = (tstate.params[n].detach().numpy() - p0[n])[held[n]]
            dw = (wp[n] - p0[n])[held[n]]
            slack = 2.0 * (i + 1) * np.linalg.norm(np.spacing(np.abs(
                wp[n][held[n]])))
            assert np.linalg.norm(dg - dw) <= (
                rtol * np.linalg.norm(dw) + slack), (i + 1, n)
        if opt != "sgd":
            assert tstate.momentum.step == int(jstate.momentum.step) == i + 1
        _assert_masked(tstate, tmasks)


def _assert_masked(state, masks):
    bufs = ([state.momentum] if isinstance(state.momentum, dict) else
            [v for v in state.momentum if isinstance(v, dict)])
    for n, mk in masks.items():
        dead = broadcast_mask(1.0 - mk, state.params[n])
        for t in [state.params[n].detach()] + [b[n] for b in bufs]:
            assert float((t * dead).abs().max()) == 0.0, n


def _tiny():
    from e2enet_tpu_torch.models.unetpp import ShiftUNetPlusPlus
    net = ShiftUNetPlusPlus(1, 3, ((2, 2, 2),) * 3, base_num_features=8,
                            compute_dtype=torch.float32, device="cpu")
    net.reset_parameters(seed=0)
    rng = np.random.RandomState(0)
    data = torch.from_numpy(rng.randn(1, 16, 16, 16, 1).astype(np.float32))
    targets = [torch.from_numpy(rng.randint(0, 3, (1, 16 // f, 16 // f,
                                                   16 // f))).long()
               for f in (1, 2, 4)]
    return net, data, targets


@pytest.mark.parametrize("opt", ["ranger", "adam"])
def test_optimizer_train_step_reduces_loss(opt):
    """tests/test_optimizers.py's case on the port."""
    net, data, targets = _tiny()
    state = tts.create_train_state(net, optimizer=opt)
    step = tts.make_train_step(net, [1.0, 0.0, 0.0], optimizer=opt)
    losses = []
    for _ in range(8):
        state, metrics = step(state, data, targets, 1e-3)
        losses.append(float(metrics["loss"]))
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0]
    assert state.step == 8 and state.momentum.step == 8


@pytest.mark.parametrize("opt", ["ranger", "adam"])
def test_masked_step_zeroes_every_buffer(opt):
    """DSFF masking zeroes dead kernels in the parameters and in the whole
    optimizer state (exp_avg, exp_avg_sq, slow / max_exp_avg_sq), never
    the step; also through a gradient-growth mask update."""
    from e2enet_tpu_torch.training import dsff as td
    net, data, targets = _tiny()
    masks = td.init_masks(net, 0.3, torch.Generator().manual_seed(5))
    state = tts.create_train_state(net, masks, optimizer=opt)
    step = tts.make_train_step(net, [1.0, 0.0, 0.0], optimizer=opt)
    state, metrics = step(state, data, targets, 1e-3)
    assert np.isfinite(float(metrics["loss"]))
    _assert_masked(state, masks)
    grads = tts.make_grad_step(net, [1.0, 0.0, 0.0])(data, targets)
    update = tts.make_mask_update_step(net, "gradient", granularity="kernel")
    state = update(state, 0.5, grads)
    assert any(not torch.equal(masks[n], state.masks[n]) for n in masks)
    _assert_masked(state, state.masks)
    assert state.momentum.step == 1


def test_unknown_optimizer_and_dynamic_momentum_refused():
    net, _, _ = _tiny()
    with pytest.raises(ValueError, match="unknown optimizer"):
        tts.create_train_state(net, optimizer="lamb")
    with pytest.raises(ValueError, match="SGD-only"):
        tts.make_train_step(net, [1.0], optimizer="adam",
                            dynamic_momentum=True)


def _trained_state(opt, steps=7):
    """A port train state of the tiny model with kernel masks after
    `steps` steps of `opt` (Ranger past its Lookahead)."""
    from e2enet_tpu_torch.training import dsff as td
    net, data, targets = _tiny()
    masks = td.init_masks(net, 0.5, torch.Generator().manual_seed(2))
    state = tts.create_train_state(net, masks, optimizer=opt)
    step = tts.make_train_step(net, [1.0, 0.5, 0.0], optimizer=opt)
    for _ in range(steps):
        state, _ = step(state, data, targets, 1e-3)
    return net, state


def _assert_opt_equal(jmom, tmom):
    assert type(jmom).__name__ == type(tmom).__name__
    assert int(jmom.step) == tmom.step
    for f in tmom._fields:
        if f == "step":
            continue
        want = from_jax_params(jax.tree_util.tree_map(np.asarray,
                                                      getattr(jmom, f)))
        got = getattr(tmom, f)
        assert set(want) == set(got), f
        for n, t in got.items():
            np.testing.assert_array_equal(t.numpy(), want[n].numpy(),
                                          err_msg=f"{f} {n}")


@pytest.mark.parametrize("opt", ["ranger", "adam"])
def test_checkpoint_crosses_both_ways(opt, tmp_path):
    """The port's checkpoint of a Ranger / Adam state loads in the JAX
    package as its NamedTuple, leaf for leaf equal; the JAX package's
    save of that state loads back into a port state equal to the bit;
    the port refuses a checkpoint of another optimizer."""
    net, state = _trained_state(opt)
    path = str(tmp_path / "port.model")
    tckpt.save_train_state(path, state, 3, {"all_tr_losses": [1.0]})
    jstate, epoch, _ = jckpt.load_checkpoint(path)
    assert epoch == 3
    assert type(jstate.momentum) is {"ranger": jranger.RangerState,
                                     "adam": jts.AdamState}[opt]
    _assert_opt_equal(jstate.momentum, state.momentum)
    jpath = str(tmp_path / "jax.model")
    jckpt.save_checkpoint(jpath, jstate, 4)
    net2, fresh = _trained_state(opt, steps=1)
    tckpt.load_train_state(jpath, fresh, net2)
    _assert_opt_equal(jstate.momentum, fresh.momentum)
    for n, p in fresh.params.items():
        assert torch.equal(p.detach(), state.params[n].detach()), n
    for n, m in fresh.masks.items():
        assert torch.equal(m, state.masks[n]), n
    assert fresh.step == state.step
    other = "adam" if opt == "ranger" else "sgd"
    net3, wrong = _trained_state(other, steps=0)
    with pytest.raises(ValueError, match="optimizer state"):
        tckpt.load_train_state(path, wrong, net3)


def test_optimizer_checkpoints_load_without_jax(tmp_path):
    """A process in which jax, flax and e2enet_tpu cannot be imported
    loads both packages' Ranger and Adam checkpoints as the port's
    NamedTuples, and writes one that names the JAX classes."""
    files = []
    for opt in ("ranger", "adam"):
        _, state = _trained_state(opt, steps=2)
        p = str(tmp_path / f"{opt}_port.model")
        tckpt.save_train_state(p, state, 1)
        jstate, _, _ = jckpt.load_checkpoint(p)
        jp = str(tmp_path / f"{opt}_jax.model")
        jckpt.save_checkpoint(jp, jstate, 1)
        files += [(p, opt), (jp, opt)]
    code = f"""
import sys, pickletools
for m in ("jax", "jaxlib", "flax", "e2enet_tpu"):
    sys.modules[m] = None
from e2enet_tpu_torch.training import checkpoint as c
from e2enet_tpu_torch.training.ranger import RangerState
from e2enet_tpu_torch.training.train_state import AdamState
for path, opt in {files!r}:
    d, _, _ = c.load_checkpoint(path)
    cls = RangerState if opt == "ranger" else AdamState
    assert type(d["momentum"]) is cls, type(d["momentum"])
    assert int(d["momentum"].step) == 2
    c.save_checkpoint(path + ".again", d["params"], 1,
                      momentum=d["momentum"], step=d["step"])
    names = [a for op, a, _ in pickletools.genops(
        open(path + ".again", "rb").read()) if op.name == "SHORT_BINUNICODE"]
    assert ("e2enet_tpu.training.ranger" if opt == "ranger" else
            "e2enet_tpu.training.train_state") in names
assert not any(k.split(".")[0] in ("jax", "flax", "e2enet_tpu")
               and sys.modules[k] is not None for k in sys.modules)
"""
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    for path, opt in files:
        jstate, _, _ = jckpt.load_checkpoint(path + ".again")
        assert type(jstate.momentum).__name__ == (
            "RangerState" if opt == "ranger" else "AdamState")


def test_variant_presets_resolve():
    """tests/test_optimizers.py's case on the port's table."""
    from e2enet_tpu_torch.training.variants import resolve_variant
    assert resolve_variant("nnUNetTrainerV2_Ranger_lr3en4") == {
        "optimizer": "ranger", "initial_lr": 3e-4}
    assert resolve_variant("nnUNetTrainerV2_Adam")["optimizer"] == "adam"
    assert resolve_variant("nnUNetTrainerV2_momentum098") == {
        "momentum": 0.98}
    with pytest.raises(KeyError):
        resolve_variant("nnUNetTrainerV2_noSuchVariant")
