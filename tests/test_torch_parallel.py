"""Data-parallel training and tile-sharded prediction of the port
(e2enet_tpu_torch/parallel/mesh.py and the steps, losses, batch norm and
tile loop it reduces) on two gloo ranks on the CPU, against one rank on
the whole batch and against the JAX package's make_sharded_train_step and
make_tiled_predictor_sharded on a 2-device "data" mesh.

One spawned world of two ranks serves the module (the `world` fixture):
it runs every case and returns each rank's results, so the spawn is paid
once. Torch is held to two threads per rank.

The train step: the small model of test_torch_train_step.py (base 4, 3
pools, 2 x 16^3, float32, weights carried over by models/weights.
from_jax_params), two steps, one axis varied at a time from the default
(dc_ce, batch dice, SGD): every loss of LOSS_REGISTRY, batch dice off,
Ranger and Adam, the two dynamic schedules (the CE -> Dice weights and the
momentum reduction as extras), batch norm, and row masks at density 0.5.
Rank 0 and rank 1 end with the same state, to the bit. Against one rank
on the whole batch: the losses within 1e-5 relative and every optimizer
buffer and parameter change within 1e-5 relative per leaf, a leaf's scale
taken as at least 1e-2 of its buffer's largest leaf: the two orders of
summation differ by ~1e-6 of a leaf's terms, which is more than 1e-5 of a
leaf whose gradient is a sum that nearly cancels (the Dice-squared loss's
last instance-norm scale: 1.04e-5 of its own norm, 1.7e-4, against a
largest leaf of 3.1e-2). Against the
JAX package's sharded step, test_torch_train_step.py's rules: 3e-4 per
leaf, 2e-2 for the masked step 2 against the XLA path, and the losses
within 1e-5 relative or four float32 spacings of 1 (the MCC loss is a
difference of normalised counts of order 1 that nearly cancel: ~1.5e-3,
and the port's one-device step differs from the reference's one-device
step by 1.8e-4 of it). Three losses have a step 2 whose gradient the
reference's float32 step does not reach from parameters that differ from
its own by rounding, and each is held so:
- Dice squared and top-k: step 2 of the reference's sharded step is taken
  from the port's state after step 1 (its parameters and momentum), at
  3e-4. From its own state the reference's sharded step differs from its
  one-device step by 1.2e-2 per leaf (Dice squared: a norm scale whose
  gradient nearly cancels), and the port's one-device step from the
  reference's by 3.1e-2 (top-k: its k% voxels change at the boundary); from
  the same state they agree within 4.6e-5 and 1.2e-4.
- GDL: the reference's sharded step runs in float64 (jax.enable_x64), at
  3e-4. At the parameters after step 1 the reference's float32 gradient is
  3.3e-2 per leaf from its own float64 gradient (loc1_0's norm bias, up1_0
  and the encoder above them), where the port's float32 gradient is within
  5e-6 of it (ROADMAP Queue 3).
The conv biases
ahead of a norm have a gradient that is zero but for rounding and are left
out of the per-leaf checks, as there.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from e2enet_tpu.models.unetpp import ShiftUNetPlusPlus as JaxNet  # noqa
from e2enet_tpu.models.unetpp import ds_loss_weights  # noqa: E402
from e2enet_tpu.training import dsff as jd  # noqa: E402
from e2enet_tpu.training import train_state as jts  # noqa: E402
from e2enet_tpu_torch.ops import losses as tl  # noqa: E402
from e2enet_tpu_torch.ops import sliding as tsl  # noqa: E402
from e2enet_tpu_torch.parallel import dryrun, mesh  # noqa: E402
from e2enet_tpu_torch.training import dsff as td  # noqa: E402
from e2enet_tpu_torch.training import train_state as tts  # noqa: E402
from test_torch_train_step import (KW, LRS, MASKED_STEP2_RTOL,  # noqa: E402
                                   SHAPE, _batch, _bias_ahead_of_norm,
                                   _params, _port_model)

RANKS = 2
THREADS = 2
RANK_RTOL = 1e-5          # two ranks against one, per leaf and loss
RANK_LEAF_FLOOR = 1e-2    # a leaf's least scale, of its buffer's largest
REF_RTOL = 3e-4           # against the JAX package's sharded step
LOSS_ATOL = 4 * float(np.finfo(np.float32).eps)
# step 2 held to the reference's step 2 from the port's step-1 state, and
# the GDL held to the reference run in float64 (module docstring)
REF_STEP2_FROM_PORT_STATE = ("loss_dice_squared", "loss_topk")
REF_FLOAT64 = ("loss_gdl",)
ADAM_G_MIN = 1e-6
# every loss the trainer takes, varied from the default one at a time;
# the region losses get 0/1 region channels
REGION_LOSSES = ("dc_bce", "dice_regions")
STEP_CASES = {
    "default": {},
    **{f"loss_{n}": {"loss_name": n} for n in tl.LOSS_REGISTRY
       if n != "dc_ce"},
    "no_batch_dice": {"batch_dice": False},
    "ranger": {"optimizer": "ranger"},
    "adam": {"optimizer": "adam"},
    "ce_to_dice": {"dynamic_loss_weights": True},
    "reduce": {"dynamic_momentum": True},
    "batch_norm": {"norm_op": "batch"},
    "masked": {"density": 0.5},
}
EXTRAS = {"dynamic_loss_weights": (0.7, 0.3), "dynamic_momentum": (0.95,)}
STEP_KEYS = ("loss_name", "batch_dice", "optimizer", "dynamic_loss_weights",
             "dynamic_momentum")
TOY_VOLUME = (20, 24, 20)
TOY_PATCH = (16, 16, 16)


def _case_inputs(spec):
    """(reference params, reference masks or None, data, targets) of a
    step case."""
    kw = dict(KW, norm_op=spec.get("norm_op", "instance"))
    params = _params(kw, SHAPE, 0)
    masks = None
    if "density" in spec:
        masks = jd.init_masks_row(params, spec["density"],
                                  jax.random.PRNGKey(1),
                                  density_48_override=spec["density"])
    x, targets = _batch(1, SHAPE, 3, 3)
    if spec.get("loss_name") in REGION_LOSSES:
        targets = [(np.eye(3, dtype=np.float32)[t] > 0).astype(np.float32)
                   for t in targets]
    return params, masks, x, targets


def _extras(spec):
    out = ()
    for k in ("dynamic_loss_weights", "dynamic_momentum"):
        if spec.get(k):
            out += EXTRAS[k]
    return out


def _port_targets(targets):
    return [torch.from_numpy(t) if t.dtype == np.float32
            else torch.from_numpy(t).long() for t in targets]


def _opt_leaves(momentum):
    """{field: {name: numpy}} of an optimizer state (SGD's momentum, or
    every dict field of a Ranger / Adam state)."""
    if isinstance(momentum, dict):
        return {"momentum": {n: b.numpy().copy()
                             for n, b in momentum.items()}}
    return {f: {n: b.numpy().copy() for n, b in getattr(momentum, f).items()}
            for f in momentum._fields if f != "step"}


def _port_model_for(spec, state_dict):
    from e2enet_tpu_torch.models.unetpp import ShiftUNetPlusPlus
    net = ShiftUNetPlusPlus(**KW, norm_op=spec.get("norm_op", "instance"),
                            compute_dtype=torch.float32, device="cpu")
    net.load_state_dict(state_dict, strict=True)
    return net


def run_port_steps(spec, state_dict, masks, x, targets, group=None):
    """[(optimizer buffers, params, loss, grad norm)] after each of two
    steps on this rank's rows (all rows without a group), and the initial
    masked parameters."""
    net = _port_model_for(spec, {k: torch.from_numpy(v)
                                 for k, v in state_dict.items()})
    tmasks = (None if masks is None else
              {k: torch.from_numpy(v) for k, v in masks.items()})
    state = tts.create_train_state(net, tmasks,
                                   optimizer=spec.get("optimizer", "sgd"))
    p0 = {n: p.detach().numpy().copy() for n, p in state.params.items()}
    step = tts.make_train_step(
        net, ds_loss_weights(3, 3), group=group,
        **{k: spec[k] for k in STEP_KEYS if k in spec})
    if group is not None:
        x, targets = mesh.shard_batch(x, targets, group)
    tx, tt = torch.from_numpy(np.ascontiguousarray(x)), _port_targets(
        [np.ascontiguousarray(t) for t in targets])
    out = []
    for lr in LRS:
        state, m = step(state, tx, tt, lr, *_extras(spec))
        out.append((_opt_leaves(state.momentum),
                    {n: p.detach().numpy().copy()
                     for n, p in state.params.items()},
                    float(m["loss"]), float(m["grad_norm"])))
    return p0, out


def _mask_updates(state_dict, masks, x, targets, group=None):
    """The kernel masks after one random and one gradient death/growth
    update of the default model's initial state (gradients of the loss on
    this rank's rows, summed over the group)."""
    net = _port_model_for({}, {k: torch.from_numpy(v)
                               for k, v in state_dict.items()})
    out = {}
    for growth in ("random", "gradient"):
        state = tts.create_train_state(
            net, {k: torch.from_numpy(v) for k, v in masks.items()}, seed=3)
        grads = None
        if growth == "gradient":
            xs, ts = (mesh.shard_batch(x, targets, group) if group is not None
                      else (x, targets))
            grads = tts.make_grad_step(net, ds_loss_weights(3, 3),
                                       group=group)(
                torch.from_numpy(np.ascontiguousarray(xs)),
                _port_targets([np.ascontiguousarray(t) for t in ts]))
        update = tts.make_mask_update_step(net, growth,
                                           granularity="kernel")
        state = update(state, 0.3, grads)
        out[growth] = {k: v.numpy().copy() for k, v in state.masks.items()}
    return out


def toy_apply(x):
    v = x[..., :1]
    return torch.cat([v, -v, 0.3 * v], dim=-1)


def _toy_volume():
    return np.random.RandomState(0).randn(*TOY_VOLUME, 1).astype(np.float32)


def _small_model_apply(state_dict):
    net = _port_model_for({}, {k: torch.from_numpy(v)
                               for k, v in state_dict.items()})
    net.eval()
    return lambda x: net(x, do_ds=False)


def run_tile_loops(state_dict, group=None):
    """{name: (acc, wacc)} of the tile loop on the toy apply_fn in float32
    and float16 and on the small model in float32."""
    vol = torch.from_numpy(_toy_volume())
    out = {}
    with torch.no_grad():
        for name, fn, dtype in (
                ("toy_f32", toy_apply, torch.float32),
                ("toy_f16", toy_apply, torch.float16),
                ("model_f32", _small_model_apply(state_dict),
                 torch.float32)):
            acc, wacc = tsl.tiled_accumulate(fn, vol, TOY_PATCH, 3,
                                             accum_dtype=dtype, group=group)
            out[name] = (acc.numpy(), wacc.numpy())
    return out


def _rank_cases(cases, kernel_masks, tile_state):
    """Every case on this rank of the module's world."""
    torch.set_num_threads(THREADS)
    group = mesh.data_group(RANKS)
    steps = {name: run_port_steps(*args, group=group)[1]
             for name, args in cases.items()}
    d = cases["default"]
    masks = _mask_updates(d[1], kernel_masks, d[3], d[4], group)
    tiles = run_tile_loops(tile_state, group)
    loss = dryrun._rank_run("cpu")
    return {"steps": steps, "masks": masks, "tiles": tiles, "dryrun": loss,
            "threads": torch.get_num_threads()}


def _numpy_state(params, spec):
    net = _port_model(dict(KW, norm_op=spec.get("norm_op", "instance")),
                      params, torch.float32)
    return {k: v.detach().numpy().copy() for k, v in net.state_dict().items()}


@pytest.fixture(scope="module")
def inputs():
    cases, refs = {}, {}
    for name, spec in STEP_CASES.items():
        params, masks, x, targets = _case_inputs(spec)
        tmasks = (None if masks is None else
                  {".".join(p): np.array(m) for p, m in masks.items()})
        cases[name] = (spec, _numpy_state(params, spec), tmasks, x, targets)
        refs[name] = (params, masks)
    net = _port_model_for({}, {k: torch.from_numpy(v) for k, v in
                               cases["default"][1].items()})
    kmasks = {k: v.numpy() for k, v in td.init_masks(
        net, 0.3, torch.Generator().manual_seed(1)).items()}
    return cases, refs, kmasks


@pytest.fixture(scope="module", autouse=True)
def _threads():
    before = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def world(inputs):
    cases, _, kmasks = inputs
    return mesh.launch(_rank_cases, RANKS, "cpu", cases, kmasks,
                       cases["default"][1])


@pytest.fixture(scope="module")
def one_rank(inputs):
    cases = inputs[0]
    return {name: run_port_steps(*args) for name, args in cases.items()}


def _assert_steps(got, want, p0, rtols, what, floor=0.0, loss_atol=0.0):
    """got's two steps held to want's: losses, grad norms, every optimizer
    buffer per leaf (bias-free leaves; a leaf's scale at least `floor` of
    its buffer's largest leaf), the parameter change per leaf with two
    float32 spacings per step of slack."""
    others = [n for n in p0 if not _bias_ahead_of_norm(n)]
    held = {n: np.ones(p0[n].shape, bool) for n in others}
    for i, ((gb, gp, gl, gn), (wb, wp, wl, wn)) in enumerate(zip(got, want)):
        rtol = rtols[i]
        np.testing.assert_allclose(gl, wl, rtol=min(rtol, 1e-5),
                                   atol=loss_atol,
                                   err_msg=f"{what}: loss, step {i + 1}")
        np.testing.assert_allclose(gn, wn, rtol=max(rtol, 1e-5),
                                   err_msg=f"{what}: grad norm, step {i + 1}")
        if "exp_avg_sq" in wb and "slow" not in wb and i == 0:
            # Adam's first step moves each weight by ~lr whatever its
            # gradient: hold the entries with a gradient above rounding
            held = {n: np.abs(wb["exp_avg"][n]) / 0.1 >= ADAM_G_MIN
                    for n in others}
        for f in wb:
            least = floor * max(np.linalg.norm(wb[f][n]) for n in others)
            for n in others:
                if not np.any(wb[f][n]):
                    assert not np.any(gb[f][n]), (what, f, n)
                    continue
                err = np.linalg.norm(gb[f][n] - wb[f][n])
                scale = max(np.linalg.norm(wb[f][n]), least)
                assert err <= rtol * scale, (what, i + 1, f, n, err / scale)
        for n in others:
            dg = (gp[n] - p0[n])[held[n]]
            dw = (wp[n] - p0[n])[held[n]]
            slack = 2.0 * (i + 1) * np.linalg.norm(
                np.spacing(np.abs(wp[n][held[n]])))
            assert np.linalg.norm(dg - dw) <= (
                rtol * np.linalg.norm(dw) + slack), (what, i + 1, n)


@pytest.mark.parametrize("name", list(STEP_CASES))
def test_two_ranks_equal_one_rank(world, one_rank, name):
    """Two ranks of one row each against one rank on both rows: the same
    state on both ranks to the bit, within 1e-5 of one rank per leaf."""
    r0, r1 = (w["steps"][name] for w in world)
    for (b0, p0_, l0, n0), (b1, p1, l1, n1) in zip(r0, r1):
        assert l0 == l1 and n0 == n1
        for n in p0_:
            assert np.array_equal(p0_[n], p1[n]), n
        for f in b0:
            for n in b0[f]:
                assert np.array_equal(b0[f][n], b1[f][n]), (f, n)
    p0, want = one_rank[name]
    _assert_steps(r0, want, p0, (RANK_RTOL, RANK_RTOL), name,
                  RANK_LEAF_FLOOR)


def _reference_sharded_steps(spec, params, masks, x, targets,
                             dtype=jnp.float32, start=None):
    """The JAX package's make_sharded_train_step on a 2-device "data"
    mesh: [(optimizer buffers, params, loss, grad norm)] per step, in the
    port's names and layouts. dtype: the model's and the state's (float64
    under jax.enable_x64). start: a port state after step 1 (SGD buffers,
    params) to take step 2 from, instead of both steps from params."""
    from e2enet_tpu.parallel.mesh import (make_mesh, make_sharded_train_step,
                                          replicate_state, shard_batch)
    from e2enet_tpu_torch.models.weights import from_jax_params, to_jax_params

    def flat(tree):
        return {k: v.numpy() for k, v in from_jax_params(
            jax.tree_util.tree_map(np.asarray, tree)).items()}

    def cast(tree):
        return jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), tree)

    opt = spec.get("optimizer", "sgd")
    mesh2 = make_mesh(jax.devices()[:RANKS])
    jnet = JaxNet(**KW, norm_op=spec.get("norm_op", "instance"),
                  compute_dtype=dtype, remat=False, quadrant=False)
    step = make_sharded_train_step(
        jnet, ds_loss_weights(3, 3), mesh2,
        batch_dice=spec.get("batch_dice", True),
        **{k: spec[k] for k in STEP_KEYS if k in spec and k != "batch_dice"})
    state = jts.create_train_state(cast(params), masks, optimizer=opt)
    lrs = LRS
    if start is not None:
        assert opt == "sgd" and masks is None
        bufs, p1 = start
        state = jts.TrainState(
            params=cast(to_jax_params(p1)),
            momentum=cast(to_jax_params(bufs["momentum"])), masks=None,
            rng=state.rng, step=state.step + 1)
        lrs = LRS[1:]
    state = replicate_state(mesh2, state)
    out = []
    for lr in lrs:
        data, tgts = shard_batch(mesh2, jnp.asarray(x, dtype),
                                 tuple(targets))
        state, m = step(state, data, tgts, dtype(lr),
                        *(dtype(e) for e in _extras(spec)))
        mom = state.momentum
        bufs = ({"momentum": flat(mom)} if opt == "sgd" else
                {f: flat(getattr(mom, f)) for f in mom._fields
                 if f != "step"})
        out.append((bufs, flat(state.params), float(m["loss"]),
                    float(m["grad_norm"])))
    return out


@pytest.mark.parametrize("name", list(STEP_CASES))
def test_two_ranks_equal_reference_sharded_step(world, one_rank, inputs,
                                                name):
    """Two ranks against the JAX package's sharded step on a 2-device
    mesh, at test_torch_train_step.py's tolerances."""
    cases, refs, _ = inputs
    spec, _, _, x, targets = cases[name]
    params, masks = refs[name]
    got = world[0]["steps"][name]
    if name in REF_FLOAT64:
        with jax.enable_x64(True):
            want = _reference_sharded_steps(spec, params, masks, x, targets,
                                            dtype=jnp.float64)
    else:
        want = _reference_sharded_steps(spec, params, masks, x, targets)
    step2 = MASKED_STEP2_RTOL if masks is not None else REF_RTOL
    if name in REF_STEP2_FROM_PORT_STATE:
        _assert_steps(got[:1], want[:1], one_rank[name][0], (REF_RTOL,),
                      name, loss_atol=LOSS_ATOL)
        want = _reference_sharded_steps(spec, params, masks, x, targets,
                                        start=got[0][:2])
        # step 2 alone, its parameter change held from the step-1 state
        _assert_steps(got[1:], want, got[0][1], (step2,),
                      f"{name} from the port's step-1 state",
                      loss_atol=LOSS_ATOL)
        return
    _assert_steps(got, want, one_rank[name][0], (REF_RTOL, step2), name,
                  loss_atol=LOSS_ATOL)


def test_gdl_gradient_matches_reference_float64(one_rank, inputs):
    """At the parameters after the port's first GDL step, the port's
    float32 gradient against the JAX package's make_grad_step run in
    float64, within REF_RTOL per leaf; the reference's float32 gradient there
    is printed beside it (module docstring: it is ~3e-2 off at these
    parameters, not at the initial ones)."""
    from e2enet_tpu_torch.models.weights import from_jax_params, to_jax_params
    cases = inputs[0]
    spec, _, _, x, targets = cases["loss_gdl"]
    p0, steps = one_rank["loss_gdl"]
    p1 = steps[0][1]
    net = _port_model_for(spec, {k: torch.from_numpy(v)
                                 for k, v in p1.items()})
    got = tts.make_grad_step(net, ds_loss_weights(3, 3),
                             loss_name="gdl")(
        torch.from_numpy(x), _port_targets(targets))

    def reference(dtype):
        jnet = JaxNet(**KW, compute_dtype=dtype, remat=False,
                      quadrant=False)
        step = jts.make_grad_step(jnet, ds_loss_weights(3, 3),
                                  loss_name="gdl")
        g = step(jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype),
                                        to_jax_params(p1)),
                 jnp.asarray(x, dtype), tuple(jnp.asarray(t)
                                             for t in targets))
        return {k: v.double().numpy() for k, v in from_jax_params(
            jax.tree_util.tree_map(np.asarray, g)).items()}
    with jax.enable_x64(True):
        want = reference(jnp.float64)
    ref32 = reference(jnp.float32)
    others = [n for n in p0 if not _bias_ahead_of_norm(n)]
    for n in [n for n in others if not np.any(want[n])]:
        # the last head, whose deep-supervision weight is 0
        assert not torch.any(got[n]), n
        others.remove(n)
    errs = {n: np.linalg.norm(got[n].double().numpy() - want[n])
            / np.linalg.norm(want[n]) for n in others}
    ref_errs = {n: np.linalg.norm(ref32[n] - want[n]) / np.linalg.norm(
        want[n]) for n in others}
    worst = sorted(others, key=ref_errs.get)[-3:]
    print("GDL gradient after step 1, relative L2 from the float64 "
          "reference, per leaf (port float32 / reference float32): "
          + ", ".join(f"{n} {errs[n]:.2e} / {ref_errs[n]:.2e}"
                      for n in reversed(worst)))
    for n in others:
        assert errs[n] <= REF_RTOL, (n, errs[n])


@pytest.mark.parametrize("growth", ["random", "gradient"])
def test_mask_updates_equal_across_ranks(world, inputs, growth):
    """A DSFF death/growth update with random and with gradient growth
    (the gradients summed over the ranks): the same masks on both ranks
    and as one rank's update on the whole batch, to the bit."""
    cases, _, kmasks = inputs
    d = cases["default"]
    want = _mask_updates(d[1], kmasks, d[3], d[4])[growth]
    for w in world:
        got = w["masks"][growth]
        for k in want:
            assert np.array_equal(got[k], want[k]), k
    assert any(not np.array_equal(want[k], kmasks[k]) for k in want)


@pytest.mark.parametrize("name", ["toy_f32", "toy_f16", "model_f32"])
def test_sharded_tile_loop_equals_one_device(world, inputs, name):
    """The tile loop with tiles [r::2] on each rank and the accumulators
    summed: float32 within 1e-6 of one device's loop; float16 no further
    from the exact sum (the loop in float64) than one device's float16
    loop is, but for the one float16 spacing the sum over the ranks adds
    (each order of float16 additions is a few spacings from the exact sum:
    one device's toy loop reaches 2.8); the same on both ranks."""
    cases = inputs[0]
    got0, got1 = (w["tiles"][name] for w in world)
    for a, b in zip(got0, got1):
        assert np.array_equal(a, b)
    want = run_tile_loops(cases["default"][1])[name]
    if name != "toy_f16":
        for g, w in zip(got0, want):
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)
        return
    vol = torch.from_numpy(_toy_volume())
    with torch.no_grad():
        exact = tsl.tiled_accumulate(toy_apply, vol, TOY_PATCH, 3,
                                     accum_dtype=torch.float64)
    for g, w, e in zip(got0, want, exact):
        e = e.numpy()
        sp = np.spacing(np.abs(e).astype(np.float16)).astype(np.float64)
        err_two = np.max(np.abs(g.astype(np.float64) - e) / sp)
        err_one = np.max(np.abs(w.astype(np.float64) - e) / sp)
        assert err_two <= err_one + 1.0, (err_two, err_one)


def test_sharded_tile_loop_equals_reference_sharded(world):
    """The toy loop against the JAX package's make_tiled_predictor_sharded
    on a 2-device mesh (as test_parallel.py holds it to its single-device
    program), rtol 1e-4."""
    from e2enet_tpu.ops.sliding import (bucket_num_tiles,
                                        compute_steps_for_sliding_window,
                                        make_tiled_predictor_sharded)
    from e2enet_tpu.parallel.mesh import make_mesh

    def apply_fn(params, x):
        v = x[..., :1]
        return jnp.concatenate([v, -v, 0.3 * v], axis=-1)

    vol = _toy_volume()
    steps = compute_steps_for_sliding_window(TOY_PATCH, vol.shape[:3], 0.5)
    starts = np.array([(a, b, c) for a in steps[0] for b in steps[1]
                       for c in steps[2]], np.int32)
    T = len(starts)
    sp = np.zeros((max(bucket_num_tiles(T), RANKS), 3), np.int32)
    sp[:T] = starts
    sharded = make_tiled_predictor_sharded(
        apply_fn, TOY_PATCH, 3, make_mesh(jax.devices()[:RANKS]))
    acc, w = sharded({}, jnp.asarray(vol), jnp.asarray(sp), jnp.int32(T))
    got_acc, got_w = world[0]["tiles"]["toy_f32"]
    np.testing.assert_allclose(got_w, np.asarray(w), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got_acc, np.asarray(acc), rtol=1e-4,
                               atol=1e-6)


def test_dryrun_multichip(world):
    """dryrun_multichip's ranks: a sharded train step of the tiny model
    with kernel masks at 0.3, finite, the same on both ranks, and a DSFF
    update whose masks agree across the ranks (checked in the ranks)."""
    losses = [w["dryrun"] for w in world]
    assert np.isfinite(losses[0]) and losses[0] == losses[1]


def test_world_ran_two_threads_per_rank(world):
    assert [w["threads"] for w in world] == [THREADS] * RANKS


def test_outside_a_group_refuses():
    """A sharded step or num_devices above 1 outside a process group
    raises and says how to launch; more CUDA ranks than cards raises."""
    with pytest.raises(RuntimeError, match="launch"):
        tts.make_sharded_train_step(None, [1.0])
    with pytest.raises(RuntimeError, match="launch"):
        mesh.data_group(2)
    if torch.cuda.device_count() < 2:
        with pytest.raises(RuntimeError, match="only .* present"):
            mesh.check_num_devices(2, "cuda")
    mesh.check_num_devices(4, "cpu")


def test_default_backends():
    """NCCL for the card, gloo for the CPU."""
    assert mesh.default_backend("cpu") == "gloo"
    assert mesh.default_backend("cuda") == "nccl"
