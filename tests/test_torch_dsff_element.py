"""Element-granular DSFF on the port (e2enet_tpu_torch/training/dsff.py,
models/masks.py) against the JAX package's (e2enet_tpu/training/dsff.py)
on the same numpy weights, carried across by models/weights.from_jax_params:

- element masks cross between the flax layout and the port's as the
  weights do, both ways equal to the bit, and are applied to a kernel
  exactly as the reference's apply_masks applies them;
- masks_density at both granularities equal to the reference's;
- init_masks_element with uniform_ori and ERK (the reference's draws
  handed over, transposed to the port's layout) and snip (the same
  gradients) equal to the bit;
- element death and growth, random (the reference's draws handed over)
  and by gradient (also through make_mask_update_step on an Adam state,
  every buffer zero where the masks are), equal to the bit, every
  kernel's alive count held, and exactly num_death grown where draws tie;
- init_masks_gmp, init_masks_lottery and gmp_prune_masks over a ramp of
  epochs equal to the bit;
- init_masks_grasp on the model of tests/test_components.py::
  test_grasp_init (the JAX side as that test runs it): the scores within
  GRASP_ATOL of the largest |score|, the masks equal but at entries whose
  score lies within that tolerance of the threshold;
- a double backward through a hand-written kernel's op refuses on the
  CPU too (the ops run their plain versions there through the same
  autograd functions), and through the plain path (ops.blocks.
  plain_ops()) the Hessian-vector product equals torch.func's forward
  over reverse.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from e2enet_tpu.training import dsff as jd  # noqa: E402
from e2enet_tpu_torch.models import masks as tm  # noqa: E402
from e2enet_tpu_torch.models.weights import from_jax_params  # noqa: E402
from e2enet_tpu_torch.ops import blocks  # noqa: E402
from e2enet_tpu_torch.training import dsff as td  # noqa: E402
from e2enet_tpu_torch.training import train_state as tts  # noqa: E402
from test_torch_train_step import _params, _port_model  # noqa: E402

KW = dict(input_channels=1, num_classes=3,
          pool_op_kernel_sizes=((2, 2, 2),) * 2, base_num_features=6)
SHAPE = (1, 8, 8, 8, 1)
# GraSP: float32 Hessian-vector products of two implementations differ in
# summation order; scores held within this share of the largest |score|
GRASP_ATOL = 1e-4
PERM = {4: (3, 2, 0, 1), 5: (3, 4, 0, 1, 2)}


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _to_port(a):
    a = np.asarray(a, np.float32)
    return torch.from_numpy(np.ascontiguousarray(
        a.transpose(PERM[a.ndim]) if a.ndim in PERM else a))


def _tmasks(masks):
    """A reference mask dict ({path: flax-layout mask}) in the port's
    names and layout."""
    return {".".join(k): _to_port(m) for k, m in masks.items()}


def _assert_masks_equal(got, want):
    """Port masks against reference masks, to the bit, in the flax
    layout."""
    flax = tm.masks_to_flax(got)
    assert set(flax) == {"|".join(k) for k in want}
    for k, m in want.items():
        np.testing.assert_array_equal(flax["|".join(k)], np.asarray(m),
                                      err_msg="/".join(k))


def _element_draws(key, masks):
    """The reference's uniform draws of an element update: one split per
    masked kernel in sorted order (dsff.py:338-341, :156-158), in the
    port's layout by name."""
    out = {}
    for path in sorted(masks):
        key, sub = jax.random.split(key)
        out[".".join(path)] = _to_port(jax.random.uniform(
            sub, masks[path].shape))
    return out


def _setup(seed, density=0.4, mode="uniform_ori"):
    """(reference params masked by element masks, those masks, the port
    model with the same weights)."""
    params = _params(KW, SHAPE, seed)
    masks = jd.init_masks_element(params, density,
                                  jax.random.PRNGKey(seed + 1), mode=mode)
    params = jax.tree_util.tree_map(np.asarray,
                                    jd.apply_masks(params, masks))
    return params, masks, _port_model(KW, params, torch.float32)


def _grads(params, seed):
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda a: rng.randn(*a.shape).astype(np.float32), params)


def test_element_masks_cross_layouts_and_apply():
    params, masks, net = _setup(0)
    flax = {"|".join(k): np.asarray(m) for k, m in masks.items()}
    port = tm.masks_for_model(flax, net)
    for n, m in port.items():
        p = dict(net.named_parameters())[n]
        assert m.shape == tuple(p.shape) and tm.is_element_mask(m)
    back = tm.masks_to_flax(port)
    assert set(back) == set(flax)
    for k, v in flax.items():
        np.testing.assert_array_equal(back[k], v)
    # applied to the reference's unmasked weights as the reference does
    raw = _params(KW, SHAPE, 0)
    want = from_jax_params(jax.tree_util.tree_map(
        np.asarray, jd.apply_masks(raw, masks)))
    got = from_jax_params(jax.tree_util.tree_map(np.asarray, raw))
    tm.apply_masks_to(got, port)
    for n, t in want.items():
        assert torch.equal(got[n], t), n
    # a mask of neither shape is refused, naming the kernel
    name = sorted(port)[0]
    bad = dict(port)
    bad[name] = np.ones(port[name].shape[:-1] + (1,), np.float32)
    with pytest.raises(ValueError, match=name):
        tm.apply_masks_to(dict(net.named_parameters()), bad)


@pytest.mark.parametrize("granularity", ["kernel", "element"])
def test_masks_density_matches_reference(granularity):
    params = _params(KW, SHAPE, 2)
    key = jax.random.PRNGKey(3)
    masks = (jd.init_masks(params, 0.35, key, density_48_override=0.35)
             if granularity == "kernel"
             else jd.init_masks_element(params, 0.35, key, mode="ERK"))
    net = _port_model(KW, params, torch.float32)
    tmasks = _tmasks(masks)
    assert td.mask_granularity(tmasks, net) == granularity
    assert tm.masks_density(tmasks, net) == pytest.approx(
        float(jd.masks_density(masks, params)), rel=1e-6)


@pytest.mark.parametrize("mode", ["uniform_ori", "ERK"])
def test_init_masks_element_matches_reference(mode):
    params = _params(KW, SHAPE, 4)
    key = jax.random.PRNGKey(5)
    want = jd.init_masks_element(params, 0.3, key, mode=mode)
    net = _port_model(KW, params, torch.float32)
    got = td.init_masks_element(net, 0.3, mode=mode,
                                draws=_element_draws(key, want))
    _assert_masks_equal(got, want)
    # from the generator: the same densities, drawn again the same
    a = td.init_masks_element(net, 0.3, torch.Generator().manual_seed(0),
                              mode)
    b = td.init_masks_element(net, 0.3, torch.Generator().manual_seed(0),
                              mode)
    assert all(torch.equal(a[n], b[n]) for n in a)
    assert tm.masks_density(a, net) == pytest.approx(0.3, abs=0.02)


def test_init_masks_snip_matches_reference():
    params = _params(KW, SHAPE, 6)
    grads = _grads(params, 7)
    want = jd.init_masks_element(params, 0.2, jax.random.PRNGKey(0),
                                 mode="snip", grads=grads)
    net = _port_model(KW, params, torch.float32)
    got = td.init_masks_element(net, 0.2, mode="snip",
                                grads=from_jax_params(grads))
    _assert_masks_equal(got, want)


@pytest.mark.parametrize("growth", ["random", "gradient"])
@pytest.mark.parametrize("rate", [0.5, 0.2])
def test_element_death_growth_matches_reference(growth, rate):
    params, masks, net = _setup(8 + int(rate * 10))
    grads = _grads(params, 9)
    key = jax.random.PRNGKey(10)
    want, wstats = jd.death_growth_update(
        params, grads, masks, key, jnp.float32(rate), growth_mode=growth,
        granularity="element")
    tmasks = _tmasks(masks)
    kw = (dict(scores=_element_draws(key, masks)) if growth == "random"
          else dict(grads=from_jax_params(grads)))
    got, stats = td.death_growth_update(net, tmasks, rate,
                                        granularity="element",
                                        growth=growth, **kw)
    assert stats["total_death"] == int(wstats["total_death"]) > 0
    _assert_masks_equal(got, want)
    moved = 0
    for n, m in got.items():
        assert float(m.sum()) == float(tmasks[n].sum())
        moved += int((m != tmasks[n]).sum())
    assert moved > 0
    if growth == "gradient":
        # through the mask update on an Adam state
        state = tts.create_train_state(net, tmasks, optimizer="adam")
        with torch.no_grad():
            for d in (state.momentum.exp_avg, state.momentum.exp_avg_sq,
                      state.momentum.max_exp_avg_sq):
                for t in d.values():
                    t.add_(1.0)
        update = tts.make_mask_update_step(net, "gradient", "local",
                                           "element")
        state = update(state, rate, from_jax_params(grads))
        _assert_masks_equal(state.masks, want)
        for n, m in state.masks.items():
            for t in (state.params[n].detach(), state.momentum.exp_avg[n],
                      state.momentum.exp_avg_sq[n],
                      state.momentum.max_exp_avg_sq[n]):
                assert float((t * (1.0 - m)).abs().max()) == 0.0, n


def test_element_growth_keeps_the_alive_count_on_tied_draws():
    """Draws that tie at the growth threshold (at element granularity the
    reference over-grows routinely): exactly as many elements revive as
    died, the lowest-indexed of the dead ones (those just killed
    included), where the reference would revive every dead element."""
    rng = np.random.RandomState(0)
    w = torch.from_numpy(rng.rand(10, 12, 3, 3).astype(np.float32) + 0.1)
    mask = torch.from_numpy((rng.rand(10, 12, 3, 3) < 0.5)
                            .astype(np.float32))
    w = w * mask
    new, killed = td.layer_death_growth_element(
        w, mask, 0.5, scores=torch.full(w.shape, 0.5))
    alive = int(mask.sum())
    assert killed == int(np.ceil(0.5 * alive)) > 0
    assert float(new.sum()) == alive
    # the survivors: the alive elements above the killed ones' |w|
    a = (w.abs() * mask).reshape(-1).numpy()
    thr = np.sort(a)[a.size - alive + killed - 1]
    survived = (a > thr) & (mask.reshape(-1).numpy() > 0)
    grown = new.reshape(-1).numpy().astype(bool) & ~survived
    np.testing.assert_array_equal(np.nonzero(grown)[0],
                                  np.nonzero(~survived)[0][:killed])


def test_gmp_and_lottery_match_reference():
    params = _params(KW, SHAPE, 11)
    net = _port_model(KW, params, torch.float32)
    _assert_masks_equal(td.init_masks_lottery(net, 0.25),
                        jd.init_masks_lottery(params, 0.25))
    want = jd.init_masks_gmp(params)
    got = td.init_masks_gmp(net)
    _assert_masks_equal(got, want)
    dens = []
    for epoch in range(6):
        want = jd.gmp_prune_masks(params, want, epoch, 0.2,
                                  init_prune_epoch=1, final_prune_epoch=2,
                                  multiplier=2)
        got = td.gmp_prune_masks(net, got, epoch, 0.2, init_prune_epoch=1,
                                 final_prune_epoch=2, multiplier=2)
        _assert_masks_equal(got, want)
        # the trainer masks the weights after each prune
        params = jax.tree_util.tree_map(np.asarray,
                                        jd.apply_masks(params, want))
        tm.apply_masks(net, got)
        dens.append(tm.masks_density(got, net))
    # the window is epochs 2-4; epoch 2 prunes at rate 0
    assert dens[0] == dens[1] == dens[2] == 1.0 > dens[3] > dens[4]
    assert dens[4] == dens[5]


# ---- GraSP on the model of tests/test_components.py::test_grasp_init
GRASP_KW = dict(input_channels=1, num_classes=2,
                pool_op_kernel_sizes=((2, 2, 2), (2, 2, 2)),
                base_num_features=4, max_num_features=8)


@pytest.fixture(scope="module")
def grasp():
    """The reference's masks and scores (its own H g1, read by a spy on
    select_masked, whose last call in init_masks_grasp takes it), and the
    port's, on the same weights and batch."""
    from e2enet_tpu.models.unetpp import ShiftUNetPlusPlus as JaxNet
    from e2enet_tpu.ops.losses import dc_and_ce_loss
    from e2enet_tpu_torch.models.unetpp import ShiftUNetPlusPlus
    from e2enet_tpu_torch.ops.losses import dc_and_ce_loss as t_dc_ce
    m = JaxNet(**GRASP_KW, compute_dtype=jnp.float32)
    rng = np.random.RandomState(0)
    data = rng.randn(1, 8, 8, 8, 1).astype(np.float32)
    target = rng.randint(0, 2, (1, 8, 8, 8)).astype(np.int32)
    params = m.init(jax.random.PRNGKey(0), jnp.asarray(data))["params"]

    @jax.jit
    def loss_fn(p, d, t):
        return dc_and_ce_loss(m.apply({"params": p}, d, do_ds=False), t)

    seen = []
    real = jd.select_masked

    def spy(tree):
        seen.append(tree)
        return real(tree)
    jd.select_masked = spy
    try:
        want = jd.init_masks_grasp(loss_fn, params, 0.25, jnp.asarray(data),
                                   jnp.asarray(target))
    finally:
        jd.select_masked = real
    hg, w = real(seen[-1]), real(params)
    scores = {k: -np.asarray(w[k] * hg[k]) for k in w}
    norm = abs(float(np.sum(np.concatenate(
        [s.reshape(-1) for _, s in sorted(scores.items())])))) + 1e-10

    net = ShiftUNetPlusPlus(**GRASP_KW, compute_dtype=torch.float32,
                            device="cpu")
    net.load_state_dict(from_jax_params(jax.tree_util.tree_map(
        np.asarray, params)), strict=True)

    def t_loss(model, d, t):
        return t_dc_ce(model(d, do_ds=False), t)
    x, t = torch.from_numpy(data), torch.from_numpy(target).long()
    got_scores = td.grasp_scores(t_loss, net, x, t)
    got = td.init_masks_grasp(t_loss, net, 0.25, x, t)
    return ({k: s / norm for k, s in scores.items()}, want, got_scores,
            got, net)


def test_grasp_scores_match_reference(grasp):
    want_s, _, got_s, _, _ = grasp
    scale = max(float(np.abs(s).max()) for s in want_s.values())
    flat = tm.masks_to_flax(got_s)
    for k, s in want_s.items():
        np.testing.assert_allclose(flat["|".join(k)], s, rtol=0,
                                   atol=GRASP_ATOL * scale,
                                   err_msg="/".join(k))


def test_grasp_masks_match_reference(grasp):
    """Equal but where an entry's score lies within the tolerance of the
    threshold; the density the reference's test asks (0.25 within 0.03)."""
    want_s, want, _, got, net = grasp
    scale = max(float(np.abs(s).max()) for s in want_s.values())
    flat_s = np.concatenate([s.reshape(-1) for _, s in sorted(
        want_s.items())])
    num_rm = int(flat_s.size * 0.75)
    thr = np.sort(flat_s)[::-1][num_rm - 1]
    flat = tm.masks_to_flax(got)
    n_close = 0
    for k, m in want.items():
        diff = flat["|".join(k)] != np.asarray(m)
        near = np.abs(want_s[k] - thr) <= GRASP_ATOL * scale
        assert not (diff & ~near).any(), "/".join(k)
        n_close += int(diff.sum())
    assert n_close <= 0.001 * flat_s.size
    assert tm.masks_density(got, net) == pytest.approx(0.25, abs=0.03)


# ---- second derivatives: refused through the kernels' ops, right through
# ---- the plain path
DEEP_KW = dict(GRASP_KW, pool_op_kernel_sizes=((2, 2, 2),) * 3)


def _tiny(dtype=torch.float32):
    """(reference params, the port model (3 pools, so that a down-link
    feeds a nest node), a batch, the DC + CE loss)."""
    from e2enet_tpu_torch.models.unetpp import ShiftUNetPlusPlus
    from e2enet_tpu_torch.ops.losses import dc_and_ce_loss
    params = _params(DEEP_KW, SHAPE, 12)
    net = ShiftUNetPlusPlus(**DEEP_KW, compute_dtype=dtype, device="cpu")
    net.load_state_dict(from_jax_params(params), strict=True)
    rng = np.random.RandomState(13)
    x = rng.randn(*SHAPE).astype(np.float32)
    t = rng.randint(0, 2, SHAPE[:4]).astype(np.int32)
    return params, net, x, t, dc_and_ce_loss


@pytest.mark.parametrize("site", sorted(blocks.KERNEL_OPS))
def test_double_backward_through_a_kernel_op_refuses(site):
    """With every other kernel site on its plain version, the one left on
    its op (float32; bf16 for the lazy up-link block, whose route only a
    bf16 model takes) gives first derivatives and refuses a double
    backward, naming itself."""
    _, net, x, t, loss = _tiny(torch.bfloat16 if site == "lazy_up_fused_block"
                               else torch.float32)
    ps = list(net.parameters())
    with blocks.plain_ops():
        vars(blocks)[site] = blocks.KERNEL_OPS[site][0]
        lv = loss(net(torch.from_numpy(x), do_ds=False),
                  torch.from_numpy(t).long())
        first = torch.autograd.grad(lv, ps, retain_graph=True,
                                    allow_unused=True)
        assert all(torch.isfinite(f).all() for f in first if f is not None)
        name = ("plain_vjp" if site in ("strided_fused", "uplink", "seghead")
                else site)
        with pytest.raises(RuntimeError, match=name):
            torch.autograd.grad(lv, ps, create_graph=True,
                                allow_unused=True)


def test_plain_path_hessian_vector_product():
    """H v by a double backward through ops.blocks.plain_ops() (reverse
    over reverse, as init_masks_grasp takes it) against torch.func's
    forward over reverse (jvp of grad: the ops' forward-mode derivatives,
    another code path), float32: relative L2 per masked kernel within
    1e-5."""
    from torch.func import functional_call, grad, jvp
    _, net, x, t, t_loss = _tiny()
    xs, ts = torch.from_numpy(x), torch.from_numpy(t).long()
    masked = tm.masked_params(net)
    names = sorted(masked)
    fixed = {n: p.detach() for n, p in net.named_parameters()}
    gen = torch.Generator().manual_seed(15)
    v = {n: torch.randn(masked[n].shape, generator=gen) for n in names}

    def loss_of(mp):
        return t_loss(functional_call(net, {**fixed, **mp}, (xs,),
                                      {"do_ds": False}), ts)
    with blocks.plain_ops():
        ps = [masked[n] for n in names]
        g = torch.autograd.grad(t_loss(net(xs, do_ds=False), ts), ps,
                                create_graph=True)
        hv = torch.autograd.grad(
            sum((a * v[n]).sum() for a, n in zip(g, names)), ps)
        _, want = jvp(grad(loss_of), ({n: fixed[n] for n in names},), (v,))
    for n, got in zip(names, hv):
        w = want[n]
        assert float(w.norm()) > 0, n
        assert float((got - w).norm() / w.norm()) <= 1e-5, n
