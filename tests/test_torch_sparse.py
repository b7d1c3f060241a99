"""The port's ShiftUNetPlusPlus under the DSFF row-sparse plan: against the
reference's sparse model (XLA path, float32, HIGHEST precision) on the same
masked numpy weights for every mirror combination, do_ds True and False
(logits within 1e-3, as the dense parity test); against its own dense
masked forward (within 2e-5: the plan is exact up to summation order); and
its lazy up-link routing counted against the reference's, traced in
bfloat16 with jax.eval_shape (no interpret run).

Geometry of the reference's sparse-plan tests (tests/test_sparse_plan.py:
3 pools, base 8, max 32, row masks at density 0.4)."""
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import e2enet_tpu.ops.qfused as jqf  # noqa: E402
from e2enet_tpu.models.sparse_plan import build_sparse_plan  # noqa: E402
from e2enet_tpu.models.unetpp import ShiftUNetPlusPlus as JaxNet  # noqa: E402
from e2enet_tpu.training import dsff  # noqa: E402
import e2enet_tpu_torch.models.unetpp as tunetpp  # noqa: E402
import e2enet_tpu_torch.ops.blocks as tblocks  # noqa: E402
from e2enet_tpu_torch.models import masks as tmasks  # noqa: E402
from e2enet_tpu_torch.models import sparse_plan as tsp  # noqa: E402
from e2enet_tpu_torch.models.weights import from_jax_params  # noqa: E402

KW = dict(input_channels=1, num_classes=3,
          pool_op_kernel_sizes=((2, 2, 2),) * 3, base_num_features=8,
          max_num_features=32)
SHAPE = (1, 8, 16, 16, 1)


def _masked_setup(seed=3):
    """(numpy params, masked numpy params, reference plan, port masks)."""
    jnet = JaxNet(**KW, compute_dtype=jnp.float32, remat=False,
                  quadrant=False)
    shapes = jax.eval_shape(jnet.init, jax.random.PRNGKey(0),
                            jnp.zeros(SHAPE))
    rng = np.random.RandomState(seed)

    def fill(path, s):
        a = rng.randn(*s.shape).astype(np.float32)
        name = path[-1].key
        return 0.3 * a if name == "kernel" else (
            1.0 + 0.1 * a if name == "norm_scale" else 0.1 * a)

    params = jax.tree_util.tree_map_with_path(fill, shapes)
    jmasks = dsff.init_masks_row(params["params"], 0.4,
                                 jax.random.PRNGKey(seed),
                                 density_48_override=0.4)
    masked = {"params": jax.tree_util.tree_map(
        np.asarray, dsff.apply_masks(params["params"], jmasks))}
    tm = {".".join(k): np.asarray(v) for k, v in jmasks.items()}
    return params, masked, build_sparse_plan(jmasks), tm


def _port(params, dtype=torch.float32, plan=None, **kw):
    net = tunetpp.ShiftUNetPlusPlus(**KW, compute_dtype=dtype, device="cpu",
                                    **kw)
    net.load_state_dict(from_jax_params(params), strict=True)
    net.set_sparse_plan(plan)
    return net


@pytest.mark.parametrize("flips", list(itertools.product([False, True],
                                                         repeat=3)))
def test_sparse_model_matches_reference_all_flips(flips):
    params, masked, jplan, tm = _masked_setup()
    plan = tsp.build_sparse_plan(tm)
    assert plan == jplan and tsp.plan_density(plan, tm) < 0.7
    net = _port(masked, plan=plan)
    x = np.random.RandomState(1).randn(*SHAPE).astype(np.float32)
    jnet = JaxNet(**KW, compute_dtype=jnp.float32, remat=False, fused=False,
                  quadrant=False, sparse_plan=jplan)
    ref = jax.jit(lambda p, v: jnet.clone(flips=flips).apply(
        p, v, do_ds=True))(masked, jnp.asarray(x))
    with torch.no_grad():
        ds = net(torch.from_numpy(x), do_ds=True, flips=flips)
        top = net(torch.from_numpy(x), do_ds=False, flips=flips)
    assert len(ds) == len(ref) == 3
    for a, b in zip(ds, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-3,
                                   atol=1e-3)
    np.testing.assert_allclose(top.numpy(), np.asarray(ref[0]), rtol=1e-3,
                               atol=1e-3)


def test_sparse_forward_equals_dense_masked():
    """The plan changes only the summation order; also after the weights
    change (the gathered weights are derived again)."""
    _, masked, _, tm = _masked_setup(seed=5)
    plan = tsp.build_sparse_plan(tm)
    dense = _port(masked)
    sparse = _port(masked, plan=plan)
    x = torch.from_numpy(np.random.RandomState(2).randn(*SHAPE).astype(
        np.float32))
    with torch.no_grad():
        for flips in ((False, False, False), (True, True, False)):
            for a, b in zip(dense(x, do_ds=True, flips=flips),
                            sparse(x, do_ds=True, flips=flips)):
                torch.testing.assert_close(b, a, rtol=2e-5, atol=2e-5)
        for net in (dense, sparse):
            net.loc0_2.block0.bias.add_(0.5)
        torch.testing.assert_close(sparse(x, do_ds=False),
                                   dense(x, do_ds=False), rtol=2e-5,
                                   atol=2e-5)


def test_lazy_routing_matches_reference(monkeypatch):
    """The reference's bf16 sparse quadrant model routes every level-0 nest
    node through the lazy up-link (counted while tracing); the port's bf16
    model makes as many lazy calls, and each kernel site is reached as
    often as kernel_launches_per_forward says. lazy_up=False takes the
    materialised route with the same result on the CPU."""
    params, masked, jplan, tm = _masked_setup()
    calls = [0]
    real = jqf._qfused_op_lazy

    def count(*a, **k):
        calls[0] += 1
        return real(*a, **k)

    monkeypatch.setattr(jqf, "_qfused_op_lazy", count)
    jnet = JaxNet(**KW, compute_dtype=jnp.bfloat16, remat=False, fused=True,
                  fused_interpret=True, quadrant=True, sparse_plan=jplan)
    jax.eval_shape(lambda p, v: jnet.apply(p, v, do_ds=False), masked,
                   jnp.zeros(SHAPE, jnp.bfloat16))

    net = _port(masked, dtype=torch.bfloat16,
                plan=tsp.build_sparse_plan(tm))
    want = tunetpp.kernel_launches_per_forward(net)
    assert want["lazy_up_fused_block"] == calls[0] == net.num_pool
    assert want["uplink"] == 0
    got = {}
    for name in tblocks.KERNEL_OPS:
        fn = getattr(tblocks, name)

        def counted(*a, _name=name, _fn=fn, **k):
            got[_name] = got.get(_name, 0) + 1
            return _fn(*a, **k)
        monkeypatch.setattr(tblocks, name, counted)
    x = torch.from_numpy(np.random.RandomState(4).randn(*SHAPE).astype(
        np.float32))
    with torch.no_grad():
        lazy = net(x, do_ds=False)
        assert got == {k: v for k, v in want.items() if v}
        net.lazy_up = False
        got.clear()
        materialised = net(x, do_ds=False)
    want = tunetpp.kernel_launches_per_forward(net)
    assert want["lazy_up_fused_block"] == 0 and want["uplink"] == 3
    assert got == {k: v for k, v in want.items() if v}
    assert torch.equal(lazy, materialised)


def test_masked_params_are_the_references():
    """Every kernel the reference masks, and only those, carries a mask in
    the port (names through from_jax_params)."""
    params, _, _, tm = _masked_setup()
    net = _port(params)
    assert set(tmasks.masked_params(net)) == set(tm)
