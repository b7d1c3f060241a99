"""The port's own sparse plan, compact groups and mask handling against the
reference's (e2enet_tpu/models/sparse_plan.py, ops/shift.py,
training/dsff.py, bench.py's artifact load): the plan and its density on
the in-repo trained mask artifact and on random row masks, exactly; the
artifact loader's key and shape checks on a bench-width model; w * mask on
the port's layouts bit for bit against the reference's on the same numpy
weights."""
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from e2enet_tpu.models import sparse_plan as jsp  # noqa: E402
from e2enet_tpu.models.unetpp import ShiftUNetPlusPlus as JaxNet  # noqa: E402
from e2enet_tpu.ops.shift import compact_groups as j_compact  # noqa: E402
from e2enet_tpu.ops.shift import group_shifts as j_groups  # noqa: E402
from e2enet_tpu.training import dsff  # noqa: E402
from e2enet_tpu_torch.models import masks as tmasks  # noqa: E402
from e2enet_tpu_torch.models import sparse_plan as tsp  # noqa: E402
from e2enet_tpu_torch.models.unetpp import ShiftUNetPlusPlus  # noqa: E402
from e2enet_tpu_torch.models.weights import from_jax_params  # noqa: E402
from e2enet_tpu_torch.ops.shift import compact_groups  # noqa: E402

ARTIFACT = (Path(__file__).resolve().parents[1] / "experiments" / "logs"
            / "bench_masks_trained.npz")
BENCH = dict(input_channels=1, num_classes=16,
             pool_op_kernel_sizes=((2, 2, 2),) * 5, base_num_features=48)
SMALL = dict(input_channels=1, num_classes=3,
             pool_op_kernel_sizes=((2, 2, 2),) * 3, base_num_features=8,
             max_num_features=32)


def _artifact():
    with np.load(ARTIFACT) as z:
        return {k: np.asarray(z[k]) for k in z.files}


def test_plan_matches_reference_on_trained_artifact():
    raw = _artifact()
    jmasks = {tuple(k.split("|")): v for k, v in raw.items()}
    tmasks_ = {k.replace("|", "."): v for k, v in raw.items()}
    plan = tsp.build_sparse_plan(tmasks_)
    assert plan == jsp.build_sparse_plan(jmasks)
    keys = dict(plan)
    assert len(plan) == 35 and "up0_0" in keys and "loc0_0/block0" in keys
    assert tsp.plan_density(plan, tmasks_) == \
        jsp.plan_density(plan, jmasks)


@pytest.mark.parametrize("seed", [0, 1])
def test_plan_matches_reference_on_random_masks(seed):
    rng = np.random.RandomState(seed)
    jm, tm = {}, {}
    for i, (cin, cout) in enumerate([(96, 48), (40, 16), (8, 8), (24, 24)]):
        rows = (rng.rand(cin) < 0.3).astype(np.float32)
        if i == 2:
            rows[:] = 1.0                   # all alive: no entry
        m = np.repeat(rows[:, None], cout, axis=1)
        jm[(f"loc{i}_0", "block0", "kernel")] = m
        tm[f"loc{i}_0.block0.kernel"] = m
    assert tsp.build_sparse_plan(tm) == jsp.build_sparse_plan(jm)
    plan = tsp.build_sparse_plan(tm)
    assert tsp.plan_density(plan, tm) == jsp.plan_density(plan, jm)
    # kernel-pair masks have no row structure: no plan
    pair = {k: (rng.rand(*v.shape) < 0.3).astype(np.float32)
            for k, v in tm.items()}
    assert tsp.build_sparse_plan(pair) is None
    assert jsp.build_sparse_plan(
        {tuple(k.split(".")): v for k, v in pair.items()}) is None


@pytest.mark.parametrize("seed", range(4))
def test_compact_groups_match_reference(seed):
    rng = np.random.RandomState(seed)
    C = int(rng.randint(8, 200))
    alive = np.sort(rng.choice(C, size=int(rng.randint(1, C)),
                               replace=False))
    groups = j_groups(C, 5)
    assert compact_groups(groups, alive) == j_compact(groups, alive)


def test_artifact_loads_into_bench_model_with_shape_check(tmp_path):
    net = ShiftUNetPlusPlus(**BENCH, device="cpu")     # no weights drawn
    masks = tmasks.load_mask_artifact(ARTIFACT, net)
    assert len(masks) == 35
    assert abs(tmasks.masks_density(masks, net) - 0.2) < 0.005
    raw = _artifact()
    bad = dict(raw)
    bad["up0_4|kernel"] = raw["up0_4|kernel"][:, :40]        # wrong shape
    for name, arrays in (
            ("shape", bad),
            ("missing", {k: v for k, v in raw.items() if k != "up0_4|kernel"}),
            ("extra", dict(raw, **{"loc9_9|block0|kernel": raw[
                "up0_4|kernel"]}))):
        path = tmp_path / f"{name}.npz"
        np.savez(path, **arrays)
        with pytest.raises(ValueError):
            tmasks.load_mask_artifact(path, net)


def test_apply_masks_matches_reference_bit_for_bit():
    jnet = JaxNet(**SMALL, compute_dtype=jnp.float32, quadrant=False)
    shapes = jax.eval_shape(jnet.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 8, 16, 16, 1)))
    rng = np.random.RandomState(3)
    params = jax.tree_util.tree_map(
        lambda s: rng.randn(*s.shape).astype(np.float32), shapes)["params"]
    jmasks = dsff.init_masks_row(params, 0.4, jax.random.PRNGKey(5),
                                 density_48_override=0.4)
    want = from_jax_params(dsff.apply_masks(params, jmasks))
    net = ShiftUNetPlusPlus(**SMALL, compute_dtype=torch.float32,
                            device="cpu")
    net.load_state_dict(from_jax_params(params), strict=True)
    masks = {".".join(k): np.asarray(v) for k, v in jmasks.items()}
    assert set(masks) == set(tmasks.masked_params(net))
    tmasks.apply_masks(net, masks)
    got = net.state_dict()
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    assert tmasks.masks_density(masks, net) == pytest.approx(
        float(dsff.masks_density(jmasks, params)), rel=1e-6)
