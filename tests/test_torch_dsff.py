"""The port's row-granular DSFF (e2enet_tpu_torch/training/dsff.py) against
the reference's (e2enet_tpu/training/dsff.py): the row death equal to the
reference's for the same (w, mask, rate), ties included; the growth equal
when fed the reference's draw; a whole model's update equal, the row
counts and the density preserved; the initial row counts and the
cosine-decayed death rate."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from e2enet_tpu.training import dsff as jd  # noqa: E402
from e2enet_tpu_torch.models.masks import masks_density  # noqa: E402
from e2enet_tpu_torch.models.unetpp import ShiftUNetPlusPlus  # noqa: E402
from e2enet_tpu_torch.models.weights import from_jax_params  # noqa: E402
from e2enet_tpu_torch.training import dsff as td  # noqa: E402

# reference layout -> port layout
PERM = {4: (3, 2, 0, 1), 5: (3, 4, 0, 1, 2)}


def _layer(seed, shape, dead_rows, tie):
    rng = np.random.RandomState(seed)
    w = rng.randn(*shape).astype(np.float32)
    cin, cout = shape[-2], shape[-1]
    rows = np.ones(cin, np.float32)
    rows[rng.choice(cin, dead_rows, replace=False)] = 0.0
    if tie:                    # two alive rows of equal L1
        alive = np.nonzero(rows)[0]
        w[..., alive[1], :] = -w[..., alive[0], :]
    mask = np.repeat(rows[:, None], cout, axis=1)
    return w * mask.reshape((1,) * (w.ndim - 2) + mask.shape), mask


@pytest.mark.parametrize("shape", [(3, 3, 12, 8), (2, 2, 2, 10, 6)])
@pytest.mark.parametrize("rate,tie", [(0.5, False), (0.3, True),
                                      (0.001, False)])
def test_layer_death_growth_matches_reference(shape, rate, tie):
    w, mask = _layer(len(shape) + int(tie), shape, 4, tie)
    key = jax.random.PRNGKey(3)
    want, wdeaths = jd._layer_death_growth_row(
        jnp.asarray(w), None, jnp.asarray(mask), key, jnp.float32(rate),
        "random")
    draw = np.asarray(jax.random.uniform(key, (shape[-2],)))
    got, deaths = td.layer_death_growth_row(
        torch.from_numpy(w.transpose(PERM[len(shape)]).copy()),
        torch.from_numpy(mask), rate, scores=torch.from_numpy(draw.copy()))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert deaths == int(wdeaths)
    assert got.numpy()[:, 0].sum() == mask[:, 0].sum()


def _jax_params(kw, shape, seed=0):
    from e2enet_tpu.models.unetpp import ShiftUNetPlusPlus as JaxNet
    net = JaxNet(**kw, compute_dtype=jnp.float32, remat=False,
                 quadrant=False)
    shapes = jax.eval_shape(net.init, jax.random.PRNGKey(0),
                            jnp.zeros(shape, jnp.float32))
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda s: (0.3 * rng.randn(*s.shape)).astype(np.float32), shapes)


def test_model_update_matches_reference():
    kw = dict(input_channels=1, num_classes=3,
              pool_op_kernel_sizes=((2, 2, 2),) * 3, base_num_features=8)
    params = _jax_params(kw, (1, 16, 16, 16, 1))["params"]
    masks = jd.init_masks_row(params, 0.4, jax.random.PRNGKey(1),
                              density_48_override=0.4)
    params = jd.apply_masks(params, masks)
    rng = jax.random.PRNGKey(2)
    want, _ = jd.death_growth_update(params, None, masks, rng,
                                     jnp.float32(0.5), "random", "row")
    # the reference's draws: one split per masked kernel in sorted order
    scores, key = {}, rng
    for path in sorted(masks):
        key, sub = jax.random.split(key)
        scores[".".join(path)] = torch.from_numpy(np.asarray(
            jax.random.uniform(sub, (masks[path].shape[0],))))

    model = ShiftUNetPlusPlus(**kw, compute_dtype=torch.float32,
                              device="cpu")
    model.load_state_dict(from_jax_params(params), strict=True)
    tmasks = {".".join(p): torch.from_numpy(np.asarray(m))
              for p, m in masks.items()}
    got, stats = td.death_growth_update(model, tmasks, 0.5, scores=scores)
    assert set(got) == set(tmasks)
    for path, m in want.items():
        np.testing.assert_array_equal(got[".".join(path)].numpy(),
                                      np.asarray(m))
        assert float(got[".".join(path)][:, 0].sum()) == float(
            tmasks[".".join(path)][:, 0].sum())
    assert stats["total_death"] > 0
    np.testing.assert_allclose(masks_density(got, model),
                               float(jd.masks_density(want, params)),
                               rtol=1e-6)
    assert masks_density(got, model) == masks_density(tmasks, model)


def test_init_masks_row_counts_and_generator():
    kw = dict(input_channels=1, num_classes=3,
              pool_op_kernel_sizes=((2, 2, 2),) * 3, base_num_features=48)
    model = ShiftUNetPlusPlus(**kw, compute_dtype=torch.float32,
                              device="cpu")
    masks = td.init_masks_row(model, 0.3, torch.Generator().manual_seed(0),
                              density_48_override=0.2)
    params = dict(model.named_parameters())
    jmasks = jd.init_masks_row(_jax_params(kw, (1, 16, 16, 16, 1))["params"],
                               0.3, jax.random.PRNGKey(0),
                               density_48_override=0.2)
    assert set(masks) == {".".join(p) for p in jmasks}
    for path, jm in jmasks.items():
        m = masks[".".join(path)]
        assert bool((m == m[:, :1]).all())                 # constant rows
        assert float(m[:, 0].sum()) == float(np.asarray(jm)[:, 0].sum())
        # the torch-dim-0 rule: kernels whose dim 0 is 48 take 0.2
        cin = m.shape[0]
        d = 0.2 if params[".".join(path)].shape[0] == 48 else 0.3
        assert float(m[:, 0].sum()) == max(1, min(round(cin * d), cin))
    again = td.init_masks_row(model, 0.3, torch.Generator().manual_seed(0),
                              density_48_override=0.2)
    assert all(torch.equal(masks[k], again[k]) for k in masks)


def test_cosine_death_rate():
    for step in (0, 30, 250, 599, 600, 900):
        np.testing.assert_allclose(
            td.cosine_death_rate(step, 0.5, 600),
            float(jd.cosine_death_rate(jnp.asarray(step, jnp.float32), 0.5,
                                       600)), rtol=1e-6, atol=1e-7)
