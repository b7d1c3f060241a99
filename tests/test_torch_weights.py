"""Reference params -> port state_dict: every leaf lands in exactly one port
tensor with the stated layout, and the state_dict loads with strict=True.
Also: importing the port leaves jax out of the process."""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from e2enet_tpu.models.unetpp import ShiftUNetPlusPlus as JaxNet  # noqa: E402
from e2enet_tpu_torch.models.unetpp import ShiftUNetPlusPlus  # noqa: E402
from e2enet_tpu_torch.models.weights import from_jax_params  # noqa: E402

REPO = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("pools", [2, 5])
def test_every_leaf_maps_once_and_loads_strict(pools):
    kw = dict(input_channels=2, num_classes=4,
              pool_op_kernel_sizes=((2, 2, 2),) * pools,
              base_num_features=4)
    jnet = JaxNet(**kw, compute_dtype=jnp.float32, quadrant=False)
    side = 2 ** pools
    shapes = jax.eval_shape(jnet.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, side, side, side, 2)))
    leaves = jax.tree_util.tree_leaves_with_path(shapes)
    rng = np.random.RandomState(pools)
    params = jax.tree_util.tree_map(
        lambda s: rng.randn(*s.shape).astype(np.float32), shapes)

    sd = from_jax_params(params)
    assert len(sd) == len(leaves)
    net = ShiftUNetPlusPlus(**kw, compute_dtype=torch.float32, device="cpu")
    net.load_state_dict(sd, strict=True)

    perms = {4: (3, 2, 0, 1), 5: (3, 4, 0, 1, 2), 2: (1, 0)}
    flat = dict(jax.tree_util.tree_leaves_with_path(params))
    for path, leaf in flat.items():
        key = ".".join(p.key for p in path[1:])     # drop the "params" root
        want = (np.transpose(leaf, perms[leaf.ndim])
                if path[-1].key == "kernel" else leaf)
        np.testing.assert_array_equal(sd[key].numpy(), want)
    assert set(dict(net.named_parameters())) == set(sd)


def test_quadrant_model_tree_loads_strict():
    """The reference's quadrant kernel model (the serving path whose flip
    variants and probs head share one parameter tree) has the port's
    parameter tree: filled from numpy, it loads with strict=True and every
    leaf lands where the dense model's would."""
    kw = dict(input_channels=1, num_classes=3,
              pool_op_kernel_sizes=((2, 2, 2),) * 3, base_num_features=4)
    shape = (1, 16, 16, 16, 1)
    qnet = JaxNet(**kw, compute_dtype=jnp.float32, quadrant=True, fused=True,
                  fused_interpret=True, remat=False)
    qshapes = jax.eval_shape(qnet.init, jax.random.PRNGKey(0),
                             jnp.zeros(shape))
    dshapes = jax.eval_shape(
        JaxNet(**kw, compute_dtype=jnp.float32, quadrant=False).init,
        jax.random.PRNGKey(0), jnp.zeros(shape))
    rng = np.random.RandomState(11)
    params = jax.tree_util.tree_map(
        lambda s: rng.randn(*s.shape).astype(np.float32), qshapes)
    assert jax.tree_util.tree_structure(qshapes) == \
        jax.tree_util.tree_structure(dshapes)
    sd = from_jax_params(params)
    net = ShiftUNetPlusPlus(**kw, compute_dtype=torch.float32,
                            head_probs_dtype=torch.bfloat16, device="cpu")
    net.load_state_dict(sd, strict=True)
    for (path, q), (_, d) in zip(
            jax.tree_util.tree_leaves_with_path(qshapes),
            jax.tree_util.tree_leaves_with_path(dshapes)):
        assert q.shape == d.shape, path


def test_unknown_leaf_is_refused():
    with pytest.raises(ValueError):
        from_jax_params({"params": {"x": {"scale": np.zeros(3)}}})


def test_import_does_not_load_jax():
    """tests/conftest.py imports jax in-process, so check in a child."""
    code = ("import sys, e2enet_tpu_torch.models.unetpp, "
            "e2enet_tpu_torch.models.weights, e2enet_tpu_torch.ops.sliding, "
            "e2enet_tpu_torch.ops._native, e2enet_tpu_torch.ops.qstride, "
            "e2enet_tpu_torch.ops.qlink, e2enet_tpu_torch.ops.qfused, "
            "e2enet_tpu_torch.models.sparse_plan, "
            "e2enet_tpu_torch.models.masks, "
            "e2enet_tpu_torch.inference.predictor; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'e2enet_tpu', 'triton')]; "
            "assert not bad, bad")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """chip_smoke.py exits non-zero and prints no result line where there
    is no card, and where it stands alone without the package."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((REPO / "chip_smoke.py").read_text())
    for cwd, script in ((REPO, REPO / "chip_smoke.py"), (tmp_path, alone)):
        r = subprocess.run([sys.executable, str(script)], cwd=cwd,
                           capture_output=True, text=True, timeout=120)
        assert r.returncode != 0
        assert '"ok"' not in r.stdout
