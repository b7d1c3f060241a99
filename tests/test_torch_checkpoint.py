"""Checkpoints across the two packages: training/checkpoint.py of the port
against e2enet_tpu/training/checkpoint.py.

A checkpoint the JAX package writes (row masks, float metadata) loads in a
process where jax and flax cannot be imported, its params equal to the bit
after models/weights.from_jax_params; to_jax_params inverts
from_jax_params; a checkpoint the port writes loads in the JAX package
with every leaf equal; and a payload holding a jax object is refused with
its key named."""
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from e2enet_tpu.models.unetpp import ShiftUNetPlusPlus as JaxNet  # noqa: E402
from e2enet_tpu.training import checkpoint as jckpt  # noqa: E402
from e2enet_tpu.training import dsff  # noqa: E402
from e2enet_tpu.training.train_state import create_train_state  # noqa: E402
from e2enet_tpu_torch.models.masks import mask_shape, masked_params  # noqa
from e2enet_tpu_torch.models.unetpp import ShiftUNetPlusPlus  # noqa: E402
from e2enet_tpu_torch.models.weights import (from_jax_params,  # noqa: E402
                                             to_jax_params)
from e2enet_tpu_torch.training import checkpoint as tckpt  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
KW = dict(input_channels=1, num_classes=4,
          pool_op_kernel_sizes=((2, 2, 2), (1, 2, 2)), base_num_features=4)


def jax_params(seed=0):
    net = JaxNet(**KW, compute_dtype=jnp.float32, quadrant=False)
    shapes = jax.eval_shape(net.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 8, 8, 8, 1)))["params"]
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda s: rng.randn(*s.shape).astype(np.float32), shapes)


def flat(tree, prefix=()):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def test_jax_checkpoint_loads_without_jax(tmp_path):
    params = jax_params(1)
    masks = dsff.init_masks_row(params, 0.5, jax.random.PRNGKey(2),
                                density_48_override=0.5)
    state = create_train_state(params, masks)
    path = str(tmp_path / "shiftConvPP_model_final_checkpoint.model")
    jckpt.save_checkpoint(path, state, 7,
                          {"all_tr_losses": [0.5, 0.25],
                           "best_val_eval_criterion_MA": 0.75},
                          {"init": {"stage": 0}, "name": "T", "class": "T",
                           "plans": {}})
    out = str(tmp_path / "loaded.npz")
    script = textwrap.dedent(f"""
        import sys
        sys.modules["jax"] = None
        sys.modules["flax"] = None
        sys.path.insert(0, {str(REPO)!r})
        import numpy as np
        from e2enet_tpu_torch.models.weights import from_jax_params
        from e2enet_tpu_torch.training.checkpoint import load_checkpoint
        state, epoch, meta = load_checkpoint({path!r})
        assert epoch == 7, epoch
        assert meta == {{"all_tr_losses": [0.5, 0.25],
                        "best_val_eval_criterion_MA": 0.75}}, meta
        sd = from_jax_params(state["params"])
        arrays = {{"sd." + k: v.numpy() for k, v in sd.items()}}
        arrays.update({{"mask." + k: v for k, v in state["masks"].items()}})
        arrays["rng"] = state["rng"]
        arrays["step"] = np.asarray(state["step"])
        np.savez({out!r}, **arrays)
        assert not any(m.split(".")[0] in ("jax", "flax", "e2enet_tpu")
                       for m, v in sys.modules.items() if v is not None)
    """)
    r = subprocess.run([sys.executable, "-c", script], capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    got = np.load(out)
    want = from_jax_params(jax.tree_util.tree_map(np.asarray, state.params))
    assert {k[3:] for k in got.files if k.startswith("sd.")} == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got["sd." + k], v.numpy())
    want_masks = {"|".join(k): np.asarray(v) for k, v in masks.items()}
    assert {k[5:] for k in got.files if k.startswith("mask.")} == \
        set(want_masks)
    for k, v in want_masks.items():
        np.testing.assert_array_equal(got["mask." + k], v)
    np.testing.assert_array_equal(got["rng"], np.asarray(state.rng))
    assert int(got["step"]) == 0


def test_to_jax_params_inverts_from_jax_params():
    params = jax.tree_util.tree_map(np.asarray, jax_params(3))
    back = to_jax_params(from_jax_params(params))
    a, b = list(flat(params)), list(flat(back))
    assert [k for k, _ in a] == [k for k, _ in b]
    for (k, x), (_, y) in zip(a, b):
        assert x.shape == y.shape and y.dtype == np.float32, k
        np.testing.assert_array_equal(x, y, err_msg="/".join(k))
    # and from a model's own state_dict
    net = ShiftUNetPlusPlus(**KW, compute_dtype=torch.float32, device="cpu")
    net.reset_parameters(seed=4)
    sd = from_jax_params(to_jax_params(net.state_dict()))
    for k, v in net.state_dict().items():
        assert torch.equal(sd[k], v), k


def test_port_checkpoint_loads_in_jax(tmp_path):
    net = ShiftUNetPlusPlus(**KW, compute_dtype=torch.float32, device="cpu")
    net.reset_parameters(seed=5)
    params = to_jax_params(net.state_dict())
    rng = np.random.RandomState(6)
    masks = {}
    for name, w in masked_params(net).items():
        cin, cout = mask_shape(w)
        rows = (rng.rand(cin, 1) < 0.5).astype(np.float32)
        masks[name.replace(".", "|")] = rows.repeat(cout, 1)
    path = str(tmp_path / "port.model")
    tckpt.save_checkpoint(path, params, 12, masks=masks, step=30,
                          metadata={"note": "port"},
                          sidecar={"init": {"stage": 0}, "plans": {}})
    state, epoch, meta = jckpt.load_checkpoint(path)
    assert epoch == 12 and meta == {"note": "port"}
    assert int(state.step) == 30
    a = list(flat(params))
    b = list(flat(jax.tree_util.tree_map(np.asarray, state.params)))
    assert [k for k, _ in a] == [k for k, _ in b]
    for (k, x), (_, y) in zip(a, b):
        np.testing.assert_array_equal(x, y, err_msg="/".join(k))
    for (k, y) in flat(jax.tree_util.tree_map(np.asarray, state.momentum)):
        assert not y.any(), k
    assert set(state.masks) == {tuple(k.split("|")) for k in masks}
    for k, v in masks.items():
        np.testing.assert_array_equal(np.asarray(state.masks[
            tuple(k.split("|"))]), v)
    # the port reads what it wrote
    tstate, tepoch, _ = tckpt.load_checkpoint(path)
    assert tepoch == 12 and set(tstate["masks"]) == set(masks)
    assert Path(path + ".pkl").is_file()


def test_jax_objects_are_refused_by_key(tmp_path):
    state = create_train_state(jax_params(7))
    path = str(tmp_path / "jaxmeta.model")
    jckpt.save_checkpoint(path, state, 1,
                          {"val_eval_criterion_MA": jnp.float32(0.5)})
    with pytest.raises(ValueError, match="metadata/val_eval_criterion_MA"):
        tckpt.load_checkpoint(path)
