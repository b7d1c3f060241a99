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


def _raw_plans(pools, patch, conv_per_stage=2):
    """A reference plans.pkl dict of one stage (the fields
    Plans.from_reference_pickle reads)."""
    return {
        "num_modalities": 2, "modalities": {0: "MR", 1: "MR"},
        "normalization_schemes": {0: "nonCT", 1: "nonCT"},
        "dataset_properties": {}, "num_classes": 2, "all_classes": [1, 2],
        "base_num_features": 4, "use_mask_for_norm": {0: False, 1: False},
        "transpose_forward": [0, 1, 2], "transpose_backward": [0, 1, 2],
        "data_identifier": "nnUNetData_plans_v2.1",
        "conv_per_stage": conv_per_stage,
        "plans_per_stage": {0: {
            "batch_size": 2, "num_pool_per_axis": [2, 2, 2],
            "patch_size": list(patch),
            "median_patient_size_in_voxels": list(patch),
            "current_spacing": [1, 1, 1], "original_spacing": [1, 1, 1],
            "do_dummy_2D_data_aug": False,
            "pool_op_kernel_sizes": [list(p) for p in pools],
            "conv_kernel_sizes": [[1, 3, 3]] * (len(pools) + 1)}}}


def _sidecar(tconv, plans, switches=None):
    init = {"fold": 0, "stage": 0, "tconv": tconv, "batch_dice": True,
            "base_num_features": 4, "cascade": False}
    init.update(switches or {})
    return {"init": init, "name": "TPUTrainer", "class": "t",
            "plans": plans.to_dict()}


ARCHS = [("ori", {}), ("resenc", {}),
         ("shiftConvPP", dict(conv_kernel=(3, 3, 3))),
         ("shiftConvPP", dict(norm_op="frn"))]


@pytest.mark.parametrize("tconv, switches", ARCHS,
                         ids=["ori", "resenc", "allConv3x3", "frn"])
def test_arch_checkpoints_cross_packages(tconv, switches, tmp_path):
    """A checkpoint of ori, resenc, allConv3x3 or FRN that the port writes
    loads in the JAX package with every parameter equal (the JAX
    package's ModelBundle reads the sidecar's init with .get, the
    switches in it unread), and the port's ModelBundle builds the
    switches' network from it; one the JAX package writes loads in the
    port into that network with every parameter equal."""
    from e2enet_tpu.inference.predictor import ModelBundle as JBundle
    from e2enet_tpu_torch.inference.predictor import ModelBundle
    from e2enet_tpu_torch.plans import Plans
    from test_torch_arch_switches import POOLS, PATCH, pair
    _, params, tnet, _ = pair(tconv, **switches)
    plans = Plans.from_reference_pickle(_raw_plans(POOLS, PATCH))
    ckpt_name = f"{tconv}_model_final_checkpoint.model"
    port_dir = tmp_path / "port" / "fold_0"
    port_dir.mkdir(parents=True)
    tckpt.save_checkpoint(str(port_dir / ckpt_name),
                          to_jax_params(tnet.state_dict()), 3,
                          sidecar=_sidecar(tconv, plans, switches))
    state, epoch, _ = jckpt.load_checkpoint(str(port_dir / ckpt_name))
    assert epoch == 3
    got = dict(jax.tree_util.tree_flatten_with_path(state.params)[0])
    want = jax.tree_util.tree_flatten_with_path(params)[0]
    assert set(got) == {p for p, _ in want}
    for p, v in want:
        np.testing.assert_array_equal(np.asarray(got[p]), v)
    jb = JBundle(str(tmp_path / "port"), [0], tconv,
                 compute_dtype=jnp.float32)
    assert jb.sidecar_init["tconv"] == tconv
    bundle = ModelBundle(str(tmp_path / "port"), [0], tconv,
                         compute_dtype=torch.float32, device="cpu")
    net = bundle.fold_models[0]
    assert bundle.arch == switches
    for n, v in tnet.state_dict().items():
        torch.testing.assert_close(net.state_dict()[n], v, rtol=0, atol=0)
    # the other way round
    jax_dir = tmp_path / "jax" / "fold_0"
    jax_dir.mkdir(parents=True)
    jckpt.save_checkpoint(str(jax_dir / ckpt_name),
                          create_train_state(jax.tree_util.tree_map(
                              jnp.asarray, params)), 5,
                          sidecar=_sidecar(tconv, plans, switches))
    state, epoch, _ = tckpt.load_checkpoint(str(jax_dir / ckpt_name))
    fresh = type(tnet)  # the same network, built again from the switches
    net2 = ModelBundle(str(tmp_path / "jax"), [0], tconv,
                       compute_dtype=torch.float32,
                       device="cpu").fold_models[0]
    assert isinstance(net2, fresh) and epoch == 5
    for n, v in from_jax_params(state["params"]).items():
        torch.testing.assert_close(net2.state_dict()[n], v, rtol=0, atol=0)


def test_jax_sidecar_gives_the_default_network(tmp_path):
    """A sidecar without the switches (the JAX trainer writes none) gives
    the default network, on the kernel route, as the JAX package builds
    it."""
    from e2enet_tpu.training.trainer import TPUTrainer
    from e2enet_tpu_torch.inference.predictor import ModelBundle
    from e2enet_tpu_torch.plans import Plans
    from test_torch_arch_switches import POOLS, PATCH, pair
    _, params, tnet, _ = pair()
    plans = Plans.from_reference_pickle(_raw_plans(POOLS, PATCH))
    sidecar = _sidecar("shiftConvPP", plans)
    fields = set(sidecar["init"])
    # the JAX trainer's own sidecar holds exactly these fields
    src = Path(TPUTrainer.save_checkpoint.__code__.co_filename).read_text()
    for f in fields:
        assert f'"{f}"' in src
    d = tmp_path / "fold_0"
    d.mkdir()
    jckpt.save_checkpoint(str(d / "shiftConvPP_model_final_checkpoint.model"),
                          create_train_state(jax.tree_util.tree_map(
                              jnp.asarray, params)), 1, sidecar=sidecar)
    bundle = ModelBundle(str(tmp_path), [0], "shiftConvPP",
                         compute_dtype=torch.float32, device="cpu")
    net = bundle.fold_models[0]
    assert bundle.arch == {} and net.kernel_route()
    assert (net.norm_op, net.nonlin, net.conv_kernel, net.seg_bias,
            net.num_conv_per_stage) == ("instance", "lrelu", (1, 3, 3),
                                        False, 2)


def test_jax_bundle_loses_the_architecture(tmp_path):
    """A reference fault the port does not copy: the JAX trainer's sidecar
    records no architecture switch, so the JAX package's ModelBundle builds
    a fold's default network. A BN + ReLU fold's parameters (the same tree
    as instance norm's) then run under instance norm and leaky relu
    without an error; a 3-conv fold runs as 2 convs per stage, its third
    convs unread; an allConv3x3 fold fails at its first conv. The port's
    sidecar records the switches and its ModelBundle builds the trained
    network."""
    from e2enet_tpu.inference.predictor import ModelBundle as JBundle
    from e2enet_tpu_torch.inference.predictor import ModelBundle
    from e2enet_tpu_torch.plans import Plans
    from test_torch_arch_switches import POOLS, PATCH, pair
    plans = Plans.from_reference_pickle(_raw_plans(POOLS, PATCH))
    x = jnp.asarray(np.random.RandomState(0).randn(1, *PATCH, 2),
                    jnp.float32)
    for tag, switches in (("bn_relu", dict(norm_op="batch", nonlin="relu")),
                          ("3conv", dict(num_conv_per_stage=3)),
                          ("allConv3x3", dict(conv_kernel=(3, 3, 3)))):
        jnet, params, tnet, _ = pair(**switches)
        d = tmp_path / tag / "fold_0"
        d.mkdir(parents=True)
        f = str(d / "shiftConvPP_model_final_checkpoint.model")
        jckpt.save_checkpoint(f, create_train_state(jax.tree_util.tree_map(
            jnp.asarray, params)), 1, sidecar=_sidecar("shiftConvPP", plans))
        jb = JBundle(str(tmp_path / tag), [0], "shiftConvPP",
                     compute_dtype=jnp.float32)
        net = jb.network.clone(quadrant_logits=False, quadrant_input=None)
        assert (net.norm_op, net.nonlin, net.num_conv_per_stage,
                net.conv_kernel) == ("instance", "lrelu", 2, (1, 3, 3))
        if tag == "allConv3x3":
            with pytest.raises(Exception):
                net.apply({"params": jb.fold_params[0]}, x, do_ds=False)
        else:
            got = net.apply({"params": jb.fold_params[0]}, x, do_ds=False)
            want = jnet.apply({"params": params}, x, do_ds=False)
            assert np.isfinite(np.asarray(got)).all()
            assert float(jnp.abs(got - want).max()) > 1e-3
        # the port's sidecar of the same fold holds the switches
        tckpt.save_checkpoint(f, params, 1, sidecar=_sidecar(
            "shiftConvPP", plans, switches))
        port = ModelBundle(str(tmp_path / tag), [0], "shiftConvPP",
                           compute_dtype=torch.float32,
                           device="cpu").fold_models[0]
        assert (port.norm_op, port.nonlin, port.num_conv_per_stage,
                port.conv_kernel) == (
            switches.get("norm_op", "instance"),
            switches.get("nonlin", "lrelu"),
            switches.get("num_conv_per_stage", 2),
            switches.get("conv_kernel", (1, 3, 3)))
