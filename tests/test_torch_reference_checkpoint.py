"""Reference-trained PyTorch checkpoints in the port
(e2enet_tpu_torch/models/torch_checkpoint.py, models/torch_import.py)
against the JAX package's (e2enet_tpu/models/torch_checkpoint.py,
torch_import.py), on a reference-format .model written from a port
network's weights through export_unetpp_state_dict (a torch.save dict and
its .model.pkl sidecar with a reference plans dict):

- export_unetpp_state_dict equal to the JAX package's on the same params,
  convert_unetpp_state_dict its inverse, at 2 and 3 convs per stage;
- load_reference_checkpoint equal to the JAX package's on the same file:
  every parameter, the plans, the info;
- convert_reference_model_to_native writes the port's checkpoint format
  (which the JAX package loads too); its fold predicts the same labels
  and probabilities (float32, CPU) as the native checkpoint of the same
  weights; a 3-conv plan's conversion records num_conv_per_stage, so the
  predictor builds the 3-conv network.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from e2enet_tpu.models import torch_checkpoint as jtc  # noqa: E402
from e2enet_tpu.models import torch_import as jti  # noqa: E402
from e2enet_tpu.training import checkpoint as jckpt  # noqa: E402
from e2enet_tpu_torch.inference.predictor import (ModelBundle,  # noqa: E402
                                                  predict_case)
from e2enet_tpu_torch.models import torch_checkpoint as ttc  # noqa: E402
from e2enet_tpu_torch.models import torch_import as tti  # noqa: E402
from e2enet_tpu_torch.models.weights import to_jax_params  # noqa: E402
from e2enet_tpu_torch.plans import Plans  # noqa: E402
from e2enet_tpu_torch.training import checkpoint as tckpt  # noqa: E402
from e2enet_tpu_torch.utils.files import save_pickle  # noqa: E402
from test_torch_arch_switches import _stage  # noqa: E402
from test_torch_checkpoint import _raw_plans, _sidecar  # noqa: E402
import e2enet_tpu_torch.plans as tplans  # noqa: E402
from e2enet_tpu_torch.models.unetpp import build_network  # noqa: E402

POOLS = ((2, 2, 2), (2, 2, 2))
PATCH = (8, 16, 16)


def _port_net(num_conv=2, seed=0):
    net = build_network(_stage(tplans, POOLS, PATCH), 2, 3,
                        base_num_features=4, compute_dtype=torch.float32,
                        num_conv_per_stage=num_conv, device="cpu")
    net.reset_parameters(seed)
    with torch.no_grad():    # no trivial bias or norm parameter
        g = torch.Generator().manual_seed(seed + 1)
        for n, p in net.named_parameters():
            if p.dim() == 1:
                p.add_(0.1 * torch.randn(p.shape, generator=g))
    return net


def _write_reference(tmp_path, net, num_conv=2):
    params = to_jax_params(net.state_dict())
    sd = tti.export_unetpp_state_dict(params, len(POOLS), num_conv)
    want = jti.export_unetpp_state_dict(params, len(POOLS), num_conv)
    assert set(sd) == set(want)
    for k in sd:
        np.testing.assert_array_equal(sd[k], want[k], err_msg=k)
    back = tti.convert_unetpp_state_dict(sd, len(POOLS), num_conv)
    for (p, a), (q, b) in zip(jax.tree_util.tree_flatten_with_path(params)[0],
                              jax.tree_util.tree_flatten_with_path(back)[0]):
        assert p == q
        np.testing.assert_array_equal(a, b)
    f = str(tmp_path / "shiftConvPP_model_final_checkpoint.model")
    torch.save({"epoch": 42, "state_dict": {
        k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()},
        "optimizer_state_dict": None}, f)
    save_pickle({"init": (None,) * 9, "name": "nnUNetTrainer_simple",
                 "class": "...",
                 "plans": _raw_plans(POOLS, PATCH, num_conv)}, f + ".pkl")
    return f, params


@pytest.mark.parametrize("num_conv", [2, 3])
def test_load_equals_the_reference(tmp_path, num_conv):
    f, params = _write_reference(tmp_path, _port_net(num_conv), num_conv)
    got, plans, info = ttc.load_reference_checkpoint(f)
    want, jplans, jinfo = jtc.load_reference_checkpoint(f)
    assert info == jinfo and info["epoch"] == 42 and info["num_pool"] == 2
    assert plans.to_dict() == jplans.to_dict()
    assert plans.conv_per_stage == num_conv
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
    assert [p for p, _ in flat_g] == [p for p, _ in flat_w]
    for (_, a), (_, b), (_, c) in zip(
            flat_g, flat_w, jax.tree_util.tree_flatten_with_path(params)[0]):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


@pytest.mark.parametrize("num_conv", [2, 3])
def test_converted_fold_predicts_as_the_native_one(tmp_path, num_conv):
    net = _port_net(num_conv, seed=3)
    f, params = _write_reference(tmp_path, net, num_conv)
    conv = tmp_path / "converted" / "fold_0"
    conv.mkdir(parents=True)
    out = ttc.convert_reference_model_to_native(
        f, str(conv / "shiftConvPP_model_final_checkpoint.model"),
        base_num_features=4)
    # the JAX package reads what the port wrote
    jstate, epoch, _ = jckpt.load_checkpoint(out)
    assert epoch == 42
    native = tmp_path / "native" / "fold_0"
    native.mkdir(parents=True)
    plans = Plans.from_reference_pickle(_raw_plans(POOLS, PATCH, num_conv))
    switches = {} if num_conv == 2 else {"num_conv_per_stage": num_conv}
    tckpt.save_checkpoint(
        str(native / "shiftConvPP_model_final_checkpoint.model"), params, 1,
        sidecar=_sidecar("shiftConvPP", plans, switches))
    data = np.random.RandomState(0).standard_normal(
        (2, 16, 16, 32)).astype(np.float32)
    probs = []
    for folder in (tmp_path / "converted", tmp_path / "native"):
        bundle = ModelBundle(str(folder), [0], "shiftConvPP",
                             compute_dtype=torch.float32, device="cpu")
        assert bundle.fold_models[0].num_conv_per_stage == num_conv
        probs.append(predict_case(bundle, data, do_tta=False,
                                  step_size=1.0))
    np.testing.assert_array_equal(probs[0].argmax(0), probs[1].argmax(0))
    np.testing.assert_allclose(probs[0], probs[1], rtol=0, atol=1e-6)
