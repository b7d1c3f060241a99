"""The port's residual-encoder UNet (e2enet_tpu_torch/models/resenc.py,
FabiansUNet) against the JAX package's (e2enet_tpu/models/resenc.py), as
tests/test_resenc.py holds the JAX one: float32 on the CPU, the same
weights crossing over with models/weights.from_jax_params (its own leaf
names: initial_*, conv1/2, bias1/2, scale1/2, nbias1/2, skip_*):

- every deep-supervision output (min(4, num_pool), full resolution first)
  within 2e-4 (tests/test_resenc.py's tolerance for the 3D convs), with
  instance and batch norm, ReLU, seg_bias, an anisotropic plan;
- output shapes and count, do_ds=False equal to the first output;
- one step's float32 gradients within 1e-4 relative per leaf (conv biases
  ahead of a norm: zero on both sides);
- no mirrored operators: flips refused (data-flip TTA), no kernel launch;
- the checkpoint's params tree round-trips through the port's state_dict.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import e2enet_tpu_torch.plans as tplans  # noqa: E402
from e2enet_tpu_torch.models.resenc import ResidualUNet  # noqa: E402
from e2enet_tpu_torch.models.unetpp import (  # noqa: E402
    build_network, kernel_launches_per_forward)
from test_torch_arch_switches import (TOL_3D, _grad_check,  # noqa: E402
                                      _stage, check_forward, pair)


@pytest.mark.parametrize("kw", [
    dict(), dict(norm_op="batch"), dict(nonlin="relu", seg_bias=True),
    dict(pools=((1, 2, 2), (2, 2, 2), (2, 2, 2)), patch=(8, 16, 16)),
    dict(pools=((2, 2, 2),) * 5, patch=(32, 32, 32), base=2)],
    ids=["in", "bn", "relu_seg_bias", "anis", "five_pools"])
def test_forward_matches_reference(kw):
    net = check_forward("resenc", tol=TOL_3D, **kw)
    assert isinstance(net, ResidualUNet)
    assert net.num_ds_outputs() == min(4, net.num_pool)


def test_shapes_and_ds():
    net = ResidualUNet(2, 4, ((2, 2, 2), (2, 2, 2), (1, 2, 2)),
                       base_num_features=4, compute_dtype=torch.float32,
                       device="cpu")
    net.reset_parameters(0)
    x = torch.zeros(1, 8, 16, 16, 2)
    with torch.no_grad():
        outs = net(x, do_ds=True)
        single = net(x, do_ds=False)
    assert len(outs) == net.num_ds_outputs() == 3
    assert [tuple(o.shape) for o in outs] == [
        (1, 8, 16, 16, 4), (1, 4, 8, 8, 4), (1, 2, 4, 4, 4)]
    torch.testing.assert_close(single, outs[0], rtol=0, atol=0)
    # the encoder's blocks (1, 2, 3, 4); a skip conv where the stride or
    # the width changes
    assert [getattr(net, f"encoder{s}").num_blocks for s in range(4)] == \
        [1, 2, 3, 4]
    assert not net.encoder0.block0.has_skip
    assert net.encoder1.block0.has_skip and not net.encoder1.block1.has_skip


def test_gradients_match_reference():
    _grad_check("resenc")


def test_no_mirrored_operators():
    _, _, net, x = pair("resenc")
    assert not net.mirrored_operators() and not net.kernel_route()
    assert set(kernel_launches_per_forward(net).values()) == {0}
    with pytest.raises(ValueError, match="data"):
        net(torch.from_numpy(x), do_ds=False, flips=(False, True, False))


def test_preset_widths():
    """nnUNetTrainerV2_ResencUNet's base 24 at five pools: 24..320."""
    net = build_network(_stage(tplans, ((2, 2, 2),) * 5, (64, 64, 64)), 1,
                        3, tconv="resenc", base_num_features=24,
                        device="cpu")
    assert net.initial_conv.shape == (24, 1, 3, 3, 3)
    assert net.encoder5.block0.conv1.shape == (320, 320, 3, 3, 3)
    assert net.up0.kernel.shape == (320, 320, 2, 2, 2)
    assert net.decoder4.block0.kernel.shape == (24, 48, 3, 3, 3)
    assert np.prod(net.seg_head3.kernel.shape) == 3 * 192


def test_reference_mirror_tta_refuses_resenc():
    """A reference fault the port does not copy: the JAX predictor takes
    flip-free TTA whenever TTA runs, and ResidualUNet asserts that it is
    given no flips, so a resenc fold cannot predict with TTA there. The
    port's resenc takes data-flip TTA (its mirror passes flip the data):
    each pass equal to the unflipped forward of the flipped input."""
    import jax
    import jax.numpy as jnp
    from e2enet_tpu.inference.predictor import mirror_apply_fns_for
    from e2enet_tpu_torch.ops.sliding import predict_volume_tiled
    jnet, params, net, x = pair("resenc")
    fns = mirror_apply_fns_for(jnet)
    with pytest.raises(AssertionError, match="data-flip"):
        fns[1](params, jnp.asarray(x))
    data = np.moveaxis(x[0], -1, 0)
    with torch.no_grad():
        got = predict_volume_tiled(lambda v: net(v, do_ds=False), data,
                                   x.shape[1:4], 3, device="cpu",
                                   do_mirroring=True)
        want = 0
        for axes in ((), (0,), (1,), (0, 1), (2,), (0, 2), (1, 2),
                     (0, 1, 2)):
            d = [a + 1 for a in axes]
            xt = torch.from_numpy(x)
            y = net(xt.flip(d) if d else xt, do_ds=False)
            y = torch.softmax(y.flip(d) if d else y, -1)
            want = want + y
    want = np.moveaxis((want / 8)[0].numpy(), -1, 0)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
