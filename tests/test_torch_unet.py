"""The port's ShiftUNet (e2enet_tpu_torch/models/unet.py: Tconv ori, shift
groups of 3, and shiftConvPP_nodff, shift groups of 5) against the JAX
package's (e2enet_tpu/models/unet.py) on its XLA path, float32 on the CPU,
the same weights crossing over with models/weights.from_jax_params:

- ori and nodff on 3D plans (isotropic and with a (1, 2, 2) pool), and ori
  on a 2D plan (no shift, max_num_features 480): every deep-supervision
  output (num_pool of them, full resolution first) within 1e-4;
- the architecture switches reaching ShiftUNet (BN + ReLU, seg_bias, 3
  convs per stage);
- one step's float32 gradients of ori within 1e-4 relative per leaf;
- flip-free TTA: ori's mirrored forward equal to the data-flip forward
  within 1e-4 for every flip combination;
- the route: no kernel launch (kernel_launches_per_forward all 0).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from e2enet_tpu_torch.models.unetpp import \
    kernel_launches_per_forward  # noqa: E402
from test_torch_arch_switches import (TOL, _grad_check,  # noqa: E402
                                      assert_close, check_forward, pair)
from test_torch_arch_switches import _flip  # noqa: E402
from e2enet_tpu_torch.ops.sliding import flip_combinations  # noqa: E402


@pytest.mark.parametrize("tconv, pools, patch", [
    ("ori", ((2, 2, 2), (2, 2, 2)), (8, 8, 8)),
    ("ori", ((1, 2, 2), (2, 2, 2), (2, 2, 2)), (8, 16, 16)),
    ("shiftConvPP_nodff", ((2, 2, 2), (2, 2, 2)), (8, 8, 8)),
    ("shiftConvPP_nodff", ((1, 2, 2), (2, 2, 2)), (4, 8, 8)),
    ("ori", ((1, 2, 2), (1, 2, 2)), (1, 16, 16))],
    ids=["ori", "ori_anis", "nodff", "nodff_anis", "ori_2d"])
def test_forward_matches_reference(tconv, pools, patch):
    net = check_forward(tconv, pools=pools, patch=patch)
    assert type(net).__name__ == "ShiftUNet"
    assert net.num_ds_outputs() == len(pools)
    two_d = patch[0] == 1
    blk = net.context0.block0
    assert blk.shifting == (not two_d)
    assert blk.shift_size == (5 if tconv == "shiftConvPP_nodff" else 3)
    assert not net.kernel_route() and net.mirrored_operators()
    assert set(kernel_launches_per_forward(net).values()) == {0}


@pytest.mark.parametrize("kw", [
    dict(norm_op="batch", nonlin="relu"), dict(seg_bias=True),
    dict(num_conv_per_stage=3, nonlin_before_norm=True)],
    ids=["bn_relu", "seg_bias", "3conv_nbn"])
def test_switches_match_reference(kw):
    check_forward("ori", **kw)


def test_two_d_ori_is_wider():
    """The reference's 2D ori caps widths at 480, not 320."""
    _, _, net, _ = pair("ori", pools=((1, 2, 2),) * 5, patch=(1, 32, 32),
                        base=32)
    assert net.enc == [32, 64, 128, 256, 480, 480]


def test_gradients_match_reference():
    _grad_check("ori")


@pytest.mark.parametrize("tconv", ["ori", "shiftConvPP_nodff"])
def test_flip_free_equals_data_flips(tconv):
    _, _, net, x = pair(tconv, pools=((2, 2, 2), (1, 2, 2)))
    xt = torch.from_numpy(x)
    with torch.no_grad():
        for c in flip_combinations((0, 1, 2)):
            f = tuple(a in c for a in range(3))
            mirrored = net(xt, do_ds=False, flips=f)
            flipped = _flip(net(_flip(xt, c), do_ds=False), c)
            assert_close(mirrored, flipped.numpy(), TOL, str(c))
