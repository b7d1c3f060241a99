"""The port's ShiftUNetPlusPlus against the reference's dense non-quadrant
model on the same numpy weights, float32 (reference at HIGHEST precision),
logits within 1e-3, with do_ds True and False. Also checks that port and
reference route the same number of blocks through the fused op."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import e2enet_tpu.ops.fused_block as jfb  # noqa: E402
import e2enet_tpu_torch.models.unetpp as tunetpp  # noqa: E402
import e2enet_tpu_torch.ops.blocks as tblocks  # noqa: E402
import e2enet_tpu_torch.ops.fused_block as tfb  # noqa: E402
from e2enet_tpu.models.unetpp import ShiftUNetPlusPlus as JaxNet  # noqa: E402
from e2enet_tpu_torch.models.weights import from_jax_params  # noqa: E402

KW = dict(input_channels=1, num_classes=3,
          pool_op_kernel_sizes=((2, 2, 2),) * 3, base_num_features=4)
SHAPE = (1, 16, 16, 16, 1)


def numpy_params(seed=0):
    """Reference param tree filled from numpy: kernels ~0.3 N(0,1), biases
    and norm offsets ~0.1 N(0,1), norm scales ~1 + 0.1 N(0,1)."""
    net = JaxNet(**KW, compute_dtype=jnp.float32, remat=False,
                 quadrant=False)
    shapes = jax.eval_shape(net.init, jax.random.PRNGKey(0),
                            jnp.zeros(SHAPE, jnp.float32))
    rng = np.random.RandomState(seed)

    def fill(path, s):
        name = path[-1].key
        a = rng.randn(*s.shape).astype(np.float32)
        if name == "kernel":
            return 0.3 * a
        if name == "norm_scale":
            return 1.0 + 0.1 * a
        return 0.1 * a

    return jax.tree_util.tree_map_with_path(fill, shapes)


def test_forward_matches_reference(monkeypatch):
    params = numpy_params()
    x = np.random.RandomState(1).randn(*SHAPE).astype(np.float32)

    jcalls = [0]
    real = jfb.fused_shift_conv_block

    def count_jax(*a, **k):
        jcalls[0] += 1
        return real(*a, **k)

    # the reference's fused routing, counted while tracing its fused path
    monkeypatch.setattr(jfb, "fused_shift_conv_block", count_jax)
    jnet_fused = JaxNet(**KW, compute_dtype=jnp.float32, remat=False,
                        quadrant=False, fused=True, fused_interpret=True)
    jax.eval_shape(lambda p, v: jnet_fused.apply(p, v, do_ds=True), params,
                   jnp.asarray(x))
    jax_calls = jcalls[0]
    # values from the XLA path, which the reference's own suite holds equal
    # to the fused path (an interpret-mode run would triple the time)
    jnet = JaxNet(**KW, compute_dtype=jnp.float32, remat=False,
                  quadrant=False)
    ref_ds = [np.asarray(o) for o in jnet.apply(params, jnp.asarray(x),
                                                do_ds=True)]
    ref_top = np.asarray(jnet.apply(params, jnp.asarray(x), do_ds=False))

    net = tunetpp.ShiftUNetPlusPlus(**KW, compute_dtype=torch.float32,
                                    device="cpu")
    net.load_state_dict(from_jax_params(params), strict=True)
    tcalls = [0]
    treal = tblocks.fused_shift_conv_block

    def count_torch(*a, **k):
        tcalls[0] += 1
        return treal(*a, **k)

    monkeypatch.setattr(tblocks, "fused_shift_conv_block", count_torch)
    with torch.no_grad():
        out_ds = net(torch.from_numpy(x), do_ds=True)
        torch_calls = tcalls[0]
        out_top = net(torch.from_numpy(x), do_ds=False)

    assert len(out_ds) == len(ref_ds) == 3
    for a, b in zip(out_ds, ref_ds):
        assert tuple(a.shape) == b.shape and a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(out_top.numpy(), ref_top, rtol=1e-3,
                               atol=1e-3)
    # context0 (2) + level-0 nest 3 + final (4) + level-1 nest 2 + final (3)
    assert torch_calls == jax_calls == \
        tunetpp.fused_launches_per_forward(net) == 9


def test_plain_path_equals_kernel_path_on_cpu(monkeypatch):
    """Swapping the plain version in for the fused op (as the card's smoke
    run does for its comparison path) changes nothing on the CPU, where the
    wrapper already runs it."""
    net = tunetpp.ShiftUNetPlusPlus(**KW, compute_dtype=torch.float32,
                                    device="cpu")
    net.reset_parameters(seed=3)
    x = torch.from_numpy(np.random.RandomState(2).randn(*SHAPE).astype(
        np.float32))
    with torch.no_grad():
        a = net(x, do_ds=False)
        monkeypatch.setattr(tblocks, "fused_shift_conv_block",
                            tfb.fused_shift_conv_block_ref)
        b = net(x, do_ds=False)
    assert torch.equal(a, b)


def test_bench_geometry_launch_count():
    """5 pools, fused levels 0-1: 13 fused blocks per forward."""
    net = tunetpp.ShiftUNetPlusPlus(
        1, 16, ((2, 2, 2),) * 5, base_num_features=2,
        compute_dtype=torch.float32, device="cpu")
    assert tunetpp.fused_launches_per_forward(net) == 13


def test_device_is_explicit_and_input_checked():
    with pytest.raises(ValueError):
        tunetpp.ShiftUNetPlusPlus(**KW)
    net = tunetpp.ShiftUNetPlusPlus(**KW, compute_dtype=torch.float32,
                                    device="cpu")
    with pytest.raises(ValueError):
        net(torch.zeros(1, 12, 16, 16, 1))
