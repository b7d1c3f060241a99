"""e2enet_tpu_torch.ops.blocks against e2enet_tpu.ops.blocks on the same
numpy inputs. float32 runs the reference at HIGHEST precision (its default
for float32) and torch's exact CPU kernels: tolerance 1e-5. The bfloat16
instance norm rounds in other places: tolerance one bf16 step (1e-2)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from e2enet_tpu.ops import blocks as jb  # noqa: E402
from e2enet_tpu_torch.ops import blocks as tb  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


def _rand(seed, *shape, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _t(a):
    return torch.from_numpy(a)


def test_instance_norm_f32():
    x = _rand(0, 2, 4, 5, 6, 7, scale=3.0) + 1.0
    g, b = _rand(1, 7) + 1.0, _rand(2, 7)
    ref = jb.instance_norm(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b))
    out = tb.instance_norm(_t(x), _t(g), _t(b))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_instance_norm_bf16():
    x = _rand(3, 2, 4, 5, 6, 7, scale=3.0) + 1.0
    g, b = _rand(4, 7) + 1.0, _rand(5, 7)
    ref = jb.instance_norm(jnp.asarray(x, jnp.bfloat16), jnp.asarray(g),
                           jnp.asarray(b))
    out = tb.instance_norm(_t(x).to(torch.bfloat16), _t(g), _t(b))
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32),
                               rtol=1e-2, atol=1e-2)


def test_leaky_relu():
    x = _rand(6, 3, 4, 5)
    np.testing.assert_array_equal(tb.leaky_relu(_t(x)).numpy(),
                                  np.asarray(jb.leaky_relu(jnp.asarray(x))))


@pytest.mark.parametrize("stride", [(1, 1, 1), (2, 2, 2)])
def test_conv3d_as_2d(stride):
    x = _rand(7, 2, 6, 8, 10, 5)
    k = _rand(8, 3, 3, 5, 4, scale=0.3)          # (kh, kw, Cin, Cout)
    b = _rand(9, 4, scale=0.1)
    ref = jb.conv3d_as_2d(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b),
                          stride, compute_dtype=jnp.float32)
    out = tb.conv3d_as_2d(_t(x), _t(k.transpose(3, 2, 0, 1).copy()), _t(b),
                          stride, torch.float32)
    assert tuple(out.shape) == ref.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_transp_conv():
    x = _rand(10, 2, 3, 4, 5, 6)
    k = _rand(11, 2, 2, 2, 6, 3, scale=0.3)      # (sd, sh, sw, Cin, Cout)
    ref = jb.transp_conv_matmul(jnp.asarray(x), jnp.asarray(k), (2, 2, 2),
                                compute_dtype=jnp.float32)
    out = tb.transp_conv_matmul(
        _t(x), _t(k.transpose(3, 4, 0, 1, 2).copy()), (2, 2, 2),
        torch.float32)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_max_pool():
    x = _rand(12, 2, 4, 6, 8, 3)
    np.testing.assert_array_equal(
        tb.max_pool(_t(x), (2, 2, 2)).numpy(),
        np.asarray(jb.max_pool(jnp.asarray(x), (2, 2, 2))))


def test_seg_head():
    x = _rand(13, 1, 4, 5, 6, 8)
    k = _rand(14, 8, 3)
    ref = jb.SegHead(num_classes=3, compute_dtype=jnp.float32).apply(
        {"params": {"kernel": jnp.asarray(k)}}, jnp.asarray(x))
    head = tb.SegHead(8, 3, compute_dtype=torch.float32, device="cpu")
    head.load_state_dict({"kernel": _t(k.T.copy())})
    with torch.no_grad():
        out = head(_t(x))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("part_c,stride", [((5, 3, 4), (1, 1, 1)),
                                           ((6,), (2, 2, 2))])
def test_shift_conv_block(part_c, stride):
    """Shift -> conv -> instance norm -> lrelu, list-of-parts and strided."""
    C, CO = sum(part_c), 6
    parts = [_rand(20 + i, 1, 6, 8, 8, c) for i, c in enumerate(part_c)]
    p = {"kernel": _rand(30, 3, 3, C, CO, scale=0.3),
         "bias": _rand(31, CO, scale=0.1),
         "norm_scale": _rand(32, CO) + 1.0, "norm_bias": _rand(33, CO)}
    jblk = jb.ShiftConvBlock(features=CO, stride=stride,
                             compute_dtype=jnp.float32)
    jin = [jnp.asarray(a) for a in parts]
    ref = jblk.apply({"params": {k: jnp.asarray(v) for k, v in p.items()}},
                     jin if len(jin) > 1 else jin[0])
    blk = tb.ShiftConvBlock(C, CO, stride=stride,
                            compute_dtype=torch.float32, device="cpu")
    sd = {k: _t(v) for k, v in p.items()}
    sd["kernel"] = _t(p["kernel"].transpose(3, 2, 0, 1).copy())
    blk.load_state_dict(sd)
    with torch.no_grad():
        tin = [_t(a) for a in parts]
        out = blk(tin if len(tin) > 1 else tin[0])
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)
