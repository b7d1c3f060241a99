"""The port's strided transition (plain version, reached through the
wrapper with CPU tensors) against the reference Pallas kernel
quadrant_strided_fused run in interpret mode, with every mirror
combination; layouts cross through the reference's to_quadrant_cf /
from_quadrant_cf.

float32: y and stats within 1e-4 (sums in another order). bfloat16: y
within one bf16 step of the largest |y| (the same bf16 operands, float32
sums in another order, so a stored value may round the other way), stats
within 1e-4 of sum|y| and relative 1e-4 for the sum of squares.
"""
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from e2enet_tpu.ops.qfused import (choose_wqp, from_quadrant_cf,  # noqa: E402
                                   to_quadrant_cf)
from e2enet_tpu.ops.qstride import QSStatic, quadrant_strided_fused  # noqa
from e2enet_tpu_torch.ops import qstride as tqs  # noqa: E402

COMBOS = list(itertools.product([False, True], repeat=3))


def _inputs(seed, N=2, D=8, H=8, W=8, C=12, CO=6):
    rng = np.random.RandomState(seed)
    x = rng.randn(N, D, H, W, C).astype(np.float32)
    mult = (rng.randn(N, C) * 0.5 + 1.0).astype(np.float32)
    off = (rng.randn(N, C) * 0.3).astype(np.float32)
    kern = (rng.randn(3, 3, C, CO) * 0.3).astype(np.float32)   # HWIO
    bias = (rng.randn(CO) * 0.2).astype(np.float32)
    return x, mult, off, kern, bias


def _jax(x, mult, off, kern, bias, q, flips, dtype):
    N, D, H, W, C = x.shape
    Hq, Wq = H // q[1], W // q[2]
    Wqp = choose_wqp(Hq, Wq)
    static = QSStatic(tuple(q), C, kern.shape[-1], D // q[0], Hq, Wq, Wqp,
                      5, True, True, tuple(flips))
    xq = to_quadrant_cf(jnp.asarray(x, dtype), q, Wqp)
    y, stats = quadrant_strided_fused(xq, jnp.asarray(mult),
                                      jnp.asarray(off),
                                      jnp.asarray(kern, dtype),
                                      jnp.asarray(bias), static)
    y = from_quadrant_cf(y, (1, 1, 1), Hq, Wq, kern.shape[-1])
    return np.asarray(y, np.float32), np.asarray(stats)


def _torch(x, mult, off, kern, bias, q, flips, dtype):
    with torch.no_grad():
        y, stats = tqs.strided_fused(
            torch.from_numpy(x).to(dtype), torch.from_numpy(mult),
            torch.from_numpy(off),
            torch.from_numpy(kern.transpose(3, 2, 0, 1).copy()),
            torch.from_numpy(bias), q, flips)
    return y, stats


def _check_stats(stats, ref, y, tol):
    scale = np.abs(y).sum(axis=(1, 2, 3)).max()
    np.testing.assert_allclose(stats[..., 0], ref[..., 0], rtol=0,
                               atol=tol * scale)
    np.testing.assert_allclose(stats[..., 1], ref[..., 1], rtol=tol)


@pytest.mark.parametrize("flips", COMBOS)
def test_matches_reference_kernel_f32(flips):
    args = _inputs(0)
    ref_y, ref_s = _jax(*args, (2, 2, 2), flips, jnp.float32)
    y, s = _torch(*args, (2, 2, 2), flips, torch.float32)
    assert y.dtype == torch.float32 and tuple(y.shape) == ref_y.shape
    np.testing.assert_allclose(y.numpy(), ref_y, rtol=1e-4, atol=1e-4)
    _check_stats(s.numpy(), ref_s, ref_y, 1e-4)


@pytest.mark.parametrize("flips", [(False, False, False), (True, True, True),
                                   (True, False, True)])
def test_matches_reference_kernel_bf16(flips):
    args = _inputs(1)
    ref_y, ref_s = _jax(*args, (2, 2, 2), flips, jnp.bfloat16)
    y, s = _torch(*args, (2, 2, 2), flips, torch.bfloat16)
    assert y.dtype == torch.bfloat16
    y = y.float().numpy()
    big = np.abs(ref_y).max()
    ulp = 2.0 ** (np.floor(np.log2(big)) - 7)
    assert np.abs(y - ref_y).max() <= ulp
    _check_stats(s.numpy(), ref_s, ref_y, 1e-4)


@pytest.mark.parametrize("flips", [(False, False, False), (True, False, True)])
def test_depth_stride_one_matches_reference_kernel(flips):
    """q = (1, 2, 2): a depth stride of 1 negates the shifts when mirrored
    and keeps every row."""
    args = _inputs(2, D=6)
    ref_y, ref_s = _jax(*args, (1, 2, 2), flips, jnp.float32)
    y, s = _torch(*args, (1, 2, 2), flips, torch.float32)
    np.testing.assert_allclose(y.numpy(), ref_y, rtol=1e-4, atol=1e-4)
    _check_stats(s.numpy(), ref_s, ref_y, 1e-4)


@pytest.mark.parametrize("flips", [(False, False, False), (True, True, True)])
def test_two_samples_wide_co_matches_reference_kernel(flips):
    """The card's sample-straddling case at a small size: N = 2, C = 16,
    CO = 40 (per-sample statistics)."""
    args = _inputs(5, N=2, D=8, H=8, W=16, C=16, CO=40)
    ref_y, ref_s = _jax(*args, (2, 2, 2), flips, jnp.float32)
    y, s = _torch(*args, (2, 2, 2), flips, torch.float32)
    np.testing.assert_allclose(y.numpy(), ref_y, rtol=1e-4, atol=1e-4)
    _check_stats(s.numpy(), ref_s, ref_y, 1e-4)


@pytest.mark.parametrize("flips", COMBOS)
def test_flips_mirror_the_op(flips):
    """strided_fused(x, flips=c) == flip_c(strided_fused(flip_c(x)))."""
    x, mult, off, kern, bias = _inputs(3)
    dims = [1 + a for a in range(3) if flips[a]]

    def flip(t):
        return t.flip(dims) if dims else t

    y, s = _torch(x, mult, off, kern, bias, (2, 2, 2), flips, torch.float32)
    xf = flip(torch.from_numpy(x)).numpy()
    y0, s0 = _torch(xf, mult, off, kern, bias, (2, 2, 2), (False,) * 3,
                    torch.float32)
    np.testing.assert_allclose(y.numpy(), flip(y0).numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(s.numpy(), s0.numpy(), rtol=1e-4, atol=1e-4)


def test_ragged_extent():
    """Odd sizes: (L + 1) // 2 rows unmirrored, L // 2 on a mirrored
    stride-2 axis; CPU tensors never launch the kernel."""
    before = tqs.strided_fused.launches
    x, mult, off, kern, bias = _inputs(4, D=7, H=9, W=6)
    y, _ = _torch(x, mult, off, kern, bias, (2, 2, 2), (False,) * 3,
                  torch.float32)
    assert tuple(y.shape[1:4]) == (4, 5, 3)
    y, _ = _torch(x, mult, off, kern, bias, (2, 2, 2), (True, True, False),
                  torch.float32)
    assert tuple(y.shape[1:4]) == (3, 4, 3)
    assert tqs.strided_fused.launches == before == 0
