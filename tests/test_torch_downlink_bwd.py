"""Gradients of the port's pooled links against the reference's.

The level-0 -> 1 down-link: its backward's plain version (TPU kernel #8's
port, reached through the autograd op with CPU tensors) against the VJP of
the reference's quadrant_block_max_cf, whose backward is the Pallas kernel
#8 (qlink.py:_downlink_bwd_kernel) in interpret mode. Windows with 2-, 3-
and 8-way ties at the max or the min, and exact zeros (a channel with mult
and off 0, a channel whose raw values include 0), at the channel counts
where the card's kernel changes route (C = 8 and 48 in 16-byte units, one
or several per voxel; C = 12 on its scalar route, where the reference takes
its XLA twin, whose subgradient at a == 0 is the pinned (1 + slope) / 2).
gx within 1e-2 of the largest |gx| (the same float32 steps; a wrong tie
split is off by a third or more), g(mult) and g(off) within 1e-4 relative
(float32 sums in another order).

The level-1 -> 2 pooled part: the port's pooled_part gradient against the
reference's pooled_part_cf (the bf16 apply, jnp.maximum's leaky relu, the
max over the window), with ties among the normalised bf16 values and exact
zeros. Both differentiate in bf16 arithmetic; within 2e-2 of the largest
|value| (one bf16 step, sums in another order).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from e2enet_tpu.ops import fused_block as jfb  # noqa: E402
from e2enet_tpu.ops import qfused  # noqa: E402
from e2enet_tpu.ops.qfused import from_quadrant_cf, to_quadrant_cf  # noqa
from e2enet_tpu_torch.ops import fused_block as tfb  # noqa: E402
from e2enet_tpu_torch.ops import qlink as tql  # noqa: E402

Q = (2, 2, 2)
HQ, WQ, WQP = 8, 15, 16


def _bf16(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)


def _tied(rng, N, D, H, W, C, k):
    """Random values with, in every (2, 2, 2) window, k elements equal to
    the window's max and (for k <= 4) k others equal to its min."""
    x = rng.randn(N, D // 2, 2, H // 2, 2, W // 2, 2, C)
    x = x.transpose(0, 1, 3, 5, 7, 2, 4, 6).reshape(-1, 8)
    perm = np.argsort(rng.rand(*x.shape), axis=1)
    rows = np.arange(x.shape[0])
    mx, mn = x.max(axis=1), x.min(axis=1)
    for j in range(k):
        x[rows, perm[:, j]] = mx
        if 2 * k <= 8:
            x[rows, perm[:, k + j]] = mn
    x = x.reshape(N, D // 2, H // 2, W // 2, C, 2, 2, 2).transpose(
        0, 1, 5, 2, 6, 3, 7, 4).reshape(N, D, H, W, C)
    return _bf16(x)


# (ties, C): C = 8 one 16-byte unit, 48 several (the main path's width),
# 12 the scalar route on the card; the C = 8 cases keep their bare ids
CASES = [pytest.param(t, c, id=str(t) if c == 8 else f"{t}-c{c}")
         for c in (8, 48, 12) for t in (1, 2, 3, 8)]


@pytest.mark.parametrize("ties,C", CASES)
def test_downlink_bwd_matches_reference_kernel(ties, C):
    rng = np.random.RandomState(ties + 100 * (C != 8) * C)
    N, DQ = 2, 2
    D, H, W = 2 * DQ, 2 * HQ, 2 * WQ
    x = _tied(rng, N, D, H, W, C, ties)
    x[..., 2] = np.where(rng.rand(N, D, H, W) < 0.3, 0.0, x[..., 2])
    mult = rng.randn(N, C).astype(np.float32)
    off = (rng.randn(N, C) * 0.2).astype(np.float32)
    mult[:, 0] = 0.0                        # the min chain; a == 0 exactly
    off[:, 0] = 0.0
    gy = _bf16(rng.randn(N, DQ, HQ, WQ, C))

    def loss(xl, m, o):
        y = qfused.quadrant_block_max_cf(
            to_quadrant_cf(xl.astype(jnp.bfloat16), Q, WQP), m, o, Q, HQ, WQ,
            C, WQP, interpret=True)
        yl = from_quadrant_cf(y, (1, 1, 1), HQ, WQ, C).astype(jnp.float32)
        return jnp.sum(yl * gy)

    want = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(mult), jnp.asarray(off))

    tx = torch.from_numpy(x).bfloat16().requires_grad_()
    tm = torch.from_numpy(mult).requires_grad_()
    to = torch.from_numpy(off).requires_grad_()
    before = tql.downlink_bwd.launches
    y = tql.downlink(tx, tm, to)
    got = torch.autograd.grad((y.float() * torch.from_numpy(gy)).sum(),
                              (tx, tm, to))
    assert tql.downlink_bwd.launches == before
    gx, gm, go = (g.float().numpy() for g in got)
    wx, wm, wo = (np.array(w, np.float32) for w in want)
    if C % 8:
        # the reference runs its XLA twin here (its Pallas kernel takes
        # C % 8 == 0 only), whose leaky relu has derivative (1 + slope) / 2
        # where a == 0 (jnp.maximum's tie), and #8 and its port 1 (pinned,
        # ROADMAP Queue 3): channel 0, where a is 0 everywhere
        half = (1.0 + tfb.LRELU_SLOPE) / 2
        assert not np.allclose(gm[:, 0], wm[:, 0])
        wm[:, 0] /= half
        wo[:, 0] /= half
    np.testing.assert_allclose(gx, wx, rtol=0,
                               atol=1e-2 * float(np.abs(wx).max()))
    np.testing.assert_allclose(gm, wm, rtol=0,
                               atol=1e-4 * float(np.abs(wm).max()))
    np.testing.assert_allclose(go, wo, rtol=0,
                               atol=1e-4 * float(np.abs(wo).max()))


def test_downlink_bwd_ref_is_the_wrapper_on_cpu():
    """The wrapper takes the plain version for CPU tensors, and the
    autograd op's backward is it, ragged edge zero."""
    rng = np.random.RandomState(3)
    x = torch.from_numpy(_bf16(rng.randn(1, 5, 6, 7, 4))).bfloat16()
    m, o = torch.from_numpy(rng.randn(1, 4).astype(np.float32)), \
        torch.zeros(1, 4)
    gy = torch.from_numpy(rng.randn(1, 2, 3, 3, 4).astype(np.float32))
    gx, gm, go = tql.downlink_bwd(x, m, o, gy.bfloat16())
    rx, rm, ro = tql.downlink_bwd_ref(x, m, o, gy.bfloat16())
    assert torch.equal(gx, rx) and torch.equal(gm, rm)
    assert float(gx[:, 4:].float().abs().sum()) == 0.0
    assert float(gx[..., 6:, :].float().abs().sum()) == 0.0


@pytest.mark.parametrize("seed", [0, 1])
def test_pooled_part_grad_matches_reference(seed):
    rng = np.random.RandomState(seed)
    N, D, H, W, C = 2, 4, 6, 8, 6
    # few distinct values: normalised bf16 values tie within windows
    x = _bf16(np.round(rng.randn(N, D, H, W, C) * 2) / 2)
    mult = (rng.randn(N, C) * 0.5).astype(np.float32)
    off = (rng.randn(N, C) * 0.2).astype(np.float32)
    mult[:, 1], off[:, 1] = 0.0, 0.0        # a == 0 exactly everywhere
    off[:, 2] = 0.0                         # a == 0 where x == 0
    gy = _bf16(rng.randn(N, D // 2, H // 2, W // 2, C))
    Wp = jfb.choose_wp(H, W)
    owp = jfb.choose_wp(H // 2, W // 2)

    def loss(xl, m, o):
        cf = jfb.to_padded_cf(xl.astype(jnp.bfloat16), W, Wp)
        y = jfb.pooled_part_cf(cf, m, o, H, W, (2, 2, 2), owp)
        yl = jfb.from_padded_cf(y, H // 2, W // 2).astype(jnp.float32)
        return jnp.sum(yl * gy)

    want = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(mult), jnp.asarray(off))
    tx = torch.from_numpy(x).bfloat16().requires_grad_()
    tm = torch.from_numpy(mult).requires_grad_()
    to = torch.from_numpy(off).requires_grad_()
    y = tfb.pooled_part(tx, tm, to, (2, 2, 2))
    with torch.no_grad():
        assert torch.equal(y, tfb.pooled_part(tx, tm, to, (2, 2, 2)))
    got = torch.autograd.grad((y.float() * torch.from_numpy(gy)).sum(),
                              (tx, tm, to))
    for g, w in zip(got, want):
        g, w = g.float().numpy(), np.asarray(w, np.float32)
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=2e-2 * float(np.abs(w).max()))
