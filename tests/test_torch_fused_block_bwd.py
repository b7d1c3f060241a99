"""The fused block's backward in the port (its plain version, reached
through the autograd op with CPU tensors) against torch's autograd of the
plain forward and against the reference's VJPs: `_fused_op` with its Pallas
backward (#2, fused_block.py:_bwd_kernel, interpret mode) and with
`_fused_bwd_xla` (float32 at HIGHEST); and the lazy block's backward
against `_qfused_op_lazy`'s VJP (qfused.py:1342-1360, the quadrant Pallas
backward #4 in interpret mode, bfloat16).

Each side differentiates L = sum(y * gy) + sum(stats * gstats) with random
gy and a nonzero gstats, so the statistics' cotangent is exercised; the
pending norms have exact zeros (a = x m + o == 0), where the kernels'
leaky-relu derivative is 1.
Tolerances: float32, every gradient within 1e-4 of its largest |value|
(float32 sums in another order; the reference's dots at HIGHEST);
bfloat16 (the lazy block), within 3e-2 of the largest |value| (both round
geff and ct to bf16 at the same points, but a value that lands one bf16
step apart after sums in another order moves the gradients after it by a
step).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from e2enet_tpu.ops import fused_block as jfb  # noqa: E402
from e2enet_tpu.ops.qfused import (LazyUp, from_quadrant_cf,  # noqa: E402
                                   quadrant_fused_block, to_quadrant_cf)
from e2enet_tpu_torch.ops import fused_block as tfb  # noqa: E402
from e2enet_tpu_torch.ops import qfused as tqf  # noqa: E402

# (N, D, H, W, part channels, pending affine per part, CO); D = 2 and 1
# are smaller than the shift window (shifts -2..2)
CASES = {
    "one_part_plain": (1, 5, 4, 7, (6,), (False,), 3),
    "two_parts": (2, 4, 5, 8, (4, 3), (True, False), 5),
    "three_parts": (1, 6, 4, 6, (3, 4, 2), (True, False, True), 4),
    "d2": (1, 2, 5, 6, (6, 4), (True, True), 3),
    "d1": (2, 1, 4, 5, (5,), (True,), 4),
}


def _rand(rng, *shape, scale=1.0, shift=0.0):
    return (rng.randn(*shape) * scale + shift).astype(np.float32)


def _inputs(seed, N, D, H, W, part_c, affine, CO):
    rng = np.random.RandomState(seed)
    parts = [_rand(rng, N, D, H, W, c) for c in part_c]
    affs = [(_rand(rng, N, c, scale=0.3, shift=1.0),
             _rand(rng, N, c, scale=0.2)) if a else None
            for c, a in zip(part_c, affine)]
    # exact zeros of the normalised input a = x m + o: channel 0 with
    # m = o = 0, and x == 0 in a fifth of channel 1's voxels with o = 0
    # (the kernels' leaky-relu derivative there is 1)
    for x, a in zip(parts, affs):
        if a is not None:
            a[0][:, 0] = a[1][:, 0] = 0.0
            if x.shape[-1] > 1:
                a[1][:, 1] = 0.0
                x[..., 1][rng.rand(*x.shape[:4]) < 0.2] = 0.0
    C = sum(part_c)
    kernel = _rand(rng, CO, C, 3, 3, scale=0.3)          # port layout
    bias = _rand(rng, CO, scale=0.1)
    gy = _rand(rng, N, D, H, W, CO)
    gstats = _rand(rng, N, CO, 2, scale=0.05)
    return parts, affs, kernel, bias, gy, gstats


def _flat(parts, affs, kernel, bias):
    return list(parts) + [kernel, bias] + [t for a in affs if a is not None
                                           for t in a]


def _port_grads(parts, affs, kernel, bias, gy, gstats):
    """Gradients of L through the port's autograd op (the plain backward
    on CPU tensors)."""
    t = lambda a: torch.from_numpy(a).requires_grad_()  # noqa: E731
    tp = [t(p) for p in parts]
    ta = [None if a is None else (t(a[0]), t(a[1])) for a in affs]
    tk, tb = t(kernel), t(bias)
    before = tfb.fused_shift_conv_block_bwd.launches
    y, stats = tfb.fused_shift_conv_block(tp, tk, tb, ta)
    loss = (y * torch.from_numpy(gy)).sum() + (
        stats * torch.from_numpy(gstats)).sum()
    grads = torch.autograd.grad(loss, _flat(tp, ta, tk, tb))
    assert tfb.fused_shift_conv_block_bwd.launches == before
    return [g.numpy() for g in grads]


def _assert_close(got, want, rtol):
    for g, w in zip(got, want):
        g, w = np.asarray(g, np.float32), np.asarray(w, np.float32)
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=rtol * float(np.abs(w).max()) + 1e-12)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_backward_matches_autograd_of_plain_forward(case):
    parts, affs, kernel, bias, gy, gstats = _inputs(len(case), *CASES[case])
    got = _port_grads(parts, affs, kernel, bias, gy, gstats)
    t = lambda a: torch.from_numpy(a).requires_grad_()  # noqa: E731
    tp = [t(p) for p in parts]
    ta = [None if a is None else (t(a[0]), t(a[1])) for a in affs]
    tk, tb = t(kernel), t(bias)
    y, stats = tfb.fused_shift_conv_block_ref(tp, tk, tb, ta)
    loss = (y * torch.from_numpy(gy)).sum() + (
        stats * torch.from_numpy(gstats)).sum()
    want = torch.autograd.grad(loss, _flat(tp, ta, tk, tb))
    _assert_close(got, [w.numpy() for w in want], 1e-4)


@pytest.mark.parametrize("case,bwd", [
    ("one_part_plain", "xla"), ("three_parts", "xla"), ("d1", "xla"),
    ("two_parts", "pallas"), ("d2", "pallas")])
def test_backward_matches_reference_vjp(case, bwd, monkeypatch):
    """The reference _fused_op's custom VJP, its Pallas backward (#2) in
    interpret mode or _fused_bwd_xla, float32."""
    monkeypatch.setattr(jfb, "_USE_PALLAS_BWD", bwd == "pallas")
    N, D, H, W = CASES[case][:4]
    parts, affs, kernel, bias, gy, gstats = _inputs(len(case), *CASES[case])
    got = _port_grads(parts, affs, kernel, bias, gy, gstats)
    Wp = jfb.choose_wp(H, W)
    has = [a is not None for a in affs]

    def loss(*flat):
        P = len(parts)
        ps, (k, b), rest = flat[:P], flat[P:P + 2], list(flat[P + 2:])
        jaff = [(rest.pop(0), rest.pop(0)) if h else None for h in has]
        cf = [jfb.to_padded_cf(p, W, Wp) for p in ps]
        y, stats = jfb.fused_shift_conv_block(
            cf, jnp.transpose(k, (2, 3, 1, 0)), b, jaff, H, W,
            interpret=True)
        return (jnp.sum(jfb.from_padded_cf(y, H, W) * gy)
                + jnp.sum(stats * gstats))

    flat = [jnp.asarray(a) for a in _flat(parts, affs, kernel, bias)]
    want = jax.grad(loss, argnums=tuple(range(len(flat))))(*flat)
    _assert_close(got, want, 1e-4)


def test_lazy_block_backward_matches_reference_vjp():
    """The lazy block's backward (u materialised through the up-link, the
    block backward, u's gradient through the up-link's plain autograd)
    against the reference's _qfused_op_lazy VJP, bf16, quadrant kernels
    in interpret mode."""
    Q = (2, 2, 2)
    N, DQ, HQ, WQ, WQP = 1, 2, 4, 5, 32
    C_SAME, CIN, C_UP, CO = 8, 8, 8, 8
    rng = np.random.RandomState(6)

    def bf(a):
        return np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)

    x = bf(rng.randn(N, 2 * DQ, 2 * HQ, 2 * WQ, C_SAME))
    raw = bf(rng.randn(N, DQ, HQ, WQ, CIN))
    smult = (rng.rand(N, C_SAME) + 0.5).astype(np.float32)
    soff = _rand(rng, N, C_SAME)
    umult = (rng.rand(N, CIN) + 0.5).astype(np.float32)
    uoff = _rand(rng, N, CIN)
    ukern = _rand(rng, CIN, C_UP, 2, 2, 2, scale=0.3)    # port layout
    wk = bf(rng.randn(CO, C_SAME + C_UP, 3, 3) * 0.2)    # port layout
    b = bf(rng.randn(CO) * 0.1)
    gy = bf(rng.randn(N, 2 * DQ, 2 * HQ, 2 * WQ, CO))
    gstats = _rand(rng, N, CO, 2, scale=1e-3)
    bfd = jnp.bfloat16

    def loss(x, raw, umult, uoff, ukern, wk, b, smult, soff):
        lz = LazyUp(to_quadrant_cf(raw.astype(bfd), (1, 1, 1), WQP), umult,
                    uoff, jnp.transpose(ukern, (2, 3, 4, 0, 1)))
        yq, sq = quadrant_fused_block(
            [to_quadrant_cf(x.astype(bfd), Q, WQP), lz],
            jnp.transpose(wk, (2, 3, 1, 0)).astype(bfd), b.astype(bfd),
            [(smult, soff), None], Q, HQ, WQ, interpret=True)
        y = from_quadrant_cf(yq, Q, HQ, WQ, CO).astype(jnp.float32)
        stats = sq.reshape(N, 8, CO, 2).sum(axis=1)
        return jnp.sum(y * gy) + jnp.sum(stats * gstats)

    args = [x, raw, umult, uoff, ukern, wk, b, smult, soff]
    want = jax.grad(loss, argnums=tuple(range(len(args))))(
        *[jnp.asarray(a) for a in args])

    t = lambda a: torch.from_numpy(a).requires_grad_()  # noqa: E731
    tx, traw, tum, tuo, tuk, twk, tb, tsm, tso = (t(a) for a in args)
    y, stats = tqf.lazy_up_fused_block(
        [tx.bfloat16()], tqf.LazyUp(traw.bfloat16(), tum, tuo, tuk),
        twk.bfloat16(), tb.bfloat16(), [(tsm, tso)])
    lt = (y.float() * torch.from_numpy(gy)).sum() + (
        stats * torch.from_numpy(gstats)).sum()
    got = torch.autograd.grad(lt, [tx, traw, tum, tuo, tuk, twk, tb, tsm,
                                   tso])
    _assert_close([g.numpy() for g in got], want, 3e-2)
