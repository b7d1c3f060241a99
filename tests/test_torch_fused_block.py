"""The port's fused shift-conv block (plain version, reached through the
wrapper with CPU tensors) against the reference Pallas kernel run in
interpret mode, through the reference's padded channels-first layout.

float32 throughout. y: 2e-5 for one block, 2e-4 for a chain of two (the
second block normalises with statistics summed in another order). Stats:
2e-5 of sum|y| for the sum, 2e-5 relative for the sum of squares.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from e2enet_tpu.ops import fused_block as jfb  # noqa: E402
from e2enet_tpu_torch.ops import fused_block as tfb  # noqa: E402


def _rand(rng, *shape, scale=1.0, shift=0.0):
    return (rng.randn(*shape) * scale + shift).astype(np.float32)


def _make(seed, N, D, H, W, part_c, affine, CO):
    rng = np.random.RandomState(seed)
    parts = [_rand(rng, N, D, H, W, c) for c in part_c]
    affs = [(_rand(rng, N, c, scale=0.3, shift=1.0),
             _rand(rng, N, c, scale=0.2)) if a else None
            for c, a in zip(part_c, affine)]
    C = sum(part_c)
    kernel = _rand(rng, 3, 3, C, CO, scale=0.3)          # reference HWIO
    bias = _rand(rng, CO, scale=0.1)
    return parts, affs, kernel, bias


def _jax_block(parts, affs, kernel, bias, H, W):
    Wp = jfb.choose_wp(H, W)
    cf = [jfb.to_padded_cf(jnp.asarray(p), W, Wp) for p in parts]
    jaff = [None if a is None else (jnp.asarray(a[0]), jnp.asarray(a[1]))
            for a in affs]
    y, stats = jfb.fused_shift_conv_block(cf, jnp.asarray(kernel),
                                          jnp.asarray(bias), jaff, H, W,
                                          interpret=True)
    return y, np.asarray(jfb.from_padded_cf(y, H, W)), np.asarray(stats)


def _torch_block(parts, affs, kernel, bias):
    taff = [None if a is None else (torch.from_numpy(a[0]),
                                    torch.from_numpy(a[1])) for a in affs]
    with torch.no_grad():
        y, stats = tfb.fused_shift_conv_block(
            [torch.from_numpy(p) for p in parts],
            torch.from_numpy(kernel.transpose(3, 2, 0, 1).copy()),
            torch.from_numpy(bias), taff)
    return y, stats


def _check_stats(stats, ref_stats, y, rtol):
    scale = np.abs(y).sum(axis=(1, 2, 3))
    np.testing.assert_allclose(stats[..., 0], ref_stats[..., 0], rtol=0,
                               atol=float(rtol * scale.max()))
    np.testing.assert_allclose(stats[..., 1], ref_stats[..., 1], rtol=rtol)


CASES = {
    "c1": (2, 6, 8, 16, (1,), (False,), 5),
    "two_parts": (1, 5, 8, 16, (5, 3), (False, False), 7),
    "three_parts_affine": (1, 6, 8, 16, (4, 3, 2), (True, False, True), 6),
    "w13": (2, 6, 8, 13, (8,), (True,), 6),
    "d3": (1, 3, 8, 16, (6, 2), (True, False), 4),
    # the card's K-chunk cases at small sizes: K = 200 with parts and shift
    # groups meeting mid-unit (CO 40), K = 240 in three parts at CO 96
    "k200_co40": (1, 3, 4, 8, (100, 100), (True, False), 40),
    "k240_co96": (1, 2, 4, 8, (96, 96, 48), (True, False, True), 96),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_block_matches_reference_kernel(case):
    N, D, H, W, part_c, affine, CO = CASES[case]
    parts, affs, kernel, bias = _make(len(case), N, D, H, W, part_c, affine,
                                      CO)
    _, ref_y, ref_stats = _jax_block(parts, affs, kernel, bias, H, W)
    y, stats = _torch_block(parts, affs, kernel, bias)
    assert tuple(y.shape) == (N, D, H, W, CO) and y.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), ref_y, rtol=2e-5, atol=2e-5)
    _check_stats(stats.numpy(), ref_stats, ref_y, 2e-5)


def test_chain_with_onload_norm():
    """Block 2 applies block 1's instance norm + lrelu on load."""
    N, D, H, W, C = 2, 6, 8, 13, 6
    parts, _, k1, b1 = _make(11, N, D, H, W, (C,), (False,), C)
    _, _, k2, b2 = _make(12, N, D, H, W, (C,), (False,), C)
    rng = np.random.RandomState(13)
    gamma, beta = _rand(rng, C, scale=0.1, shift=1.0), _rand(rng, C,
                                                             scale=0.05)
    n_vox = D * H * W

    y1_j, _, st1_j = _jax_block(parts, [None], k1, b1, H, W)
    m_j, o_j = jfb.norm_affine_from_stats(jnp.asarray(st1_j), n_vox,
                                          jnp.asarray(gamma),
                                          jnp.asarray(beta))
    Wp = jfb.choose_wp(H, W)
    y2_j, st2_j = jfb.fused_shift_conv_block(
        [y1_j], jnp.asarray(k2), jnp.asarray(b2), [(m_j, o_j)], H, W,
        interpret=True)
    ref_y2 = np.asarray(jfb.from_padded_cf(y2_j, H, W))
    lane = np.arange(H * Wp) % Wp
    ref_norm = np.asarray(jfb.from_padded_cf(jfb.apply_norm_lrelu_cf(
        y1_j, m_j, o_j, jnp.asarray((lane < W).astype(np.float32))), H, W))

    y1, st1 = _torch_block(parts, [None], k1, b1)
    m, o = tfb.norm_affine_from_stats(st1, n_vox, torch.from_numpy(gamma),
                                      torch.from_numpy(beta))
    np.testing.assert_allclose(m.numpy(), np.asarray(m_j), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_j), rtol=2e-4,
                               atol=2e-4)
    with torch.no_grad():
        y2, st2 = tfb.fused_shift_conv_block(
            [y1], torch.from_numpy(k2.transpose(3, 2, 0, 1).copy()),
            torch.from_numpy(b2), [(m, o)])
    np.testing.assert_allclose(y2.numpy(), ref_y2, rtol=2e-4, atol=2e-4)
    _check_stats(st2.numpy(), np.asarray(st2_j), ref_y2, 2e-4)
    np.testing.assert_allclose(tfb.apply_norm_lrelu(y1, m, o).numpy(),
                               ref_norm, rtol=2e-4, atol=2e-4)


def test_cpu_tensors_never_launch_the_kernel():
    before = tfb.fused_shift_conv_block.launches
    parts, affs, kernel, bias = _make(3, 1, 4, 8, 8, (4, 4), (True, False), 4)
    _torch_block(parts, affs, kernel, bias)
    assert tfb.fused_shift_conv_block.launches == before == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pooled_part(dtype):
    """The pooled down-link equals max_pool of the materialised norm exactly
    (mult of both signs), and the reference's pooled_cl_from_cf: exactly in
    float32, within one bf16 step in bfloat16 (rounding order of the apply)."""
    from e2enet_tpu_torch.ops.blocks import max_pool
    rng = np.random.RandomState(7)
    N, D, H, W, C = 2, 4, 6, 8, 5
    x = _rand(rng, N, D, H, W, C)
    mult = _rand(rng, N, C)                       # both signs
    off = _rand(rng, N, C, scale=0.3)
    tdt = getattr(torch, dtype)
    tx = torch.from_numpy(x).to(tdt)
    tm, to = torch.from_numpy(mult), torch.from_numpy(off)
    out = tfb.pooled_part(tx, tm, to, (2, 2, 2))
    ref_port = max_pool(tfb.apply_norm_lrelu(tx, tm, to), (2, 2, 2))
    assert torch.equal(out, ref_port)
    Wp = jfb.choose_wp(H, W)
    ref = jfb.pooled_cl_from_cf(
        jfb.to_padded_cf(jnp.asarray(x, getattr(jnp, dtype)), W, Wp),
        jnp.asarray(mult), jnp.asarray(off), H, W, (2, 2, 2))
    tol = 0 if dtype == "float32" else 2 ** -8
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), rtol=tol,
                               atol=tol)
