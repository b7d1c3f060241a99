"""The port's lazy up-link block (its plain version, reached through the
wrapper with CPU tensors) against the reference's quadrant fused block with
a LazyUp part (e2enet_tpu/ops/qfused.py, the lazy mode of `_fwd_kernel`, in
interpret mode), bfloat16. Layouts cross through the reference's
to_quadrant_cf / from_quadrant_cf; the coarse depth is odd and W not a
multiple of 8.

Tolerance: y within 2 bf16 steps of each output channel's largest |y|;
the statistics within 1e-3 relative. Both sides compute the same bf16
up-link (mult and off rounded to bf16, norm in bf16) and round it to bf16
before the conv, but the reference's interpret mode may keep more precision
between the norm's steps (tests/test_torch_qlink.py), and float32 sums run
in another order, so a staged up value may differ by one bf16 step.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from e2enet_tpu.ops.blocks import flip_transp_kernel  # noqa: E402
from e2enet_tpu.ops.qfused import (LazyUp, from_quadrant_cf,  # noqa: E402
                                   quadrant_fused_block, to_quadrant_cf)
from e2enet_tpu_torch.ops import qfused as tqf  # noqa: E402
from e2enet_tpu_torch.ops import qlink as tql  # noqa: E402

Q = (2, 2, 2)
WQP = 32
# (N, DQ, HQ, WQ, C_SAME, CIN, C_UP, CO); HQ * WQP a multiple of 128
SMALL = (1, 3, 4, 5, 8, 16, 8, 8)
# an up part wider than the CUDA kernel's 48-channel K chunk, beside a part
WIDE_UP = (1, 2, 4, 5, 8, 16, 56, 8)
# one coarse depth (D = 2)
ONE_DEPTH = (2, 1, 4, 5, 8, 16, 8, 8)
FLIPS = [(fd, fh, fw) for fd in (False, True) for fh in (False, True)
         for fw in (False, True)]


def _bf16(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)


def _inputs(seed, dims):
    N, DQ, HQ, WQ, C_SAME, CIN, C_UP, CO = dims
    rng = np.random.RandomState(seed)
    x = _bf16(rng.randn(N, 2 * DQ, 2 * HQ, 2 * WQ, C_SAME))
    raw = _bf16(rng.randn(N, DQ, HQ, WQ, CIN))
    smult = (rng.rand(N, C_SAME) + 0.5).astype(np.float32)
    soff = rng.randn(N, C_SAME).astype(np.float32)
    umult = (rng.rand(N, CIN) + 0.5).astype(np.float32)
    uoff = rng.randn(N, CIN).astype(np.float32)
    ukern = (rng.randn(2, 2, 2, CIN, C_UP) * 0.3).astype(np.float32)
    wk = _bf16(rng.randn(3, 3, C_SAME + C_UP, CO) * 0.2)
    b = _bf16(rng.randn(CO) * 0.1)
    return x, raw, smult, soff, umult, uoff, ukern, wk, b


def _check_against_reference(seed, dims, flips, groups):
    N, _, HQ, WQ, _, _, _, CO = dims
    x, raw, smult, soff, umult, uoff, ukern, wk, b = _inputs(seed, dims)
    bf = jnp.bfloat16
    lz = LazyUp(to_quadrant_cf(jnp.asarray(raw, bf), (1, 1, 1), WQP),
                jnp.asarray(umult), jnp.asarray(uoff),
                flip_transp_kernel(jnp.asarray(ukern), flips))
    yq, sq = quadrant_fused_block(
        [to_quadrant_cf(jnp.asarray(x, bf), Q, WQP), lz],
        jnp.asarray(wk, bf), jnp.asarray(b, bf),
        [(jnp.asarray(smult), jnp.asarray(soff)), None], Q, HQ, WQ,
        interpret=True, flips=flips, groups_override=groups)
    ref = np.asarray(from_quadrant_cf(yq, Q, HQ, WQ, CO), np.float32)
    ref_stats = np.asarray(sq).reshape(N, 8, CO, 2).sum(axis=1)

    t = torch.from_numpy
    kern = tql.flip_transp_kernel(t(ukern.transpose(3, 4, 0, 1, 2).copy()),
                                  flips)
    with torch.no_grad():
        y, stats = tqf.lazy_up_fused_block(
            [t(x).bfloat16()],
            tqf.LazyUp(t(raw).bfloat16(), t(umult), t(uoff), kern),
            t(wk.transpose(3, 2, 0, 1).copy()), t(b), [(t(smult), t(soff))],
            flips, groups)
    assert y.dtype == torch.bfloat16 and tuple(y.shape) == ref.shape
    out = y.float().numpy()
    ulp = 2.0 ** (np.floor(np.log2(np.abs(ref).max(axis=(0, 1, 2, 3)))) - 7)
    assert np.all(np.abs(out - ref).max(axis=(0, 1, 2, 3)) <= 2 * ulp)
    np.testing.assert_allclose(stats.numpy(), ref_stats, rtol=1e-3,
                               atol=1e-3 * float(np.abs(ref).sum()))
    assert tqf.lazy_up_fused_block.launches == 0


@pytest.mark.parametrize("flips,groups", [
    ((False, False, False), None),
    ((True, False, True), None),
    # compact groups that start mid-unit, as the sparse plan gives
    ((True, True, False), ((0, 3, -2), (3, 9, 0), (9, 12, 1), (12, 16, 2))),
])
def test_lazy_block_matches_reference_kernel(flips, groups):
    _check_against_reference(sum(flips), SMALL, flips, groups)


@pytest.mark.parametrize("flips", FLIPS)
def test_wide_up_part_matches_reference_kernel(flips):
    """An up part of 56 channels beside an 8-channel part: on the card it
    takes two K chunks of the up part."""
    _check_against_reference(10 + sum(flips), WIDE_UP, flips, None)


@pytest.mark.parametrize("flips,groups", [
    ((False, False, False), None),
    ((True, True, True), None),
    # compact groups whose up columns read both depth parities at one
    # output depth, across the wide up part's two K chunks
    ((False, False, False), ((0, 3, -2), (3, 20, 1), (20, 40, -1),
                             (40, 52, 2), (52, 64, 0))),
    ((True, False, False), ((0, 3, -2), (3, 20, 1), (20, 40, -1),
                            (40, 52, 2), (52, 64, 0))),
])
def test_wide_up_part_compact_groups_match_reference_kernel(flips, groups):
    _check_against_reference(20 + sum(flips), WIDE_UP, flips, groups)


@pytest.mark.parametrize("flips", [(False, False, False),
                                   (True, False, True)])
def test_one_coarse_depth_matches_reference_kernel(flips):
    """D = 2: every shifted up column but shift 0's reads outside the
    volume at one of the two depths, or the single coarse depth."""
    _check_against_reference(30 + sum(flips), ONE_DEPTH, flips, None)


def test_plain_version_is_uplink_then_block():
    """The lazy op's plain version is exactly the materialised route: the
    up-link op's plain version, then the fused block's (float32 too)."""
    from e2enet_tpu_torch.ops import fused_block as tfb
    rng = np.random.RandomState(4)
    t = lambda a: torch.from_numpy(a.astype(np.float32))  # noqa: E731
    x = t(rng.randn(2, 4, 6, 10, 5))
    raw = t(rng.randn(2, 2, 3, 5, 7))
    m, o = t(rng.rand(2, 7) + 0.5), t(rng.randn(2, 7))
    k = t(rng.randn(7, 3, 2, 2, 2))
    w, b = t(rng.randn(6, 8, 3, 3)), t(rng.randn(6))
    aff = [(t(rng.rand(2, 5) + 0.5), t(rng.randn(2, 5)))]
    y, s = tqf.lazy_up_fused_block([x], tqf.LazyUp(raw, m, o, k), w, b, aff,
                                   (True, False, False))
    u = tql.uplink(raw, m, o, k)
    y2, s2 = tfb.fused_shift_conv_block([x, u], w, b, aff + [None],
                                        (True, False, False))
    assert torch.equal(y, y2) and torch.equal(s, s2)
