"""e2enet_tpu_torch.ops.shift against e2enet_tpu.ops.shift: torch.chunk
group boundaries and the zero-filled depth shift, bit for bit."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from e2enet_tpu.ops import shift as jshift  # noqa: E402
from e2enet_tpu_torch.ops import shift as tshift  # noqa: E402

CHANNELS = [1, 3, 5, 8, 48, 96, 240]


@pytest.mark.parametrize("C", CHANNELS)
def test_groups_match_reference(C):
    assert tshift.chunk_sizes(C, 5) == jshift.chunk_sizes(C, 5)
    assert tshift.group_shifts(C, 5) == jshift.group_shifts(C, 5)
    assert tshift.group_shifts(C, 3) == jshift.group_shifts(C, 3)


def test_small_channel_counts_shift_down():
    # C=1: one group, shift -2 (the first block of context0); C=3: -2,-1,0
    assert tshift.group_shifts(1, 5) == [(0, 1, -2)]
    assert [s for *_, s in tshift.group_shifts(3, 5)] == [-2, -1, 0]


@pytest.mark.parametrize("C,D", [(1, 4), (3, 6), (8, 7), (48, 5), (7, 3)])
def test_depth_shift_exact(C, D):
    x = np.random.RandomState(C * 10 + D).randn(2, D, 3, 4, C).astype(
        np.float32)
    ref = np.asarray(jshift.depth_shift(jnp.asarray(x), 5))
    out = tshift.depth_shift(torch.from_numpy(x), 5).numpy()
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("lo,hi", [(0, 5), (5, 8), (3, 12)])
def test_restricted_groups_match_slice_of_concat(lo, hi):
    """Shifting a channel slice with restrict_groups equals slicing the
    shifted concat (the list-of-parts block)."""
    x = np.random.RandomState(lo).randn(1, 6, 2, 3, 13).astype(np.float32)
    groups = tshift.group_shifts(13, 5)
    full = tshift.depth_shift(torch.from_numpy(x), 5)[..., lo:hi]
    part = tshift.depth_shift_groups(torch.from_numpy(x[..., lo:hi]),
                                     tshift.restrict_groups(groups, lo, hi))
    np.testing.assert_array_equal(part.numpy(), full.numpy())
    assert tshift.restrict_groups(groups, lo, hi) == \
        jshift.group_shifts_for_range(13, 5, lo, hi)


@pytest.mark.parametrize("C", [1, 3, 48, 96])
@pytest.mark.parametrize("stride_d", [1, 2])
def test_mirrored_depth_source_matches_reference(C, stride_d):
    """strided_depth_source reads the input depth row the reference's
    mirrored strided transition reads (qstride._groups: s -> -(s+1) at
    stride 2, -s at stride 1, source row stride_d*do - s)."""
    from e2enet_tpu.ops.qstride import _groups
    groups = tshift.group_shifts(C, 5)
    for flip in (False, True):
        ours, parity = tshift.strided_depth_source(groups, stride_d, flip)
        ref = _groups(C, 5, True, qd=stride_d, flip_d=flip)
        assert [g[:2] for g in ours] == [g[:2] for g in ref]
        for (_, _, s), (_, _, s_ref) in zip(ours, ref):
            for do in range(3):
                assert stride_d * do + parity - s == stride_d * do - s_ref
    assert tshift.mirror_groups(groups) == tuple((a, b, -s) for a, b, s in groups)
