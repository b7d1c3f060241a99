"""The port's level links and seg head (plain versions, reached through the
wrappers with CPU tensors) against the reference Pallas kernels of
e2enet_tpu/ops/qlink.py run in interpret mode: uplink_from_cf,
downlink_block_max, seghead_probs_quadrant and seghead_quadrant. Layouts
cross through the reference's to_quadrant_cf / from_quadrant_cf; the
geometry is the reference tests' (Hq 8, Wq 15, 128 lanes).

The reference up-link, down-link and probs head store bfloat16: within one
bf16 step of the largest value (the same bf16 operands; the up-link's bf16
norm may keep more precision between its steps in the reference's
interpret mode, float32 sums run in another order). The logits head runs
in float32 (weights already bf16 values, which the reference rounds to):
within 1e-4.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from e2enet_tpu.ops import qfused  # noqa: E402
from e2enet_tpu.ops.blocks import flip_transp_kernel  # noqa: E402
from e2enet_tpu.ops.qfused import from_quadrant_cf, to_quadrant_cf  # noqa
from e2enet_tpu.ops.qlink import (downlink_block_max,  # noqa: E402
                                  seghead_probs_quadrant, seghead_quadrant,
                                  uplink_from_cf)
from e2enet_tpu_torch.ops import fused_block as tfb  # noqa: E402
from e2enet_tpu_torch.ops import qlink as tql  # noqa: E402

Q = (2, 2, 2)
HQ, WQ, WQP = 8, 15, 16


def _bf16(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)


def _one_ulp_of_max(out, ref):
    big = float(np.abs(ref).max())
    ulp = 2.0 ** (np.floor(np.log2(big)) - 7)
    assert float(np.abs(out - ref).max()) <= ulp


def _twin(*a):
    raise AssertionError("the backward is not run")


@pytest.mark.parametrize("flips", [(False, False, False), (True, True, False),
                                   (False, True, True)])
def test_uplink_matches_reference_kernel(flips):
    rng = np.random.RandomState(0)
    N, Dq, Cin, Cout = 2, 3, 16, 8
    x = _bf16(rng.randn(N, Dq, HQ, WQ, Cin))            # coarse pending raw
    mult = (rng.rand(N, Cin) + 0.5).astype(np.float32)
    off = rng.randn(N, Cin).astype(np.float32)
    kern = (rng.randn(2, 2, 2, Cin, Cout) * 0.3).astype(np.float32)
    raw = to_quadrant_cf(jnp.asarray(x, jnp.bfloat16), (1, 1, 1), WQP)
    ref = uplink_from_cf(raw, jnp.asarray(mult), jnp.asarray(off),
                         flip_transp_kernel(jnp.asarray(kern), flips), Q, HQ,
                         WQ, _twin, interpret=True)
    ref = np.asarray(from_quadrant_cf(ref, Q, HQ, WQ, Cout), np.float32)
    with torch.no_grad():
        out = tql.uplink(torch.from_numpy(x).bfloat16(),
                         torch.from_numpy(mult), torch.from_numpy(off),
                         torch.from_numpy(kern.transpose(3, 4, 0, 1, 2)
                                          .copy()), flips)
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == ref.shape
    _one_ulp_of_max(out.float().numpy(), ref)


# (Cin, Cout, stride): the bench's level 1 -> 0 up-link, a ragged one, a
# (1, 2, 2) stride
IMAGES = {"bench_width": (96, 48, (2, 2, 2)), "ragged": (8, 12, (2, 2, 2)),
          "stride_122": (24, 16, (1, 2, 2))}


@pytest.mark.parametrize("case", sorted(IMAGES))
@pytest.mark.parametrize("flips", [(False, False, False), (True, False, True)])
def test_uplink_image_is_ref_layout(case, flips):
    """The weights' image the CUDA up-link packs (uplink_image_ref, its
    plain version) holds uplink_ref's (Cin, sd*sh*sw*Cout) product columns
    k.permute(0, 2, 3, 4, 1) of the mirrored kernel, chunk (bd, bh) by
    chunk, zero past NW and Cin."""
    C, cout, (sd, sh, sw) = IMAGES[case]
    rng = np.random.RandomState(C + cout)
    k = torch.from_numpy(rng.randn(C, cout, sd, sh, sw).astype(np.float32))
    img = tql.uplink_image_ref(k.bfloat16(), flips)
    nw = sw * cout
    assert tuple(img.shape) == (sd * sh, -(-nw // 16) * 16,
                                -(-C // 16) * 16 + 8)
    assert img.dtype == torch.bfloat16
    w2 = tql.flip_transp_kernel(k.bfloat16(), flips).permute(
        0, 2, 3, 4, 1).reshape(C, sd * sh * nw)
    assert torch.equal(img[:, :nw, :C], w2.t().reshape(sd * sh, nw, C))
    pad = img.clone()
    pad[:, :nw, :C] = 0
    assert not bool(pad.float().abs().sum())


@pytest.mark.parametrize("flips", [(False, False, False), (False, True, True)])
def test_uplink_through_image_matches_reference_kernel(flips):
    """The up-link computed the way the CUDA kernel reads the image (per
    chunk (bd, bh), u times the chunk's NW columns, each coarse voxel's
    sw*Cout values one contiguous piece of the finer row) against the
    reference kernel in interpret mode: within one bf16 step of the
    largest value, as test_uplink_matches_reference_kernel."""
    rng = np.random.RandomState(4)
    N, Dq, Cin, Cout = 2, 3, 16, 8
    x = _bf16(rng.randn(N, Dq, HQ, WQ, Cin))
    mult = (rng.rand(N, Cin) + 0.5).astype(np.float32)
    off = rng.randn(N, Cin).astype(np.float32)
    kern = (rng.randn(2, 2, 2, Cin, Cout) * 0.3).astype(np.float32)
    raw = to_quadrant_cf(jnp.asarray(x, jnp.bfloat16), (1, 1, 1), WQP)
    ref = uplink_from_cf(raw, jnp.asarray(mult), jnp.asarray(off),
                         flip_transp_kernel(jnp.asarray(kern), flips), Q, HQ,
                         WQ, _twin, interpret=True)
    ref = np.asarray(from_quadrant_cf(ref, Q, HQ, WQ, Cout), np.float32)
    k = torch.from_numpy(kern.transpose(3, 4, 0, 1, 2).copy()).bfloat16()
    img = tql.uplink_image_ref(k, flips).float()
    xt = torch.from_numpy(x).bfloat16()
    shape = (N, 1, 1, 1, Cin)
    m = torch.from_numpy(mult).bfloat16().reshape(shape)
    o = torch.from_numpy(off).bfloat16().reshape(shape)
    u = tfb.lrelu_max(xt * m + o).float()           # bf16 arithmetic
    D, H, W = x.shape[1:4]
    nw = 2 * Cout
    y = torch.empty(N, 2 * D, 2 * H, 2 * W, Cout)
    for ch in range(4):
        bd, bh = divmod(ch, 2)
        seg = (u @ img[ch, :nw, :Cin].t()).reshape(N, D, H, 2 * W, Cout)
        y[:, bd::2, bh::2] = seg
    _one_ulp_of_max(y.bfloat16().float().numpy(), ref)


def test_downlink_matches_reference_kernel():
    rng = np.random.RandomState(2)
    N, Dq, C = 2, 3, 16
    x = _bf16(rng.randn(N, 2 * Dq, 2 * HQ, 2 * WQ, C))  # fine pending raw
    mult = rng.randn(N, C).astype(np.float32)           # both signs
    off = rng.randn(N, C).astype(np.float32)
    xq = to_quadrant_cf(jnp.asarray(x, jnp.bfloat16), Q, WQP)
    ref = downlink_block_max(xq, jnp.asarray(mult), jnp.asarray(off), C, HQ,
                             WQ, _twin, interpret=True)
    ref = np.asarray(from_quadrant_cf(ref, (1, 1, 1), HQ, WQ, C), np.float32)
    out = tql.downlink(torch.from_numpy(x).bfloat16(), torch.from_numpy(mult),
                       torch.from_numpy(off), (2, 2, 2))
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == ref.shape
    _one_ulp_of_max(out.float().numpy(), ref)


def _head_inputs(seed, C=16, K=8):
    rng = np.random.RandomState(seed)
    x = _bf16(rng.randn(2, 2 * 3, 2 * HQ, 2 * WQ, C))
    mult = (rng.rand(2, C) + 0.5).astype(np.float32)
    off = rng.randn(2, C).astype(np.float32)
    w = _bf16(rng.randn(C, K))                          # reference (C, K)
    return x, mult, off, w


def test_seghead_probs_matches_reference_kernel():
    x, mult, off, w = _head_inputs(9)
    K = w.shape[1]
    xq = to_quadrant_cf(jnp.asarray(x, jnp.bfloat16), Q, WQP)
    ref = seghead_probs_quadrant(xq, jnp.asarray(mult), jnp.asarray(off),
                                 jnp.asarray(w), 8, _twin, interpret=True)
    ref = np.asarray(from_quadrant_cf(ref, Q, HQ, WQ, K), np.float32)
    out = tql.seghead(torch.from_numpy(x).bfloat16(), torch.from_numpy(mult),
                      torch.from_numpy(off), torch.from_numpy(w.T.copy()),
                      torch.bfloat16)
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == ref.shape
    _one_ulp_of_max(out.float().numpy(), ref)
    np.testing.assert_allclose(out.float().sum(-1).numpy(), 1.0, atol=1e-2)


def test_seghead_logits_matches_reference_kernel():
    x, mult, off, w = _head_inputs(5)
    K = w.shape[1]
    xq = to_quadrant_cf(jnp.asarray(x, jnp.float32), Q, WQP)
    ref = seghead_quadrant(xq, jnp.asarray(mult), jnp.asarray(off),
                           jnp.asarray(w), 8, _twin, interpret=True)
    ref = np.asarray(from_quadrant_cf(ref, Q, HQ, WQ, K))
    out = tql.seghead(torch.from_numpy(x), torch.from_numpy(mult),
                      torch.from_numpy(off), torch.from_numpy(w.T.copy()))
    assert out.dtype == torch.float32 and tuple(out.shape) == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=1e-4)


def test_downlink_is_pooled_norm():
    """The down-link equals max_pool of the float32-normalised tensor
    exactly, for mult of both signs and a ragged edge, and agrees with the
    reference's XLA twin of the block max."""
    from e2enet_tpu_torch.ops.blocks import max_pool
    rng = np.random.RandomState(7)
    x = torch.from_numpy(rng.randn(2, 5, 6, 8, 5).astype(np.float32))
    m = torch.from_numpy(rng.randn(2, 5).astype(np.float32))
    o = torch.from_numpy(rng.randn(2, 5).astype(np.float32) * 0.3)
    out = tql.downlink(x, m, o, (2, 2, 2))
    a = torch.nn.functional.leaky_relu(x * m[:, None, None, None]
                                       + o[:, None, None, None], 0.01)
    assert torch.equal(out, max_pool(a[:, :4], (2, 2, 2)))
    xq = to_quadrant_cf(jnp.asarray(x[:, :4].numpy()), Q, 5)
    ref = qfused._quadrant_block_max_cf_xla(xq, jnp.asarray(m.numpy()),
                                            jnp.asarray(o.numpy()), Q, 3, 4,
                                            5, 5)
    np.testing.assert_allclose(
        out.numpy(), np.asarray(from_quadrant_cf(ref, (1, 1, 1), 3, 4, 5)),
        rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("flips", [(True, False, False), (False, True, True),
                                   (True, True, True)])
def test_links_mirror(flips):
    """uplink(flips=c) == flip_c(uplink(flip_c(x))); the down-link and the
    seg head are flip-equivariant as they are."""
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(2, 4, 6, 8, 6).astype(np.float32))
    m = torch.from_numpy(rng.randn(2, 6).astype(np.float32))
    o = torch.from_numpy(rng.randn(2, 6).astype(np.float32))
    dims = [1 + a for a in range(3) if flips[a]]
    k = torch.from_numpy(rng.randn(6, 4, 2, 2, 2).astype(np.float32))
    np.testing.assert_allclose(
        tql.uplink(x, m, o, k, flips).numpy(),
        tql.uplink(x.flip(dims), m, o, k).flip(dims).numpy(), rtol=1e-5,
        atol=1e-5)
    assert torch.equal(tql.downlink(x, m, o).flip(dims),
                       tql.downlink(x.flip(dims), m, o))
    w = torch.from_numpy(rng.randn(3, 6).astype(np.float32))
    np.testing.assert_allclose(
        tql.seghead(x, m, o, w, torch.bfloat16).flip(dims).float().numpy(),
        tql.seghead(x.flip(dims), m, o, w, torch.bfloat16).float().numpy(),
        rtol=0, atol=0)


def test_cpu_tensors_never_launch():
    x = torch.zeros(1, 2, 2, 2, 8)
    m, o = torch.ones(8), torch.zeros(8)
    tql.uplink(x, m, o, torch.zeros(8, 4, 2, 2, 2))
    tql.downlink(x, m, o)
    tql.seghead(x, m, o, torch.zeros(3, 8))
    assert tql.uplink.launches == tql.downlink.launches == \
        tql.seghead.launches == 0
