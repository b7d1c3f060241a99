"""Mirrored ops of the port (flip-free mirror TTA): every op with flips=c
computes flip_c(op(flip_c(x))), and agrees with the reference op given the
same flips. float32 throughout (reference at HIGHEST precision): 2e-5 for
one conv, 1e-4 for a block with its instance norm."""
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from e2enet_tpu.ops import blocks as jb  # noqa: E402
from e2enet_tpu.ops import fused_block as jfb  # noqa: E402
from e2enet_tpu_torch.ops import blocks as tb  # noqa: E402
from e2enet_tpu_torch.ops import fused_block as tfb  # noqa: E402

COMBOS = list(itertools.product([False, True], repeat=3))


def _rand(rng, *shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype(np.float32)


def _flip(t, c):
    dims = [1 + a for a in range(3) if c[a]]
    return t.flip(dims) if dims else t


@pytest.mark.parametrize("stride", [(1, 1, 1), (2, 2, 2), (1, 2, 2)])
def test_conv3d_as_2d_flips(stride):
    rng = np.random.RandomState(0)
    x = _rand(rng, 2, 8, 8, 8, 5)
    k = _rand(rng, 3, 3, 5, 6, scale=0.3)                 # HWIO
    b = _rand(rng, 6, scale=0.1)
    tk = torch.from_numpy(k.transpose(3, 2, 0, 1).copy())
    for c in COMBOS:
        got = tb.conv3d_as_2d(torch.from_numpy(x), tk, torch.from_numpy(b),
                              stride, torch.float32, c)
        mirrored = _flip(tb.conv3d_as_2d(_flip(torch.from_numpy(x), c), tk,
                                         torch.from_numpy(b), stride,
                                         torch.float32), c)
        ref = jb.conv3d_as_2d(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b),
                              stride, jnp.float32, flips=c)
        np.testing.assert_allclose(got.numpy(), mirrored.numpy(), rtol=2e-5,
                                   atol=2e-5, err_msg=f"flips={c}")
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-5,
                                   atol=2e-5, err_msg=f"flips={c}")


@pytest.mark.parametrize("part_c,stride", [((5, 3, 4), (1, 1, 1)),
                                           ((6,), (2, 2, 2))])
def test_shift_conv_block_flips(part_c, stride):
    """Negated shift groups (also across an implicit concat), mirrored
    kernel, re-anchored strided windows; the norm is flip-invariant."""
    rng = np.random.RandomState(1)
    C, CO = sum(part_c), 6
    parts = [_rand(rng, 1, 6, 8, 8, c) for c in part_c]
    p = {"kernel": _rand(rng, 3, 3, C, CO, scale=0.3),
         "bias": _rand(rng, CO, scale=0.1),
         "norm_scale": _rand(rng, CO) + 1.0, "norm_bias": _rand(rng, CO)}
    blk = tb.ShiftConvBlock(C, CO, stride=stride, compute_dtype=torch.float32,
                            device="cpu")
    sd = {k: torch.from_numpy(v) for k, v in p.items()}
    sd["kernel"] = torch.from_numpy(p["kernel"].transpose(3, 2, 0, 1).copy())
    blk.load_state_dict(sd)
    jin = [jnp.asarray(a) for a in parts]
    for c in [(True, False, False), (False, True, True), (True, True, True)]:
        ref = jb.ShiftConvBlock(features=CO, stride=stride,
                                compute_dtype=jnp.float32, flips=c).apply(
            {"params": {k: jnp.asarray(v) for k, v in p.items()}},
            jin if len(jin) > 1 else jin[0])
        with torch.no_grad():
            tin = [torch.from_numpy(a) for a in parts]
            got = blk(tin, c)
            mirrored = _flip(blk([_flip(t, c) for t in tin]), c)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                                   atol=1e-4, err_msg=f"flips={c}")
        np.testing.assert_allclose(got.numpy(), mirrored.numpy(), rtol=1e-4,
                                   atol=1e-4, err_msg=f"flips={c}")


def test_transp_conv_flips():
    rng = np.random.RandomState(2)
    x = _rand(rng, 2, 3, 4, 5, 6)
    k = _rand(rng, 2, 2, 2, 6, 3, scale=0.3)               # (s, s, s, I, O)
    mod = tb.TranspConv(6, 3, (2, 2, 2), compute_dtype=torch.float32,
                        device="cpu")
    mod.load_state_dict({"kernel": torch.from_numpy(
        k.transpose(3, 4, 0, 1, 2).copy())})
    for c in COMBOS:
        with torch.no_grad():
            got = mod(torch.from_numpy(x), c)
            mirrored = _flip(mod(_flip(torch.from_numpy(x), c)), c)
        ref = jb.transp_conv_matmul(jnp.asarray(x), jb.flip_transp_kernel(
            jnp.asarray(k), c), (2, 2, 2), compute_dtype=jnp.float32)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-5, err_msg=f"flips={c}")
        np.testing.assert_allclose(got.numpy(), mirrored.numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=f"flips={c}")


@pytest.mark.parametrize("flips", COMBOS)
def test_fused_block_flips(flips):
    """The fused block with flips (reordered taps, negated shifts) against
    the reference Pallas fused block with the same flips (interpret mode)
    and against flip(block(flip(x)))."""
    rng = np.random.RandomState(9)
    C, CO, D, H, W = 6, 4, 6, 8, 8
    x = _rand(rng, 2, D, H, W, C)
    kern = _rand(rng, 3, 3, C, CO, scale=0.3)
    bias = _rand(rng, CO, scale=0.2)
    Wp = jfb.choose_wp(H, W)
    y, st = jfb.fused_shift_conv_block(
        [jfb.to_padded_cf(jnp.asarray(x), W, Wp)], jnp.asarray(kern),
        jnp.asarray(bias), [None], H, W, interpret=True, flips=flips)
    ref = np.asarray(jfb.from_padded_cf(y, H, W))
    tk = torch.from_numpy(kern.transpose(3, 2, 0, 1).copy())
    with torch.no_grad():
        got, gst = tfb.fused_shift_conv_block(
            [torch.from_numpy(x)], tk, torch.from_numpy(bias), [None], flips)
        m, _ = tfb.fused_shift_conv_block(
            [_flip(torch.from_numpy(x), flips)], tk, torch.from_numpy(bias),
            [None])
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got.numpy(), _flip(m, flips).numpy(),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(gst.numpy(), np.asarray(st), rtol=1e-4,
                               atol=1e-4)


def test_seg_head_probs_mode():
    """The plain probs head: the float32 class softmax of the reference
    head's logits, stored in the probs dtype."""
    rng = np.random.RandomState(13)
    x = _rand(rng, 1, 4, 5, 6, 8)
    k = _rand(rng, 8, 3)
    logits = jb.SegHead(num_classes=3, compute_dtype=jnp.float32).apply(
        {"params": {"kernel": jnp.asarray(k)}}, jnp.asarray(x))
    ref = np.asarray(jnp.asarray(
        np.exp(logits - logits.max(-1, keepdims=True))
        / np.exp(logits - logits.max(-1, keepdims=True)).sum(-1,
                                                              keepdims=True),
        jnp.bfloat16), np.float32)
    head = tb.SegHead(8, 3, compute_dtype=torch.float32, device="cpu")
    head.load_state_dict({"kernel": torch.from_numpy(k.T.copy())})
    with torch.no_grad():
        p = head(torch.from_numpy(x), torch.bfloat16)
    assert p.dtype == torch.bfloat16
    np.testing.assert_allclose(p.float().numpy(), ref, rtol=0, atol=2 ** -8)
