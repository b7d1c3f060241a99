"""The port's DC+CE deep-supervision loss (e2enet_tpu_torch/ops/losses.py)
against the reference's (e2enet_tpu/ops/losses.py) on the same numpy
logits and labels: values and gradients with respect to the logits within
1e-5 relative (float32 sums in another order); the target downsampling
exactly."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from e2enet_tpu.ops import losses as jl  # noqa: E402
from e2enet_tpu_torch.ops import losses as tl  # noqa: E402


def _data(seed, shape=(2, 4, 6, 5), K=4):
    rng = np.random.RandomState(seed)
    logits = (rng.randn(*shape, K) * 2).astype(np.float32)
    target = rng.randint(0, K, size=shape).astype(np.int32)
    return logits, target


@pytest.mark.parametrize("batch_dice", [True, False])
@pytest.mark.parametrize("ignore_label", [None, 2])
def test_dc_and_ce_loss_and_grad(batch_dice, ignore_label):
    logits, target = _data(int(batch_dice) + 2 * (ignore_label or 0))

    def jloss(lg):
        return jl.dc_and_ce_loss(lg, jnp.asarray(target), batch_dice,
                                 ignore_label=ignore_label)

    want, wgrad = jax.value_and_grad(jloss)(jnp.asarray(logits))
    tlg = torch.from_numpy(logits).requires_grad_()
    got = tl.dc_and_ce_loss(tlg, torch.from_numpy(target).long(), batch_dice,
                            ignore_label=ignore_label)
    (grad,) = torch.autograd.grad(got, tlg)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    np.testing.assert_allclose(grad.numpy(), np.asarray(wgrad), rtol=1e-5,
                               atol=1e-8)


@pytest.mark.parametrize("batch_dice", [True, False])
def test_parts(batch_dice):
    logits, target = _data(5)
    jt, tt = jnp.asarray(target), torch.from_numpy(target).long()
    probs = jax.nn.softmax(jnp.asarray(logits), axis=-1)
    for a, b in zip(jl.get_tp_fp_fn_tn(probs, jt, batch_dice),
                    tl.get_tp_fp_fn_tn(tl.softmax_helper(
                        torch.from_numpy(logits)), tt, batch_dice)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5,
                                   atol=1e-6)
    np.testing.assert_allclose(
        float(tl.soft_dice_loss(torch.from_numpy(logits), tt, batch_dice)),
        float(jl.soft_dice_loss(jnp.asarray(logits), jt, batch_dice)),
        rtol=1e-5)
    np.testing.assert_allclose(
        float(tl.robust_cross_entropy(torch.from_numpy(logits), tt)),
        float(jl.robust_cross_entropy(jnp.asarray(logits), jt)), rtol=1e-5)


def test_deep_supervision_loss_and_targets():
    """Three heads at the scales of (2,2,2) pools, the last weight zero
    (skipped), the targets downsampled from one full-size label map."""
    from e2enet_tpu.models.unetpp import (deep_supervision_scales,
                                          ds_loss_weights)
    from e2enet_tpu_torch.models import unetpp as tu
    pools = ((2, 2, 2),) * 3
    scales = deep_supervision_scales(pools, 3)
    weights = ds_loss_weights(3, 3)
    assert tu.deep_supervision_scales(pools, 3) == scales
    np.testing.assert_array_equal(tu.ds_loss_weights(3, 3), weights)
    assert weights[-1] == 0.0
    rng = np.random.RandomState(7)
    seg = rng.randint(0, 3, size=(2, 8, 8, 8)).astype(np.int32)
    jt = jl.downsample_seg_for_ds(jnp.asarray(seg), scales)
    tt = tl.downsample_seg_for_ds(torch.from_numpy(seg).long(), scales)
    for a, b in zip(jt, tt):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    outs = [(rng.randn(2, 8 // f, 8 // f, 8 // f, 3)).astype(np.float32)
            for f in (1, 2, 4)]
    want, wgrads = jax.value_and_grad(
        lambda o: jl.deep_supervision_loss(o, jt, weights))(
            [jnp.asarray(o) for o in outs])
    touts = [torch.from_numpy(o).requires_grad_() for o in outs]
    got = tl.deep_supervision_loss(touts, tt, weights)
    grads = torch.autograd.grad(got, touts, allow_unused=True)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    for g, w in zip(grads[:2], wgrads[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-8)
    assert grads[2] is None and not np.any(np.asarray(wgrads[2]))
