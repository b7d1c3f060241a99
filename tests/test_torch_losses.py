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


# every loss of the registry: (name, takes batch dice, region targets)
REGISTRY = [("dc_ce", True, False), ("mcc", False, False),
            ("dice", True, False), ("dice_squared", True, False),
            ("gdl", True, False), ("gdl_ce", True, False),
            ("dc_topk", True, False), ("topk", False, False),
            ("ce", False, False), ("focal", False, False),
            ("dc_bce", True, True), ("dice_regions", True, True)]
CASES = [(n, bd) for n, takes, _ in REGISTRY
         for bd in ((True, False) if takes else (True,))]


def _loss_inputs(name, seed):
    """Logits leaning towards the label by 2 (a model that has learnt
    something: on unrelated logits the MCC's numerator is a difference of
    near-equal float32 sums, ~1e-3 of its terms) and targets for the loss
    `name`: integer labels, or 0/1 region channels from them for the
    region losses."""
    logits, target = _data(seed)
    logits = logits + 2.0 * np.eye(logits.shape[-1],
                                   dtype=np.float32)[target]
    if dict((n, r) for n, _, r in REGISTRY)[name]:
        target = (np.eye(logits.shape[-1], dtype=np.float32)[target] > 0)
        target = target.astype(np.float32)
    return logits, target


def test_registry_is_the_reference_s():
    assert set(tl.LOSS_REGISTRY) == set(jl.LOSS_REGISTRY) == {
        n for n, _, _ in REGISTRY}
    assert set(tl._TAKES_BATCH_DICE) == {n for n, t, _ in REGISTRY if t}


@pytest.mark.parametrize("name, batch_dice", CASES)
def test_every_loss_and_grad(name, batch_dice):
    """Each registry loss through make_loss, value and gradient with
    respect to the logits within 1e-5 relative of the reference's."""
    logits, target = _loss_inputs(name, 11 + int(batch_dice))
    jfn = jl.make_loss(name, batch_dice)
    want, wgrad = jax.value_and_grad(
        lambda lg: jfn(lg, jnp.asarray(target)))(jnp.asarray(logits))
    tlg = torch.from_numpy(logits).requires_grad_()
    tt = torch.from_numpy(target)
    got = tl.make_loss(name, batch_dice)(
        tlg, tt if tt.dtype == torch.float32 else tt.long())
    (grad,) = torch.autograd.grad(got, tlg)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    np.testing.assert_allclose(grad.numpy(), np.asarray(wgrad), rtol=1e-5,
                               atol=1e-5 * float(np.abs(wgrad).max()))


@pytest.mark.parametrize("name, kwargs", [
    ("dc_ce", {"smooth": 0.0}), ("dice_squared", {"smooth": 1e-5}),
    ("dc_ce", {"weight_ce": 0.4, "weight_dice": 1.6}),
    ("topk", {"k_percent": 25.0}), ("dc_bce", {"smooth": 0.0})])
def test_deep_supervision_loss_by_name(name, kwargs):
    """deep_supervision_loss with loss_name and loss_kwargs (the variant
    presets' and the CE -> Dice transition's), two heads and a
    zero-weight one."""
    rng = np.random.RandomState(3)
    logits, target = _loss_inputs(name, 21)
    outs = [logits, logits[:, ::2, ::2, ::2] * 0.5,
            logits[:, ::4, ::4, ::4]]
    targets = [target, target[:, ::2, ::2, ::2], target[:, ::4, ::4, ::4]]
    weights = [0.6, 0.4 + rng.rand() * 0.1, 0.0]
    want, wgrads = jax.value_and_grad(
        lambda o: jl.deep_supervision_loss(
            o, [jnp.asarray(t) for t in targets], weights,
            loss_name=name, loss_kwargs=kwargs))(
                [jnp.asarray(o) for o in outs])
    touts = [torch.from_numpy(np.ascontiguousarray(o)).requires_grad_()
             for o in outs]
    tts = [torch.from_numpy(np.ascontiguousarray(t)) for t in targets]
    tts = [t if t.dtype == torch.float32 else t.long() for t in tts]
    got = tl.deep_supervision_loss(touts, tts, weights, loss_name=name,
                                   loss_kwargs=kwargs)
    grads = torch.autograd.grad(got, touts[:2])
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    for g, w in zip(grads, wgrads[:2]):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(w).max()))


def test_mcc_gradient_is_finite_where_a_class_is_absent():
    """A class absent from the targets makes the MCC's square root 0: the
    loss equals the reference's, whose gradient is NaN there (and spreads
    to every logit through the softmax); the port's gradient is
    finite."""
    logits, target = _loss_inputs("mcc", 31)
    target = np.where(target == 2, 1, target).astype(np.int32)
    want, wgrad = jax.value_and_grad(
        lambda lg: jl.mcc_loss(lg, jnp.asarray(target)))(
            jnp.asarray(logits))
    assert np.isnan(np.asarray(wgrad)).any()
    tlg = torch.from_numpy(logits).requires_grad_()
    got = tl.mcc_loss(tlg, torch.from_numpy(target).long())
    (grad,) = torch.autograd.grad(got, tlg)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    assert torch.isfinite(grad).all()
