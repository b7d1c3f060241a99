"""The port's train step (e2enet_tpu_torch/training/train_state.py) against
the reference's make_train_step (e2enet_tpu/training/train_state.py) on the
same numpy weights, DSFF row masks, batch and learning rates, float32: two
steps.

Compared, leaf by leaf (leaves mapped through models/weights.py), each on
its own scale (relative L2, ||port - ref|| <= rtol ||ref||): the gradients
of step 1 (read from the momentum after step 1, which is the gradient plus
the weight-decay term when the norm is under the clip, as it is here), the
momentum after step 2 and the change of the parameters over the two steps
(with two float32 spacings of the parameters as slack: both sides round
the parameters at each step). Also the loss of each step within 1e-5
relative, its gradient norm within 1e-4, and the masks kept applied to
parameters and momentum (dead rows exactly zero). The conv biases ahead of
an instance norm have a gradient that is zero but for rounding (the norm
removes a per-channel constant) and their momentum is the weight decay's;
a rule holds them instead: both sides' gradients of both steps stay under
1e-5 of the same block's kernel gradient.

Without masks the port stays within 3e-4 of the reference's XLA path at
every leaf over both steps. With masks (density 0.5) the step-1 gradients
still do; after step 2 the port takes the instance-norm statistics of the
fused levels as the reference's fused path does (one pass, E[x^2] -
E[x]^2), not in two passes as its XLA path, and the dead rows make the
second step's gradient sensitive to that: the reference's own fused and XLA
paths differ there by far more than 3e-4 per leaf. So the masked
comparison with the XLA path holds step 2 to 2e-2 per leaf, and
test_torch_train_step_fused.py holds the port to the reference's fused
path within 3e-4 per leaf over both steps, and that fused path to the XLA
path within the same 2e-2.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from e2enet_tpu.models.unetpp import ShiftUNetPlusPlus as JaxNet  # noqa
from e2enet_tpu.models.unetpp import ds_loss_weights  # noqa: E402
from e2enet_tpu.training import dsff as jd  # noqa: E402
from e2enet_tpu.training import train_state as jts  # noqa: E402
from e2enet_tpu_torch.models.masks import broadcast_mask  # noqa: E402
from e2enet_tpu_torch.models.unetpp import ShiftUNetPlusPlus  # noqa: E402
from e2enet_tpu_torch.models.weights import from_jax_params  # noqa: E402
from e2enet_tpu_torch.training import train_state as tts  # noqa: E402

KW = dict(input_channels=1, num_classes=3,
          pool_op_kernel_sizes=((2, 2, 2),) * 3, base_num_features=4)
SHAPE = (2, 16, 16, 16, 1)
LRS = (0.01, 0.009)
GRAD_RTOL = 3e-4            # step-1 gradients, every comparison
DENSE_STEP2_RTOL = 3e-4     # step 2 without masks, against the XLA path
MASKED_STEP2_RTOL = 2e-2    # step 2 with masks, against the XLA path
BIAS_ZERO = 1e-5            # |bias gradient| / |kernel gradient|, a zero


def _params(kw, shape, seed):
    net = JaxNet(**kw, compute_dtype=jnp.float32, remat=False,
                 quadrant=False)
    shapes = jax.eval_shape(net.init, jax.random.PRNGKey(0),
                            jnp.zeros(shape, jnp.float32))
    rng = np.random.RandomState(seed)

    def fill(path, s):
        a = rng.randn(*s.shape).astype(np.float32)
        name = path[-1].key
        if name == "kernel":
            return 0.3 * a
        return 1.0 + 0.1 * a if name == "norm_scale" else 0.1 * a
    return jax.tree_util.tree_map_with_path(fill, shapes)["params"]


def _batch(seed, shape, n_out, K):
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape).astype(np.float32)
    seg = rng.randint(0, K, size=shape[:4]).astype(np.int32)
    targets = [seg[:, ::f, ::f, ::f] for f in (1, 2, 4, 8)[:n_out]]
    return x, targets


def _flat_port(tree):
    """{port name: numpy} of a reference tree in the port's layouts."""
    return {k: v.numpy() for k, v in from_jax_params(
        jax.tree_util.tree_map(np.asarray, tree)).items()}


def _port_model(kw, params, dtype):
    net = ShiftUNetPlusPlus(**kw, compute_dtype=dtype, device="cpu")
    net.load_state_dict(from_jax_params(params), strict=True)
    return net


def _setup(density):
    """(reference params, row masks at `density`, data, targets)."""
    params = _params(KW, SHAPE, 0)
    masks = jd.init_masks_row(params, density, jax.random.PRNGKey(1),
                              density_48_override=density)
    x, targets = _batch(1, SHAPE, 3, 3)
    return params, masks, x, targets


def _reference_steps(params, masks, x, targets, **flags):
    """[(momentum, params, loss, grad norm)] after each of the reference's
    steps, in the port's names and layouts. flags: the reference model's
    path (default its XLA path)."""
    jnet = JaxNet(**KW, compute_dtype=jnp.float32, remat=False,
                  quadrant=False, **flags)
    state = jts.create_train_state(params, masks)
    step = jts.make_train_step(jnet, ds_loss_weights(3, 3), donate=False)
    out = []
    for lr in LRS:
        state, m = step(state, jnp.asarray(x),
                        tuple(jnp.asarray(t) for t in targets),
                        jnp.float32(lr))
        out.append((_flat_port(state.momentum), _flat_port(state.params),
                    float(m["loss"]), float(m["grad_norm"])))
    return out


def _port_steps(params, masks, x, targets):
    """(the masked initial parameters, [(momentum, params, loss, grad
    norm)] after each of the port's steps, the final state, the masks)."""
    net = _port_model(KW, params, torch.float32)
    tmasks = {".".join(p): torch.from_numpy(np.array(m))
              for p, m in masks.items()}
    state = tts.create_train_state(net, tmasks)
    p0 = {n: p.detach().numpy().copy() for n, p in state.params.items()}
    step = tts.make_train_step(net, ds_loss_weights(3, 3))
    tx = torch.from_numpy(x)
    tt = [torch.from_numpy(t).long() for t in targets]
    out = []
    for lr in LRS:
        state, m = step(state, tx, tt, lr)
        out.append(({n: b.numpy().copy() for n, b in state.momentum.items()},
                    {n: p.detach().numpy().copy()
                     for n, p in state.params.items()},
                    float(m["loss"]), float(m["grad_norm"])))
    return p0, out, state, tmasks


def _bias_ahead_of_norm(name):
    return name.endswith(".bias") and not name.endswith(".norm_bias")


def _assert_leaves(got, want, rtol, what, names, atol=None):
    for n in names:
        err = np.linalg.norm(got[n] - want[n])
        ref = np.linalg.norm(want[n])
        slack = 0.0 if atol is None else atol[n]
        assert err <= rtol * ref + slack, (
            f"{what}, {n}: |diff| {err:.3e} > {rtol} x |ref| {ref:.3e} "
            f"+ {slack:.3e}")


def _assert_two_steps(got, want, p0, step2_rtol, grad_rtol=GRAD_RTOL):
    """got's two steps held to want's, leaf by leaf (module docstring)."""
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g[2], w[2], rtol=1e-5,
                                   err_msg=f"loss, step {i + 1}")
        np.testing.assert_allclose(g[3], w[3], rtol=1e-4,
                                   err_msg=f"grad norm, step {i + 1}")
    assert want[0][3] < tts.GRAD_CLIP_NORM     # step 1 unclipped
    biases = [n for n in p0 if _bias_ahead_of_norm(n)]
    others = [n for n in p0 if n not in biases]
    wd, mom = tts.WEIGHT_DECAY, tts.MOMENTUM
    grads = [{n: s[0][0][n] - wd * p0[n] for n in p0} for s in (got, want)]
    _assert_leaves(*grads, grad_rtol, "step-1 gradient", others)
    # a bias's gradient of either step (step 2's: its momentum less the
    # decayed step-1 momentum and the weight decay) is rounding
    grads2 = [{n: s[1][0][n] - mom * s[0][0][n] - wd * s[0][1][n]
               for n in biases} for s in (got, want)]
    for n in biases:
        kernel = n.replace(".bias", ".kernel")
        for g in grads + grads2:
            assert np.linalg.norm(g[n]) <= BIAS_ZERO * np.linalg.norm(
                grads[1][kernel]), n
    _assert_leaves(got[1][0], want[1][0], step2_rtol,
                   "momentum after step 2", others)
    # the parameters after step 2, held to the change over the two steps;
    # each side rounds the parameters twice, so two float32 spacings of
    # slack per value
    changes = [{n: s[1][1][n] - p0[n] for n in p0} for s in (got, want)]
    ulps = {n: 2.0 * np.linalg.norm(np.spacing(np.abs(want[1][1][n])))
            for n in p0}
    _assert_leaves(*changes, step2_rtol, "parameter change over two steps",
                   others, ulps)


def _assert_masks_kept(state, masks):
    for n, mk in masks.items():
        dead = broadcast_mask(1.0 - mk, state.params[n])
        assert float((state.params[n].detach() * dead).abs().max()) == 0.0
        assert float((state.momentum[n] * dead).abs().max()) == 0.0


def test_two_steps_match_reference_float32():
    """Row masks at density 0.5, against the reference's XLA path."""
    params, masks, x, targets = _setup(0.5)
    want = _reference_steps(params, masks, x, targets)
    p0, got, state, tmasks = _port_steps(params, masks, x, targets)
    _assert_two_steps(got, want, p0, MASKED_STEP2_RTOL)
    assert state.step == 2
    _assert_masks_kept(state, tmasks)


def test_two_steps_match_reference_float32_dense():
    """No dead rows (density 1), against the reference's XLA path: every
    leaf within 3e-4 over both steps."""
    params, masks, x, targets = _setup(1.0)
    want = _reference_steps(params, masks, x, targets)
    p0, got, state, _ = _port_steps(params, masks, x, targets)
    _assert_two_steps(got, want, p0, DENSE_STEP2_RTOL)
    assert state.step == 2


def test_kernel_chain_matches_reference_kernels_bf16():
    """One bf16 case against the reference's kernels in interpret mode: the
    level-0 -> 1 chain of a train step (a block from the input, a block
    with the pending norm, the block-max down-link, a level-1 block) and
    its gradients through the reference's Pallas backward kernels (#4 as
    the level-0 blocks take it, #8, and the level-1 block's #2 function on
    the same machinery with a (1, 1, 1) quadrant). (The whole bf16 model
    cannot run here: XLA:CPU executes no bf16 x bf16 -> f32 dot outside
    the kernels.) Every gradient within 1e-3 of its norm in L2: both round
    activations and cotangents to bf16 at the same points and sum exact
    bf16 products in float32, so the weights' bf16 gradients come out
    equal and the norms' float32 ones within ~1e-5."""
    from e2enet_tpu.ops.qfused import (from_quadrant_cf, quadrant_block_max_cf,
                                       quadrant_fused_block,
                                       quadrant_norm_affine, to_quadrant_cf)
    from e2enet_tpu_torch.ops import fused_block as tfb
    from e2enet_tpu_torch.ops import qlink as tql
    Q, HQ, WQ, WQP = (2, 2, 2), 4, 5, 32
    N, C0, C1, C2 = 2, 8, 8, 8
    D, H, W = 4, 2 * HQ, 2 * WQ
    rng = np.random.RandomState(11)
    x = np.asarray(jnp.asarray(rng.randn(N, D, H, W, 1), jnp.bfloat16),
                   np.float32)

    def r(*s, scale=0.3, shift=0.0):
        return (rng.randn(*s) * scale + shift).astype(np.float32)
    # port layouts: conv (CO, C, 3, 3)
    args = [r(C0, 1, 3, 3), r(C0, scale=0.1), r(C0, scale=0.1, shift=1.0),
            r(C0, scale=0.1), r(C1, C0, 3, 3), r(C1, scale=0.1),
            r(C1, scale=0.1, shift=1.0), r(C1, scale=0.1), r(C2, C1, 3, 3),
            r(C2, scale=0.1)]
    gy = r(N, D // 2, H // 2, W // 2, C2, scale=1.0)
    gst = r(N, C2, 2, scale=1e-3)
    bfd = jnp.bfloat16
    n0 = D * H * W

    def jchain(w0, b0, s0, nb0, w1, b1, s1, nb1, w2, b2):
        hw = lambda k: jnp.transpose(k, (2, 3, 1, 0)).astype(bfd)  # noqa
        xq = to_quadrant_cf(jnp.asarray(x, bfd), Q, WQP)
        r0, st0 = quadrant_fused_block([xq], hw(w0), b0.astype(bfd), [None],
                                       Q, HQ, WQ, interpret=True)
        m0, o0 = quadrant_norm_affine(st0, 8, n0, s0, nb0)
        r1, st1 = quadrant_fused_block([r0], hw(w1), b1.astype(bfd),
                                       [(m0, o0)], Q, HQ, WQ, interpret=True)
        m1, o1 = quadrant_norm_affine(st1, 8, n0, s1, nb1)
        down = quadrant_block_max_cf(r1, m1, o1, Q, HQ, WQ, C1, WQP,
                                     interpret=True)
        y2, st2 = quadrant_fused_block([down], hw(w2), b2.astype(bfd),
                                       [None], (1, 1, 1), HQ, WQ,
                                       interpret=True)
        y = from_quadrant_cf(y2, (1, 1, 1), HQ, WQ, C2).astype(jnp.float32)
        return jnp.sum(y * gy) + jnp.sum(st2 * gst)

    want = jax.grad(jchain, argnums=tuple(range(10)))(
        *[jnp.asarray(a) for a in args])

    t = [torch.from_numpy(a).requires_grad_() for a in args]
    w0, b0, s0, nb0, w1, b1, s1, nb1, w2, b2 = t
    bf = torch.bfloat16
    before = (tfb.fused_shift_conv_block_bwd.launches,
              tql.downlink_bwd.launches)
    r0, st0 = tfb.fused_shift_conv_block([torch.from_numpy(x).to(bf)],
                                         w0.to(bf), b0.to(bf), [None])
    a0 = tfb.norm_affine_from_stats(st0, n0, s0, nb0)
    r1, st1 = tfb.fused_shift_conv_block([r0], w1.to(bf), b1.to(bf), [a0])
    m1, o1 = tfb.norm_affine_from_stats(st1, n0, s1, nb1)
    down = tql.downlink(r1, m1, o1)
    y2, st2 = tfb.fused_shift_conv_block([down], w2.to(bf), b2.to(bf),
                                         [None])
    loss = (y2.float() * torch.from_numpy(gy)).sum() + (
        st2 * torch.from_numpy(gst)).sum()
    got = torch.autograd.grad(loss, t)
    assert (tfb.fused_shift_conv_block_bwd.launches,
            tql.downlink_bwd.launches) == before       # plain versions here
    for g, w in zip(got, want):
        g, w = g.numpy(), np.asarray(w, np.float32)
        assert np.linalg.norm(g - w) <= 1e-3 * np.linalg.norm(w)


def test_sparse_plan_refuses_a_gradient():
    """Training is dense-masked: with the row-sparse plan attached the
    model (and its derived, gathered weights) refuse a gradient, serve
    without one, and train again once the plan is detached."""
    from e2enet_tpu_torch.models.masks import apply_masks
    from e2enet_tpu_torch.models.sparse_plan import build_sparse_plan
    from e2enet_tpu_torch.training.dsff import init_masks_row
    net = ShiftUNetPlusPlus(**KW, compute_dtype=torch.float32, device="cpu")
    net.reset_parameters(seed=5)
    masks = init_masks_row(net, 0.5, torch.Generator().manual_seed(6),
                           density_48_override=0.5)
    apply_masks(net, masks)
    net.set_sparse_plan(build_sparse_plan({k: m.numpy()
                                           for k, m in masks.items()}))
    x = torch.from_numpy(np.random.RandomState(7).randn(1, 16, 16, 16, 1)
                         .astype(np.float32))
    with pytest.raises(RuntimeError):
        net(x, do_ds=True)
    with pytest.raises(RuntimeError):
        net.loc0_0.block0.weights()
    with torch.no_grad():
        sparse = net(x, do_ds=False)
    net.set_sparse_plan(None)
    dense = net(x, do_ds=False)
    assert dense.requires_grad
    torch.testing.assert_close(sparse, dense.detach(), rtol=1e-4, atol=1e-4)
