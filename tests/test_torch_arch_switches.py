"""The architecture switches of the port's ShiftUNetPlusPlus
(e2enet_tpu_torch/models/unetpp.py, ops/blocks.py) against the JAX
package's network on its XLA path, float32 on the CPU (JAX at HIGHEST,
TF32 off), the same weights crossing over with models/weights.
from_jax_params (random, from a numpy seed, so no bias or norm parameter
is trivial):

- every norm (instance, batch, group, frn, none) and every nonlinearity
  (lrelu, relu, gelu, mish, none, lrelu2e1), and the presets' pairs:
  each deep-supervision output within 1e-4 of the reference's (relative
  to its largest magnitude);
- nonlin_before_norm, num_conv_per_stage 3 (base 24 on the kernel route),
  seg_bias, allConv3x3 (3,3,3), shiftConvPP_313 / _331, each output
  within 1e-4 (the full 3D kernels 2e-4, as tests/test_resenc.py allows);
- one step's float32 gradients of BN + ReLU, nonlin_before_norm and
  allConv3x3 within 1e-4 of the reference's, relative per leaf (a conv
  bias ahead of a mean-removing norm, whose gradient is zero, within
  1e-5 of its kernel's gradient on both sides);
- _313 / _331 flip-free (mirrored operators) equal to the data-flip
  forward within 1e-4 for every flip combination; a full 3D kernel has
  no mirrored operator and refuses flips;
- the route set by the architecture: off the kernel route no kernel site
  is called (kernel_launches_per_forward all 0), on it (3 convs per stage,
  seg_bias) each site as many times as kernel_launches_per_forward says;
  a seg head with a bias refuses the probs head and the model returns
  logits there, as the reference's does.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import e2enet_tpu.plans as jplans  # noqa: E402
import e2enet_tpu_torch.ops.blocks as tblocks  # noqa: E402
import e2enet_tpu_torch.plans as tplans  # noqa: E402
from e2enet_tpu.models.unetpp import build_network as jbuild  # noqa: E402
from e2enet_tpu_torch.models.unetpp import (  # noqa: E402
    build_network as tbuild, kernel_launches_per_forward)
from e2enet_tpu_torch.models.weights import (from_jax_params,  # noqa: E402
                                             to_jax_params)
from e2enet_tpu_torch.ops.sliding import flip_combinations  # noqa: E402

POOLS = ((2, 2, 2), (2, 2, 2))
PATCH = (8, 8, 8)
TOL = 1e-4
TOL_3D = 2e-4
BIAS_ZERO = 1e-5     # |bias gradient| / |kernel gradient|, a zero


@pytest.fixture(scope="module", autouse=True)
def exact_float32():
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32 = tf32


def _stage(plans_mod, pools, patch):
    return plans_mod.StagePlan(
        batch_size=2, num_pool_per_axis=[2, 2, 2], patch_size=list(patch),
        median_patient_size_in_voxels=[64, 64, 64],
        current_spacing=[1.0, 1.0, 1.0], original_spacing=[1.0, 1.0, 1.0],
        do_dummy_2D_data_aug=False,
        pool_op_kernel_sizes=[list(p) for p in pools],
        conv_kernel_sizes=[[1, 3, 3]] * (len(pools) + 1))


def _random_params(shapes, seed):
    """He-scaled kernels, scales near 1 and small biases, from a numpy
    seed, in the reference's tree."""
    rng = np.random.RandomState(seed)

    def draw(path, s):
        name = str(path[-1].key)
        if len(s.shape) >= 2:
            std = np.sqrt(2.0 / np.prod(s.shape[:-1]))
            return (std * rng.standard_normal(s.shape)).astype(np.float32)
        base = 1.0 if "scale" in name else 0.0
        return (base + 0.1 * rng.standard_normal(s.shape)).astype(
            np.float32)
    return jax.tree_util.tree_map_with_path(draw, shapes)


def pair(tconv="shiftConvPP", pools=POOLS, patch=PATCH, base=4, seed=0,
         **switches):
    """(JAX network, its params, the port's network with the same weights,
    input x (1, *patch, 2) float32 numpy)."""
    jnet = jbuild(_stage(jplans, pools, patch), 2, 3, tconv=tconv,
                  base_num_features=base, compute_dtype=jnp.float32,
                  fused=False, remat=False, **switches)
    x = np.random.RandomState(seed).standard_normal(
        (1, *patch, 2)).astype(np.float32)
    shapes = jax.eval_shape(jnet.init, jax.random.PRNGKey(0),
                            jnp.asarray(x))["params"]
    params = _random_params(shapes, seed + 1)
    tnet = tbuild(_stage(tplans, pools, patch), 2, 3, tconv=tconv,
                  base_num_features=base, compute_dtype=torch.float32,
                  device="cpu", **switches)
    sd = from_jax_params(params)
    tnet.load_state_dict(sd, strict=True)
    back = to_jax_params(sd)
    for (p, a), (q, b) in zip(
            jax.tree_util.tree_flatten_with_path(params)[0],
            jax.tree_util.tree_flatten_with_path(back)[0]):
        assert p == q
        np.testing.assert_array_equal(a, b)
    return jnet, params, tnet, x


def assert_close(got, want, tol, what=""):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    scale = float(np.max(np.abs(want))) or 1.0
    err = float(np.max(np.abs(got - want)))
    assert err <= tol * scale, (what, err, scale)


def check_forward(tconv="shiftConvPP", tol=TOL, **kw):
    jnet, params, tnet, x = pair(tconv, **kw)
    want = jax.jit(lambda p, x: jnet.apply({"params": p}, x, do_ds=True))(
        params, jnp.asarray(x))
    with torch.no_grad():
        got = tnet(torch.from_numpy(x), do_ds=True)
        single = tnet(torch.from_numpy(x), do_ds=False)
    assert len(got) == len(want) == tnet.num_ds_outputs()
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape and g.dtype == torch.float32
        assert_close(g, w, tol, f"output {i}")
    torch.testing.assert_close(single, got[0], rtol=0, atol=0)
    return tnet


NORMS = ("instance", "batch", "group", "frn", "none")
NONLINS = ("lrelu", "relu", "gelu", "mish", "none", "lrelu2e1")
PAIRS = ([(n, "lrelu") for n in NORMS]
         + [("instance", a) for a in NONLINS[1:]]
         + [("batch", "relu"), ("group", "gelu"), ("none", "mish"),
            ("frn", "relu")])


@pytest.mark.parametrize("norm_op, nonlin", PAIRS)
def test_norm_nonlin_matches_reference(norm_op, nonlin):
    net = check_forward(norm_op=norm_op, nonlin=nonlin)
    assert net.kernel_route() == (norm_op == "instance"
                                  and nonlin == "lrelu")
    assert hasattr(net.context0.block0, "frn_tau") == (norm_op == "frn")


@pytest.mark.parametrize("kw, tol", [
    (dict(nonlin_before_norm=True), TOL),
    (dict(nonlin="relu", nonlin_before_norm=True), TOL),
    (dict(norm_op="frn", nonlin_before_norm=True), TOL),
    (dict(num_conv_per_stage=3, base=24), TOL),
    (dict(seg_bias=True), TOL),
    (dict(num_conv_per_stage=3, seg_bias=True, nonlin="relu"), TOL),
    (dict(conv_kernel=(3, 3, 3)), TOL_3D),
    (dict(tconv="shiftConvPP_313"), TOL),
    (dict(tconv="shiftConvPP_331"), TOL),
    (dict(tconv="shiftConvPP_313", pools=((1, 2, 2), (2, 2, 2)),
          patch=(4, 8, 8)), TOL),
    (dict(tconv="shiftConvPP_noshift", norm_op="group"), TOL)],
    ids=["nbn", "relu_nbn", "frn_nbn", "3conv_base24", "seg_bias",
         "3conv_seg_bias_relu", "allConv3x3", "313", "331", "313_anis",
         "noshift_gn"])
def test_block_switches_match_reference(kw, tol):
    kw = dict(kw)
    net = check_forward(tol=tol, **kw)
    kernel = net.context0.block0.kernel
    full3d = kw.get("conv_kernel") == (3, 3, 3)
    assert kernel.dim() == (5 if full3d else 4)
    assert net.mirrored_operators() == (not full3d)
    if "seg_bias" in kw:
        assert net.seg_head0.bias.shape == (3,)


def _grad_check(tconv="shiftConvPP", tol=TOL, **kw):
    jnet, params, tnet, x = pair(tconv, **kw)
    rng = np.random.RandomState(7)
    n_out = tnet.num_ds_outputs()
    shapes = [(1, *[s // 2 ** i for s in PATCH], 3) for i in range(n_out)]
    ws = [rng.standard_normal(s).astype(np.float32) for s in shapes]

    def jloss(p):
        outs = jnet.apply({"params": p}, jnp.asarray(x), do_ds=True)
        return sum(jnp.sum(o * w) for o, w in zip(outs, ws))
    want = jax.jit(jax.grad(jloss))(params)
    outs = tnet(torch.from_numpy(x), do_ds=True)
    loss = sum((o * torch.from_numpy(w)).sum() for o, w in zip(outs, ws))
    names = [n for n, _ in tnet.named_parameters()]
    got = torch.autograd.grad(loss, [p for _, p in tnet.named_parameters()],
                              allow_unused=True)
    got = to_jax_params({n: (g if g is not None else torch.zeros_like(p))
                         for n, g, p in zip(names, got,
                                            tnet.parameters())})
    flat_w = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    flat_g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    # a conv bias ahead of a mean-removing norm has a zero gradient: both
    # sides' rounding noise, held against the block kernel's gradient
    mean_free = (kw.get("norm_op", "instance") in ("instance", "batch",
                                                   "group")
                 and not kw.get("nonlin_before_norm"))
    kernel_of = {"bias": "kernel", "bias1": "conv1", "bias2": "conv2",
                 "initial_bias": "initial_conv"}
    for path, g in flat_g.items():
        head = len(path) > 1 and str(path[-2].key).startswith("seg_head")
        if mean_free and path[-1].key in kernel_of and not head:
            kpath = path[:-1] + (jax.tree_util.DictKey(
                kernel_of[path[-1].key]),)
            ref = np.linalg.norm(flat_w[kpath])
            for side in (g, flat_w[path]):
                assert np.linalg.norm(side) <= BIAS_ZERO * ref, path
            continue
        assert_close(g, flat_w[path], tol, jax.tree_util.keystr(path))


@pytest.mark.parametrize("kw", [
    dict(norm_op="batch", nonlin="relu"), dict(nonlin_before_norm=True),
    dict(conv_kernel=(3, 3, 3))], ids=["bn_relu", "nbn", "allConv3x3"])
def test_gradients_match_reference(kw):
    _grad_check(**kw)


def _flip(a, axes):
    return a.flip([1 + i for i in axes]) if axes else a


@pytest.mark.parametrize("tconv", ["shiftConvPP_313", "shiftConvPP_331"])
def test_flip_free_equals_data_flips(tconv):
    _, _, tnet, x = pair(tconv, pools=((2, 2, 2), (1, 2, 2)),
                         patch=(8, 8, 8))
    xt = torch.from_numpy(x)
    with torch.no_grad():
        for c in flip_combinations((0, 1, 2)):
            f = tuple(a in c for a in range(3))
            mirrored = tnet(xt, do_ds=False, flips=f)
            flipped = _flip(tnet(_flip(xt, c), do_ds=False), c)
            assert_close(mirrored, flipped.numpy(), TOL, str(c))


def test_full_3d_kernel_refuses_flips():
    _, _, tnet, x = pair(conv_kernel=(3, 3, 3))
    assert not tnet.mirrored_operators()
    with pytest.raises(ValueError, match="data-flip"):
        tnet(torch.from_numpy(x), do_ds=False, flips=(True, False, False))


class _Spy:
    def __init__(self):
        self.calls = {}

    def wrap(self, name, fn):
        def f(*a, **k):
            self.calls[name] = self.calls.get(name, 0) + 1
            return fn(*a, **k)
        return f


def _site_calls(net, x, monkeypatch):
    spy = _Spy()
    for name, (_, ref) in tblocks.KERNEL_OPS.items():
        monkeypatch.setattr(tblocks, name, spy.wrap(name, ref))
    with torch.no_grad():
        net(x, do_ds=False)
    return {name: spy.calls.get(name, 0) for name in tblocks.KERNEL_OPS}


@pytest.mark.parametrize("kw", [
    dict(norm_op="batch", nonlin="relu"), dict(norm_op="group"),
    dict(nonlin="mish"), dict(nonlin_before_norm=True),
    dict(conv_kernel=(3, 3, 3)), dict(tconv="shiftConvPP_313"),
    dict(num_conv_per_stage=3, base_num_features=24),
    dict(seg_bias=True), dict()],
    ids=["bn_relu", "gn", "mish", "nbn", "allConv3x3", "313", "3conv",
         "seg_bias", "default"])
def test_route_is_set_by_the_architecture(kw, monkeypatch):
    kw = dict(kw)
    tconv = kw.pop("tconv", "shiftConvPP")
    kernel = tconv == "shiftConvPP" and set(kw) <= {
        "num_conv_per_stage", "seg_bias", "base_num_features"}
    net = tbuild(_stage(tplans, POOLS, (16, 16, 16)), 1, 3, tconv=tconv,
                 compute_dtype=torch.float32, device="cpu",
                 **{"base_num_features": 8, **kw})
    net.reset_parameters(0)
    x = torch.randn(1, 16, 16, 16, 1, generator=torch.Generator()
                    .manual_seed(0))
    calls = _site_calls(net, x, monkeypatch)
    want = kernel_launches_per_forward(net)
    assert calls == want
    assert net.kernel_route() == kernel
    assert (sum(want.values()) > 0) == kernel


def test_seg_bias_has_no_probs_head():
    net = tbuild(_stage(tplans, POOLS, (16, 16, 16)), 1, 3,
                 seg_bias=True, compute_dtype=torch.float32, device="cpu",
                 base_num_features=8)
    net.reset_parameters(0)
    x = torch.zeros(1, 16, 16, 16, 1)
    net.head_probs_dtype = torch.bfloat16
    with torch.no_grad():
        assert net(x, do_ds=False).dtype == torch.float32
        with pytest.raises(ValueError, match="probs"):
            net.seg_head1(torch.zeros(1, 8, 8, 8, 16), torch.bfloat16)


@pytest.mark.parametrize("granularity", ["row", "kernel"])
@pytest.mark.parametrize("tconv, kw", [
    ("shiftConvPP", dict(conv_kernel=(3, 3, 3))), ("ori", {}),
    ("resenc", {}), ("shiftConvPP_331", {})],
    ids=["allConv3x3", "ori", "resenc", "331"])
def test_dsff_update_matches_reference(tconv, kw, granularity):
    """DSFF on every network: the port masks the kernels the JAX trainer
    masks (a `kernel` whose path holds 'loc' or 'up' and not 'context':
    'block' holds 'loc', so ResidualUNet's up{i} and decoder blocks, not
    its encoder's conv1/conv2), and one death-and-growth update (the
    reference's draws fed in) equals the reference's on the same weights;
    allConv3x3's rank-5 conv kernels take the conv layout, not the
    transposed conv's."""
    from e2enet_tpu.training import dsff as jd
    from e2enet_tpu_torch.models.masks import masked_params
    from e2enet_tpu_torch.training import dsff as td
    _, params, tnet, _ = pair(tconv, **kw)
    init = jd.init_masks_row if granularity == "row" else jd.init_masks
    masks = init(params, 0.5, jax.random.PRNGKey(1),
                 density_48_override=0.5)
    params = jd.apply_masks(params, masks)
    tnet.load_state_dict(from_jax_params(jax.tree_util.tree_map(
        np.asarray, params)), strict=True)
    names = {".".join(p) for p in masks}
    assert set(masked_params(tnet)) == names and names
    rng = jax.random.PRNGKey(2)
    want, _ = jd.death_growth_update(params, None, masks, rng,
                                     jnp.float32(0.5), "random", granularity)
    scores, key = {}, rng
    for path in sorted(masks):
        key, sub = jax.random.split(key)
        shape = ((masks[path].shape[0],) if granularity == "row"
                 else masks[path].shape)
        scores[".".join(path)] = torch.from_numpy(np.asarray(
            jax.random.uniform(sub, shape)))
    tmasks = {".".join(p): torch.from_numpy(np.asarray(m))
              for p, m in masks.items()}
    got, _ = td.death_growth_update(tnet, tmasks, 0.5, scores=scores,
                                    granularity=granularity)
    for path, m in want.items():
        np.testing.assert_array_equal(got[".".join(path)].numpy(),
                                      np.asarray(m))
