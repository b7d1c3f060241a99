"""The port's ShiftUNetPlusPlus against the reference model on the same
numpy weights, float32 (reference at HIGHEST precision): the dense XLA
path with do_ds True and False, every mirror combination of the probs
head, and one forward of the quadrant kernel path in interpret mode.
Logits within 1e-3; bf16 probs within one bf16 step plus 1e-3. Also checks
that port and reference route the same number of blocks through the fused
block ops, and which heads a forward computes."""
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import e2enet_tpu.ops.fused_block as jfb  # noqa: E402
import e2enet_tpu.ops.qfused as jqf  # noqa: E402
import e2enet_tpu_torch.models.unetpp as tunetpp  # noqa: E402
import e2enet_tpu_torch.ops.blocks as tblocks  # noqa: E402
import e2enet_tpu_torch.ops.fused_block as tfb  # noqa: E402
from e2enet_tpu.models.unetpp import ShiftUNetPlusPlus as JaxNet  # noqa: E402
from e2enet_tpu_torch.models.weights import from_jax_params  # noqa: E402

KW = dict(input_channels=1, num_classes=3,
          pool_op_kernel_sizes=((2, 2, 2),) * 3, base_num_features=4)
SHAPE = (1, 16, 16, 16, 1)


def numpy_params(seed=0, kw=KW, shape=SHAPE):
    """Reference param tree filled from numpy: kernels ~0.3 N(0,1), biases
    and norm offsets ~0.1 N(0,1), norm scales ~1 + 0.1 N(0,1)."""
    net = JaxNet(**kw, compute_dtype=jnp.float32, remat=False,
                 quadrant=False)
    shapes = jax.eval_shape(net.init, jax.random.PRNGKey(0),
                            jnp.zeros(shape, jnp.float32))
    rng = np.random.RandomState(seed)

    def fill(path, s):
        name = path[-1].key
        a = rng.randn(*s.shape).astype(np.float32)
        if name == "kernel":
            return 0.3 * a
        if name == "norm_scale":
            return 1.0 + 0.1 * a
        return 0.1 * a

    return jax.tree_util.tree_map_with_path(fill, shapes)


def test_forward_matches_reference(monkeypatch):
    params = numpy_params()
    x = np.random.RandomState(1).randn(*SHAPE).astype(np.float32)

    jcalls = [0]

    def counted(real):
        def count_jax(*a, **k):
            jcalls[0] += 1
            return real(*a, **k)
        return count_jax

    # the reference's fused routing, counted while tracing its quadrant
    # path: level 0 through the quadrant fused block, level 1 (context1's
    # second block, the nest) through the fused block
    monkeypatch.setattr(jfb, "fused_shift_conv_block",
                        counted(jfb.fused_shift_conv_block))
    monkeypatch.setattr(jqf, "quadrant_fused_block",
                        counted(jqf.quadrant_fused_block))
    jnet_fused = JaxNet(**KW, compute_dtype=jnp.float32, remat=False,
                        quadrant=True, fused=True, fused_interpret=True)
    jax.eval_shape(lambda p, v: jnet_fused.apply(p, v, do_ds=True), params,
                   jnp.asarray(x))
    jax_calls = jcalls[0]
    # values from the XLA path, which the reference's own suite holds equal
    # to the fused path (an interpret-mode run would triple the time)
    jnet = JaxNet(**KW, compute_dtype=jnp.float32, remat=False,
                  quadrant=False)
    ref_ds = [np.asarray(o) for o in jnet.apply(params, jnp.asarray(x),
                                                do_ds=True)]
    ref_top = np.asarray(jnet.apply(params, jnp.asarray(x), do_ds=False))

    net = tunetpp.ShiftUNetPlusPlus(**KW, compute_dtype=torch.float32,
                                    device="cpu")
    net.load_state_dict(from_jax_params(params), strict=True)
    tcalls = [0]
    treal = tblocks.fused_shift_conv_block

    def count_torch(*a, **k):
        tcalls[0] += 1
        return treal(*a, **k)

    monkeypatch.setattr(tblocks, "fused_shift_conv_block", count_torch)
    with torch.no_grad():
        out_ds = net(torch.from_numpy(x), do_ds=True)
        torch_calls = tcalls[0]
        out_top = net(torch.from_numpy(x), do_ds=False)

    assert len(out_ds) == len(ref_ds) == 3
    for a, b in zip(out_ds, ref_ds):
        assert tuple(a.shape) == b.shape and a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(out_top.numpy(), ref_top, rtol=1e-3,
                               atol=1e-3)
    # context0 (2) + context1's second block (1) + level-0 nest 3 + final
    # (4) + level-1 nest 2 + final (3)
    assert torch_calls == jax_calls == \
        tunetpp.fused_launches_per_forward(net) == 10


def test_plain_path_equals_kernel_path_on_cpu(monkeypatch):
    """Swapping the plain version in for the fused op (as the card's smoke
    run does for its comparison path) changes nothing on the CPU, where the
    wrapper already runs it."""
    net = tunetpp.ShiftUNetPlusPlus(**KW, compute_dtype=torch.float32,
                                    device="cpu")
    net.reset_parameters(seed=3)
    x = torch.from_numpy(np.random.RandomState(2).randn(*SHAPE).astype(
        np.float32))
    with torch.no_grad():
        a = net(x, do_ds=False)
        with tblocks.plain_ops():
            assert tblocks.fused_shift_conv_block is \
                tfb.fused_shift_conv_block_ref
            b = net(x, do_ds=False)
        monkeypatch.setattr(tblocks, "fused_shift_conv_block",
                            tfb.fused_shift_conv_block_ref)
        c = net(x, do_ds=False)
    assert torch.equal(a, b) and torch.equal(a, c)
    assert tblocks.strided_fused is tblocks.KERNEL_OPS["strided_fused"][0]


def test_bench_geometry_launch_count():
    """5 pools, fused levels 0-1: 14 fused blocks, one strided transition,
    5 up-links, 4 down-links and one seg head per forward on the
    materialised route (float32, or lazy_up=False); in bfloat16 the five
    level-0 nest nodes take the lazy up-link block instead of an up-link and
    a fused block."""
    net = tunetpp.ShiftUNetPlusPlus(
        1, 16, ((2, 2, 2),) * 5, base_num_features=2,
        compute_dtype=torch.float32, device="cpu")
    assert tunetpp.fused_launches_per_forward(net) == 14
    assert tunetpp.kernel_launches_per_forward(net) == {
        "fused_shift_conv_block": 14, "lazy_up_fused_block": 0,
        "strided_fused": 1, "uplink": 5, "downlink": 4, "seghead": 1}
    net16 = tunetpp.ShiftUNetPlusPlus(
        1, 16, ((2, 2, 2),) * 5, base_num_features=2, device="cpu")
    assert tunetpp.kernel_launches_per_forward(net16) == {
        "fused_shift_conv_block": 9, "lazy_up_fused_block": 5,
        "strided_fused": 1, "uplink": 0, "downlink": 4, "seghead": 1}
    net16.lazy_up = False
    assert tunetpp.kernel_launches_per_forward(net16) == \
        tunetpp.kernel_launches_per_forward(net)


def test_kernel_sites_counted_per_forward(monkeypatch):
    """Each kernel site is reached as often as kernel_launches_per_forward
    says, with do_ds False and True."""
    net = tunetpp.ShiftUNetPlusPlus(**KW, compute_dtype=torch.float32,
                                    device="cpu")
    net.reset_parameters(seed=4)
    calls = {}
    for name in tblocks.KERNEL_OPS:
        real = getattr(tblocks, name)

        def count(*a, _name=name, _real=real, **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _real(*a, **k)
        monkeypatch.setattr(tblocks, name, count)
    x = torch.zeros(SHAPE)
    for do_ds in (False, True):
        calls.clear()
        with torch.no_grad():
            net(x, do_ds=do_ds)
        want = tunetpp.kernel_launches_per_forward(net, do_ds)
        assert calls == {k: v for k, v in want.items() if v}, do_ds


def test_only_returned_heads_are_computed(monkeypatch):
    """do_ds=False computes head 0 only, and returns what do_ds=True
    returns first."""
    net = tunetpp.ShiftUNetPlusPlus(**KW, compute_dtype=torch.float32,
                                    device="cpu")
    net.reset_parameters(seed=5)
    x = torch.from_numpy(np.random.RandomState(3).randn(*SHAPE).astype(
        np.float32))
    called = []
    for i in range(net.num_ds_outputs()):
        head = getattr(net, f"seg_head{i}")
        for meth in ("forward", "forward_pending"):
            real = getattr(head, meth)

            def spy(*a, _i=i, _real=real, **k):
                called.append(_i)
                return _real(*a, **k)
            monkeypatch.setattr(head, meth, spy)
    with torch.no_grad():
        top = net(x, do_ds=False)
        assert called == [0]
        ds = net(x, do_ds=True)
    assert sorted(called) == [0, 0, 1, 2]
    assert torch.equal(top, ds[0])


KW2 = dict(input_channels=1, num_classes=3,
           pool_op_kernel_sizes=((2, 2, 2),) * 2, base_num_features=4)
SHAPE2 = (1, 8, 8, 16, 1)


def test_probs_slice_matches_reference_all_flips():
    """do_ds=False with the bf16 probs head, every mirror combination,
    against the reference's XLA path with the same flips, softmaxed."""
    params = numpy_params(7, KW2, SHAPE2)
    x = np.random.RandomState(8).randn(*SHAPE2).astype(np.float32)
    jnet = JaxNet(**KW2, compute_dtype=jnp.float32, remat=False,
                  quadrant=False)
    net = tunetpp.ShiftUNetPlusPlus(**KW2, compute_dtype=torch.float32,
                                    head_probs_dtype=torch.bfloat16,
                                    device="cpu")
    net.load_state_dict(from_jax_params(params), strict=True)
    for c in itertools.product([False, True], repeat=3):
        logits = jax.jit(lambda p, v, _n=jnet.clone(flips=c): _n.apply(
            p, v, do_ds=False))(params, jnp.asarray(x))
        ref = np.asarray(jax.nn.softmax(logits, axis=-1))
        with torch.no_grad():
            p = net(torch.from_numpy(x), do_ds=False, flips=c)
        assert p.dtype == torch.bfloat16
        np.testing.assert_allclose(p.float().numpy(), ref, rtol=0,
                                   atol=2 ** -8 + 1e-3, err_msg=f"flips={c}")


def test_one_forward_matches_quadrant_kernel_path():
    """One mirrored forward against the reference's quadrant kernels in
    interpret mode (quadrant_logits: the logits come back in the quadrant
    layout)."""
    flips = (True, False, True)
    jkw = dict(KW2, compute_dtype=jnp.float32, remat=False, fused=True,
               fused_interpret=True, quadrant=True, quadrant_logits=True)
    jnet = JaxNet(**jkw, flips=flips)
    params = numpy_params(9, KW2, SHAPE2)
    x = np.random.RandomState(10).randn(*SHAPE2).astype(np.float32)
    lq = jnet.apply(params, jnp.asarray(x), do_ds=False)
    assert lq.ndim == 4
    _, D, H, W, _ = SHAPE2
    ref = np.asarray(jqf.from_quadrant_cf(lq, (2, 2, 2), H // 2, W // 2, 3))
    net = tunetpp.ShiftUNetPlusPlus(**KW2, compute_dtype=torch.float32,
                                    device="cpu")
    net.load_state_dict(from_jax_params(params), strict=True)
    with torch.no_grad():
        out = net(torch.from_numpy(x), do_ds=False, flips=flips)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-3, atol=1e-3)


def test_device_is_explicit_and_input_checked():
    with pytest.raises(ValueError):
        tunetpp.ShiftUNetPlusPlus(**KW)
    net = tunetpp.ShiftUNetPlusPlus(**KW, compute_dtype=torch.float32,
                                    device="cpu")
    with pytest.raises(ValueError):
        net(torch.zeros(1, 12, 16, 16, 1))


def _stage(plans_mod, pools, patch):
    return plans_mod.StagePlan(
        batch_size=2, num_pool_per_axis=[2, 2, 2], patch_size=list(patch),
        median_patient_size_in_voxels=[64, 64, 64],
        current_spacing=[1.0, 1.0, 1.0], original_spacing=[1.0, 1.0, 1.0],
        do_dummy_2D_data_aug=False,
        pool_op_kernel_sizes=[list(p) for p in pools],
        conv_kernel_sizes=[[1, 3, 3]] * (len(pools) + 1))


@pytest.mark.parametrize("pools,patch,lazy,tconv", [
    (((2, 2, 2), (2, 2, 2)), (32, 32, 32), True, "shiftConvPP"),
    (((1, 2, 2), (2, 2, 2)), (16, 32, 32), False, "shiftConvPP"),
    # a 2D plan builds shiftConvPP_noshift, on the materialised route
    (((1, 2, 2), (1, 2, 2)), (1, 32, 32), False, "shiftConvPP"),
    (((2, 2, 2), (2, 2, 2)), (32, 32, 32), True, "shiftConvPP_noshift")],
    ids=["pools0-patch0-True", "pools1-patch1-False", "2d_plan",
         "noshift"])
def test_build_network_matches_reference(pools, patch, lazy, tconv):
    """models/unetpp.build_network on a plan's stage: the reference's
    parameter names and shapes through from_jax_params, its divisibility,
    whether it shifts, and the up-link route the pools allow (a first
    pool of (1, 2, 2) takes the materialised route)."""
    import e2enet_tpu.plans as jplans
    import e2enet_tpu_torch.plans as tplans
    from e2enet_tpu.models.unetpp import build_network as jbuild
    jnet = jbuild(_stage(jplans, pools, patch), 2, 4, tconv=tconv,
                  base_num_features=8, compute_dtype=jnp.float32)
    shapes = jax.eval_shape(jnet.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, *patch, 2)))["params"]
    want = from_jax_params(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes))
    net = tunetpp.build_network(_stage(tplans, pools, patch), 2, 4,
                                tconv=tconv, base_num_features=8,
                                device="cpu")
    got = net.state_dict()
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
    net.load_state_dict(want, strict=True)
    assert net.compute_dtype == torch.bfloat16 and net.pools == list(pools)
    assert net.do_shift == jnet.do_shift
    np.testing.assert_array_equal(net.input_shape_must_be_divisible_by,
                                  jnet.input_shape_must_be_divisible_by)
    assert net.lazy_up_route() == lazy
    with pytest.raises(ValueError, match="divisible"):
        net(torch.zeros(1, patch[0], patch[1], patch[2] + 2, 2))


def test_build_network_refuses_what_is_not_ported():
    """Every Tconv of the reference's factory builds (Queue 1 item 6, once
    refused, is ported), each the reference's class; what the reference
    refuses the port refuses: an unknown name, a switch the network has no
    field for, no device."""
    import e2enet_tpu_torch.plans as tplans
    from e2enet_tpu.models.unetpp import build_network as jbuild
    stage = _stage(tplans, ((2, 2, 2),) * 2, (32, 32, 32))
    flat = _stage(tplans, ((1, 2, 2),) * 2, (1, 32, 32))
    for st, tconv in [(stage, t) for t in tunetpp.TCONVS] + [(flat, "ori")]:
        net = tunetpp.build_network(st, 1, 3, tconv=tconv, device="cpu")
        want = jbuild(st, 1, 3, tconv=tconv, fused=False)
        assert type(net).__name__ == type(want).__name__, tconv
        assert net.kernel_route() == (tconv in ("shiftConvPP",
                                                "shiftConvPP_noshift")), tconv
    # 2D ori: no shift, max_num_features 480 (the reference's 2D rule)
    assert net.context0.block0.shifting is False
    for tconv, kw in (("ori", dict(conv_kernel=(3, 3, 3))),
                      ("resenc", dict(num_conv_per_stage=3))):
        with pytest.raises(TypeError):
            jbuild(stage, 1, 3, tconv=tconv, fused=False, **kw)
        with pytest.raises(TypeError):
            tunetpp.build_network(stage, 1, 3, tconv=tconv, device="cpu",
                                  **kw)
    with pytest.raises(KeyError):
        tunetpp.build_network(stage, 1, 3, tconv="unet9", device="cpu")
    with pytest.raises(ValueError, match="device"):
        tunetpp.build_network(stage, 1, 3)
