"""The port's channels-first fused block and relayout probe (#12, their
plain versions, reached through the wrappers with CPU tensors) against the
reference's Pallas kernels of experiments/exp_cf_fused.py in interpret
mode: make_cf_call (`_cf_kernel`), make_cf_call_v2 (`_cf_kernel_v2`) with
each of the affine and the statistics on and off, and try_reshape_hwc.
Also the host side of the TMA route's staging: the boxes (each shift group
cut to slots of at most 16 channels, cf_slots) gathered plainly with TMA's
zero fill, against the wgmma-packed weights (pack_weights_n48, zero-padded
K, unpacked by the packing's index formula), reproduce the plain version
and the reference's kernels.

Importing the reference module sets JAX's persistent compilation cache
options for the whole process (exp_cf_fused.py:35-36); a module-scoped
fixture imports it and puts both options back at once, so the other test
files on the same worker keep the options they had.

Tolerances: y within 2 bf16 steps of each output channel's largest |y| in
bfloat16, within 1e-5 of the largest |y| in float32 (both sum exact
products of the same operands in float32, in another order); the statistics
within 1e-4 of their largest value (float32 sums of those sums).
"""
import functools
import importlib
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

from e2enet_tpu_torch.experiments import exp_cf_fused as tcf  # noqa: E402
from e2enet_tpu_torch.experiments import shift_conv as tsc  # noqa: E402
from e2enet_tpu_torch.ops.shift import group_shifts  # noqa: E402

CACHE_OPTIONS = ("jax_compilation_cache_dir",
                 "jax_persistent_cache_min_compile_time_secs")


@pytest.fixture(scope="module")
def ref_module():
    saved = {k: getattr(jax.config, k) for k in CACHE_OPTIONS}
    try:
        mod = importlib.import_module("experiments.exp_cf_fused")
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
    return mod, saved


@pytest.fixture
def ref(ref_module, monkeypatch):
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    return ref_module[0]


def test_cache_options_restored(ref_module):
    _, saved = ref_module
    assert {k: getattr(jax.config, k) for k in CACHE_OPTIONS} == saved


def _inputs(seed, N, D, H, W, C, CO, jdt):
    rng = np.random.RandomState(seed)
    cast = lambda a: np.array(jnp.asarray(a, jdt), np.float32)  # noqa
    x = cast(rng.randn(N, D, C, H * W))
    k = cast(rng.randn(3, 3, C, CO) * 0.1)
    b = cast(rng.randn(CO) * 0.1)
    mult = (rng.randn(C) * 0.5 + 1.0).astype(np.float32)
    off = (rng.randn(C) * 0.1).astype(np.float32)
    return x, k, b, mult, off


def _assert_y(y, y_ref, dtype):
    y, y_ref = np.asarray(y, np.float32), np.asarray(y_ref, np.float32)
    assert y.shape == y_ref.shape
    if dtype == jnp.float32:
        np.testing.assert_allclose(y, y_ref, rtol=0,
                                   atol=1e-5 * np.abs(y_ref).max())
        return
    # (N, D, CO, HW): channel axis 2
    top = np.maximum(np.abs(y_ref).max(axis=(0, 1, 3)), 2.0 ** -126)
    ulp = 2.0 ** (np.floor(np.log2(top)) - 7)
    assert np.all(np.abs(y - y_ref).max(axis=(0, 1, 3)) <= 2 * ulp)


def _port(x, k, b, H, W, tdt, mult=None, off=None, do_stats=False):
    t = torch.from_numpy
    y, stats = tcf.cf_fused_shift_conv(
        t(x).to(tdt), t(k.transpose(3, 2, 0, 1).copy()), t(b), H, W,
        None if mult is None else t(mult), None if off is None else t(off),
        do_stats)
    assert y.dtype == tdt
    return y.float().numpy(), stats


@pytest.mark.parametrize("jdt,tdt", [(jnp.bfloat16, torch.bfloat16),
                                     (jnp.float32, torch.float32)])
@pytest.mark.parametrize("N,D,H,W,C,CO", [
    (1, 8, 8, 16, 48, 48),            # the reference's E4a shape
    (2, 3, 5, 13, 8, 6),              # D = 3, W = 13
    (1, 4, 4, 8, 3, 5),               # C = 3: shifts -2, -1, 0
])
def test_cf_matches_make_cf_call(ref, jdt, tdt, N, D, H, W, C, CO):
    x, k, b, _, _ = _inputs(N + D + C, N, D, H, W, C, CO, jdt)
    call = ref.make_cf_call(N, D, C, H * W, H, W, CO, jdt)
    y_ref = call(jnp.asarray(x, jdt), jnp.asarray(k, jdt),
                 jnp.asarray(b, jdt))
    y, stats = _port(x, k, b, H, W, tdt)
    assert stats is None
    _assert_y(y, y_ref, jdt)
    assert tcf.cf_fused_shift_conv.launches == 0


@pytest.mark.parametrize("do_affine", [False, True])
@pytest.mark.parametrize("do_stats", [False, True])
@pytest.mark.parametrize("N,D,H,W,C,CO", [(1, 8, 8, 16, 48, 48),
                                          (2, 3, 5, 13, 8, 6)])
def test_cf_matches_make_cf_call_v2(ref, do_affine, do_stats, N, D, H, W,
                                    C, CO):
    bf = jnp.bfloat16
    x, k, b, mult, off = _inputs(1, N, D, H, W, C, CO, bf)
    run = ref.make_cf_call_v2(N, D, C, H * W, H, W, CO, bf,
                              do_affine=do_affine, do_stats=do_stats)
    y_ref, st_ref = run(jnp.asarray(x, bf), jnp.asarray(k, bf),
                        jnp.asarray(b, bf),
                        *((jnp.asarray(mult), jnp.asarray(off))
                          if do_affine else ()))
    y, stats = _port(x, k, b, H, W, torch.bfloat16,
                     *((mult, off) if do_affine else (None, None)), do_stats)
    _assert_y(y, y_ref, bf)
    if do_stats:
        st_ref = np.asarray(st_ref)
        np.testing.assert_allclose(stats.numpy(), st_ref, rtol=0,
                                   atol=1e-4 * np.abs(st_ref).max())
    else:
        assert stats is None


def test_reshape_hwc_matches_probe(ref):
    """E1: the reference's kernel lowers and its result equals the reshape;
    the port's plain version gives that reshape (a copy)."""
    assert ref.try_reshape_hwc() is True
    H, W, C = 8, 16, 48
    x = torch.arange(H * W * C, dtype=torch.float32).reshape(H, W * C)
    y = tcf.reshape_hwc(x, C)
    np.testing.assert_array_equal(
        y.numpy(), np.arange(H * W * C, dtype=np.float32).reshape(H * W, C))
    assert y.data_ptr() != x.data_ptr()
    assert tcf.reshape_hwc.launches == 0


# ------------------------------ the TMA route's boxes and K order, on the host
def _unpack(wpk, C):
    """The packed weights back to (9 taps, 48 output channels, KS * 16 K
    rows), by the index formula of csrc/shift_conv_block.cuh wgmma_b_index
    (KS = ceil(C / 16) steps of 16 channels, N8 = 6 groups of 8 output
    channels)."""
    KS, N8 = -(-C // 16), tsc.N48 // 8
    t, n, k = np.meshgrid(np.arange(9), np.arange(8 * N8),
                          np.arange(16 * KS), indexing="ij")
    idx = (((((t * KS + k // 16) * N8 + n // 8) * 2 + (k % 16) // 8) * 8
            + n % 8) * 8 + k % 8)
    return wpk.float().numpy()[idx]


def _boxes_conv(x, kernel, bias, H, W, mult=None, off=None, do_stats=False):
    """The TMA route's dataflow in plain torch: per slot (cf_slots) and tap
    the box of the slot's channel planes at source depth d - shift, rows
    and columns offset by the tap, zero outside the volume (after the
    affine, rounded to x's dtype as the kernel rounds it), times the
    slot's K rows of the unpacked weights; float32 sums, y rounded to x's
    dtype."""
    N, D, C, _ = x.shape
    CO = kernel.shape[0]
    w_pad = torch.from_numpy(_unpack(tsc.pack_weights_n48(
        kernel.to(x.dtype)), C))
    xa = x.reshape(N, D, C, H, W).float()
    if mult is not None:
        a = xa * mult.reshape(1, 1, C, 1, 1) + off.reshape(1, 1, C, 1, 1)
        xa = torch.maximum(a, a * tcf.LRELU_SLOPE).to(x.dtype).float()
    # index i of a padded axis is source depth i - 2, row i - 1, column
    # i - 1
    xp = torch.nn.functional.pad(xa, (1, 1, 1, 1, 0, 0, 2, 2))
    acc = torch.zeros(N, D, tsc.N48, H, W)
    for (c0, n, sh), dh, dw in itertools.product(tcf.cf_slots(C), range(3),
                                                 range(3)):
        box = xp[:, 2 - sh:2 - sh + D, c0:c0 + n, dh:dh + H, dw:dw + W]
        acc += torch.einsum("ndchw,oc->ndohw", box,
                            w_pad[3 * dh + dw, :, c0:c0 + n])
    acc = acc[:, :, :CO] + bias.to(x.dtype).float().reshape(1, 1, CO, 1, 1)
    stats = (torch.stack([acc.sum(dim=(1, 3, 4)),
                          acc.square().sum(dim=(1, 3, 4))], dim=-1)
             if do_stats else None)
    return acc.to(x.dtype).reshape(N, D, CO, H * W), stats


def test_cf_slots_and_packing():
    """Slots cover every channel once, in the groups' order, at most 16
    each, within one group each; the packing puts weight (co, c, kh, kw)
    at K row c of tap 3 kh + kw and zero past CO and C."""
    for C in (1, 3, 8, 12, 24, 48, 80, 96):
        slots = tcf.cf_slots(C)
        assert [c for c0, n, _ in slots for c in range(c0, c0 + n)] == \
            list(range(C))
        assert all(1 <= n <= 16 for _, n, _ in slots)
        groups = group_shifts(C, tcf.SHIFT_SIZE)
        assert all(any(g0 <= c0 and c0 + n <= g1 and gs == sh
                       for g0, g1, gs in groups) for c0, n, sh in slots)
    rng = np.random.RandomState(0)
    for C, CO in ((48, 40), (20, 48), (1, 5)):
        k = rng.randn(CO, C, 3, 3).astype(np.float32)
        w = _unpack(tsc.pack_weights_n48(torch.from_numpy(k)), C)
        want = np.zeros((9, 48, w.shape[2]), np.float32)
        want[:, :CO, :C] = k.transpose(2, 3, 0, 1).reshape(9, CO, C)
        np.testing.assert_array_equal(w, want)
    with pytest.raises(ValueError):
        tsc.pack_weights_n48(torch.zeros(56, 48, 3, 3))


@pytest.mark.parametrize("N,D,H,W,C,CO", [
    (2, 3, 5, 13, 8, 6),              # W = 13, four groups of 2
    (1, 4, 6, 10, 12, 7),             # C = 12: groups of 3 and 2
    (1, 5, 4, 9, 24, 16),             # C = 24: groups of 5 and 4
])
@pytest.mark.parametrize("v2", [False, True])
def test_tma_boxes_match_plain_and_reference(ref, N, D, H, W, C, CO, v2):
    """The per-slot boxes with zero fill and the packed K order give the
    plain version's y (within 2 bf16 steps of each channel's largest |y|:
    float32 sums of exact products in another order) and statistics (1e-4
    of their largest value), and the reference's make_cf_call (v2: with the
    affine and the statistics, make_cf_call_v2) within the same bounds."""
    bf = jnp.bfloat16
    x, k, b, mult, off = _inputs(7 + C, N, D, H, W, C, CO, bf)
    t = torch.from_numpy
    xt, kt = t(x).to(torch.bfloat16), t(k.transpose(3, 2, 0, 1).copy())
    aff = (t(mult), t(off)) if v2 else (None, None)
    y, st = _boxes_conv(xt, kt, t(b), H, W, *aff, do_stats=v2)
    y_p, st_p = tcf.cf_fused_shift_conv_ref(xt, kt, t(b), H, W, *aff,
                                            do_stats=v2)
    _assert_y(y.float().numpy(), y_p.float().numpy(), bf)
    if v2:
        run = ref.make_cf_call_v2(N, D, C, H * W, H, W, CO, bf,
                                  do_affine=True, do_stats=True)
        y_ref, st_ref = run(jnp.asarray(x, bf), jnp.asarray(k, bf),
                            jnp.asarray(b, bf), jnp.asarray(mult),
                            jnp.asarray(off))
        st_ref = np.asarray(st_ref)
        for got in (st.numpy(), st_p.numpy()):
            np.testing.assert_allclose(got, st_ref, rtol=0,
                                       atol=1e-4 * np.abs(st_ref).max())
    else:
        y_ref = ref.make_cf_call(N, D, C, H * W, H, W, CO, bf)(
            jnp.asarray(x, bf), jnp.asarray(k, bf), jnp.asarray(b, bf))
    _assert_y(y.float().numpy(), y_ref, bf)
