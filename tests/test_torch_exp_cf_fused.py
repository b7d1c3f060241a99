"""The port's channels-first fused block and relayout probe (#12, their
plain versions, reached through the wrappers with CPU tensors) against the
reference's Pallas kernels of experiments/exp_cf_fused.py in interpret
mode: make_cf_call (`_cf_kernel`), make_cf_call_v2 (`_cf_kernel_v2`) with
each of the affine and the statistics on and off, and try_reshape_hwc.

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

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

from e2enet_tpu_torch.experiments import exp_cf_fused as tcf  # noqa: E402

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
