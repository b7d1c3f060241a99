"""The port's ring shift + conv and ring shift (#11, their plain versions,
reached through the wrappers with CPU tensors) against the reference's
Pallas kernels of experiments/shift_conv_pallas.py in interpret mode:
fused_shift_conv (v1, any W), fused_shift_conv_v2 (W * C % 128 == 0) and
pallas_depth_shift, values and gradients (jax.vjp through the reference's
custom VJPs).

The reference module has relative imports (`from .shift import ...`), so it
is loaded from its file as a module of the package e2enet_tpu.ops; a
function-scoped fixture patches pl.pallas_call to interpret=True for the
test alone.

Tolerances: float32 within 1e-5 of the largest |value| (both sum exact
products in float32, in another order); bfloat16 within 2 bf16 steps of
each output channel's largest |y| (both round the same float32 sums once,
which differ in order by ~1e-6 relative); the shift and its gradient equal
to the bit.
"""
import functools
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

import e2enet_tpu.ops  # noqa: E402,F401  (the reference module's package)
from e2enet_tpu_torch.experiments import shift_conv as tsc  # noqa: E402

REF = Path(__file__).resolve().parents[1] / "experiments" / \
    "shift_conv_pallas.py"
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture
def ref(monkeypatch):
    """experiments/shift_conv_pallas.py with its kernels in interpret
    mode."""
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    spec = importlib.util.spec_from_file_location(
        "e2enet_tpu.ops._exp_shift_conv_pallas", REF)
    mod = importlib.util.module_from_spec(spec)
    mod.__package__ = "e2enet_tpu.ops"
    spec.loader.exec_module(mod)
    return mod


def _inputs(seed, shape, CO, jdt):
    rng = np.random.RandomState(seed)
    N, D, H, W, C = shape
    cast = lambda a: np.array(jnp.asarray(a, jdt), np.float32)  # noqa
    x = cast(rng.randn(*shape))
    k = cast(rng.randn(3, 3, C, CO) * (2.0 / (9 * C)) ** 0.5)
    b = cast(rng.randn(CO) * 0.1)
    return x, k, b


def _assert_close(out, ref, dtype_name):
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    assert out.shape == ref.shape
    if dtype_name == "float32":
        np.testing.assert_allclose(out, ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max())
    else:
        dims = tuple(range(ref.ndim - 1))
        top = np.maximum(np.abs(ref).max(axis=dims), 2.0 ** -126)
        ulp = 2.0 ** (np.floor(np.log2(top)) - 7)
        assert np.all(np.abs(out - ref).max(axis=dims) <= 2 * ulp)


def _port(x, k, b, tdt):
    t = torch.from_numpy
    with torch.no_grad():
        y = tsc.fused_shift_conv(t(x).to(tdt),
                                 t(k.transpose(3, 2, 0, 1).copy()), t(b))
    assert y.dtype == tdt
    return y.float().numpy()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape,CO", [
    ((1, 6, 4, 8, 16), 8),            # the reference's own check, shrunk
    ((1, 3, 4, 13, 1), 5),            # C = 1: one group, shift -2
    ((2, 3, 5, 13, 3), 4),            # C = 3: shifts -2, -1, 0; W = 13
    ((1, 3, 4, 13, 16), 8),
])
def test_fused_shift_conv_matches_v1(ref, dtype, shape, CO):
    jdt, tdt = DTYPES[dtype]
    x, k, b = _inputs(len(shape) + shape[-1], shape, CO, jdt)
    y_ref = ref.fused_shift_conv(jnp.asarray(x, jdt), jnp.asarray(k, jdt),
                                 jnp.asarray(b, jdt))
    _assert_close(_port(x, k, b, tdt), y_ref, dtype)
    assert tsc.fused_shift_conv.launches == 0


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape,CO", [((1, 6, 4, 8, 16), 8),
                                      ((2, 3, 3, 8, 16), 6)])
def test_fused_shift_conv_matches_v2(ref, dtype, shape, CO):
    jdt, tdt = DTYPES[dtype]
    x, k, b = _inputs(7, shape, CO, jdt)
    y_ref = ref.fused_shift_conv_v2(jnp.asarray(x, jdt),
                                    jnp.asarray(k, jdt), jnp.asarray(b, jdt))
    _assert_close(_port(x, k, b, tdt), y_ref, dtype)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", [(1, 3, 4, 8, 16), (2, 5, 3, 16, 8)])
def test_depth_shift_ring_matches_reference(ref, dtype, shape):
    jdt, tdt = DTYPES[dtype]
    x, _, _ = _inputs(3, shape, 1, jdt)
    y_ref = np.asarray(ref.pallas_depth_shift(jnp.asarray(x, jdt)),
                       np.float32)
    y = tsc.depth_shift_ring(torch.from_numpy(x).to(tdt))
    assert y.dtype == tdt
    np.testing.assert_array_equal(y.float().numpy(), y_ref)
    assert tsc.depth_shift_ring.launches == 0


def test_fused_shift_conv_gradients(ref):
    """float32 gradients of x, kernel and bias against jax.vjp of the
    reference's custom VJP (its backward: XLA autodiff of `_reference`)."""
    x, k, b = _inputs(5, (1, 4, 4, 8, 16), 8, jnp.float32)
    g = np.random.RandomState(6).randn(1, 4, 4, 8, 8).astype(np.float32)
    _, vjp = jax.vjp(ref.fused_shift_conv, jnp.asarray(x), jnp.asarray(k),
                     jnp.asarray(b))
    gx_r, gk_r, gb_r = (np.asarray(v) for v in vjp(jnp.asarray(g)))
    t = torch.from_numpy
    xt = t(x).requires_grad_()
    kt = t(k.transpose(3, 2, 0, 1).copy()).requires_grad_()
    bt = t(b).requires_grad_()
    tsc.fused_shift_conv(xt, kt, bt).backward(t(g))
    _assert_close(xt.grad.numpy(), gx_r, "float32")
    _assert_close(kt.grad.numpy().transpose(2, 3, 1, 0), gk_r, "float32")
    _assert_close(bt.grad.numpy(), gb_r, "float32")


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_depth_shift_ring_gradient(ref, dtype):
    """The shift's cotangent: the same shift with negated groups
    (reference `_bwd_shift_ring`), exact."""
    jdt, tdt = DTYPES[dtype]
    x, _, _ = _inputs(8, (2, 5, 3, 16, 8), 1, jdt)
    g = _inputs(9, (2, 5, 3, 16, 8), 1, jdt)[0]
    _, vjp = jax.vjp(ref.pallas_depth_shift, jnp.asarray(x, jdt))
    (gx_r,) = vjp(jnp.asarray(g, jdt))
    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    tsc.depth_shift_ring(xt).backward(torch.from_numpy(g).to(tdt))
    np.testing.assert_array_equal(xt.grad.float().numpy(),
                                  np.asarray(gx_r, np.float32))


def test_shift_size_beyond_the_ring_raises():
    with pytest.raises(ValueError):
        tsc.depth_shift_ring(torch.zeros(1, 3, 2, 2, 14), shift_size=7)
