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


# ------------------------- the TMA route's weights and staging, on the host
def _packed_by_index(k):
    """kernel (CO, C, 3, 3) -> the packed flat weights, element by element
    at the index of csrc/shift_conv_block.cuh wgmma_b_index (KS =
    ceil(C / 16) steps of 16 K rows, 6 groups of 8 output channels), zero
    elsewhere."""
    CO, C = k.shape[:2]
    KS = -(-C // 16)
    out = np.zeros(9 * KS * 16 * tsc.N48, np.float32)
    for t in range(9):
        for co in range(CO):
            for c in range(C):
                idx = (((((t * KS + c // 16) * 6 + co // 8) * 2
                         + (c % 16) // 8) * 8 + co % 8) * 8 + c % 8)
                out[idx] = k[co, c, t // 3, t % 3]
    return out


@pytest.mark.parametrize("C,CO", [(48, 48), (40, 24), (8, 8), (20, 5)])
def test_pack_weights_n48_index_formula(C, CO):
    """Weight (co, c, kh, kw) at K row c of tap 3 kh + kw and output
    channel co, zero past CO and C (C = 48: the main shape; 40 and 20: K
    rows past C in the last step)."""
    k = np.random.RandomState(C + CO).randn(CO, C, 3, 3).astype(np.float32)
    wpk = tsc.pack_weights_n48(torch.from_numpy(k))
    assert wpk.dtype == torch.float32
    np.testing.assert_array_equal(wpk.numpy(), _packed_by_index(k))
    with pytest.raises(ValueError):
        tsc.pack_weights_n48(torch.zeros(56, C, 3, 3))


def _ring_pairs_conv(x, kernel, bias):
    """The TMA route's dataflow in plain torch: per depth d the ring's
    window of the 5 slices d - 2 .. d + 2, each a box of 16 KS + 8 channels
    with TMA's zero fill (outside the volume, past C); A's K row c read
    from window position 2 - shift of its channel pair (c // 2); the 9
    taps' products against the packed weights, unpacked by the index
    formula; float32 sums, the bias in float32, y rounded once."""
    N, D, H, W, C = x.shape
    CO = kernel.shape[0]
    KS = -(-C // 16)
    groups = tsc.ring_groups(C, tsc.SHIFT_SIZE)
    shift = np.zeros(16 * KS, np.int64)           # past C: shift 0
    for c0, c1, s in groups:
        shift[c0:c1] = s
    # every group edge even: the two channels of a pair share a shift
    assert all(c0 % 2 == 0 and c1 % 2 == 0 for c0, c1, _ in groups)
    pair_shift = shift[0::2]
    wpk = tsc.pack_weights_n48(kernel.to(x.dtype)).float().numpy()
    w = np.zeros((9, tsc.N48, 16 * KS), np.float32)
    t, n, k = np.meshgrid(np.arange(9), np.arange(tsc.N48),
                          np.arange(16 * KS), indexing="ij")
    w[t, n, k] = wpk[(((((t * KS + k // 16) * 6 + n // 8) * 2
                        + (k % 16) // 8) * 8 + n % 8) * 8 + k % 8)]
    # index i of the padded depth axis is source depth i - 2, of the rows
    # and columns i - 1
    xp = torch.nn.functional.pad(x.float(), (0, 16 * KS + 8 - C, 1, 1, 1, 1,
                                             2, 2))
    acc = torch.zeros(N, D, H, W, tsc.N48)
    for d in range(D):
        window = xp[:, d:d + 5]                    # positions 0 .. 4
        a = torch.stack([window[:, 2 - int(pair_shift[c // 2]), :, :, c]
                         for c in range(16 * KS)], dim=-1)
        for tap in range(9):
            dh, dw = divmod(tap, 3)
            acc[:, d] += a[:, dh:dh + H, dw:dw + W] @ torch.from_numpy(
                w[tap]).T
    y = acc[..., :CO] + bias.to(x.dtype).float()
    return y.to(x.dtype)


@pytest.mark.parametrize("shape,CO", [
    ((2, 3, 5, 13, 8), 8),            # four groups of 2, W = 13
    ((1, 1, 4, 9, 16), 8),            # D = 1: four of the 5 slices zero
    ((1, 4, 6, 20, 48), 48),          # the main shape's channels
    ((1, 2, 3, 17, 40), 24),          # K rows 40-47 from the zero fill
])
def test_tma_ring_dataflow_matches_plain_and_reference(ref, shape, CO):
    """The ring's window, the pair's slot chosen by its group's shift, TMA's
    zero fill and the packed K order give the plain version's y and the
    reference's fused_shift_conv (within 2 bf16 steps of each channel's
    largest |y|: float32 sums of exact products in another order)."""
    x, k, b = _inputs(shape[-1] + CO, shape, CO, jnp.bfloat16)
    t = torch.from_numpy
    xt, kt = t(x).to(torch.bfloat16), t(k.transpose(3, 2, 0, 1).copy())
    y = _ring_pairs_conv(xt, kt, t(b))
    _assert_close(y.float().numpy(),
                  tsc.fused_shift_conv_ref(xt, kt, t(b)).float().numpy(),
                  "bfloat16")
    y_ref = ref.fused_shift_conv(jnp.asarray(x, jnp.bfloat16),
                                 jnp.asarray(k, jnp.bfloat16),
                                 jnp.asarray(b, jnp.bfloat16))
    _assert_close(y.float().numpy(), y_ref, "bfloat16")


def test_route_argument():
    """On CPU tensors every route is the plain version and counts no
    launch; an unknown route raises."""
    x, k, b = _inputs(4, (1, 3, 4, 8, 16), 8, jnp.float32)
    t = torch.from_numpy
    args = (t(x), t(k.transpose(3, 2, 0, 1).copy()), t(b))
    y = tsc.fused_shift_conv_ref(*args)
    routes = dict(tsc.fused_shift_conv.routes)
    for route in (None,) + tsc.ROUTES:
        assert torch.equal(tsc.fused_shift_conv(*args, route=route), y)
    assert tsc.fused_shift_conv.routes == routes
    with pytest.raises(ValueError):
        tsc.fused_shift_conv(*args, route="ldg")


def test_ring_phase_cuts_match_the_source():
    """Each of ring_phases' cuts edits lines that occur exactly once in
    csrc/shift_conv_ring.cu, and changes the source."""
    from e2enet_tpu_torch.experiments import ring_phases
    src = (ring_phases._native.CSRC / "shift_conv_ring.cu").read_text()
    for edits in ring_phases.CUTS.values():
        assert ring_phases.cut_source(edits) != src
