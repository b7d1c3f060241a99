"""The port's pipelined fused block (#13, its plain version, reached
through the wrapper with CPU tensors) against the reference's software-
pipelined Pallas kernel, experiments/exp_pipeline_fwd.py pipelined_forward,
in interpret mode, bfloat16: two parts with pending affines, q = (2, 2, 2),
Dq = Hq = Wq = 4, Wqp = 6. The layouts cross through the reference's
to_quadrant_cf / from_quadrant_cf, as tests/test_torch_qfused.py does. The
reference's pipelined kernel is also held to its own quadrant_fused_block,
which it must equal exactly (it reorders the work, not the sums).

Importing the reference module sets JAX's persistent compilation cache
options for the whole process (exp_pipeline_fwd.py:24-25); a module-scoped
fixture imports it and puts both options back at once.

Tolerance: y within 2 bf16 steps of each output channel's largest |y| (both
sum exact bf16 products in float32, in another order, and round once); the
statistics within 1e-3 relative (float32 sums in another order).
"""
import functools
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

from e2enet_tpu.ops.qfused import (QStatic, from_quadrant_cf,  # noqa: E402
                                   quadrant_fused_block, to_quadrant_cf)
from e2enet_tpu.ops.shift import group_shifts  # noqa: E402
from e2enet_tpu_torch.experiments import exp_pipeline_fwd as tpf  # noqa

CACHE_OPTIONS = ("jax_compilation_cache_dir",
                 "jax_persistent_cache_min_compile_time_secs")
Q = (2, 2, 2)
N, DQ, HQ, WQ, WQP = 1, 4, 4, 4, 6
PARTS, CO = (8, 8), 8


@pytest.fixture(scope="module")
def ref_module():
    saved = {k: getattr(jax.config, k) for k in CACHE_OPTIONS}
    try:
        mod = importlib.import_module("experiments.exp_pipeline_fwd")
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


def _bf16(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_pipelined_block_matches_reference(ref, seed):
    rng = np.random.RandomState(seed)
    C = sum(PARTS)
    xs = [_bf16(rng.randn(N, 2 * DQ, 2 * HQ, 2 * WQ, c) * 0.3) for c in PARTS]
    w = _bf16(rng.randn(3, 3, C, CO) * 0.3)
    b = (rng.randn(CO) * 0.1).astype(np.float32)
    affs = [((rng.rand(N, c) + 0.5).astype(np.float32),
             (rng.randn(N, c) * 0.2).astype(np.float32)) for c in PARTS]
    bf = jnp.bfloat16
    qparts = [to_quadrant_cf(jnp.asarray(x, bf), Q, WQP) for x in xs]
    jaffs = [(jnp.asarray(m), jnp.asarray(o)) for m, o in affs]
    static = QStatic(Q, PARTS, (True, True), tuple(group_shifts(C, 5)), DQ,
                     HQ, WQ, WQP, CO, True, True)
    y_pipe, s_pipe = ref.pipelined_forward(qparts, jnp.asarray(w),
                                           jnp.asarray(b), jaffs, static)
    y_base, s_base = quadrant_fused_block(
        qparts, jnp.asarray(w, bf), jnp.asarray(b, bf), jaffs, Q, HQ, WQ,
        interpret=True)
    # the reference's pipelined kernel is its quadrant block, reordered
    np.testing.assert_array_equal(np.asarray(y_pipe, np.float32),
                                  np.asarray(y_base, np.float32))
    np.testing.assert_array_equal(np.asarray(s_pipe), np.asarray(s_base))
    y_ref = np.asarray(from_quadrant_cf(y_pipe, Q, HQ, WQ, CO), np.float32)
    s_ref = np.asarray(s_pipe).reshape(N, 8, CO, 2).sum(axis=1)

    t = torch.from_numpy
    y, stats = tpf.pipelined_fused_block(
        [t(x).bfloat16() for x in xs], t(w.transpose(3, 2, 0, 1).copy()),
        t(b), [(t(m), t(o)) for m, o in affs])
    assert y.dtype == torch.bfloat16 and tuple(y.shape) == y_ref.shape
    out = y.float().numpy()
    ulp = 2.0 ** (np.floor(np.log2(np.abs(y_ref).max(axis=(0, 1, 2, 3))))
                  - 7)
    assert np.all(np.abs(out - y_ref).max(axis=(0, 1, 2, 3)) <= 2 * ulp)
    np.testing.assert_allclose(stats.numpy(), s_ref, rtol=1e-3,
                               atol=1e-3 * float(np.abs(y_ref).sum()))
    assert tpf.pipelined_fused_block.launches == 0


def test_plain_version_is_the_fused_blocks():
    """On the CPU the pipelined block is #1's plain version, float32
    included."""
    from e2enet_tpu_torch.ops import fused_block as tfb
    rng = np.random.RandomState(2)
    t = lambda a: torch.from_numpy(a.astype(np.float32))  # noqa: E731
    parts = [t(rng.randn(2, 3, 5, 13, 5)), t(rng.randn(2, 3, 5, 13, 3))]
    k, b = t(rng.randn(7, 8, 3, 3)), t(rng.randn(7))
    affs = [(t(rng.rand(2, 5) + 0.5), t(rng.randn(2, 5))), None]
    y, s = tpf.pipelined_fused_block(parts, k, b, affs)
    y2, s2 = tfb.fused_shift_conv_block(parts, k, b, affs)
    assert torch.equal(y, y2) and torch.equal(s, s2)
