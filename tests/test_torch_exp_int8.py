"""The port's tensor-core product (#14, its plain version, reached through
the wrapper with CPU tensors) against the reference's. The reference's
Pallas kernel is defined inside `main` of experiments/exp_int8_mxu.py and
cannot be called; per output block it computes jnp.dot(a, b,
preferred_element_type=...), so the reference side here is that product,
jax.lax.dot with the same preferred_element_type, at small and ragged
M, N, K.

Tolerances: int8 x int8 -> int32 equal to the bit (both exact); bf16 x bf16
-> float32 within 1e-5 of the largest |value| (exact products, float32 sums
in another order).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from e2enet_tpu_torch.experiments import exp_int8_mma as tim  # noqa: E402

# (128, 256, 64): one tile of the card's wgmma route, which TMA describes
SHAPES = [(64, 48, 32), (33, 50, 100), (7, 9, 3), (1, 1, 1), (130, 129, 65),
          (128, 256, 64)]


@pytest.mark.parametrize("M,N,K", SHAPES)
def test_int8_matches_lax_dot(M, N, K):
    rng = np.random.RandomState(M + N + K)
    a = rng.randint(-128, 128, (M, K)).astype(np.int8)
    b = rng.randint(-128, 128, (K, N)).astype(np.int8)
    ref = np.asarray(jax.lax.dot(jnp.asarray(a), jnp.asarray(b),
                                 preferred_element_type=jnp.int32))
    c = tim.mma_gemm(torch.from_numpy(a), torch.from_numpy(b))
    assert c.dtype == torch.int32
    np.testing.assert_array_equal(c.numpy(), ref)
    assert tim.mma_gemm.launches == 0


def test_int8_extremes_are_exact():
    """Every product at -128 * -128: the largest sums an int32 holds here,
    exact through the plain version's float64."""
    K = 4096
    a = np.full((3, K), -128, np.int8)
    b = np.full((K, 2), -128, np.int8)
    c = tim.mma_gemm(torch.from_numpy(a), torch.from_numpy(b))
    ref = np.asarray(jax.lax.dot(jnp.asarray(a), jnp.asarray(b),
                                 preferred_element_type=jnp.int32))
    assert int(c[0, 0]) == K * 128 * 128
    np.testing.assert_array_equal(c.numpy(), ref)


@pytest.mark.parametrize("M,N,K", SHAPES)
def test_bf16_matches_lax_dot(M, N, K):
    rng = np.random.RandomState(M * N + K)
    a = jnp.asarray(rng.randn(M, K), jnp.bfloat16)
    b = jnp.asarray(rng.randn(K, N), jnp.bfloat16)
    ref = np.asarray(jax.lax.dot(a, b, preferred_element_type=jnp.float32))
    t = lambda v: torch.from_numpy(np.array(v, np.float32)).bfloat16()  # noqa
    c = tim.mma_gemm(t(a), t(b))
    assert c.dtype == torch.float32
    np.testing.assert_allclose(c.numpy(), ref, rtol=0,
                               atol=1e-5 * max(np.abs(ref).max(), 1e-30))


def test_wrong_types_raise():
    with pytest.raises(TypeError):
        tim.mma_gemm(torch.zeros(2, 3), torch.zeros(3, 2))
    with pytest.raises(TypeError):
        tim.mma_gemm(torch.zeros(2, 3, dtype=torch.int8),
                     torch.zeros(3, 2, dtype=torch.bfloat16))
    with pytest.raises(ValueError):
        tim.mma_gemm(torch.zeros(2, 3, dtype=torch.int8),
                     torch.zeros(4, 2, dtype=torch.int8))
