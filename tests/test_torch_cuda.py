"""The CUDA fused-block kernel on the card, against its plain torch
version. Imports no jax (the machine with the card has none); run there
with

    python -m pytest tests/test_torch_cuda.py --noconftest -m cuda -q

(tests/conftest.py imports jax, hence --noconftest). Without a card every
test skips. bfloat16: y within 2 bf16 ulps of each output channel's max |y|
(both sum exact bf16 products in float32 from identical operands; only the
order differs), stats within 1e-3 (float32 atomics in a varying order).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from e2enet_tpu_torch.ops import fused_block as tfb  # noqa: E402

# (N, D, H, W, part channels, pending affine per part, CO)
CASES = {
    "c1": (2, 6, 8, 16, (1,), (False,), 5),
    "two_parts": (1, 5, 8, 16, (5, 3), (False, False), 7),
    "three_parts_affine": (1, 6, 8, 16, (4, 3, 2), (True, False, True), 6),
    "w13": (2, 6, 8, 13, (8,), (True,), 6),
    "d3": (1, 3, 8, 16, (6, 2), (True, False), 4),
    "vector_loads": (1, 5, 16, 64, (48, 48), (True, False), 48),
    "co_tiles": (1, 4, 8, 32, (16, 24), (False, True), 112),
    "w128": (1, 3, 4, 128, (96,), (True,), 48),
    # rows wider than one block's tile: W tiles with a shared halo column
    "w160": (1, 3, 4, 160, (48, 48), (True, False), 48),
    "w200_c240": (1, 3, 3, 200, (96, 96, 48), (True, False, False), 96),
    "w600": (1, 2, 2, 600, (8,), (True,), 16),
}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _make(seed, N, D, H, W, part_c, affine, CO, dev):
    rng = np.random.RandomState(seed)

    def rand(*shape, scale=1.0, shift=0.0):
        return torch.from_numpy((rng.randn(*shape) * scale + shift).astype(
            np.float32)).to(dev)

    parts = [rand(N, D, H, W, c).bfloat16() for c in part_c]
    affs = [(rand(N, c, scale=0.3, shift=1.0), rand(N, c, scale=0.2))
            if a else None for c, a in zip(part_c, affine)]
    C = sum(part_c)
    return parts, affs, rand(CO, C, 3, 3, scale=(2.0 / (9 * C)) ** 0.5), \
        rand(CO, scale=0.1)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_matches_plain(case):
    dev = _card()
    parts, affs, kernel, bias = _make(len(case), *CASES[case], dev)
    before = tfb.fused_shift_conv_block.launches
    with torch.no_grad():
        y, s = tfb.fused_shift_conv_block(parts, kernel, bias, affs)
        y_p, s_p = tfb.fused_shift_conv_block_ref(parts, kernel, bias, affs)
    torch.cuda.synchronize()
    assert tfb.fused_shift_conv_block.launches == before + 1
    y, y_p = y.float(), y_p.float()
    ch_max = y_p.abs().amax(dim=(0, 1, 2, 3))
    ulp = torch.exp2(torch.floor(torch.log2(ch_max.clamp_min(1e-30))) - 7)
    assert bool(((y - y_p).abs().amax(dim=(0, 1, 2, 3)) <= 2 * ulp).all())
    torch.testing.assert_close(s, s_p, rtol=1e-3,
                               atol=1e-3 * float(y_p.abs().sum()))


@pytest.mark.cuda
def test_wrapper_launches_or_raises():
    """On a card the wrapper never falls back to the plain version: it
    raises on what the kernel does not take and launches the kernel on the
    rest, rows wider than one block's W tile included."""
    dev = _card()
    x = torch.randn(1, 4, 8, 8, 4, device=dev)
    k = torch.randn(4, 4, 3, 3, device=dev)
    b = torch.zeros(4, device=dev)
    with pytest.raises(TypeError):                  # float32 parts
        tfb.fused_shift_conv_block([x], k, b, [None])
    with pytest.raises(RuntimeError):               # needs a backward
        tfb.fused_shift_conv_block([x.bfloat16()], k.requires_grad_(), b,
                                   [None])
    wide = torch.randn(1, 2, 4, 144, 8, device=dev).bfloat16()
    before = tfb.fused_shift_conv_block.launches
    with torch.no_grad():
        y, _ = tfb.fused_shift_conv_block(
            [wide], torch.randn(4, 8, 3, 3, device=dev), b, [None])
    assert tfb.fused_shift_conv_block.launches == before + 1
    assert tuple(y.shape) == (1, 2, 4, 144, 4)
