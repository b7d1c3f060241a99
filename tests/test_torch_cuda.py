"""The CUDA kernels on the card, against their plain torch versions: the
fused block (the main path's level-0 and level-1 calls, the cascade's
first block at 16 and 3 input channels, the region trainers' at 4, K of
one to five chunks, CO 96 in one tile, W tiles, all mirrors at CO 24 and 96; its taps
on mma.sync as the control), the fused block with a lazy up-link part
(ragged, compact groups, all mirrors, its tile's edges, up parts wider
than one K chunk, no read of the up weights past cin, its taps on mma.sync
as the control), the strided transition (ragged and all mirrors, N = 2
with a block's tiles straddling the samples), the
up-link (N = 1 and 2, mirrored, ragged, the (1, 2, 2) stride of an
anisotropic plan's first pool; its weights' packing) and the seg
head (C 48 and 96, K 16 and 3, tiles straddling two samples, a ragged
last tile), each
on both routes and with the route each shape takes asserted by kernel name,
the down-link (also at the (1, 2, 2) window); the block backward and the
down-link backward (main-path, ragged and N = 2 shapes, the cascade's
first block with and without its input's gradient, the region trainers'
wgrad at 4 channels, ties, C = 96; its
16-byte and scalar routes by kernel name), and a small train step's
launches; the block backward's parts wanted or not and
its two device kernels per call; the experiment kernels (#11 the ring shift +
conv and the ring shift with its backward, #12 the relayout probe and the
channels-first block with and without affine and statistics on both of
its routes (the route each shape takes asserted; the ring shift + conv
on both of its routes likewise), #13 the pipelined block
against #1 (equal to the bit) and its own control,
#14 the bf16 and int8 products on the route each shape takes, counted per
route, beside the mma.sync control, and the int8 repack of B); a double
backward through the kernel model refusing, GraSP on the card (the
plain path) against its CPU run, and the on-device augmentation
(ops/device_augment.apply, every transform on) against its CPU run.
Imports no jax (the machine with the card
has none); run there with

    python -m pytest tests/test_torch_cuda.py --noconftest -m cuda -q

(tests/conftest.py imports jax, hence --noconftest). Without a card every
test skips. bfloat16: y within 2 bf16 ulps of each output channel's max |y|
(both sum exact bf16 products in float32 from identical operands; only the
order differs), stats within 1e-3 (float32 atomics in a varying order);
down-link within one bf16 step (max/min are exact, the affine may round
once more); probs within one bf16 step at the largest probability.
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
    # the main path's calls at their widths (fewer depths): level 0 at
    # 128^2, CO 48 (one K chunk); level 1 at 64^2, CO 96 in one block (2
    # and 5 K chunks)
    "l0_c1_to48": (1, 2, 128, 128, (1,), (False,), 48),
    "l0_48_to48": (1, 2, 128, 128, (48,), (True,), 48),
    "l0_48+48_to48": (1, 2, 128, 128, (48, 48), (True, False), 48),
    "l1_96_to96": (1, 3, 64, 64, (96,), (True,), 96),
    "l1_96+96+48_to96": (1, 3, 64, 64, (96, 96, 48), (True, False, False),
                         96),
    # the cascade's first block: one modality and the previous stage's
    # one-hot labels, 16 channels at the bench's 16 classes (shift groups
    # of 4, 32-byte rows), 3 at 3 classes (three 1-channel groups, 6-byte
    # rows)
    "l0_c16_to48": (1, 2, 128, 128, (16,), (False,), 48),
    "l0_c3_to48": (1, 2, 128, 128, (3,), (False,), 48),
    # the region trainers' first block: four MR modalities (four 1-channel
    # shift groups, 8-byte rows)
    "l0_c4_to48": (1, 2, 128, 128, (4,), (False,), 48),
    # K of 1 to 5 chunks at CO 48 (200: parts and groups meeting mid-unit),
    # W = 144 at CO 96
    "k200_co40": (1, 3, 16, 40, (100, 100), (True, False), 40),
    "k240_co48": (1, 3, 16, 32, (96, 96, 48), (True, False, True), 48),
    "w144_co96": (1, 2, 8, 144, (96,), (True,), 96),
    # base 24 (nnUNetTrainerV2_3ConvPerStage's width): level 0 at 128^2,
    # 1 -> 24, 24 -> 24 (the third conv of a stack too), 24 + 24 -> 24;
    # level 1 at 64^2, 48 -> 48 and 48 + 48 + 24 -> 48
    "b24_l0_c1_to24": (1, 2, 128, 128, (1,), (False,), 24),
    "b24_l0_24_to24": (1, 2, 128, 128, (24,), (True,), 24),
    "b24_l0_24+24_to24": (1, 2, 128, 128, (24, 24), (True, False), 24),
    "b24_l1_48_to48": (1, 3, 64, 64, (48,), (True,), 48),
    "b24_l1_48+48+24_to48": (1, 3, 64, 64, (48, 48, 24),
                             (True, False, False), 48),
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
    # with a gradient wanted: the forward kernel, then the backward kernel
    before = (tfb.fused_shift_conv_block.launches,
              tfb.fused_shift_conv_block_bwd.launches)
    y, s = tfb.fused_shift_conv_block([x.bfloat16()], k.requires_grad_(), b,
                                      [None])
    (y.float().sum() + s.sum()).backward()
    assert (tfb.fused_shift_conv_block.launches,
            tfb.fused_shift_conv_block_bwd.launches) == (before[0] + 1,
                                                         before[1] + 1)
    assert k.grad is not None and bool(torch.isfinite(k.grad).all())
    wide = torch.randn(1, 2, 4, 144, 8, device=dev).bfloat16()
    before = tfb.fused_shift_conv_block.launches
    with torch.no_grad():
        y, _ = tfb.fused_shift_conv_block(
            [wide], torch.randn(4, 8, 3, 3, device=dev), b, [None])
    assert tfb.fused_shift_conv_block.launches == before + 1
    assert tuple(y.shape) == (1, 2, 4, 144, 4)


def _rand(rng, dev, *shape, scale=1.0, shift=0.0):
    return torch.from_numpy((rng.randn(*shape) * scale + shift).astype(
        np.float32)).to(dev)


def _within_ulps(y, y_ref, ulps=2.0):
    """y within `ulps` bf16 steps of each output channel's largest |y|."""
    y, y_ref = y.float(), y_ref.float()
    dims = tuple(range(y.dim() - 1))
    ch_max = y_ref.abs().amax(dim=dims)
    ulp = torch.exp2(torch.floor(torch.log2(ch_max.clamp_min(1e-30))) - 7)
    return bool(((y - y_ref).abs().amax(dim=dims) <= ulps * ulp).all())


FLIPS = [(fd, fh, fw) for fd in (False, True) for fh in (False, True)
         for fw in (False, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("flips", FLIPS)
@pytest.mark.parametrize("CO", [24, 96])
def test_fused_block_flips_match_plain(flips, CO):
    """All 8 mirrors, at one CO tile of n48 and of n96."""
    dev = _card()
    parts, affs, kernel, bias = _make(3, 1, 6, 8, 24, (40, 8), (True, False),
                                      CO, dev)
    with torch.no_grad():
        y, s = tfb.fused_shift_conv_block(parts, kernel, bias, affs, flips)
        y_p, s_p = tfb.fused_shift_conv_block_ref(parts, kernel, bias, affs,
                                                  flips)
    torch.cuda.synchronize()
    assert _within_ulps(y, y_p)
    torch.testing.assert_close(s, s_p, rtol=1e-3,
                               atol=1e-3 * float(y_p.float().abs().sum()))


# (N, D, H, W, C, CO, stride)
STRIDED = {
    "even": (1, 8, 16, 32, 48, 96, (2, 2, 2)),
    # odd D, odd H, output W 13 (not a multiple of 8), C = 8
    "ragged": (2, 7, 9, 26, 8, 24, (2, 2, 2)),
    "stride_122": (1, 5, 8, 20, 16, 40, (1, 2, 2)),
    # more tiles than blocks, 80 per sample: a block's tiles straddle the
    # two samples, its statistics flushed with the next tile in flight
    "n2_straddle": (2, 40, 64, 32, 16, 40, (2, 2, 2)),
    # weights too large for two operand buffers beside them: one buffer,
    # the next tile's copies after the products
    "one_buffer": (1, 4, 8, 128, 96, 64, (2, 2, 2)),
    # base 24: context1's strided first block, 24 -> 48
    "b24": (1, 8, 32, 64, 24, 48, (2, 2, 2)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case,flips",
                         [(c, (False,) * 3) for c in sorted(STRIDED)]
                         + [("even", f) for f in FLIPS[1:]]
                         + [("ragged", f) for f in FLIPS[1:]]
                         + [("n2_straddle", (True, True, True))])
def test_strided_matches_plain(case, flips):
    from e2enet_tpu_torch.ops import qstride
    dev = _card()
    N, D, H, W, C, CO, stride = STRIDED[case]
    rng = np.random.RandomState(D + C)
    x = _rand(rng, dev, N, D, H, W, C).bfloat16()
    m, o = _rand(rng, dev, N, C, scale=0.3, shift=1.0), _rand(rng, dev, N, C,
                                                              scale=0.2)
    k = _rand(rng, dev, CO, C, 3, 3, scale=(2.0 / (9 * C)) ** 0.5)
    b = _rand(rng, dev, CO, scale=0.1)
    before = qstride.strided_fused.launches
    with torch.no_grad():
        y, s = qstride.strided_fused(x, m, o, k, b, stride, flips)
        y_p, s_p = qstride.strided_fused_ref(x, m, o, k, b, stride, flips)
    torch.cuda.synchronize()
    assert qstride.strided_fused.launches == before + 1
    assert y.shape == y_p.shape
    assert _within_ulps(y, y_p)
    torch.testing.assert_close(s, s_p, rtol=1e-3,
                               atol=1e-3 * float(y_p.float().abs().sum()))


# (N, D, H, W, Cin, Cout, stride)
UPLINKS = {
    "bench_width": (1, 4, 8, 64, 96, 48, (2, 2, 2)),
    # the train step's batch of two
    "bench_width_n2": (2, 4, 8, 64, 96, 48, (2, 2, 2)),
    # odd D, W = 13, a part of width 8, a tile past W = 64
    "ragged": (2, 3, 5, 13, 8, 12, (2, 2, 2)),
    "wide": (1, 2, 2, 70, 24, 16, (1, 2, 2)),
    # an anisotropic plan's level-0 up-link (first pool (1, 2, 2)) at the
    # bench width: the materialised route's #6
    "aniso_bench_width": (1, 4, 16, 64, 96, 48, (1, 2, 2)),
    "aniso_ragged": (2, 3, 5, 13, 16, 8, (1, 2, 2)),
    # a 2D plan's level-1 -> 0 up-link: depth 1, a batch of slices
    "2d_batch": (8, 1, 16, 16, 96, 48, (1, 2, 2)),
    # base 24: level 1 -> 0, 48 -> 24
    "b24": (1, 4, 16, 64, 48, 24, (2, 2, 2)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(UPLINKS))
@pytest.mark.parametrize("flips", [(False,) * 3, (True, False, True)])
def test_uplink_matches_plain(case, flips):
    from e2enet_tpu_torch.ops import qlink
    dev = _card()
    N, D, H, W, C, cout, stride = UPLINKS[case]
    rng = np.random.RandomState(W + C)
    x = _rand(rng, dev, N, D, H, W, C).bfloat16()
    m, o = _rand(rng, dev, N, C, scale=0.3, shift=1.0), _rand(rng, dev, N, C,
                                                              scale=0.2)
    k = _rand(rng, dev, C, cout, *stride, scale=(1.0 / C) ** 0.5)
    before = qlink.uplink.launches
    with torch.no_grad():
        y = qlink.uplink(x, m, o, k, flips)
        y_p = qlink.uplink_ref(x, m, o, k, flips)
    torch.cuda.synchronize()
    assert qlink.uplink.launches == before + 1
    assert y.shape == y_p.shape
    assert _within_ulps(y, y_p)


# (N, D, H, W, C, window)
DOWNLINKS = {
    "bench_width": (1, 8, 16, 64, 48, (2, 2, 2)),
    # odd D (a ragged edge), W = 26, C = 8 and C = 5 (channel by channel)
    "ragged": (2, 7, 6, 26, 8, (2, 2, 2)),
    "c5": (1, 4, 4, 6, 5, (2, 2, 2)),
    # the window of an anisotropic plan's first pool, (1, 2, 2), at the
    # bench width and ragged
    "aniso_bench_width": (1, 4, 32, 128, 48, (1, 2, 2)),
    "aniso_ragged": (2, 3, 7, 26, 8, (1, 2, 2)),
    # a 2D plan's level-0 -> 1 down-link: depth 1, a batch of slices
    "2d_batch": (8, 1, 32, 32, 48, (1, 2, 2)),
    # base 24: level 0 -> 1 at C = 24
    "b24": (1, 8, 32, 128, 24, (2, 2, 2)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(DOWNLINKS))
def test_downlink_matches_plain(case):
    from e2enet_tpu_torch.ops import qlink
    dev = _card()
    N, D, H, W, C, window = DOWNLINKS[case]
    rng = np.random.RandomState(W + C)
    x = _rand(rng, dev, N, D, H, W, C).bfloat16()
    m, o = _rand(rng, dev, N, C), _rand(rng, dev, N, C, scale=0.2)
    before = qlink.downlink.launches
    with torch.no_grad():
        y = qlink.downlink(x, m, o, window)
        y_p = qlink.downlink_ref(x, m, o, window)
    torch.cuda.synchronize()
    assert qlink.downlink.launches == before + 1
    assert y.shape == y_p.shape
    assert _within_ulps(y, y_p, ulps=1.0)


# (N, D, H, W, C, K)
HEADS = {
    "bench_width": (1, 4, 16, 64, 48, 16),
    # the train step's level-1 head
    "c96": (1, 4, 8, 64, 96, 16),
    # 195 voxels per sample: tiles of 128 voxels straddle the two samples
    "n2_straddle": (2, 3, 5, 13, 48, 16),
    # the bulk route with K = 5: one tile of 105 voxels whose outputs are
    # not a multiple of 16 bytes (stored element by element)
    "k5_tail": (1, 3, 5, 7, 16, 5),
    "ragged": (2, 3, 5, 13, 8, 3),
    "c6": (1, 2, 3, 7, 6, 5),
    # a 2D plan's level-0 head: depth 1, a batch of slices
    "2d_batch": (8, 1, 32, 32, 48, 16),
    # three labels (the cascade's CPU-size task): K < 16
    "k3": (1, 4, 16, 64, 48, 3),
    "k3_n2": (2, 4, 16, 64, 48, 3),
    # base 24: the level-0 head at C = 24 (the ldg route: C % 16 != 0)
    "b24": (1, 4, 32, 128, 24, 16),
    "b24_k3_n2": (2, 4, 16, 64, 24, 3),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(HEADS))
@pytest.mark.parametrize("probs", [True, False])
def test_seghead_matches_plain(case, probs):
    from e2enet_tpu_torch.ops import qlink
    dev = _card()
    N, D, H, W, C, K = HEADS[case]
    rng = np.random.RandomState(W + C)
    x = _rand(rng, dev, N, D, H, W, C).bfloat16()
    m, o = _rand(rng, dev, N, C, scale=0.3, shift=1.0), _rand(rng, dev, N, C,
                                                              scale=0.2)
    w = _rand(rng, dev, K, C, scale=(2.0 / C) ** 0.5)
    pd = torch.bfloat16 if probs else None
    before = qlink.seghead.launches
    with torch.no_grad():
        y = qlink.seghead(x, m, o, w, pd)
        y_p = qlink.seghead_ref(x, m, o, w, pd)
    torch.cuda.synchronize()
    assert qlink.seghead.launches == before + 1
    assert y.shape == y_p.shape and y.dtype == y_p.dtype
    if probs:
        # one bf16 step at the largest probability, sums to 1
        assert float((y.float() - y_p.float()).abs().max()) <= 2.0 ** -8
        torch.testing.assert_close(y.float().sum(-1),
                                   torch.ones(y.shape[:-1], device=dev),
                                   rtol=0, atol=1e-2)
    else:
        torch.testing.assert_close(y, y_p, rtol=1e-4,
                                   atol=1e-4 * float(y_p.abs().max()))


@pytest.mark.cuda
def test_link_wrappers_launch_or_raise():
    """The new wrappers never fall back to the plain version on a card:
    they raise on what their kernel does not take."""
    from e2enet_tpu_torch.ops import qlink, qstride
    dev = _card()
    x = torch.randn(1, 4, 8, 8, 8, device=dev)
    m, o = torch.ones(8, device=dev), torch.zeros(8, device=dev)
    with torch.no_grad():
        with pytest.raises(TypeError):              # float32 input
            qstride.strided_fused(x, m, o, torch.randn(8, 8, 3, 3,
                                                       device=dev),
                                  torch.zeros(8, device=dev))
        with pytest.raises(ValueError):             # stride 3
            qstride.strided_fused(x.bfloat16(), m, o,
                                  torch.randn(8, 8, 3, 3, device=dev),
                                  torch.zeros(8, device=dev), (3, 3, 3))
        with pytest.raises(RuntimeError):           # CO = 200 > 128
            qstride.strided_fused(x.bfloat16(), m, o,
                                  torch.randn(200, 8, 3, 3, device=dev),
                                  torch.zeros(200, device=dev))
        with pytest.raises(TypeError):
            qlink.uplink(x, m, o, torch.randn(8, 4, 2, 2, 2, device=dev))
        with pytest.raises(RuntimeError):           # sw * Cout = 256 > 128
            qlink.uplink(x.bfloat16(), m, o,
                         torch.randn(8, 128, 2, 2, 2, device=dev))
        with pytest.raises(TypeError):
            qlink.downlink(x, m, o)
        with pytest.raises(TypeError):              # float16 probs
            qlink.seghead(x.bfloat16(), m, o, torch.randn(3, 8, device=dev),
                          torch.float16)
        with pytest.raises(RuntimeError):           # K = 40 > 32
            qlink.seghead(x.bfloat16(), m, o, torch.randn(40, 8, device=dev))
    # with a gradient wanted: the kernel forward, the plain version's
    # autograd backward
    w = torch.randn(8, 4, 2, 2, 2, device=dev, requires_grad=True)
    before = qlink.uplink.launches
    qlink.uplink(x.bfloat16(), m, o, w).float().sum().backward()
    assert qlink.uplink.launches == before + 1
    assert w.grad is not None and bool(torch.isfinite(w.grad).all())


# (N, Dc, Hc, Wc, materialised part channels, pending affine per part, cin,
# C_up, CO, compact groups or None); the level-0 volume is 2x the coarse one
LAZY = {
    "bench_width": (1, 2, 8, 32, (48,), (True,), 96, 48, 48, None),
    # odd coarse depth, W = 26 (not a multiple of 16), 8-channel parts, CO 8
    "ragged": (2, 3, 5, 13, (8,), (True,), 8, 8, 8, None),
    "co24": (1, 3, 4, 7, (16,), (False,), 24, 16, 24, None),
    # part boundary and up channels mid-unit: C = 5 + 11
    "odd_parts": (1, 2, 3, 9, (5,), (True,), 7, 11, 12, None),
    # compact groups of a sparse plan, starting mid-unit
    "compact_groups": (1, 2, 4, 20, (24,), (True,), 24, 16, 40,
                       ((0, 5, -2), (5, 19, -1), (19, 27, 0), (27, 33, 1),
                        (33, 40, 2))),
    "co96": (1, 2, 4, 16, (48, 8), (True, False), 24, 48, 96, None),
    # the tile's edges: H = 18, not a multiple of its 16 rows; one coarse
    # depth (D = 2); sparse output widths 10 and 40; three pending parts
    # beside the up-link (MAX_PARTS); W = 144 and 600
    "h_tile_ragged": (1, 2, 9, 16, (48,), (True,), 96, 48, 48, None),
    "dc1": (2, 1, 4, 8, (16,), (True,), 24, 16, 24, None),
    "co10": (1, 3, 8, 16, (12,), (True,), 24, 10, 10, None),
    "co40": (1, 3, 8, 16, (24,), (True,), 48, 24, 40, None),
    "max_parts": (1, 2, 5, 20, (8, 16, 8), (True, False, True), 24, 16, 40,
                  None),
    "w144": (1, 2, 3, 72, (48,), (True,), 96, 48, 48, None),
    "w600": (1, 1, 2, 300, (8,), (True,), 16, 8, 16, None),
    # up parts of more than one staged chunk beside a part: 64 + up
    # 128 -> 64 (a model of 64 base features), 8 + up 24 -> 56
    "wide_up64": (1, 2, 4, 16, (64,), (True,), 128, 64, 48, None),
    # base 24: a level-0 nest node, 24 + up 48 -> 24, CO 24
    "b24": (1, 4, 16, 64, (24,), (True,), 48, 24, 24, None),
    "wide_up56": (1, 3, 4, 9, (8,), (False,), 24, 56, 24, None),
    # compact groups whose up columns read both depth parities at one
    # output depth (shifts 1, -1, 2, 0 side by side)
    "both_parities": (1, 3, 6, 16, (8,), (True,), 24, 12, 10,
                      ((0, 3, -2), (3, 9, 1), (9, 12, -1), (12, 16, 2),
                       (16, 20, 0))),
}


def _lazy_inputs(case, dev):
    from e2enet_tpu_torch.ops import qfused
    N, Dc, Hc, Wc, part_c, affine, cin, cout, CO, groups = LAZY[case]
    rng = np.random.RandomState(cin + cout + CO)
    D, H, W = 2 * Dc, 2 * Hc, 2 * Wc
    parts = [_rand(rng, dev, N, D, H, W, c).bfloat16() for c in part_c]
    affs = [(_rand(rng, dev, N, c, scale=0.3, shift=1.0),
             _rand(rng, dev, N, c, scale=0.2)) if a else None
            for c, a in zip(part_c, affine)]
    up = qfused.LazyUp(_rand(rng, dev, N, Dc, Hc, Wc, cin).bfloat16(),
                       _rand(rng, dev, N, cin, scale=0.3, shift=1.0),
                       _rand(rng, dev, N, cin, scale=0.2),
                       _rand(rng, dev, cin, cout, 2, 2, 2,
                             scale=(1.0 / cin) ** 0.5))
    C = sum(part_c) + cout
    kernel = _rand(rng, dev, CO, C, 3, 3, scale=(2.0 / (9 * C)) ** 0.5)
    return parts, up, kernel, _rand(rng, dev, CO, scale=0.1), affs, groups


@pytest.mark.cuda
@pytest.mark.parametrize("case,flips",
                         [(c, (False,) * 3) for c in sorted(LAZY)]
                         + [("ragged", f) for f in FLIPS[1:]]
                         + [("compact_groups", (True, True, True)),
                            ("both_parities", (True, True, True))])
def test_lazy_block_matches_plain(case, flips):
    from e2enet_tpu_torch.ops import qfused
    dev = _card()
    parts, up, kernel, bias, affs, groups = _lazy_inputs(case, dev)
    before = qfused.lazy_up_fused_block.launches
    with torch.no_grad():
        y, s = qfused.lazy_up_fused_block(parts, up, kernel, bias, affs,
                                          flips, groups)
        y_p, s_p = qfused.lazy_up_fused_block_ref(parts, up, kernel, bias,
                                                  affs, flips, groups)
    torch.cuda.synchronize()
    assert qfused.lazy_up_fused_block.launches == before + 1
    assert y.shape == y_p.shape
    assert _within_ulps(y, y_p)
    torch.testing.assert_close(s, s_p, rtol=1e-3,
                               atol=1e-3 * float(y_p.float().abs().sum()))


@pytest.mark.cuda
def test_lazy_reads_no_up_weight_past_cin():
    """cin = 24 pads to 32 channels: the kernel must not copy the up
    weights past cin, which for the last row is past the tensor. Launched
    with up weights followed by NaN (the last up column reads depth parity
    1, the last row), the result still matches the plain version."""
    from e2enet_tpu_torch.ops import _native, qfused
    from e2enet_tpu_torch.ops.fused_block import (affine_nc,
                                                  mirror_conv_kernel)
    dev = _card()
    rng = np.random.RandomState(11)
    N, Dc, Hc, Wc, c0, cin, cout, CO = 1, 2, 4, 8, 16, 24, 8, 16
    groups = ((0, 16, 0), (16, 24, -1))   # up columns read d + 1
    parts = [_rand(rng, dev, N, 2 * Dc, 2 * Hc, 2 * Wc, c0).bfloat16()]
    affs = [(_rand(rng, dev, N, c0, scale=0.3, shift=1.0),
             _rand(rng, dev, N, c0, scale=0.2))]
    up = qfused.LazyUp(_rand(rng, dev, N, Dc, Hc, Wc, cin).bfloat16(),
                       _rand(rng, dev, N, cin, scale=0.3, shift=1.0),
                       _rand(rng, dev, N, cin, scale=0.2),
                       _rand(rng, dev, cin, cout, 2, 2, 2, scale=0.2))
    C = c0 + cout
    kernel = _rand(rng, dev, CO, C, 3, 3, scale=(2.0 / (9 * C)) ** 0.5)
    bias = _rand(rng, dev, CO, scale=0.1)
    bf = torch.bfloat16
    wu = torch.full((8 * cout * cin + 8,), float("nan"), dtype=bf,
                    device=dev)
    wu[:8 * cout * cin] = up.kernel.to(bf).permute(2, 3, 4, 1, 0).reshape(-1)
    w9 = mirror_conv_kernel(kernel.to(bf), (False,) * 3).permute(
        2, 3, 0, 1).reshape(9, CO, C).contiguous()
    D, H, W = 2 * Dc, 2 * Hc, 2 * Wc
    y = torch.empty((N, D, H, W, CO), dtype=bf, device=dev)
    stats = torch.zeros((N, CO, 2), dtype=torch.float32, device=dev)
    with torch.no_grad():
        _native.launch_lazy_up(
            parts, [(affine_nc(affs[0][0], N, c0),
                     affine_nc(affs[0][1], N, c0))], groups, w9,
            bias.to(bf), up.raw, affine_nc(up.mult, N, cin),
            affine_nc(up.off, N, cin), wu[:8 * cout * cin].view(8, cout, cin),
            y, stats)
        y_p, s_p = qfused.lazy_up_fused_block_ref(parts, up, kernel, bias,
                                                  affs, (False,) * 3, groups)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(y.float()).all())
    assert _within_ulps(y, y_p)
    torch.testing.assert_close(stats, s_p, rtol=1e-3,
                               atol=1e-3 * float(y_p.float().abs().sum()))


@pytest.mark.cuda
def test_lazy_wrapper_raises():
    """float32 inputs and a second LazyUp part are refused, never run
    through the plain version or the materialised route."""
    from e2enet_tpu_torch.ops import qfused
    dev = _card()
    parts, up, kernel, bias, affs, _ = _lazy_inputs("ragged", dev)
    with torch.no_grad():
        with pytest.raises(TypeError):
            qfused.lazy_up_fused_block([p.float() for p in parts], up,
                                       kernel, bias, affs)
        with pytest.raises(TypeError):
            qfused.lazy_up_fused_block(parts + [up], up, kernel, bias,
                                       affs + [None])


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["bench_width", "co40", "co96",
                                  "wide_up64", "both_parities"])
def test_lazy_mma_control_matches_plain(case):
    """The kernel with its taps on mma.sync (the control that measures the
    wgmma loop) computes the same block."""
    from e2enet_tpu_torch.ops import qfused
    dev = _card()
    parts, up, kernel, bias, affs, groups = _lazy_inputs(case, dev)
    flips = (True, False, True)
    with torch.no_grad():
        y, s = qfused.lazy_up_fused_block(parts, up, kernel, bias, affs,
                                          flips, groups, wgmma=False)
        y_w, _ = qfused.lazy_up_fused_block(parts, up, kernel, bias, affs,
                                            flips, groups)
        y_p, s_p = qfused.lazy_up_fused_block_ref(parts, up, kernel, bias,
                                                  affs, flips, groups)
    torch.cuda.synchronize()
    assert _within_ulps(y, y_p)
    assert _within_ulps(y, y_w)
    torch.testing.assert_close(s, s_p, rtol=1e-3,
                               atol=1e-3 * float(y_p.float().abs().sum()))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["l0_48+48_to48", "l1_96+96+48_to96",
                                  "c1", "w13", "co_tiles", "w600"])
def test_fused_block_mma_control_matches_plain(case):
    """#1 with its taps on mma.sync (the control that measures the wgmma
    loop) computes the same block; it refuses a gradient."""
    dev = _card()
    parts, affs, kernel, bias = _make(11, *CASES[case], dev)
    flips = (True, False, True)
    before = tfb.fused_shift_conv_block.launches
    with torch.no_grad():
        y, s = tfb.fused_shift_conv_block(parts, kernel, bias, affs, flips,
                                          wgmma=False)
        y_w, _ = tfb.fused_shift_conv_block(parts, kernel, bias, affs, flips)
        y_p, s_p = tfb.fused_shift_conv_block_ref(parts, kernel, bias, affs,
                                                  flips)
    torch.cuda.synchronize()
    assert tfb.fused_shift_conv_block.launches == before + 2
    assert _within_ulps(y, y_p)
    assert _within_ulps(y, y_w, ulps=1.0)
    torch.testing.assert_close(s, s_p, rtol=1e-3,
                               atol=1e-3 * float(y_p.float().abs().sum()))
    with pytest.raises(ValueError):
        tfb.fused_shift_conv_block(parts, kernel.requires_grad_(), bias,
                                   affs, wgmma=False)


# ---------------------------------------------------------------------------
# backward kernels

def _bwd_inputs(seed, N, D, H, W, part_c, affine, CO, dev):
    """The forward's inputs and output and random cotangents."""
    parts, affs, kernel, bias = _make(seed, N, D, H, W, part_c, affine, CO,
                                      dev)
    with torch.no_grad():
        y, _ = tfb.fused_shift_conv_block_ref(parts, kernel, bias, affs)
    rng = np.random.RandomState(seed + 7)
    gy = _rand(rng, dev, *y.shape, scale=0.1).bfloat16()
    gstats = _rand(rng, dev, N, CO, 2, scale=1e-4)
    return parts, kernel, bias, affs, y, gy, gstats


def _close_max(a, b, rtol):
    """max |a - b| within rtol of max |b| (float32 sums in another order,
    with atomics)."""
    a, b = a.float(), b.float()
    return float((a - b).abs().max()) <= rtol * float(b.abs().max()) + 1e-30


# (N, D, H, W, part channels, pending affine per part, CO): level-0 and
# level-1 widths at small extents, N = 2, ragged W, D below the shift
# window (D = 2, and D = 1 where every depth is an edge), a part with no
# affine, two CO tiles, shift groups of C = 48 that straddle 8-channel
# units (10, 10, 10, 10, 8)
BWD = {
    "l0_lazy_width": (2, 6, 8, 64, (48, 48), (True, False), 48),
    "l1_width": (2, 4, 8, 32, (96, 96, 48), (True, False, False), 96),
    "l1_one_part": (1, 4, 8, 32, (96,), (True,), 96),
    "ragged_w13": (2, 5, 6, 13, (8, 5), (True, True), 7),
    "d2": (1, 2, 8, 16, (6, 2), (True, False), 4),
    "d1": (2, 1, 8, 16, (16, 8), (True, False), 24),
    "co112": (1, 3, 4, 32, (16, 24), (False, True), 112),
    "c1": (2, 4, 8, 16, (1,), (False,), 48),
    "c48_straddle": (2, 5, 8, 32, (48,), (True,), 48),
    # the cascade's first block at level 0 (16 and 3 input channels)
    "l0_c16": (2, 4, 32, 64, (16,), (False,), 48),
    "l0_c3": (2, 4, 32, 64, (3,), (False,), 48),
    # the region trainers' first block (four modalities)
    "l0_c4": (2, 4, 32, 64, (4,), (False,), 48),
    # base 24 at batch 2: level 0 (24 + 24 -> 24), level 1 (48 + 48 + 24
    # -> 48)
    "b24_l0": (2, 6, 16, 64, (24, 24), (True, False), 24),
    "b24_l1": (2, 4, 8, 32, (48, 48, 24), (True, False, False), 48),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(BWD))
def test_block_bwd_matches_plain(case):
    """The block backward kernel against its plain version on the same
    bf16 inputs: gx within two bf16 steps of each channel's largest |gx|
    (ct is rounded to bf16 after float32 sums in another order); gW, gb
    and g(affine) within 2e-3 of the largest |value| (float32 sums in
    another order, atomics)."""
    dev = _card()
    args = _bwd_inputs(len(case), *BWD[case], dev)
    before = tfb.fused_shift_conv_block_bwd.launches
    gp, gk, gb, ga = tfb.fused_shift_conv_block_bwd(*args)
    rp, rk, rb, ra = tfb.fused_shift_conv_block_bwd_ref(*args)
    torch.cuda.synchronize()
    assert tfb.fused_shift_conv_block_bwd.launches == before + 1
    for g, r in zip(gp, rp):
        assert g.dtype == torch.bfloat16 and g.shape == r.shape
        assert bool(torch.isfinite(g.float()).all())
        assert _within_ulps(g, r)
    assert _close_max(gk, rk, 2e-3) and _close_max(gb, rb, 2e-3)
    for g, r in zip(ga, ra):
        assert (g is None) == (r is None)
        if g is not None:
            assert _close_max(g[0], r[0], 2e-3)
            assert _close_max(g[1], r[1], 2e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("flips", [(True, False, True), (False, True, False)])
def test_block_bwd_flips_match_plain(flips):
    dev = _card()
    parts, kernel, bias, affs, y, gy, gstats = _bwd_inputs(
        5, 1, 5, 8, 24, (40, 8), (True, False), 24, dev)
    gp, gk, gb, ga = tfb.fused_shift_conv_block_bwd(
        parts, kernel, bias, affs, y, gy, gstats, flips)
    rp, rk, rb, ra = tfb.fused_shift_conv_block_bwd_ref(
        parts, kernel, bias, affs, y, gy, gstats, flips)
    torch.cuda.synchronize()
    assert all(_within_ulps(g, r) for g, r in zip(gp, rp))
    assert _close_max(gk, rk, 2e-3) and _close_max(gb, rb, 2e-3)
    assert _close_max(ga[0][0], ra[0][0], 2e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("cin", [16, 3, 4])
def test_block_bwd_cascade_first_block_wgrad(cin):
    """The cascade's first block (16 or 3 channels) and the region
    trainers' (4 modalities) as the train step runs them: the input wants
    no gradient, so the backward is the wgrad alone; gW and gb against
    the plain version."""
    dev = _card()
    args = _bwd_inputs(cin, 2, 4, 32, 64, (cin,), (False,), 48, dev)
    gp, gk, gb, ga = tfb.fused_shift_conv_block_bwd(*args, want=[False])
    rp, rk, rb, ra = tfb.fused_shift_conv_block_bwd_ref(*args)
    torch.cuda.synchronize()
    assert gp[0] is None and ga[0] is None
    assert _close_max(gk, rk, 2e-3) and _close_max(gb, rb, 2e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("want", [(False, False), (True, False),
                                  (False, True)])
def test_block_bwd_parts_wanted_match_plain(want):
    """Only the wanted parts get a gradient; gW and gb are right with no
    part wanted (the dgrad does not run), and the wanted part's gx and
    g(affine) are right beside an unwanted one."""
    dev = _card()
    args = _bwd_inputs(9, 2, 5, 8, 32, (48, 48), (True, True), 48, dev)
    gp, gk, gb, ga = tfb.fused_shift_conv_block_bwd(*args, want=want)
    rp, rk, rb, ra = tfb.fused_shift_conv_block_bwd_ref(*args)
    torch.cuda.synchronize()
    assert _close_max(gk, rk, 2e-3) and _close_max(gb, rb, 2e-3)
    for w, g, r, a, b in zip(want, gp, rp, ga, ra):
        assert (g is None) == (not w) and (a is None) == (not w)
        if w:
            assert _within_ulps(g, r)
            assert _close_max(a[0], b[0], 2e-3)
            assert _close_max(a[1], b[1], 2e-3)


def _device_kernels(fn):
    """Names of the device kernels fn() launches that are not torch's own
    (the wrapper's allocations, fills and layout copies)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and "at::" not in e.name and not e.name.startswith("Mem")]


@pytest.mark.cuda
@pytest.mark.parametrize("any_wanted", [True, False])
def test_block_bwd_two_kernels(any_wanted):
    """The block backward is two device kernels per call, the dgrad (with
    geff on load and the shift's adjoint) and the wgrad (with geff and gb);
    the wgrad alone when no part is wanted."""
    dev = _card()
    args = _bwd_inputs(4, 2, 4, 8, 32, (48, 48), (True, False), 48, dev)
    want = (any_wanted, False)
    tfb.fused_shift_conv_block_bwd(*args, want=want)    # builds, warms up
    names = _device_kernels(
        lambda: tfb.fused_shift_conv_block_bwd(*args, want=want))
    kinds = sorted(n.split("<")[0].split()[-1] for n in names)
    assert kinds == (["dgrad_kernel", "wgrad_kernel"] if any_wanted
                     else ["wgrad_kernel"]), names


# (N, D, H, W, C, window, integer-valued input: exact ties)
DOWN_BWD = {
    "bench_width": (2, 8, 16, 64, 48, (2, 2, 2), False),
    "ties": (2, 6, 8, 32, 48, (2, 2, 2), True),
    "ragged": (2, 7, 6, 26, 8, (2, 2, 2), True),
    "c5": (1, 4, 4, 6, 5, (2, 2, 2), False),
    # 16-byte units: aligned rows with exact ties, and twelve units
    "ties_aligned": (2, 16, 32, 64, 48, (2, 2, 2), True),
    "c96": (2, 8, 16, 32, 96, (2, 2, 2), False),
    # a 2D plan's window (1, 2, 2) at depth 1 (the scalar route)
    "2d_window": (8, 1, 32, 32, 48, (1, 2, 2), True),
    # base 24 at batch 2
    "b24": (2, 8, 16, 64, 24, (2, 2, 2), False),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(DOWN_BWD))
def test_downlink_bwd_matches_plain(case):
    """Kernel #8's port against its plain version: the same float32 steps,
    so gx agrees to the bit; g(mult), g(off) within 1e-4 of the largest
    (float32 sums in another order)."""
    from e2enet_tpu_torch.ops import qlink
    dev = _card()
    N, D, H, W, C, window, ties = DOWN_BWD[case]
    rng = np.random.RandomState(D + W + C)
    x = _rand(rng, dev, N, D, H, W, C)
    if ties:
        x = torch.round(2 * x)              # few distinct values: ties
    x = x.bfloat16()
    m, o = _rand(rng, dev, N, C), _rand(rng, dev, N, C, scale=0.2)
    m[:, 0] = 0.0                           # the min chain at mult == 0
    o[:, 1] = 0.0
    gy = _rand(rng, dev, N, D // window[0], H // window[1], W // window[2],
               C).bfloat16()
    before = qlink.downlink_bwd.launches
    gx, gm, go = qlink.downlink_bwd(x, m, o, gy, window)
    rx, rm, ro = qlink.downlink_bwd_ref(x, m, o, gy, window)
    torch.cuda.synchronize()
    assert qlink.downlink_bwd.launches == before + 1
    assert gx.dtype == torch.bfloat16 and torch.equal(gx, rx)
    assert _close_max(gm, rm, 1e-4) and _close_max(go, ro, 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("C,kernel", [(48, "downlink_bwd_vec_kernel"),
                                      (8, "downlink_bwd_vec_kernel"),
                                      (12, "downlink_bwd_kernel"),
                                      (5, "downlink_bwd_kernel")])
def test_downlink_bwd_route(C, kernel):
    """Kernel #8's route follows the shape: 16-byte units where C is a
    multiple of 8 (aligned rows, a 2 x 2 x 2 window), scalar otherwise."""
    from e2enet_tpu_torch.ops import qlink
    dev = _card()
    rng = np.random.RandomState(C)
    x = _rand(rng, dev, 1, 4, 4, 8, C).bfloat16()
    m, o = _rand(rng, dev, 1, C), _rand(rng, dev, 1, C)
    gy = _rand(rng, dev, 1, 2, 2, 4, C).bfloat16()
    qlink.downlink_bwd(x, m, o, gy)                 # builds, warms up
    names = _device_kernels(lambda: qlink.downlink_bwd(x, m, o, gy))
    kinds = [n.split("(")[0].split()[-1] for n in names]
    assert kernel in kinds and len([k for k in kinds if "downlink" in k]) == 1


def _unaligned(rng, dev, *shape):
    """A contiguous bf16 tensor whose data is 2 bytes off a 16-byte
    boundary."""
    n = int(np.prod(shape))
    base = _rand(rng, dev, n + 1).bfloat16()
    return base[1:].view(*shape)


@pytest.mark.cuda
@pytest.mark.parametrize("C,K,aligned,kernel", [
    (48, 16, True, "seghead_kernel"), (96, 16, True, "seghead_kernel"),
    (32, 3, True, "seghead_kernel"), (8, 3, True, "seghead_ldg_kernel"),
    (48, 20, True, "seghead_ldg_kernel"), (112, 16, True, "seghead_ldg_kernel"),
    (48, 16, False, "seghead_ldg_kernel")])
def test_seghead_route(C, K, aligned, kernel):
    """#10/#9's route follows the library's rule: the bulk route where C is
    a multiple of 16 up to 96, K <= 16, N * C <= 2048 and x and y are
    16-byte aligned; the first design otherwise. One kernel per call, counted per route, both
    modes within the tolerances."""
    from e2enet_tpu_torch.ops import qlink
    dev = _card()
    rng = np.random.RandomState(C + K)
    shape = (2, 3, 4, 24, C)
    x = (_rand(rng, dev, *shape).bfloat16() if aligned
         else _unaligned(rng, dev, *shape))
    m, o = _rand(rng, dev, 2, C, scale=0.3, shift=1.0), _rand(
        rng, dev, 2, C, scale=0.2)
    w = _rand(rng, dev, K, C, scale=(2.0 / C) ** 0.5).bfloat16()
    route = "bulk" if kernel == "seghead_kernel" else "ldg"
    for pd in (torch.bfloat16, None):
        before = dict(qlink.seghead.routes)
        names = _device_kernels(lambda: qlink.seghead(x, m, o, w, pd))
        kinds = [n.split("(")[0].split("<")[0].split()[-1] for n in names]
        assert [k for k in kinds if "seghead" in k] == [kernel], names
        assert qlink.seghead.routes[route] == before[route] + 1
        y = qlink.seghead(x, m, o, w, pd)
        y_p = qlink.seghead_ref(x, m, o, w, pd)
        if pd is not None:
            assert float((y.float() - y_p.float()).abs().max()) <= 2.0 ** -8
        else:
            torch.testing.assert_close(y, y_p, rtol=1e-4,
                                       atol=1e-4 * float(y_p.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("C,cout,stride,aligned,kernel", [
    (96, 48, (2, 2, 2), True, "uplink_kernel"),
    (8, 12, (2, 2, 2), True, "uplink_kernel"),
    (24, 16, (1, 2, 2), True, "uplink_kernel"),
    (12, 8, (2, 2, 2), True, "uplink_ldg_kernel"),
    (16, 5, (2, 2, 2), True, "uplink_ldg_kernel"),
    (96, 48, (2, 2, 2), False, "uplink_ldg_kernel")])
def test_uplink_route(C, cout, stride, aligned, kernel):
    """#6's route follows the library's rule: the bulk route where Cin is a
    multiple of 8 up to 96, sw*Cout a multiple of 8 (at most 24 weight row
    fragments) and x, y, mult and off are 16-byte aligned; the first design
    otherwise. Each call packs the weights' image first
    (uplink_image_kernel), then runs one kernel, counted per route; y within
    2 bf16 ulps of the plain version."""
    from e2enet_tpu_torch.ops import qlink
    dev = _card()
    rng = np.random.RandomState(C + cout)
    shape = (1, 2, 3, 70, C)
    x = (_rand(rng, dev, *shape).bfloat16() if aligned
         else _unaligned(rng, dev, *shape))
    m, o = _rand(rng, dev, 1, C, scale=0.3, shift=1.0), _rand(
        rng, dev, 1, C, scale=0.2)
    k = _rand(rng, dev, C, cout, *stride, scale=(1.0 / C) ** 0.5)
    route = "bulk" if kernel == "uplink_kernel" else "ldg"
    before = dict(qlink.uplink.routes)
    with torch.no_grad():
        names = _device_kernels(lambda: qlink.uplink(x, m, o, k))
    kinds = [n.split("(")[0].split()[-1] for n in names]
    assert [n for n in kinds if "uplink" in n] == ["uplink_image_kernel",
                                                   kernel], names
    assert qlink.uplink.routes[route] == before[route] + 1
    with torch.no_grad():
        y = qlink.uplink(x, m, o, k)
        y_p = qlink.uplink_ref(x, m, o, k)
    assert _within_ulps(y, y_p)


@pytest.mark.cuda
@pytest.mark.parametrize("C,cout,stride", [(96, 48, (2, 2, 2)),
                                           (8, 12, (2, 2, 2)),
                                           (24, 16, (1, 2, 2))])
def test_uplink_image_matches_plain(C, cout, stride):
    """The weights' packing kernel against uplink_image_ref, to the bit."""
    from e2enet_tpu_torch.ops import _native, qlink
    dev = _card()
    rng = np.random.RandomState(C)
    k = _rand(rng, dev, C, cout, *stride).bfloat16()
    ref = qlink.uplink_image_ref(k)
    img = torch.full((ref.numel(),), float("nan"), dtype=torch.bfloat16,
                     device=dev)
    _native.launch_uplink_image(k, img)
    torch.cuda.synchronize()
    assert torch.equal(img.view(ref.shape), ref)


@pytest.mark.cuda
def test_train_step_launches():
    """One train step of a small bf16 model on the card launches each
    kernel as kernel_launches_per_train_step counts, and its loss and
    gradient norm are finite."""
    from e2enet_tpu_torch.models.unetpp import kernel_launches_per_train_step
    from e2enet_tpu_torch.ops import blocks
    from e2enet_tpu_torch.training import train_bench_masks as tb
    dev = _card()
    model, state, step_fn, _, _ = tb.build(dev, base_features=8)
    batches = tb.device_batches(np.random.RandomState(0), 1, 2, (32, 32, 32),
                                model.num_ds_outputs(), dev)
    ops = {**{k: v[0] for k, v in blocks.KERNEL_OPS.items()},
           **{k: v[0] for k, v in blocks.BACKWARD_OPS.items()}}
    for op in ops.values():
        op.launches = 0
    _, metrics = step_fn(state, *batches[0], 0.01)
    torch.cuda.synchronize()
    want = kernel_launches_per_train_step(model)
    total = {k: want["forward"].get(k, 0) + want["backward"].get(k, 0)
             for k in ops}
    assert {k: op.launches for k, op in ops.items()} == total
    assert bool(torch.isfinite(metrics["loss"])) and bool(
        torch.isfinite(metrics["grad_norm"]))


@pytest.mark.cuda
@pytest.mark.parametrize("opt", ["sgd", "ranger", "adam"])
def test_options_step_and_gradient_growth_launches(opt):
    """A train step of each optimizer and a gradient-growth mask update
    (make_grad_step on the batch) on a small bf16 model on the card: each
    launches the kernels as kernel_launches_per_train_step counts, the
    loss is finite, dead rows stay zero in the parameters and in every
    buffer of the optimizer's state, the row counts hold."""
    from e2enet_tpu_torch.models.masks import broadcast_mask
    from e2enet_tpu_torch.models.unetpp import kernel_launches_per_train_step
    from e2enet_tpu_torch.ops import blocks
    from e2enet_tpu_torch.training import train_bench_masks as tb
    dev = _card()
    model, state, step_fn, update, _ = tb.build(
        dev, base_features=8, optimizer=opt, growth="gradient")
    data, targets = tb.device_batches(np.random.RandomState(0), 1, 2,
                                      (32, 32, 32), model.num_ds_outputs(),
                                      dev)[0]
    ops = {**{k: v[0] for k, v in blocks.KERNEL_OPS.items()},
           **{k: v[0] for k, v in blocks.BACKWARD_OPS.items()}}
    want = kernel_launches_per_train_step(model)
    total = {k: want["forward"].get(k, 0) + want["backward"].get(k, 0)
             for k in ops}
    rows = {n: int(m[:, 0].sum()) for n, m in state.masks.items()}
    for op in ops.values():
        op.launches = 0
    state, metrics = step_fn(state, data, targets, 0.01)
    assert {k: op.launches for k, op in ops.items()} == total
    for op in ops.values():
        op.launches = 0
    state = update(state, 0.5, data, targets)
    assert {k: op.launches for k, op in ops.items()} == total
    assert bool(torch.isfinite(metrics["loss"]))
    assert {n: int(m[:, 0].sum()) for n, m in state.masks.items()} == rows
    bufs = ([state.momentum] if isinstance(state.momentum, dict) else
            [v for v in state.momentum if isinstance(v, dict)])
    for n, m in state.masks.items():
        dead = broadcast_mask(1.0 - m, state.params[n])
        for t in [state.params[n].detach()] + [b[n] for b in bufs]:
            assert float((t * dead).abs().max()) == 0.0, n


# ------------------------------------------- the shift off and 2D plans
ONE_GROUP_FLIPS = [(False, False, False), (True, True, False),
                   (True, False, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("D", [1, 3])
def test_one_group_block_and_backward_match_plain(D):
    """The fused block (#1) and its backward (#2/#4) with the shift off,
    one group of shift 0, at depth 1 (a 2D plan's slices) and 3, against
    their plain versions (the tolerances of test_kernel_matches_plain and
    test_block_bwd_matches_plain)."""
    dev = _card()
    parts, affs, kernel, bias = _make(D, 6, D, 16, 32, (48, 48),
                                      (True, False), 48, dev)
    groups = tfb.shift_groups(96, False)
    rng = np.random.RandomState(D)
    for flips in ONE_GROUP_FLIPS:
        before = tfb.fused_shift_conv_block.launches
        with torch.no_grad():
            y, s = tfb.fused_shift_conv_block(parts, kernel, bias, affs,
                                              flips, groups)
            y_p, s_p = tfb.fused_shift_conv_block_ref(parts, kernel, bias,
                                                      affs, flips, groups)
        torch.cuda.synchronize()
        assert tfb.fused_shift_conv_block.launches == before + 1
        assert _within_ulps(y, y_p)
        torch.testing.assert_close(s, s_p, rtol=1e-3,
                                   atol=1e-3 * float(y_p.float().abs().sum()))
        gy = _rand(rng, dev, *y_p.shape, scale=0.1).bfloat16()
        gstats = _rand(rng, dev, 6, 48, 2, scale=1e-4)
        args = (parts, kernel, bias, affs, y_p, gy, gstats, flips, groups)
        gp, gk, gb, ga = tfb.fused_shift_conv_block_bwd(*args)
        rp, rk, rb, ra = tfb.fused_shift_conv_block_bwd_ref(*args)
        torch.cuda.synchronize()
        for g, r in zip(gp, rp):
            assert _within_ulps(g, r)
        assert _close_max(gk, rk, 2e-3) and _close_max(gb, rb, 2e-3)
        assert _close_max(ga[0][0], ra[0][0], 2e-3)
        assert _close_max(ga[0][1], ra[0][1], 2e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [1, 3])
def test_one_group_strided_matches_plain(D):
    """The strided transition (#5) at a 2D plan's stride (1, 2, 2) with
    the shift off, at depth 1 and 3, every flip of test_strided's."""
    from e2enet_tpu_torch.ops import qstride
    dev = _card()
    N, H, W, C, CO = 6, 32, 32, 48, 96
    rng = np.random.RandomState(D + C)
    x = _rand(rng, dev, N, D, H, W, C).bfloat16()
    m, o = _rand(rng, dev, N, C, scale=0.3, shift=1.0), _rand(rng, dev, N, C,
                                                              scale=0.2)
    k = _rand(rng, dev, CO, C, 3, 3, scale=(2.0 / (9 * C)) ** 0.5)
    b = _rand(rng, dev, CO, scale=0.1)
    groups = ((0, C, 0),)
    for flips in FLIPS:
        before = qstride.strided_fused.launches
        with torch.no_grad():
            y, s = qstride.strided_fused(x, m, o, k, b, (1, 2, 2), flips,
                                         groups)
            y_p, s_p = qstride.strided_fused_ref(x, m, o, k, b, (1, 2, 2),
                                                 flips, groups)
        torch.cuda.synchronize()
        assert qstride.strided_fused.launches == before + 1
        assert y.shape == y_p.shape == (N, D, H // 2, W // 2, CO)
        assert _within_ulps(y, y_p)
        torch.testing.assert_close(s, s_p, rtol=1e-3,
                                   atol=1e-3 * float(y_p.float().abs().sum()))


@pytest.mark.cuda
def test_one_group_lazy_block_matches_plain():
    """The lazy up-link block (#3) with the one-group table:
    shiftConvPP_noshift on a 3D plan's level-0 nest node."""
    from e2enet_tpu_torch.ops import qfused
    dev = _card()
    rng = np.random.RandomState(3)
    N, Dc, Hc, Wc, cin, cout, CO = 2, 3, 4, 16, 96, 48, 48
    parts = [_rand(rng, dev, N, 2 * Dc, 2 * Hc, 2 * Wc, 48).bfloat16()]
    affs = [(_rand(rng, dev, N, 48, scale=0.3, shift=1.0),
             _rand(rng, dev, N, 48, scale=0.2))]
    up = qfused.LazyUp(_rand(rng, dev, N, Dc, Hc, Wc, cin).bfloat16(),
                       _rand(rng, dev, N, cin, scale=0.3, shift=1.0),
                       _rand(rng, dev, N, cin, scale=0.2),
                       _rand(rng, dev, cin, cout, 2, 2, 2,
                             scale=(1.0 / cin) ** 0.5))
    kernel = _rand(rng, dev, CO, 96, 3, 3, scale=(2.0 / 864) ** 0.5)
    bias = _rand(rng, dev, CO, scale=0.1)
    for flips in ONE_GROUP_FLIPS:
        with torch.no_grad():
            y, s = qfused.lazy_up_fused_block(parts, up, kernel, bias, affs,
                                              flips, ((0, 96, 0),))
            y_p, s_p = qfused.lazy_up_fused_block_ref(
                parts, up, kernel, bias, affs, flips, ((0, 96, 0),))
        torch.cuda.synchronize()
        assert _within_ulps(y, y_p)
        torch.testing.assert_close(s, s_p, rtol=1e-3,
                                   atol=1e-3 * float(y_p.float().abs().sum()))


@pytest.mark.cuda
def test_downlink_bwd_2d_window_takes_the_scalar_route():
    """#8 at a 2D plan's window (1, 2, 2) runs its scalar kernel."""
    from e2enet_tpu_torch.ops import qlink
    dev = _card()
    rng = np.random.RandomState(12)
    x = _rand(rng, dev, 8, 1, 32, 32, 48).bfloat16()
    m, o = _rand(rng, dev, 8, 48), _rand(rng, dev, 8, 48, scale=0.2)
    gy = _rand(rng, dev, 8, 1, 16, 16, 48).bfloat16()
    qlink.downlink_bwd(x, m, o, gy, (1, 2, 2))
    names = _device_kernels(lambda: qlink.downlink_bwd(x, m, o, gy,
                                                       (1, 2, 2)))
    assert any("downlink_bwd_kernel" in n for n in names), names
    assert not any("downlink_bwd_vec_kernel" in n for n in names), names


def _model_2d(dev, dtype):
    from e2enet_tpu_torch.models.unetpp import ShiftUNetPlusPlus
    m = ShiftUNetPlusPlus(1, 4, ((1, 2, 2),) * 3, base_num_features=16,
                          compute_dtype=dtype, do_shift=False, device=dev)
    m.reset_parameters(seed=0)
    return m


@pytest.mark.cuda
def test_2d_model_kernel_path_matches_plain():
    """A small 2D model (depth 1, three (1, 2, 2) pools, no shift, bf16) on
    the card: a forward launches each kernel as
    kernel_launches_per_forward counts (the materialised route) and its
    logits are no further from a float32 plain run than 1.25x the bf16
    plain path's; one train step launches as
    kernel_launches_per_train_step counts, and its gradients are no
    further from the float32 plain run's than 1.25x the plain path's."""
    from e2enet_tpu_torch.models.unetpp import (
        ds_loss_weights, kernel_launches_per_forward,
        kernel_launches_per_train_step)
    from e2enet_tpu_torch.ops import blocks
    from e2enet_tpu_torch.ops.losses import deep_supervision_loss
    from e2enet_tpu_torch.training import train_bench_masks as tb
    dev = _card()
    model, model32 = _model_2d(dev, torch.bfloat16), _model_2d(
        dev, torch.float32)
    assert not model.lazy_up_route()
    n_out = model.num_ds_outputs()
    v, ts = tb.make_batch(np.random.RandomState(0), 8, (1, 64, 64), 4,
                          tb.ds_factors(model.pools, n_out))
    data = torch.from_numpy(v).to(dev)
    targets = [torch.from_numpy(t).to(dev) for t in ts]
    ops = {**{k: v[0] for k, v in blocks.KERNEL_OPS.items()},
           **{k: v[0] for k, v in blocks.BACKWARD_OPS.items()}}
    for op in ops.values():
        op.launches = 0
    with torch.no_grad():
        lk = model(data, do_ds=False)
        assert {k: ops[k].launches for k in blocks.KERNEL_OPS} == \
            kernel_launches_per_forward(model)
        with blocks.plain_ops():
            lp = model(data, do_ds=False)
            l32 = model32(data, do_ds=False)
    e_k = float((lk - l32).abs().mean())
    e_p = float((lp - l32).abs().mean())
    assert e_k <= 1.25 * e_p, (e_k, e_p)
    weights = ds_loss_weights(3, n_out)

    def grads(net):
        loss = deep_supervision_loss(net(data, do_ds=True), targets, weights,
                                     batch_dice=False)
        g = torch.autograd.grad(loss, list(net.parameters()),
                                allow_unused=True)
        return torch.cat([(torch.zeros_like(p) if x is None else x).float()
                          .flatten() for x, p in zip(g, net.parameters())])
    for op in ops.values():
        op.launches = 0
    g_k = grads(model)
    want = kernel_launches_per_train_step(model)
    assert {k: op.launches for k, op in ops.items()} == {
        k: want["forward"].get(k, 0) + want["backward"].get(k, 0)
        for k in ops}
    with blocks.plain_ops():
        g_p = grads(model)
        g_32 = grads(model32)
    assert bool(torch.isfinite(g_k).all())
    e_k = float((g_k - g_32).norm() / g_32.norm())
    e_p = float((g_p - g_32).norm() / g_32.norm())
    assert e_k <= 1.25 * e_p, (e_k, e_p)


# ------------------------------------------------- the experiment kernels
from e2enet_tpu_torch.experiments import exp_cf_fused as tcf  # noqa: E402
from e2enet_tpu_torch.experiments import exp_int8_mma as tim  # noqa: E402
from e2enet_tpu_torch.experiments import exp_pipeline_fwd as tpf  # noqa: E402
from e2enet_tpu_torch.experiments import shift_conv as tsc  # noqa: E402

# (N, D, H, W, C, CO): the ring's and the channels-first block's cases
RING = {
    "c48": (1, 9, 16, 32, 48, 48),
    "d3_w13_c8": (2, 3, 5, 13, 8, 8),
    "c1": (2, 4, 8, 16, 1, 5),
    "c24_co56": (1, 5, 9, 20, 24, 56),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(RING))
def test_ring_shift_conv_matches_plain(case):
    dev = _card()
    N, D, H, W, C, CO = RING[case]
    rng = np.random.RandomState(11)
    x = _rand(rng, dev, N, D, H, W, C).bfloat16()
    k = _rand(rng, dev, CO, C, 3, 3, scale=(2.0 / (9 * C)) ** 0.5)
    b = _rand(rng, dev, CO, scale=0.1)
    before = (tsc.fused_shift_conv.launches, tsc.depth_shift_ring.launches)
    with torch.no_grad():
        y = tsc.fused_shift_conv(x, k, b)
        s = tsc.depth_shift_ring(x)
    torch.cuda.synchronize()
    assert (tsc.fused_shift_conv.launches,
            tsc.depth_shift_ring.launches) == (before[0] + 1, before[1] + 1)
    assert _within_ulps(y, tsc.fused_shift_conv_ref(x, k, b))
    assert torch.equal(s, tsc.depth_shift_ring_ref(x))
    # the shift's backward: the ring kernel with the shifts negated
    xg = x.clone().requires_grad_()
    g = _rand(rng, dev, N, D, H, W, C).bfloat16()
    tsc.depth_shift_ring(xg).backward(g)
    assert tsc.depth_shift_ring.launches == before[1] + 3
    from e2enet_tpu_torch.ops.shift import depth_shift_groups, mirror_groups
    assert torch.equal(xg.grad, depth_shift_groups(
        g, mirror_groups(tsc.ring_groups(C, 5))))


# the ring shift + conv's routes: (N, D, H, W, C, CO, the route the rule
# gives). TMA: the main shape, N = 2, D of 1-3 (depth rows outside the
# volume from TMA's zero fill), H and W off the 8 x 16 tile, C = 8 and 40
# (K rows past C zero in A and B), CO < 48; the first design (cp.async):
# C = 1 and 24 (groups of 5: odd edges), CO = 56 and 12 (not one n48 tile)
RING_ROUTE = {
    "main": (1, 128, 128, 128, 48, 48, "tma"),
    "n2": (2, 5, 16, 32, 48, 48, "tma"),
    "d1": (1, 1, 8, 16, 48, 48, "tma"),
    "d2_co40": (2, 2, 9, 20, 48, 40, "tma"),
    "d3_h13_w37": (1, 3, 13, 37, 48, 48, "tma"),
    "h21_w45_c40_co24": (1, 6, 21, 45, 40, 24, "tma"),
    "c8": (2, 4, 8, 16, 8, 8, "tma"),
    "c16_w9": (1, 4, 7, 9, 16, 16, "tma"),
    "c1": (2, 4, 8, 16, 1, 5, "cp_async"),
    "c24": (1, 5, 9, 20, 24, 40, "cp_async"),
    "co56": (1, 3, 8, 16, 48, 56, "cp_async"),
    "co12": (1, 3, 8, 16, 48, 12, "cp_async"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(RING_ROUTE))
def test_ring_shift_conv_route(case):
    """The route the rule gives, counted, within 2 bf16 steps of the plain
    version; on the TMA route's shapes also the first design (the control,
    route="cp_async")."""
    dev = _card()
    N, D, H, W, C, CO, route = RING_ROUTE[case]
    rng = np.random.RandomState(13)
    x = _rand(rng, dev, N, D, H, W, C).bfloat16()
    k = _rand(rng, dev, CO, C, 3, 3, scale=(2.0 / (9 * C)) ** 0.5)
    b = _rand(rng, dev, CO, scale=0.1)
    routes = dict(tsc.fused_shift_conv.routes)
    with torch.no_grad():
        y = tsc.fused_shift_conv(x, k, b)
        y_p = tsc.fused_shift_conv_ref(x, k, b)
        torch.cuda.synchronize()
        routes[route] += 1
        assert tsc.fused_shift_conv.routes == routes
        assert _within_ulps(y, y_p)
        if route == "tma":
            y_c = tsc.fused_shift_conv(x, k, b, route="cp_async")
            torch.cuda.synchronize()
            routes["cp_async"] += 1
            assert tsc.fused_shift_conv.routes == routes
            assert _within_ulps(y_c, y_p)
        else:                           # the TMA route refuses the shape
            with pytest.raises((RuntimeError, ValueError)):
                tsc.fused_shift_conv(x, k, b, route="tma")


# the channels-first block's cases: the ring's, and two column tiles of 64
# with a ragged last one (and ragged row tiles); the route each takes (TMA:
# W % 8 == 0 and CO <= 48)
CF = dict(RING, w72_h7=(1, 5, 7, 72, 48, 48))
CF_ROUTE = {"c48": "tma", "c1": "tma", "w72_h7": "tma", "d3_w13_c8": "ldg",
            "c24_co56": "ldg"}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CF))
@pytest.mark.parametrize("affine,stats", [(False, False), (True, True),
                                          (True, False), (False, True)])
def test_cf_fused_matches_plain(case, affine, stats):
    dev = _card()
    N, D, H, W, C, CO = CF[case]
    rng = np.random.RandomState(12)
    x = _rand(rng, dev, N, D, C, H * W).bfloat16()
    k = _rand(rng, dev, CO, C, 3, 3, scale=(2.0 / (9 * C)) ** 0.5)
    b = _rand(rng, dev, CO, scale=0.1)
    m, o = ((_rand(rng, dev, C, scale=0.5, shift=1.0),
             _rand(rng, dev, C, scale=0.1)) if affine else (None, None))
    before = tcf.cf_fused_shift_conv.launches
    routes = dict(tcf.cf_fused_shift_conv.routes)
    with torch.no_grad():
        y, st = tcf.cf_fused_shift_conv(x, k, b, H, W, m, o, stats)
        y_p, st_p = tcf.cf_fused_shift_conv_ref(x, k, b, H, W, m, o, stats)
    torch.cuda.synchronize()
    assert tcf.cf_fused_shift_conv.launches == before + 1
    routes[CF_ROUTE[case]] += 1
    assert tcf.cf_fused_shift_conv.routes == routes
    assert _within_ulps(y.transpose(2, 3), y_p.transpose(2, 3))
    if stats:
        torch.testing.assert_close(st, st_p, rtol=0,
                                   atol=1e-4 * float(st_p.abs().max()))
    else:
        assert st is None and st_p is None


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype", [((8, 16, 48), torch.float32),
                                         ((5, 13, 3), torch.bfloat16)])
def test_reshape_hwc_matches_plain(shape, dtype):
    dev = _card()
    H, W, C = shape
    x = torch.arange(H * W * C, device=dev).reshape(H, W * C).to(dtype)
    before = tcf.reshape_hwc.launches
    y = tcf.reshape_hwc(x, C)
    torch.cuda.synchronize()
    assert tcf.reshape_hwc.launches == before + 1
    assert torch.equal(y, tcf.reshape_hwc_ref(x, C))


# (N, D, H, W, part channels, pending affine per part, CO)
PIPE = {
    "l0_48+48": (1, 6, 16, 64, (48, 48), (True, True), 48),
    "ragged_w13": (2, 3, 6, 13, (5, 3), (True, False), 7),
    "d2_c1": (2, 2, 8, 16, (1,), (False,), 48),
    "co112": (1, 3, 4, 32, (16, 24), (False, True), 112),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(PIPE))
def test_pipelined_block_matches_kernel1(case):
    dev = _card()
    parts, affs, kernel, bias = _make(13, *PIPE[case], dev)
    before = tpf.pipelined_fused_block.launches
    with torch.no_grad():
        y, s = tpf.pipelined_fused_block(parts, kernel, bias, affs)
        y1, s1 = tfb.fused_shift_conv_block(parts, kernel, bias, affs)
    torch.cuda.synchronize()
    assert tpf.pipelined_fused_block.launches == before + 1
    assert tpf.pipelined_fused_block.stages in (2, 4)
    # #13 runs #1's wgmma body on the same K chunks at every case here
    # (one chunk of C rounded up to 16, or 48-channel chunks): the same
    # products in the same order, equal to the bit. Where the chunks
    # differed, the f32 sums would come in another order, which moves a
    # bf16 value by one step at most
    assert torch.equal(y, y1)
    assert _within_ulps(y, y1, ulps=1.0)
    torch.testing.assert_close(s, s1, rtol=1e-4,
                               atol=1e-4 * float(s1.abs().max()))
    with torch.no_grad():                           # the control: no overlap
        y_s, s_s = tpf.pipelined_fused_block(parts, kernel, bias, affs,
                                             overlap=False)
    torch.cuda.synchronize()
    assert tpf.pipelined_fused_block.stages == 1
    assert torch.equal(y_s, y)                      # the same loop's sums
    torch.testing.assert_close(s_s, s1, rtol=1e-4,
                               atol=1e-4 * float(s1.abs().max()))


def _gemm_route(M, N, K, dtype):
    """The route #14 takes by shape (contiguous, aligned operands)."""
    if dtype == torch.int8:
        return "wgmma" if K % 16 == 0 else "mma_sync"
    return "wgmma" if K % 8 == 0 and N % 8 == 0 else "mma_sync"


@pytest.mark.cuda
@pytest.mark.parametrize("mnk", [(256, 128, 64), (200, 136, 272),
                                 (33, 50, 100), (7, 9, 3), (512, 1024, 768),
                                 (300, 264, 208)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8])
def test_mma_gemm_matches_plain(mnk, dtype):
    """#14 against its plain version on the route its shape takes (wgmma
    fed by TMA where TMA describes the operands, counted per route), and
    its mma.sync control: int8 equal to the bit, bf16 within 1e-3 of the
    largest |value| (float32 sums in another order)."""
    dev = _card()
    M, N, K = mnk
    gen = torch.Generator(device=dev).manual_seed(M + N + K)
    if dtype == torch.int8:
        a = torch.randint(-128, 128, (M, K), generator=gen, device=dev,
                          dtype=torch.int8)
        b = torch.randint(-128, 128, (K, N), generator=gen, device=dev,
                          dtype=torch.int8)
    else:
        a = torch.randn((M, K), generator=gen, device=dev).to(dtype)
        b = torch.randn((K, N), generator=gen, device=dev).to(dtype)
    before = tim.mma_gemm.launches
    routes = dict(tim.mma_gemm.routes)
    route = _gemm_route(M, N, K, dtype)
    c = tim.mma_gemm(a, b)
    ref = tim.mma_gemm_ref(a, b)
    torch.cuda.synchronize()
    assert tim.mma_gemm.launches == before + 1
    assert tim.mma_gemm.routes[route] == routes[route] + 1
    c_ctl = tim.mma_gemm(a, b, wgmma=False)
    torch.cuda.synchronize()
    assert tim.mma_gemm.routes["mma_sync"] == routes["mma_sync"] + 1 + (
        route == "mma_sync")
    for out in (c, c_ctl):
        if dtype == torch.int8:
            assert out.dtype == torch.int32 and torch.equal(out, ref)
        else:
            assert out.dtype == torch.float32
            assert float((out - ref).abs().max()) <= 1e-3 * float(
                ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("kn", [(64, 64), (208, 264), (4096, 4096),
                                (32, 9)])
def test_mma_gemm_repack(kn):
    """The wgmma route's int8 repack alone: b (K, N) -> its transpose."""
    from e2enet_tpu_torch.ops import _native
    dev = _card()
    K, N = kn
    gen = torch.Generator(device=dev).manual_seed(K + N)
    b = torch.randint(-128, 128, (K, N), generator=gen, device=dev,
                      dtype=torch.int8)
    bt = torch.empty((N, K), dtype=torch.int8, device=dev)
    _native.launch_mma_gemm_repack(b, bt)
    torch.cuda.synchronize()
    assert torch.equal(bt, b.t().contiguous())


@pytest.mark.cuda
def test_experiment_wrappers_raise():
    dev = _card()
    x = torch.randn(1, 3, 4, 16, 8, device=dev)
    with pytest.raises(TypeError):                  # float32 on the card
        tsc.fused_shift_conv(x, torch.randn(8, 8, 3, 3, device=dev),
                             torch.zeros(8, device=dev))
    with pytest.raises(TypeError):
        tsc.depth_shift_ring(x)
    with pytest.raises(ValueError):                 # shifts beyond the ring
        tsc.depth_shift_ring(x.bfloat16(), 7)
    with pytest.raises(TypeError):
        tim.mma_gemm(torch.randn(4, 4, device=dev),
                     torch.randn(4, 4, device=dev))


@pytest.mark.cuda
def test_anisotropic_plan_forward_launches_and_matches_plain():
    """models/unetpp.build_network on an anisotropic plan (pools (1, 2, 2),
    (2, 2, 2), (2, 2, 2)), as folder prediction builds it: the level-0
    up-links take the materialised route (#6 at stride (1, 2, 2), then #1),
    the level-1 nodes' down-links #7 the (1, 2, 2) window. One mirrored
    forward launches each kernel as kernel_launches_per_forward counts, and
    its logits are as close to a float32 plain run as the bf16 plain path's
    (mean |dlogit| within 1.25x, chip_smoke.py's rule for one patch)."""
    from e2enet_tpu_torch import plans
    from e2enet_tpu_torch.models import unetpp
    from e2enet_tpu_torch.ops import blocks
    dev = _card()
    stage = plans.StagePlan(
        batch_size=2, num_pool_per_axis=[2, 3, 3], patch_size=[16, 64, 64],
        median_patient_size_in_voxels=[16, 64, 64],
        current_spacing=[2.5, 0.8, 0.8], original_spacing=[2.5, 0.8, 0.8],
        do_dummy_2D_data_aug=False,
        pool_op_kernel_sizes=[[1, 2, 2], [2, 2, 2], [2, 2, 2]],
        conv_kernel_sizes=[[1, 3, 3]] * 4)
    net = unetpp.build_network(stage, 1, 5, base_num_features=16,
                               device=dev)
    net.reset_parameters(seed=3)
    net32 = unetpp.build_network(stage, 1, 5, base_num_features=16,
                                 compute_dtype=torch.float32, device=dev)
    net32.load_state_dict(net.state_dict())
    assert not net.lazy_up_route()
    want = unetpp.kernel_launches_per_forward(net)
    assert want["uplink"] == 3 and want["downlink"] == 2
    x = _rand(np.random.RandomState(4), dev, 1, 16, 64, 64, 1)
    ops = {name: op for name, (op, _) in blocks.KERNEL_OPS.items()}
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    with torch.no_grad():
        before = {n: op.launches for n, op in ops.items()}
        k = net(x, do_ds=False, flips=(True, False, True)).float()
        got = {n: op.launches - before[n] for n, op in ops.items()}
        with blocks.plain_ops():
            p = net(x, do_ds=False, flips=(True, False, True)).float()
            f = net32(x, do_ds=False, flips=(True, False, True))
    assert got == want
    assert bool(torch.isfinite(k).all())
    e_k, e_p = (k - f).abs().mean(), (p - f).abs().mean()
    assert float(e_k) <= 1.25 * float(e_p)


@pytest.mark.cuda
@pytest.mark.parametrize("tconv, switches", [
    ("shiftConvPP", dict(num_conv_per_stage=3, seg_bias=True,
                         base_num_features=24)),
    ("shiftConvPP", dict(norm_op="batch", nonlin="relu")),
    ("shiftConvPP", dict(conv_kernel=(3, 3, 3))),
    ("ori", {}), ("resenc", dict(base_num_features=24))],
    ids=["3conv_seg_bias_b24", "bn_relu", "allConv3x3", "ori", "resenc"])
def test_arch_networks_launch_as_counted(tconv, switches):
    """The networks of the architecture switches on the card: one bf16
    forward and backward (do_ds) launch each kernel as
    kernel_launches_per_train_step counts (every count 0 off the kernel
    route: the materialised networks launch nothing), with finite logits
    and gradients; the bf16 forward as close to a float32 run of the same
    weights as the plain bf16 run is (mean |dlogit| within 1.25x)."""
    from e2enet_tpu_torch import plans
    from e2enet_tpu_torch.models import unetpp
    from e2enet_tpu_torch.ops import blocks
    dev = _card()
    stage = plans.StagePlan(
        batch_size=2, num_pool_per_axis=[3, 3, 3], patch_size=[32, 32, 32],
        median_patient_size_in_voxels=[32, 32, 32],
        current_spacing=[1.0] * 3, original_spacing=[1.0] * 3,
        do_dummy_2D_data_aug=False, pool_op_kernel_sizes=[[2, 2, 2]] * 3,
        conv_kernel_sizes=[[1, 3, 3]] * 4)
    kw = {"base_num_features": 8, **switches}
    net = unetpp.build_network(stage, 1, 3, tconv=tconv, device=dev, **kw)
    net.reset_parameters(3)
    net32 = unetpp.build_network(stage, 1, 3, tconv=tconv, device=dev,
                                 compute_dtype=torch.float32, **kw)
    net32.load_state_dict(net.state_dict())
    ops = {**{k: v[0] for k, v in blocks.KERNEL_OPS.items()},
           **{k: v[0] for k, v in blocks.BACKWARD_OPS.items()}}
    x = _rand(np.random.RandomState(4), dev, 2, 32, 32, 32, 1)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    for op in ops.values():
        op.launches = 0
    outs = net(x, do_ds=True)
    sum(o.float().square().mean() for o in outs).backward()
    torch.cuda.synchronize()
    want = unetpp.kernel_launches_per_train_step(net)
    total = {k: want["forward"].get(k, 0) + want["backward"].get(k, 0)
             for k in ops}
    assert {k: op.launches for k, op in ops.items()} == total
    assert (sum(total.values()) > 0) == net.kernel_route()
    assert all(bool(torch.isfinite(p.grad).all()) for p in net.parameters()
               if p.grad is not None)
    with torch.no_grad():
        k = net(x, do_ds=False).float()
        with blocks.plain_ops():
            p = net(x, do_ds=False).float()
            f = net32(x, do_ds=False)
    assert bool(torch.isfinite(k).all())
    e_k, e_p = (k - f).abs().mean(), (p - f).abs().mean()
    assert float(e_k) <= 1.25 * float(e_p)


def _grasp_setup(dev, dtype):
    from e2enet_tpu_torch.models.unetpp import ShiftUNetPlusPlus
    net = ShiftUNetPlusPlus(1, 3, ((2, 2, 2),) * 3, base_num_features=8,
                            compute_dtype=dtype, device=dev)
    net.reset_parameters(seed=7)
    rng = np.random.RandomState(8)
    x = _rand(rng, dev, 1, 16, 16, 16, 1)
    t = torch.from_numpy(rng.randint(0, 3, (1, 16, 16, 16))).long().to(dev)
    return net, x, t


def _grasp_loss(model, x, t):
    from e2enet_tpu_torch.ops.losses import dc_and_ce_loss
    return dc_and_ce_loss(model(x, do_ds=False), t)


@pytest.mark.cuda
def test_double_backward_through_the_kernels_refuses():
    """The bf16 model on its kernels (the lazy up-link route, the block
    and down-link backward kernels): a first-order gradient runs, a double
    backward (create_graph=True) raises instead of dropping terms."""
    from e2enet_tpu_torch.models.masks import masked_params
    net, x, t = _grasp_setup(_card(), torch.bfloat16)
    assert net.lazy_up_route()
    ws = list(masked_params(net).values())
    loss = _grasp_loss(net, x, t)
    g = torch.autograd.grad(loss, ws, retain_graph=True)
    assert all(bool(torch.isfinite(v).all()) for v in g)
    with pytest.raises(RuntimeError, match="double backward"):
        torch.autograd.grad(loss, ws, create_graph=True)


@pytest.mark.cuda
def test_grasp_on_the_card_matches_the_cpu():
    """init_masks_grasp on the card takes the plain path (no kernel
    launched) and gives the CPU run's scores within 1e-4 of the largest
    |score| (float32, no TF32), its masks equal but where a score lies
    within that tolerance of the threshold."""
    from e2enet_tpu_torch.ops import blocks
    from e2enet_tpu_torch.training import dsff
    dev = _card()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    net, x, t = _grasp_setup(dev, torch.float32)
    cpu, xc, tc = _grasp_setup("cpu", torch.float32)
    cpu.load_state_dict({k: v.cpu() for k, v in net.state_dict().items()})
    xc, tc = x.cpu(), t.cpu()
    ops = {n: op for n, (op, _) in list(blocks.KERNEL_OPS.items())
           + list(blocks.BACKWARD_OPS.items())}
    before = {n: op.launches for n, op in ops.items()}
    s_card = dsff.grasp_scores(_grasp_loss, net, x, t)
    m_card = dsff.init_masks_grasp(_grasp_loss, net, 0.3, x, t)
    assert all(op.launches == before[n] for n, op in ops.items())
    s_cpu = dsff.grasp_scores(_grasp_loss, cpu, xc, tc)
    m_cpu = dsff.init_masks_grasp(_grasp_loss, cpu, 0.3, xc, tc)
    scale = max(float(s.abs().max()) for s in s_cpu.values())
    flat = torch.cat([s.reshape(-1) for _, s in sorted(s_cpu.items())])
    thr = torch.sort(flat, descending=True).values[
        int(flat.numel() * 0.7) - 1]
    for n, s in s_cpu.items():
        assert float((s_card[n].cpu() - s).abs().max()) <= 1e-4 * scale, n
        diff = m_card[n].cpu() != m_cpu[n]
        near = (s - thr).abs() <= 1e-4 * scale
        assert not bool((diff & ~near).any()), n


@pytest.mark.cuda
@pytest.mark.parametrize("target", [(40, 48, 32), (10, 12, 8), (27, 17, 21),
                                    (20, 24, 16)])
def test_amos2022_resample_on_the_card_matches_the_cpu(target):
    """inference/amos2022's resize on the card (a 2x upsample, a 2x
    downsample, a mixed target, the identity) within 1e-5 of its CPU run,
    float32 with TF32 on outside the call (the resize turns it off while
    it runs); the labels equal where the CPU run's top two differ by more
    than 1e-4; "nearest" equal to the bit."""
    from e2enet_tpu_torch.inference import amos2022
    dev = _card()
    rng = np.random.RandomState(0)
    logits = 2.0 * rng.randn(16, 20, 24, 16).astype(np.float32)
    x = np.exp(logits - logits.max(0))
    x /= x.sum(0)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        card = amos2022.resize_softmax(x, target, device=dev)
        seg = amos2022.resample_softmax_on_device(x, target, device=dev)
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    cpu = amos2022.resize_softmax(x, target, device="cpu")
    assert card.device.type == "cuda" and card.dtype == torch.float32
    assert float((card.cpu() - cpu).abs().max()) <= 1e-5
    top2 = torch.topk(cpu, 2, dim=0).values
    sure = (top2[0] - top2[1]) > 1e-4
    want = amos2022.resample_softmax_on_device(x, target, device="cpu")
    assert seg.dtype == np.uint8 and seg.shape == tuple(target)
    assert (seg == want)[sure.numpy()].all()
    near = amos2022.resize_softmax(x, target, "nearest", device=dev)
    assert torch.equal(near.cpu(), amos2022.resize_softmax(
        x, target, "nearest", device="cpu"))


@pytest.mark.cuda
@pytest.mark.parametrize("C, in_patch, patch", [
    (1, (40, 44, 48), (32, 32, 32)), (2, (40, 44, 48), (32, 32, 32)),
    (1, (30, 52, 61), (1, 40, 40))])
def test_device_augment_on_the_card_matches_the_cpu(C, in_patch, patch):
    """ops/device_augment.apply on the card against its CPU run on the same
    params (rotation and scaling forced on, every other transform on) and
    noise: data within 1e-5 (the coordinates and the warp are the same
    float32 arithmetic; the contrast's and the gamma's reductions sum in
    another order), the labels equal; make_device_augmenter's function on
    the card: channels-last data and int64 targets there."""
    import dataclasses
    from e2enet_tpu_torch.ops import device_augment as da
    dev = _card()
    B = 2
    rng = np.random.RandomState(C)
    data = torch.from_numpy(rng.randn(B, C, *in_patch).astype(np.float32))
    seg = torch.from_numpy(rng.randint(-1, 4, (B,) + in_patch)
                           .astype(np.int8))
    p = da.sample_params(torch.Generator().manual_seed(0), B, C, patch,
                         p_rot=1.0, p_scale=1.0)
    on = np.ones(B, bool)
    p = dataclasses.replace(p, noise=on, blur=np.ones((B, C), bool),
                            bright=on, contrast=on, gamma_inv=on, gamma=on)
    noise = torch.randn((B, C) + patch,
                        generator=torch.Generator().manual_seed(1))
    d_cpu, s_cpu = da.apply(p, data, seg, noise)
    d_card, s_card = da.apply(p, data.to(dev), seg.to(dev), noise.to(dev))
    assert d_card.device.type == "cuda" and s_card.dtype == torch.int8
    assert float((d_card.cpu() - d_cpu).abs().max()) <= 1e-5
    assert torch.equal(s_card.cpu(), s_cpu)
    ds = [[1, 1, 1], [0.5, 0.5, 0.5]]
    aug = da.make_device_augmenter(patch, in_patch, 4, ds)
    d, targets = aug(torch.Generator().manual_seed(2),
                     torch.Generator(device=dev).manual_seed(2),
                     data.to(dev), seg.to(dev))
    assert d.device.type == "cuda" and d.shape == (B,) + patch + (C,)
    assert bool(torch.isfinite(d).all())
    assert [tuple(t.shape) for t in targets] == [
        (B,) + patch, (B,) + tuple((x + 1) // 2 for x in patch)]
    assert all(t.dtype == torch.int64 and t.device.type == "cuda"
               for t in targets)


# ---------------------------------------------------------------------------
# halo mode (spatial parallelism): an H slab with its neighbour rows

# (N, D, H of the slab, W, part channels, pending affine per part, CO): the
# 16-byte, pair and scalar staging units, parts with and without a norm,
# both tile sizes (CO 48 and 96), tiles that end inside the slab
HALO = {
    "l0_width": (1, 4, 16, 64, (48, 48), (True, False), 48),
    "l1_width": (2, 3, 8, 32, (96, 96, 48), (True, False, False), 96),
    "ragged": (2, 5, 6, 13, (5, 3), (True, False), 7),
    "rows_10": (1, 3, 10, 32, (16, 8), (False, True), 24),
}
HALO_SIDES = ("top", "bottom", "both")


def _slab(whole, top, bottom):
    """(the slab of `whole` between its halo rows, the row above or None,
    the row below or None, the slab's first row)."""
    t0 = 1 if top else 0
    H = whole.shape[2] - t0 - (1 if bottom else 0)
    return (whole[:, :, t0:t0 + H].contiguous(),
            whole[:, :, :1].contiguous() if top else None,
            whole[:, :, -1:].contiguous() if bottom else None, t0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(HALO))
@pytest.mark.parametrize("side", HALO_SIDES)
def test_fused_block_halo_matches_plain(case, side):
    """#1 with halo rows (raw, read through each part's norm) against its
    plain version with the same rows, and against the rows of the kernel
    on the whole H (the slab and its rows): y within one bf16 step of the
    whole-H kernel's rows, two of the plain version's; the statistics the
    slab's own."""
    dev = _card()
    N, D, H, W, part_c, affine, CO = HALO[case]
    top, bottom = side in ("top", "both"), side in ("bottom", "both")
    wholes, affs, kernel, bias = _make(len(case), N, D, H + top + bottom, W,
                                       part_c, affine, CO, dev)
    split = [_slab(w, top, bottom) for w in wholes]
    parts, t0 = [s[0] for s in split], split[0][3]
    halos = ([s[1] for s in split], [s[2] for s in split])
    before = tfb.fused_shift_conv_block.launches
    with torch.no_grad():
        y, s = tfb.fused_shift_conv_block(parts, kernel, bias, affs,
                                          halos=halos)
        y_p, s_p = tfb.fused_shift_conv_block_ref(parts, kernel, bias, affs,
                                                  halos=halos)
        y_w, _ = tfb.fused_shift_conv_block(wholes, kernel, bias, affs)
    torch.cuda.synchronize()
    assert tfb.fused_shift_conv_block.launches == before + 2
    assert _within_ulps(y, y_p)
    assert _within_ulps(y, y_w[:, :, t0:t0 + H], 1.0)
    torch.testing.assert_close(s, s_p, rtol=1e-3,
                               atol=1e-3 * float(y_p.float().abs().sum()))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["l0_width", "l1_width", "ragged"])
@pytest.mark.parametrize("side", HALO_SIDES)
def test_block_bwd_halo_matches_plain(case, side):
    """#2/#4 on an H slab: the forward's halo rows and the neighbours' y
    and gy rows, against the plain version with the same rows (gx within
    two bf16 steps, gW, gb and g(affine) within 2e-3), and gx against the
    rows of the whole-H backward (within one step: the slab's whole
    gradient)."""
    dev = _card()
    N, D, H, W, part_c, affine, CO = HALO[case]
    top, bottom = side in ("top", "both"), side in ("bottom", "both")
    wholes, kernel, bias, affs, y_w, gy_w, gstats = _bwd_inputs(
        len(case), N, D, H + top + bottom, W, part_c, affine, CO, dev)
    split = [_slab(w, top, bottom) for w in wholes]
    parts, t0 = [s[0] for s in split], split[0][3]
    halos = ([s[1] for s in split], [s[2] for s in split])
    y, gy = (t[:, :, t0:t0 + H].contiguous() for t in (y_w, gy_w))
    edge = ((y_w[:, :, :1].contiguous(), gy_w[:, :, :1].contiguous())
            if top else None,
            (y_w[:, :, -1:].contiguous(), gy_w[:, :, -1:].contiguous())
            if bottom else None)
    args = (parts, kernel, bias, affs, y, gy, gstats)
    gp, gk, gb, ga = tfb.fused_shift_conv_block_bwd(*args, halos=halos,
                                                    edge_rows=edge)
    rp, rk, rb, ra = tfb.fused_shift_conv_block_bwd_ref(*args, halos=halos,
                                                        edge_rows=edge)
    wp, _, _, _ = tfb.fused_shift_conv_block_bwd(wholes, kernel, bias, affs,
                                                 y_w, gy_w, gstats)
    torch.cuda.synchronize()
    for g, r, w in zip(gp, rp, wp):
        assert _within_ulps(g, r)
        assert _within_ulps(g, w[:, :, t0:t0 + H], 1.0)
    assert _close_max(gk, rk, 2e-3) and _close_max(gb, rb, 2e-3)
    for g, r in zip(ga, ra):
        if g is not None:
            assert _close_max(g[0], r[0], 2e-3)
            assert _close_max(g[1], r[1], 2e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("case,flipped", [("even", False), ("ragged", False),
                                          ("even", True), ("ragged", True)])
def test_strided_halo_matches_plain(case, flipped):
    """#5 on an H slab of even rows: its top row (its bottom row on a
    mirrored H, whose windows reach row H) through the norm, against its
    plain version with the same row and against the rows of the kernel on
    the whole H."""
    from e2enet_tpu_torch.ops import qstride
    dev = _card()
    N, D, H, W, C, CO, stride = STRIDED[case]
    H = 2 * max(H // 2, 2)
    rng = np.random.RandomState(D + C + 1)
    whole = _rand(rng, dev, N, D, H + 2, W, C).bfloat16()
    if flipped:        # the slab's rows 0..H, the row below, one more
        x, up, down = (whole[:, :, :H].contiguous(), None,
                       whole[:, :, H:H + 1].contiguous())
        rows = slice(0, H // 2)
    else:              # one more, the row above, the slab's rows
        x, up, down = (whole[:, :, 2:].contiguous(),
                       whole[:, :, 1:2].contiguous(), None)
        rows = slice(1, None)
    flips = (False, flipped, False)
    m, o = _rand(rng, dev, N, C, scale=0.3, shift=1.0), _rand(rng, dev, N, C,
                                                              scale=0.2)
    k = _rand(rng, dev, CO, C, 3, 3, scale=(2.0 / (9 * C)) ** 0.5)
    b = _rand(rng, dev, CO, scale=0.1)
    args = (x, m, o, k, b, stride, flips, None, (up, down))
    with torch.no_grad():
        y, s = qstride.strided_fused(*args)
        y_p, s_p = qstride.strided_fused_ref(*args)
        y_w, _ = qstride.strided_fused(whole, m, o, k, b, stride, flips)
    torch.cuda.synchronize()
    assert _within_ulps(y, y_p)
    assert _within_ulps(y, y_w[:, :, rows], 1.0)
    torch.testing.assert_close(s, s_p, rtol=1e-3,
                               atol=1e-3 * float(y_p.float().abs().sum()))
