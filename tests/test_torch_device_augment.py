"""The port's on-device augmentation (e2enet_tpu_torch/ops/device_augment.py)
against the JAX package's (e2enet_tpu/ops/device_augment.py) on the CPU, at
small sizes, inputs seeded with numpy.

The pieces against the JAX private functions: the rotation, the affine
given its draws, the source coordinates and the center crop within 1e-6;
the resample at order 0 equal and at order 1 within 1e-6, on coordinates
exactly at .5 and -0.5 and past both edges; the blur within 1e-6. The
whole chain against make_device_augmenter: the test replays the JAX draws
from each key, following aug_one's own splits, builds the port's params
from them and passes JAX's noise in; data within 1e-5 absolute (gamma's
power included), targets equal at every scale but where JAX's source
coordinate lies within 1e-4 of a .5 (those that differ counted and
bounded: at most 1 % of the warped voxels), at a 3D shape
and at a 2D plan's (patch depth 1). Every switch of the chain is on for
some sample of those batches. The port's own draws (sample_params) over
20k samples: every probability within 4 binomial sigma, every range
respected, the switches off where the arguments turn them off, the same
params from the same seed.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from e2enet_tpu.ops import device_augment as jda  # noqa: E402
from e2enet_tpu_torch.ops import device_augment as tda  # noqa: E402

ATOL = 1e-6
DATA_ATOL = 1e-5
TIE = 1e-4           # a source coordinate this close to a .5 may round apart
TIE_SHARE = 0.01     # at most this share of warped target voxels differ
DS = [[1, 1, 1], [0.5, 0.5, 0.5], [0.25, 0.25, 0.25]]
DS_2D = [[1, 1, 1], [1, 0.5, 0.5], [1, 0.25, 0.25]]
SHAPES = {"3d": ((12, 14, 14), (8, 8, 8), DS),
          "2d": ((12, 22, 31), (1, 16, 16), DS_2D)}
SWITCHES = ("warp", "noise", "blur", "bright", "contrast", "gamma_inv",
            "gamma", "flips")


def _u(key, lo=0.0, hi=1.0, shape=()):
    return np.asarray(jax.random.uniform(key, shape, minval=lo, maxval=hi))


def _replay(key, B, C, patch, rot=tda.ROT_RANGE, scale=tda.SCALE_RANGE):
    """The JAX augmenter's draws for key, split as augment and aug_one
    split them (e2enet_tpu/ops/device_augment.py:137-212, default
    probabilities), as the port's params; JAX's standard normal noise
    (B, C, *patch); each sample's key of _sample_affine."""
    fields = {f.name: [] for f in tda.DeviceAugParams.__dataclass_fields__
              .values() if f.name != "patch"}
    noise, affine_keys = [], []
    for k in jax.random.split(key, B):
        ks = jax.random.split(k, 16)
        k1, k2, k3, k4, k5 = jax.random.split(ks[0], 5)
        do_rot = _u(k2) < 0.2
        sc = _u(k4, scale[0], 1.0) if _u(k3) < 0.5 else _u(k4, 1.0, scale[1])
        do_sc = _u(k5) < 0.2
        fields["angles"].append(_u(k1, rot[0], rot[1], (3,)) if do_rot
                                else np.zeros(3, np.float32))
        fields["scale"].append(sc if do_sc else np.float32(1))
        fields["warp"].append(do_rot | do_sc)
        fields["noise_var"].append(_u(ks[1], 0.0, 0.1))
        noise.append(np.moveaxis(np.asarray(jax.random.normal(
            ks[2], tuple(patch) + (C,))), -1, 0))
        fields["noise"].append(_u(ks[3]) < 0.1)
        fields["blur_sigma"].append(_u(ks[4], 0.5, 1.0))
        fields["blur"].append((_u(ks[5]) < 0.2) & (_u(ks[6], shape=(C,))
                                                   < 0.5))
        fields["bright_mult"].append(_u(ks[7], 0.75, 1.25, (C,)))
        fields["bright"].append(_u(ks[8]) < 0.15)
        fields["contrast_factor"].append(_u(ks[9], 0.75, 1.25))
        fields["contrast"].append(_u(ks[10]) < 0.15)
        fields["gamma_inv"].append(_u(ks[11]) < 0.1)
        for name, kk in (("gamma_inv_g", ks[12]), ("gamma_g", ks[14])):
            ka, kb = jax.random.split(kk)
            fields[name].append(_u(kb, 0.7, 1.0) if _u(ka) < 0.5
                                else _u(kb, 1.0, 1.5))
        fields["gamma"].append(_u(ks[13]) < 0.3)
        fields["flips"].append(_u(ks[15], shape=(3,)) < 0.5)
        affine_keys.append(ks[0])
    params = tda.DeviceAugParams(patch=tuple(patch), **{
        n: np.asarray(v) for n, v in fields.items()})
    return params, np.stack(noise), affine_keys


@pytest.mark.parametrize("angles", [(0.0, 0.0, 0.0), (0.3, -0.2, 0.5),
                                    (-0.52, 0.52, -0.1), (1.0, 2.0, 3.0)])
def test_rot_matrix(angles):
    want = np.asarray(jda._rot_matrix(*[jnp.float32(a) for a in angles]))
    np.testing.assert_allclose(tda.rot_matrix(*angles), want, rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("seed", range(6))
def test_affine_and_coords_given_the_draws(seed):
    """_sample_affine's (M, offset) from the port's affine on the same
    draws (p_rot and p_scale 0.5 so that both sides occur), then the
    source coordinates of both from JAX's (M, offset)."""
    in_patch, patch = (12, 14, 14), (8, 8, 8)
    key = jax.random.PRNGKey(seed)
    m, off, did = jda._sample_affine(key, patch, in_patch, tda.ROT_RANGE,
                                     tda.SCALE_RANGE, 0.5, 0.5, True, True)
    k1, k2, k3, k4, k5 = jax.random.split(key, 5)
    rot, sc = _u(k2) < 0.5, _u(k5) < 0.5
    angles = _u(k1, *tda.ROT_RANGE, shape=(3,)) if rot else np.zeros(3)
    scale = ((_u(k4, 0.7, 1.0) if _u(k3) < 0.5 else _u(k4, 1.0, 1.4))
             if sc else 1.0)
    assert bool(did) == bool(rot | sc)
    tm, toff = tda.affine(angles, scale, patch, in_patch)
    np.testing.assert_allclose(tm, np.asarray(m), rtol=0, atol=ATOL)
    np.testing.assert_allclose(toff, np.asarray(off), rtol=0, atol=ATOL)
    want = np.asarray(jda._affine_coords(m, off, patch))
    got = tda.affine_coords(np.asarray(m), np.asarray(off), patch)
    np.testing.assert_allclose(got.reshape(3, -1).numpy(), want, rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("in_patch, patch", [((12, 14, 14), (8, 8, 8)),
                                             ((11, 9, 16), (6, 9, 5)),
                                             ((12, 22, 31), (1, 16, 16))])
def test_center_crop(in_patch, patch):
    x = np.random.RandomState(0).randn(*in_patch).astype(np.float32)
    want = np.asarray(jda._center_crop(jnp.asarray(x), patch))
    np.testing.assert_array_equal(
        tda.center_crop(torch.from_numpy(x), patch).numpy(), want)


def _edge_coords(shape, rng):
    """(3, 6, 7, 5) coordinates: per axis whole numbers, .5 and -.5 ties,
    -0.5 exactly, values just inside and past both edges, random ones."""
    specials = []
    for size in shape:
        s = [-0.5, -0.49999997, -0.50000006, -1.2, -1.0, 0.0, 0.5, 1.5,
             2.5, size - 1.0, size - 0.5, size - 0.49999997, size - 0.3,
             size + 0.7, size - 1.5, 1.0000001, 3.4999998]
        s += list(rng.uniform(-2.0, size + 1.0, 210 - len(s)))
        specials.append(rng.permutation(np.asarray(s, np.float32)))
    return np.stack(specials).reshape(3, 6, 7, 5)


@pytest.mark.parametrize("order", [0, 1])
def test_resample(order):
    rng = np.random.RandomState(order)
    shape = (9, 11, 10)
    vol = rng.randn(*shape).astype(np.float32)
    src = _edge_coords(shape, rng)
    want = np.asarray(jda._resample(jnp.asarray(vol),
                                    jnp.asarray(src.reshape(3, -1)),
                                    src.shape[1:], order))
    got = tda.resample(torch.from_numpy(vol)[None], torch.from_numpy(src),
                       order)[0].numpy()
    if order == 0:
        np.testing.assert_array_equal(got, want)
        # integer labels (int8, as the trainer uploads them) alike
        lab = rng.randint(-1, 5, shape).astype(np.int8)
        want_l = np.asarray(jda._resample(
            jnp.asarray(lab.astype(np.float32)),
            jnp.asarray(src.reshape(3, -1)), src.shape[1:], 0))
        got_l = tda.resample(torch.from_numpy(lab)[None],
                             torch.from_numpy(src), 0)[0]
        assert got_l.dtype == torch.int8
        np.testing.assert_array_equal(got_l.numpy().astype(np.float32),
                                      want_l)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    # -0.5 on every axis is out of range at order 0 (rounds to -1) and
    # half a voxel at order 1
    edge = torch.full((3, 1, 1, 1), -0.5)
    v = tda.resample(torch.from_numpy(vol)[None], edge, order)[0]
    assert float(v.reshape(())) == (0.0 if order == 0
                                    else float(vol[0, 0, 0]) / 8)


def test_round_half_away():
    x = torch.tensor([-2.5, -1.5, -0.5, -0.49999997, 0.5, 1.5, 2.5,
                      2.4999998, -0.0, 3.0])
    want = np.asarray(jax.lax.round(jnp.asarray(x.numpy())))
    np.testing.assert_array_equal(tda.round_half_away(x).numpy(), want)


@pytest.mark.parametrize("sigma, shape", [(0.5, (8, 8, 8)),
                                          (0.73, (5, 9, 7)),
                                          (1.0, (1, 16, 16))])
def test_separable_blur(sigma, shape):
    img = np.random.RandomState(1).randn(*shape).astype(np.float32)
    want = np.asarray(jda._separable_blur(jnp.asarray(img),
                                          jnp.float32(sigma)))
    got = tda.separable_blur(torch.from_numpy(img), np.float32(sigma))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def _tie_mask(key_b, params, b, patch, in_patch):
    """Where JAX's source coordinate of a warped sample lies within TIE of
    a .5, after the sample's flips: (*patch) bool."""
    m, off, _ = jda._sample_affine(key_b, patch, in_patch, tda.ROT_RANGE,
                                   tda.SCALE_RANGE, 0.2, 0.2, True, True)
    src = np.asarray(jda._affine_coords(m, off, patch)).reshape(
        (3,) + tuple(patch))
    near = (np.abs(src - np.floor(src) - 0.5) < TIE).any(0)
    for a in range(3):
        if params.flips[b, a]:
            near = np.flip(near, a)
    return near


@pytest.mark.parametrize("C", [1, 2])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_chain_matches_make_device_augmenter(shape, C):
    in_patch, patch, ds = SHAPES[shape]
    B = 24 if shape == "3d" else 16
    aug = jda.make_device_augmenter(patch, in_patch, 3, ds)
    rng = np.random.RandomState(C)
    on = dict.fromkeys(SWITCHES, 0)
    differing = total = 0
    for seed in range(3):
        data = rng.randn(B, C, *in_patch).astype(np.float32)
        seg = rng.randint(-1, 3, (B,) + in_patch).astype(np.float32)
        key = jax.random.PRNGKey(seed)
        jd, jt = aug(key, jnp.asarray(np.moveaxis(data, 1, -1)),
                     jnp.asarray(seg))
        params, noise, keys0 = _replay(key, B, C, patch)
        for n in SWITCHES:
            on[n] += int(np.asarray(getattr(params, n)).sum())
        d, s = tda.apply(params, torch.from_numpy(data),
                         torch.from_numpy(seg), torch.from_numpy(noise))
        got = np.moveaxis(d.numpy(), 1, -1)
        np.testing.assert_allclose(got, np.asarray(jd), rtol=0,
                                   atol=DATA_ATOL)
        targets = tda.ds_targets(s, ds)
        assert len(targets) == len(jt)
        near = np.zeros((B,) + tuple(patch), bool)
        for b in range(B):
            if params.warp[b]:
                near[b] = _tie_mask(keys0[b], params, b, patch, in_patch)
                total += int(np.prod(patch))
        for t, w, sc in zip(targets, jt, ds):
            f = [int(round(1 / x)) for x in sc]
            assert t.dtype == torch.int64 and t.shape == w.shape
            differ = t.numpy() != np.asarray(w)
            assert not (differ & ~near[:, ::f[0], ::f[1], ::f[2]]).any(), (
                f"seed {seed}: targets differ away from .5 ties")
            if f == [1, 1, 1]:
                differing += int(differ.sum())
    assert all(v > 0 for v in on.values()), on
    assert total > 0 and differing <= TIE_SHARE * total, (differing, total)


def test_make_device_augmenter_draws_and_shapes():
    """The port's augmenter: channels-last float32 data, one int64 target
    per deep-supervision scale of the strided shapes, the same output from
    the same generators' seeds, a wrong input patch refused."""
    in_patch, patch, ds = SHAPES["3d"]
    aug = tda.make_device_augmenter(patch, in_patch, 3, ds)
    rng = np.random.RandomState(0)
    data = torch.from_numpy(rng.randn(4, 2, *in_patch).astype(np.float32))
    seg = torch.from_numpy(rng.randint(-1, 3, (4,) + in_patch)
                           .astype(np.int8))
    outs = [aug(torch.Generator().manual_seed(3),
                torch.Generator().manual_seed(4), data, seg)
            for _ in range(2)]
    d, targets = outs[0]
    assert d.dtype == torch.float32 and d.shape == (4,) + patch + (2,)
    assert [tuple(t.shape) for t in targets] == [(4, 8, 8, 8), (4, 4, 4, 4),
                                                 (4, 2, 2, 2)]
    assert all(t.dtype == torch.int64 and int(t.min()) >= 0
               and int(t.max()) < 3 for t in targets)
    assert torch.equal(d, outs[1][0])
    assert all(torch.equal(a, b) for a, b in zip(targets, outs[1][1]))
    with pytest.raises(ValueError, match="expected"):
        aug(torch.Generator(), torch.Generator(), data[:, :, 1:], seg)
    with pytest.raises(TypeError):
        tda.make_device_augmenter(patch, in_patch, 3, None)


def test_apply_wants_noise_where_drawn():
    params = tda.sample_params(torch.Generator().manual_seed(0), 64, 1,
                               (4, 4, 4))
    assert params.noise.any()
    with pytest.raises(ValueError, match="noise"):
        tda.apply(params, torch.zeros(64, 1, 6, 6, 6),
                  torch.zeros(64, 6, 6, 6))


N_DRAWS = 20000


@pytest.fixture(scope="module")
def draws():
    return tda.sample_params(torch.Generator().manual_seed(0), N_DRAWS, 2,
                             (8, 8, 8))


def _near(count, n, p):
    sigma = np.sqrt(n * p * (1 - p))
    return abs(count - n * p) <= 4 * sigma


@pytest.mark.parametrize("name, p", [
    ("rotated", 0.2), ("scaled", 0.2), ("zoom_in", 0.1), ("warp", 0.36),
    ("noise", 0.1), ("blur_channel", 0.1), ("blur_sample", 0.15),
    ("bright", 0.15), ("contrast", 0.15), ("gamma_inv", 0.1),
    ("gamma", 0.3), ("gamma_inv_low", 0.5), ("gamma_low", 0.5),
    ("flip0", 0.5), ("flip1", 0.5), ("flip2", 0.5)])
def test_sample_params_probabilities(draws, name, p):
    """Each switch's share over 20k draws within 4 binomial sigma of its
    probability: rotation 0.2, scale 0.2 (zoom in half of it), warped
    1 - 0.8², noise 0.1, blur 0.2 per sample and 0.5 per channel (0.1 per
    channel, 0.15 per sample of two channels), brightness and contrast
    0.15, inverted gamma 0.1, gamma 0.3, each gamma below 1 half the
    time, each flip 0.5."""
    got = {"rotated": (draws.angles != 0).any(1),
           "scaled": draws.scale != 1, "zoom_in": draws.scale < 1,
           "warp": draws.warp, "noise": draws.noise,
           "blur_channel": draws.blur.reshape(-1),
           "blur_sample": draws.blur.any(1), "bright": draws.bright,
           "contrast": draws.contrast, "gamma_inv": draws.gamma_inv,
           "gamma": draws.gamma, "gamma_inv_low": draws.gamma_inv_g < 1,
           "gamma_low": draws.gamma_g < 1, "flip0": draws.flips[:, 0],
           "flip1": draws.flips[:, 1], "flip2": draws.flips[:, 2]}[name]
    assert _near(int(got.sum()), got.size, p), (name, got.mean())


def test_sample_params_ranges(draws):
    rot = draws.angles[(draws.angles != 0).any(1)]
    lo, hi = np.float32(-np.pi / 6), np.float32(np.pi / 6)
    assert (rot >= lo).all() and (rot <= hi).all()
    assert rot.min() < lo * 0.99 and rot.max() > hi * 0.99
    sc = draws.scale[draws.scale != 1]
    assert (sc >= np.float32(0.7)).all() and (sc <= np.float32(1.4)).all()
    for v, a, b in ((draws.noise_var, 0.0, 0.1), (draws.blur_sigma, 0.5, 1),
                    (draws.bright_mult, 0.75, 1.25),
                    (draws.contrast_factor, 0.75, 1.25),
                    (draws.gamma_inv_g, 0.7, 1.5), (draws.gamma_g, 0.7, 1.5)):
        assert v.dtype == np.float32
        assert (v >= np.float32(a)).all() and (v <= np.float32(b)).all()
        assert v.min() < a + 0.01 * (b - a) and v.max() > b - 0.01 * (b - a)
    assert draws.warp.tolist() == ((draws.angles != 0).any(1)
                                   | (draws.scale != 1)).tolist()


def test_sample_params_switches_and_seed():
    gen = lambda: torch.Generator().manual_seed(11)  # noqa: E731
    a, b = (tda.sample_params(gen(), 500, 2, (4, 4, 4)) for _ in range(2))
    for f in tda.DeviceAugParams.__dataclass_fields__:
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
    off = tda.sample_params(gen(), 500, 2, (4, 4, 4), do_rotation=False,
                            do_scaling=False, do_mirror=False,
                            do_gamma=False)
    assert not off.warp.any() and not off.flips.any()
    assert not off.gamma.any() and (off.angles == 0).all()
    assert (off.scale == 1).all() and off.gamma_inv.any()
    one_axis = tda.sample_params(gen(), 500, 2, (4, 4, 4), mirror_axes=(0,))
    assert one_axis.flips[:, 0].any() and not one_axis.flips[:, 1:].any()
