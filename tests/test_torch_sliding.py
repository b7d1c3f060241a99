"""e2enet_tpu_torch.ops.sliding against e2enet_tpu.ops.sliding: step grid,
Gaussian map and host helpers exactly; predict_volume_tiled with 8 mirror
passes on a 24x20x20 volume and 16^3 patches through the same
position-dependent toy model (so a missing unflip would show). float32
accumulators: 1e-4. float16 accumulators: both add the same float16 values in
the same order; float32 softmax differences of a few ulps can move a float16
rounding, so 2e-3 (two float16 steps near 1)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from e2enet_tpu.ops import sliding as js  # noqa: E402
from e2enet_tpu_torch.ops import sliding as ts  # noqa: E402

PATCH = (16, 16, 16)
K = 3


@pytest.mark.parametrize("image,step", [((24, 20, 20), 0.5),
                                        ((16, 40, 33), 0.5),
                                        ((128, 192, 150), 0.25)])
def test_steps_match(image, step):
    assert ts.compute_steps_for_sliding_window(PATCH, image, step) == \
        js.compute_steps_for_sliding_window(PATCH, image, step)


@pytest.mark.parametrize("patch", [(16, 16, 16), (8, 12, 10)])
def test_gaussian_matches(patch):
    np.testing.assert_array_equal(ts.gaussian_importance_map(patch),
                                  js.gaussian_importance_map(patch))


def test_host_helpers_match():
    assert ts.flip_combinations((0, 1, 2)) == js.flip_combinations((0, 1, 2))
    assert ts.flip_combinations((2, 0)) == js.flip_combinations((2, 0))
    for n in (1, 3, 8, 9, 5000):
        assert ts.bucket_num_tiles(n) == js.bucket_num_tiles(n)
    data = np.random.RandomState(0).randn(2, 10, 17, 16).astype(np.float32)
    a, sa = ts.pad_volume_to_patch(data, PATCH)
    b, sb = js.pad_volume_to_patch(data, PATCH)
    np.testing.assert_array_equal(a, b)
    assert sa == sb


def _toy_models():
    """logits = x * a_k + B[d, h, w, k]: not flip-equivariant."""
    rng = np.random.RandomState(5)
    a = rng.randn(K).astype(np.float32)
    B = rng.randn(*PATCH, K).astype(np.float32)

    def jax_apply(params, x):
        return x[..., :1] * jnp.asarray(a) + jnp.asarray(B)[None]

    ta, tB = torch.from_numpy(a), torch.from_numpy(B)

    def torch_apply(x):
        return x[..., :1] * ta + tB[None]

    return jax_apply, torch_apply


@pytest.mark.parametrize("accum,tol", [("f32", 1e-4), ("f16", 2e-3)])
def test_predict_volume_tiled_matches(accum, tol):
    data = np.random.RandomState(1).randn(1, 24, 20, 20).astype(np.float32)
    jax_apply, torch_apply = _toy_models()
    jdt = {"f32": jnp.float32, "f16": jnp.float16}[accum]
    tdt = {"f32": torch.float32, "f16": torch.float16}[accum]
    pred = js.make_tiled_predictor(jax_apply, PATCH, K, accum_dtype=jdt)
    ref = js.predict_volume_tiled(jax_apply, {}, data, PATCH, K,
                                  predictor=pred)
    out = ts.predict_volume_tiled(torch_apply, data, PATCH, K, device="cpu",
                                  accum_dtype=tdt)
    assert out.shape == ref.shape == (K, 24, 20, 20)
    assert out.dtype == ref.dtype
    np.testing.assert_allclose(out.astype(np.float32),
                               ref.astype(np.float32), rtol=0, atol=tol)
    # sums to 1 where the accumulated weight is a normal number of the
    # accumulator's type; float16 loses the Gaussian's tails near tile
    # corners (subnormal or zero weight) exactly as the reference does
    w = np.zeros(data.shape[1:], ref.dtype)
    g = ts.gaussian_importance_map(PATCH).astype(ref.dtype)
    steps = ts.compute_steps_for_sliding_window(PATCH, data.shape[1:], 0.5)
    for a in steps[0]:
        for b in steps[1]:
            for c in steps[2]:
                w[a:a + 16, b:b + 16, c:c + 16] += g
    normal = w >= np.finfo(ref.dtype).tiny
    assert accum == "f16" or normal.all()
    np.testing.assert_allclose(out.astype(np.float32).sum(0)[normal], 1.0,
                               atol=5 * tol)


def test_mirroring_off_and_padding():
    """A volume smaller than the patch is padded and cropped back."""
    data = np.random.RandomState(2).randn(1, 12, 20, 16).astype(np.float32)
    jax_apply, torch_apply = _toy_models()
    ref = js.predict_volume_tiled(jax_apply, {}, data, PATCH, K,
                                  do_mirroring=False)
    out = ts.predict_volume_tiled(torch_apply, data, PATCH, K, device="cpu",
                                  do_mirroring=False)
    assert out.shape == (K, 12, 20, 16)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4)


def _mirror_fns(jax_apply, torch_apply, probs_dtype=None):
    """One mirrored toy model per flip_combinations pass: fns[m](x) ==
    flip_m(toy(flip_m(x))). With probs_dtype the port's passes return the
    toy's class softmax in that dtype (a probs head)."""
    combos = ts.flip_combinations((0, 1, 2))
    jfns, tfns = [], []
    for c in combos:
        ax = tuple(a + 1 for a in c)

        def jf(params, x, _ax=ax):
            y = jax_apply(params, jnp.flip(x, _ax) if _ax else x)
            return jnp.flip(y, _ax) if _ax else y

        def tf(x, _ax=ax):
            y = torch_apply(x.flip(_ax) if _ax else x)
            y = y.flip(_ax) if _ax else y
            if probs_dtype is not None:
                y = torch.softmax(y, dim=-1).to(probs_dtype)
            return y

        jfns.append(jf)
        tfns.append(tf)
    return jfns, tfns


@pytest.mark.parametrize("probs_dtype,tol", [(None, 1e-4),
                                             (torch.bfloat16, 2 ** -8)])
def test_flip_free_predictor_matches(probs_dtype, tol):
    """Flip-free mirror TTA: the port's mirror_apply_fns branch against
    the reference's (float32 accumulators); with a bf16 probs head the
    predictor takes the probabilities as they are (one bf16 step)."""
    data = np.random.RandomState(4).randn(1, 24, 20, 20).astype(np.float32)
    jax_apply, torch_apply = _toy_models()
    jfns, tfns = _mirror_fns(jax_apply, torch_apply, probs_dtype)
    pred = js.make_tiled_predictor(jax_apply, PATCH, K,
                                   mirror_apply_fns=jfns)
    ref = js.predict_volume_tiled(jax_apply, {}, data, PATCH, K,
                                  predictor=pred)

    def refuse(x):
        raise AssertionError("apply_fn is not used under flip-free TTA")

    out = ts.predict_volume_tiled(refuse, data, PATCH, K, device="cpu",
                                  mirror_apply_fns=tfns)
    assert out.shape == ref.shape == (K, 24, 20, 20)
    np.testing.assert_allclose(out, ref, rtol=0, atol=tol)
    # the data-flip branch computes the same
    flip = ts.predict_volume_tiled(torch_apply, data, PATCH, K, device="cpu")
    np.testing.assert_allclose(out, flip, rtol=0, atol=tol)


def test_predictor_checks_head_output_kind():
    """float32 logits are softmaxed, bf16 probabilities taken as they are,
    anything else refused (no second softmax on a probs head)."""
    logits = torch.randn(2, 3, 4, 5)
    torch.testing.assert_close(ts.head_probs(logits),
                               torch.softmax(logits, -1))
    probs = torch.softmax(logits, -1).bfloat16()
    assert torch.equal(ts.head_probs(probs), probs.float())
    data = np.zeros((1, 16, 16, 16), np.float32)
    for dt in (torch.float16, torch.float64, torch.int64):
        def apply(x, _dt=dt):
            return torch.zeros((*x.shape[:4], K), dtype=_dt)
        with pytest.raises(TypeError):
            ts.predict_volume_tiled(apply, data, PATCH, K, device="cpu",
                                    do_mirroring=False)
        with pytest.raises(TypeError):
            ts.predict_volume_tiled(apply, data, PATCH, K, device="cpu",
                                    mirror_apply_fns=[apply] * 8)
    with pytest.raises(ValueError):
        ts.predict_volume_tiled(apply, data, PATCH, K, device="cpu",
                                mirror_apply_fns=[apply] * 3)


def test_mirror_apply_fns_for_the_model():
    """inference.predictor.mirror_apply_fns_for: pass m is the model's
    mirrored forward, equal to flip_m(model(flip_m(x)))."""
    from e2enet_tpu_torch.inference.predictor import mirror_apply_fns_for
    from e2enet_tpu_torch.models.unetpp import ShiftUNetPlusPlus
    net = ShiftUNetPlusPlus(1, 3, ((2, 2, 2),) * 2, base_num_features=4,
                            compute_dtype=torch.float32, device="cpu")
    net.reset_parameters(seed=1)
    fns = mirror_apply_fns_for(net)
    x = torch.from_numpy(np.random.RandomState(6).randn(1, 8, 8, 8, 1)
                         .astype(np.float32))
    assert len(fns) == 8
    with torch.no_grad():
        for fn, c in zip(fns, ts.flip_combinations((0, 1, 2))):
            ax = tuple(a + 1 for a in c)
            want = net(x.flip(ax) if ax else x, do_ds=False)
            want = want.flip(ax) if ax else want
            np.testing.assert_allclose(fn(x).numpy(), want.numpy(),
                                       rtol=1e-4, atol=1e-4)


def _quadrant_toy(jax_apply, q=(2, 2, 2)):
    """The toy's logits in the reference's quadrant layout, so the
    reference runs the data-flip branch where prob_dtype acts
    (e2enet_tpu/ops/sliding.py:366-374)."""
    from e2enet_tpu.ops.qfused import choose_wqp, to_quadrant_cf
    hq, wq = PATCH[1] // q[1], PATCH[2] // q[2]
    wqp = choose_wqp(hq, wq)

    def jq(params, x):
        if x.ndim != 5:
            raise ValueError("rank-5 input only")
        return to_quadrant_cf(jax_apply(params, x), q, wqp)

    return jq, (q, hq, wq)


@pytest.mark.parametrize("prob_dtype,tol", [(None, 1e-4),
                                            ("bf16", 2 ** -8)])
def test_prob_dtype_on_data_flips_matches(prob_dtype, tol):
    """prob_dtype on the data-flip branch: each pass's probabilities are
    rounded to bfloat16 before the unflip, as the reference's fast mode
    stores them; float32 accumulators."""
    data = np.random.RandomState(7).randn(1, 24, 20, 20).astype(np.float32)
    jax_apply, torch_apply = _toy_models()
    jq, qmeta = _quadrant_toy(jax_apply)
    jdt = None if prob_dtype is None else jnp.bfloat16
    tdt = None if prob_dtype is None else torch.bfloat16
    pred = js.make_tiled_predictor(jq, PATCH, K, quadrant_meta=qmeta,
                                   prob_dtype=jdt)
    ref = js.predict_volume_tiled(jq, {}, data, PATCH, K, predictor=pred)
    out = ts.predict_volume_tiled(torch_apply, data, PATCH, K, device="cpu",
                                  prob_dtype=tdt)
    assert out.shape == ref.shape == (K, 24, 20, 20)
    np.testing.assert_allclose(out, ref, rtol=0, atol=tol)
    exact = ts.predict_volume_tiled(torch_apply, data, PATCH, K,
                                    device="cpu")
    assert (prob_dtype is None) == np.array_equal(out, exact)


def test_prob_dtype_is_ignored_under_flip_free():
    """As the reference: a warning, and the flip-free result unchanged."""
    data = np.random.RandomState(8).randn(1, 16, 16, 16).astype(np.float32)
    jax_apply, torch_apply = _toy_models()
    _, tfns = _mirror_fns(jax_apply, torch_apply)
    plain = ts.predict_volume_tiled(None, data, PATCH, K, device="cpu",
                                    mirror_apply_fns=tfns)
    with pytest.warns(UserWarning, match="no-op under flip-free"):
        out = ts.predict_volume_tiled(None, data, PATCH, K, device="cpu",
                                      mirror_apply_fns=tfns,
                                      prob_dtype=torch.bfloat16)
    np.testing.assert_array_equal(out, plain)
