"""The port's AMOS2022 predictor (e2enet_tpu_torch/inference/amos2022.py)
against the JAX package's on the same seeded inputs.

The resize before the argmax: a 2x upsample, a 2x downsample, a mixed
target (27, 17, 21) and the identity, within 1e-5 of jax.image.resize's
"linear" (an antialiased triangle filter when an axis shrinks, which
F.interpolate's trilinear is not); "nearest" equal to the bit. Labels
equal wherever the reference's top two resized probabilities differ by
more than 1e-4. The export with and without a crop box; then one case end
to end through a tiny fold in the JAX package's checkpoint format, float32
on both sides (the JAX model at HIGHEST precision, TF32 off): the network's
probabilities within 1e-4 and the written labels equal where the
reference is sure. The card's resize against this CPU one is in
tests/test_torch_cuda.py."""
import functools
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import e2enet_tpu.inference.amos2022 as jamos  # noqa: E402
import e2enet_tpu.inference.predictor as jpred  # noqa: E402
import e2enet_tpu_torch.inference.amos2022 as tamos  # noqa: E402
from e2enet_tpu_torch.io.nifti import read_nifti  # noqa: E402

from test_torch_predict import (CASES, F32_TOL, NUM_FG, top_two_gap,  # noqa
                                write_cases, write_model)

RESIZE_TOL = 1e-5
SOURCE = (20, 24, 16)
TARGETS = {"up2": (40, 48, 32), "down2": (10, 12, 8),
           "mixed": (27, 17, 21), "identity": SOURCE}


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two torch threads while this module runs, as the other heavy port
    tests hold them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def softmax(seed, k=5, shape=SOURCE):
    rng = np.random.RandomState(seed)
    logits = 2.0 * rng.randn(k, *shape).astype(np.float32)
    e = np.exp(logits - logits.max(0))
    return e / e.sum(0)


def jax_resize(x, target, method="linear"):
    return np.asarray(jax.image.resize(jnp.asarray(x),
                                       (x.shape[0], *target), method))


@pytest.mark.parametrize("name", sorted(TARGETS))
def test_resize_matches_jax(name):
    """The resize within 1e-5 of jax.image.resize, the labels equal where
    the reference is sure; each output's weights summing to one."""
    x, target = softmax(0), TARGETS[name]
    want = jax_resize(x, target)
    got = tamos.resize_softmax(x, target, device="cpu")
    assert got.dtype == torch.float32 and got.shape == (5, *target)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=RESIZE_TOL)
    np.testing.assert_allclose(got.sum(0).numpy(), 1.0, atol=RESIZE_TOL)
    seg = tamos.resample_softmax_on_device(x, target, device="cpu")
    ref = jamos.resample_softmax_on_device(x, target)
    assert seg.dtype == np.uint8 and seg.shape == ref.shape == target
    sure = top_two_gap(want) > 1e-4
    assert sure.mean() > 0.9
    np.testing.assert_array_equal(seg[sure], ref[sure])


@pytest.mark.parametrize("name", sorted(TARGETS))
def test_nearest_matches_jax(name):
    x, target = softmax(1), TARGETS[name]
    got = tamos.resize_softmax(x, target, "nearest", device="cpu").numpy()
    np.testing.assert_array_equal(got, jax_resize(x, target, "nearest"))
    np.testing.assert_array_equal(
        tamos.resample_softmax_on_device(x, target, "nearest", device="cpu"),
        jamos.resample_softmax_on_device(x, target, "nearest"))


def test_nearest_indices_exact_rule():
    """The nearest source index is floor((i + 0.5) * in / out) exactly,
    at every size pair up to 40 (the ties included)."""
    for m in range(1, 41):
        for n in range(1, 41):
            want = [((2 * i + 1) * m) // (2 * n) for i in range(n)]
            assert tamos.nearest_indices(m, n).tolist() == want, (m, n)


def test_linear_is_not_trilinear_interpolate():
    """F.interpolate's trilinear agrees with jax's linear resize where
    every axis grows or stays, and not where one shrinks (jax filters
    there): the reason the port builds jax's weights."""
    x = softmax(2)
    t = torch.from_numpy(x)[None]
    for target, agree in (((40, 30, 16), True), ((10, 12, 8), False),
                          ((27, 17, 21), False)):
        interp = F.interpolate(t, size=target, mode="trilinear",
                               align_corners=False)[0].numpy()
        gap = np.abs(interp - jax_resize(x, target)).max()
        assert (gap < RESIZE_TOL) == agree, (target, gap)


def test_linear_weights_rows():
    """Each weight matrix: (out, in), rows summing to one, a 1-wide
    triangle when upsampling and a 1/scale-wide one when downsampling."""
    up = tamos.linear_weights(4, 8)
    down = tamos.linear_weights(8, 4)
    assert up.shape == (8, 4) and down.shape == (4, 8)
    np.testing.assert_allclose(up.sum(1).numpy(), 1.0, atol=1e-6)
    np.testing.assert_allclose(down.sum(1).numpy(), 1.0, atol=1e-6)
    assert int((up > 0).sum(1).max()) == 2
    assert int((down > 0).sum(1).max()) == 4


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tamos.resample_softmax_on_device(softmax(3), (4, 5, 6))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tamos.predict_from_folder_amos2022("m", "i", "o", (0,))


def _props(crop):
    shape = (27, 17, 21)
    props = {"size_after_cropping": shape,
             "itk_spacing": (0.7, 1.1, 2.5), "itk_origin": (4.0, -3.0, 9.5),
             "itk_direction": tuple(np.eye(3)[::-1].flatten())}
    if crop:
        props["original_size_of_raw_data"] = (31, 22, 25)
        props["crop_bbox"] = [[2, 99], [5, 99], [1, 99]]   # ends rewritten
    else:
        props["original_size_of_raw_data"] = shape
    return props


@pytest.mark.parametrize("crop", [False, True])
def test_export_matches_reference(tmp_path, crop):
    """export_softmax_amos2022 with and without a crop box: the labels at
    the original geometry equal the JAX package's where it is sure, the
    geometry the same, the crop box clamped in place alike."""
    x = softmax(4)
    props = {n: _props(crop) for n in ("j", "t")}
    jamos.export_softmax_amos2022(x, str(tmp_path / "j.nii.gz"), props["j"])
    tamos.export_softmax_amos2022(x, str(tmp_path / "t.nii.gz"), props["t"],
                                  device="cpu")
    assert props["j"] == props["t"]
    a, b = read_nifti(str(tmp_path / "t.nii.gz")), \
        read_nifti(str(tmp_path / "j.nii.gz"))
    assert a.array.shape == b.array.shape == props["t"][
        "original_size_of_raw_data"]
    for k in ("spacing", "origin", "direction"):
        np.testing.assert_allclose(getattr(a, k), getattr(b, k))
    sure = np.zeros(a.array.shape, bool)
    gap = top_two_gap(jax_resize(x, props["t"]["size_after_cropping"]))
    if crop:
        (z0, z1), (y0, y1), (x0, x1) = props["t"]["crop_bbox"]
        assert (z1, y1, x1) == (29, 22, 22)
        sure[z0:z1, y0:y1, x0:x1] = gap[:z1 - z0, :y1 - y0, :x1 - x0] > 1e-4
        outside = np.ones(a.array.shape, bool)
        outside[z0:z1, y0:y1, x0:x1] = False
        assert not a.array[outside].any()
    else:
        sure = gap > 1e-4
    np.testing.assert_array_equal(a.array[sure], b.array[sure])


def _record(monkeypatch, module):
    """Every (softmax, target) the module's export hands its resample."""
    got = []
    real = module.resample_softmax_on_device

    def spy(x, target, *a, **k):
        got.append((np.asarray(x, np.float32).copy(), tuple(target)))
        return real(x, target, *a, **k)

    monkeypatch.setattr(module, "resample_softmax_on_device", spy)
    return got


def test_predict_from_folder_matches_reference(tmp_path, monkeypatch):
    """One anisotropic case (its z axis shrinks on the way back, y and x
    grow) through a tiny float32 fold with row masks, TTA on: the
    network's probabilities within 1e-4 of the JAX package's, the written
    labels equal where the reference is sure, the geometry the input's;
    the probabilities resized to the case within 1e-4 of the reference's
    (the softmax here is smooth enough that a resize without jax's filter
    would still give the same labels)."""
    inp = str(tmp_path / "in")
    write_cases(inp)
    case = "case_001"
    for name in CASES:
        if name != case:
            os.remove(os.path.join(inp, f"{name}_0000.nii.gz"))
    folder = write_model(str(tmp_path / "results"), "A", True)
    monkeypatch.setattr(jpred, "ModelBundle", functools.partial(
        jpred.ModelBundle, compute_dtype=jnp.float32))
    ref, port = _record(monkeypatch, jamos), _record(monkeypatch, tamos)
    jamos.predict_from_folder_amos2022(folder, inp, str(tmp_path / "j"),
                                       (0,))
    monkeypatch.setattr(tamos, "ModelBundle", functools.partial(
        tamos.ModelBundle, compute_dtype=torch.float32))
    torch.backends.cudnn.allow_tf32 = False
    tamos.predict_from_folder_amos2022(folder, inp, str(tmp_path / "t"),
                                       (0,), device="cpu")
    assert len(ref) == len(port) == 1
    (p_ref, target), (p_port, target_t) = ref[0], port[0]
    shape, spacing = CASES[case]
    assert target == target_t == shape
    assert p_ref.shape == p_port.shape and p_ref.shape[0] == NUM_FG + 1
    assert p_ref.shape[1] > shape[0] and p_ref.shape[2] < shape[1]
    np.testing.assert_allclose(p_port, p_ref, rtol=0, atol=F32_TOL)
    np.testing.assert_allclose(
        tamos.resize_softmax(p_port, shape, device="cpu").numpy(),
        jax_resize(p_ref, shape), rtol=0, atol=F32_TOL)
    a = read_nifti(str(tmp_path / "t" / f"{case}.nii.gz"))
    b = read_nifti(str(tmp_path / "j" / f"{case}.nii.gz"))
    src = read_nifti(os.path.join(inp, f"{case}_0000.nii.gz"))
    assert a.array.shape == b.array.shape == src.array.shape == shape
    for k in ("spacing", "origin", "direction"):
        np.testing.assert_allclose(getattr(a, k), getattr(src, k))
        np.testing.assert_allclose(getattr(a, k), getattr(b, k))
    sure = top_two_gap(jax_resize(p_ref, shape)) > F32_TOL
    assert sure.mean() > 0.9
    np.testing.assert_array_equal(a.array[sure], b.array[sure])
    assert a.array.max() <= NUM_FG
    assert os.listdir(tmp_path / "t") == [f"{case}.nii.gz"]
