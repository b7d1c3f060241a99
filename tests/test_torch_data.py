"""The port's data pipeline (e2enet_tpu_torch/data/, native/) against the JAX
package's (e2enet_tpu/data/, native/) on one small preprocessed task
(chip_smoke.write_train_task: six 20 x 24 x 22 cases, 3 classes): the
5-fold split file byte for byte, the patch sampler's batches, the
augmentation on both warp routes and the C++ warp itself to the bit, and
the background pipeline's first batches with one thread. Both packages
draw from numpy RandomStates seeded alike, so every comparison is exact."""
import os
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
from e2enet_tpu import native as jnative  # noqa: E402
from e2enet_tpu.data import augment as jaug  # noqa: E402
from e2enet_tpu.data import dataset as jds  # noqa: E402
from e2enet_tpu.data import pipeline as jpipe  # noqa: E402
from e2enet_tpu.data import sampler as jsamp  # noqa: E402
from e2enet_tpu_torch import native as tnative  # noqa: E402
from e2enet_tpu_torch.data import augment as taug  # noqa: E402
from e2enet_tpu_torch.data import dataset as tds  # noqa: E402
from e2enet_tpu_torch.data import pipeline as tpipe  # noqa: E402
from e2enet_tpu_torch.data import sampler as tsamp  # noqa: E402

PATCH = (16, 16, 16)
POOLS = [[2, 2, 2]] * 2
CASES = {f"case_{i:03d}": (20, 24, 22) for i in range(6)}
SCALES = [[1.0, 1.0, 1.0], [0.5, 0.5, 0.5]]


@pytest.fixture(scope="module")
def task(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("data"))
    paths = chip_smoke.write_train_task(base, "Task777_Data", CASES, PATCH,
                                        POOLS, 3)
    folder = os.path.join(paths["task"], "nnUNetData_plans_v2.1_stage0")
    tds.unpack_dataset(folder)
    return paths["task"], folder


def _assert_batches_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        if k in ("properties", "keys"):
            continue
        if isinstance(a[k], list):
            assert len(a[k]) == len(b[k])
            for x, y in zip(a[k], b[k]):
                assert x.dtype == y.dtype and x.shape == y.shape, k
                np.testing.assert_array_equal(x, y, err_msg=k)
        else:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_split_file_and_folds_equal(task, tmp_path):
    """do_split creates splits_final.pkl byte for byte as the JAX package
    does (the port computes sklearn's seeded KFold itself), and both read
    the same folds from it, 'all' included."""
    _, folder = task
    dataset = tds.load_dataset(folder)
    assert list(dataset) == list(jds.load_dataset(folder))
    files = {}
    for name, mod in (("port", tds), ("jax", jds)):
        f = str(tmp_path / f"splits_{name}.pkl")
        for fold in range(5):
            assert mod.do_split(dataset, fold, f) == jds.do_split(
                dataset, fold, str(tmp_path / "splits_jax_ref.pkl"))
        assert mod.do_split(dataset, "all", f) == jds.do_split(
            dataset, "all", f)
        files[name] = open(f, "rb").read()
    assert files["port"] == files["jax"]
    # more folds than splits: the seeded 80:20 fallback
    assert tds.do_split(dataset, 7, str(tmp_path / "splits_port.pkl")) == \
        jds.do_split(dataset, 7, str(tmp_path / "splits_jax.pkl"))
    keys = [f"k{i}" for i in range(13)]
    assert pickle.dumps(tds._kfold_splits(keys)) == pickle.dumps(
        jds._kfold_splits(keys))


def test_sampler_batches_equal(task):
    """PatchSampler3D: the enlarged generator patch with padding, and the
    final patch, with foreground oversampling; batches equal to the bit."""
    _, folder = task
    dataset = tds.load_dataset(folder)
    big = taug.get_patch_size(PATCH, (-0.5236, 0.5236), (-0.5236, 0.5236),
                              (-0.5236, 0.5236), (0.7, 1.4))
    np.testing.assert_array_equal(big, jaug.get_patch_size(
        PATCH, (-0.5236, 0.5236), (-0.5236, 0.5236), (-0.5236, 0.5236),
        (0.7, 1.4)))
    for patch in (big, PATCH):
        ts = tsamp.PatchSampler3D(dataset, patch, PATCH, 3, seed=5)
        js = jsamp.PatchSampler3D(dataset, patch, PATCH, 3, seed=5)
        assert [ts.get_do_oversample(i) for i in range(3)] == \
            [js.get_do_oversample(i) for i in range(3)] == [False, False,
                                                            True]
        for _ in range(4):
            a, b = ts.generate_train_batch(), js.generate_train_batch()
            assert list(a["keys"]) == list(b["keys"])
            _assert_batches_equal(a, b)


def test_native_warp_equal_to_reference():
    """The port's C++ warp (built into build/) against e2enet_tpu/native's
    on the same inputs: every order, the label warp, to the bit."""
    assert tnative.native_available() and jnative.native_available()
    assert tnative.route() == "native"
    rng = np.random.RandomState(0)
    vol = rng.randn(2, 19, 23, 21).astype(np.float32)
    seg = rng.randint(-1, 3, (19, 23, 21)).astype(np.float32)
    c, s = np.cos(0.4), np.sin(0.4)
    M = np.array([[1, 0, 0], [0, c, -s], [0, s, c]]) * 0.9
    off = np.array([1.5, -2.0, 3.25])
    for order in (0, 1, 3):
        np.testing.assert_array_equal(
            tnative.affine_warp(vol, M, off, (16, 16, 16), order, -1.0),
            jnative.affine_warp(vol, M, off, (16, 16, 16), order, -1.0))
    np.testing.assert_array_equal(
        tnative.affine_warp_seg(seg, M, off, (16, 16, 16), -1.0),
        jnative.affine_warp_seg(seg, M, off, (16, 16, 16), -1.0))


@pytest.mark.parametrize("route", ["native", "scipy"])
@pytest.mark.parametrize("always_warp", [False, True])
def test_augment_batch_equal(task, monkeypatch, route, always_warp):
    """augment_batch on the same sampled batches with the same RandomState:
    the whole train-time chain (warp, noise, blur, brightness, contrast,
    low resolution, gamma, mirror) and the deep-supervision targets equal
    to the bit, on the C++ warp and on scipy's (E2ENET_NO_NATIVE switches
    both packages). always_warp forces the rotation and the scaling."""
    if route == "scipy":
        monkeypatch.setenv("E2ENET_NO_NATIVE", "1")
    assert tnative.route() == route
    _, folder = task
    dataset = tds.load_dataset(folder)
    big = taug.get_patch_size(PATCH, (-0.5236, 0.5236), (-0.5236, 0.5236),
                              (-0.5236, 0.5236), (0.7, 1.4))
    sampler = jsamp.PatchSampler3D(dataset, big, PATCH, 2, seed=1)
    kw = dict(patch_size=PATCH, deep_supervision_scales=SCALES,
              mask_was_used_for_normalization={0: False})
    if always_warp:
        kw.update(p_rot=1.0, p_scale=1.0)
    rt, rj = np.random.RandomState(3), np.random.RandomState(3)
    for _ in range(3):
        batch = sampler.generate_train_batch()
        a = taug.augment_batch({k: v.copy() for k, v in batch.items()
                                if k in ("data", "seg")},
                               taug.AugmentParams(**kw), rt)
        b = jaug.augment_batch({k: v.copy() for k, v in batch.items()
                                if k in ("data", "seg")},
                               jaug.AugmentParams(**kw), rj)
        _assert_batches_equal(a, b)
        assert a["data"].shape == (2, 1, *PATCH)
        assert [t.shape for t in a["target"]] == [(2, 16, 16, 16),
                                                  (2, 8, 8, 8)]
    # validation batches pass through unaugmented
    batch = jsamp.PatchSampler3D(dataset, PATCH, PATCH, 2,
                                 seed=2).generate_train_batch()
    _assert_batches_equal(
        taug.augment_batch(dict(batch), taug.AugmentParams(**kw), rt, True),
        jaug.augment_batch(dict(batch), jaug.AugmentParams(**kw), rj, True))


def test_unported_targets_raise():
    """The region trainers' targets, which raised before they were ported,
    and the cascade's one-hot move: both equal to the JAX package's (the
    region targets one float32 channel per region, channels-last, at every
    deep-supervision scale; tests/test_torch_cascade.py holds the
    cascade's augmentation)."""
    rng = np.random.RandomState(5)
    seg = rng.randint(0, 4, (2, 2, *PATCH)).astype(np.float32)
    batch = {"data": rng.randn(2, 1, *PATCH).astype(np.float32),
             "seg": seg}
    kw = dict(patch_size=PATCH, move_last_seg_channel_to_data=True,
              all_segmentation_labels=[1, 2, 3])
    out = taug.augment_batch(dict(batch), taug.AugmentParams(**kw),
                             np.random.RandomState(0), True)
    assert out["data"].shape == (2, 4, *PATCH)
    _assert_batches_equal(out, jaug.augment_batch(
        dict(batch), jaug.AugmentParams(**kw), np.random.RandomState(0),
        True))
    kw = dict(patch_size=PATCH, regions=((1, 2, 3), (2, 3), (3,)),
              deep_supervision_scales=SCALES)
    one = {"data": batch["data"], "seg": seg[:, :1]}
    out = taug.augment_batch(dict(one), taug.AugmentParams(**kw),
                             np.random.RandomState(0), True)
    assert [t.shape for t in out["target"]] == [
        (2, *PATCH, 3), (2, *[p // 2 for p in PATCH], 3)]
    assert all(t.dtype == np.float32 and set(np.unique(t)) == {0.0, 1.0}
               for t in out["target"])
    _assert_batches_equal(out, jaug.augment_batch(
        dict(one), jaug.AugmentParams(**kw), np.random.RandomState(0),
        True))


def test_pipeline_first_batches_equal(task):
    """BatchPipeline with one thread (one RandomState(seed), the sampler
    not shared): the first batches in order, equal to the bit; the queue
    prefetches, so the sequence is compared, not the timing."""
    _, folder = task
    dataset = tds.load_dataset(folder)
    big = taug.get_patch_size(PATCH, (-0.5236, 0.5236), (-0.5236, 0.5236),
                              (-0.5236, 0.5236), (0.7, 1.4))
    kw = dict(patch_size=PATCH, deep_supervision_scales=SCALES)
    pipes = [tpipe.BatchPipeline(tsamp.PatchSampler3D(dataset, big, PATCH, 2,
                                                      seed=0),
                                 taug.AugmentParams(**kw), seed=0),
             jpipe.BatchPipeline(jsamp.PatchSampler3D(dataset, big, PATCH, 2,
                                                      seed=0),
                                 jaug.AugmentParams(**kw), seed=0)]
    try:
        for _ in range(4):
            _assert_batches_equal(next(pipes[0]), next(pipes[1]))
    finally:
        for p in pipes:
            p.stop()
