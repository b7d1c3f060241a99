"""The port's cascade pieces (e2enet_tpu_torch/training/cascade.py, the
cascade step of data/augment.py, the sampler's has_prev_stage, the model at
the cascade's input width) against the JAX package's, on inputs made from
numpy seeds:

- move_seg_as_onehot_to_data and cascade_augment_onehot equal to the bit
  for several seeds, at the trainer's default knobs and at the five knob
  sets of the cascade presets' augmentation levels (the JAX package's
  apply_da_level values, used here as data), and at one that takes every
  branch;
- resample_and_save writing equal uint8 arrays (up, down, both);
- the sampler's batches with has_prev_stage on a task whose cases have
  <case>_segFromPrevStage.npz files, and augment_batch and BatchPipeline
  with move_last_seg_channel_to_data and the cascade augmentation, equal
  to the bit, training and validation batches;
- the model at three input channels (one modality and two one-hot
  labels): the weights crossing by from_jax_params / to_jax_params and
  the float32 output within tests/test_torch_unetpp.py's 1e-3 of the
  JAX model's.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from scipy.ndimage import gaussian_filter  # noqa: E402

import chip_smoke  # noqa: E402
from e2enet_tpu.data import augment as jaug  # noqa: E402
from e2enet_tpu.data import dataset as jds  # noqa: E402
from e2enet_tpu.data import pipeline as jpipe  # noqa: E402
from e2enet_tpu.data import sampler as jsamp  # noqa: E402
from e2enet_tpu.models.unetpp import ShiftUNetPlusPlus as JaxNet  # noqa
from e2enet_tpu.training import cascade as jcas  # noqa: E402
from e2enet_tpu_torch.data import augment as taug  # noqa: E402
from e2enet_tpu_torch.data import dataset as tds  # noqa: E402
from e2enet_tpu_torch.data import pipeline as tpipe  # noqa: E402
from e2enet_tpu_torch.data import sampler as tsamp  # noqa: E402
from e2enet_tpu_torch.models import unetpp as tunetpp  # noqa: E402
from e2enet_tpu_torch.models.weights import (from_jax_params,  # noqa: E402
                                             to_jax_params)
from e2enet_tpu_torch.training import cascade as tcas  # noqa: E402
from test_torch_data import _assert_batches_equal  # noqa: E402
from test_torch_unetpp import numpy_params  # noqa: E402

PATCH = (16, 16, 16)
POOLS = [[2, 2, 2]] * 2
SCALES = [[1.0, 1.0, 1.0], [0.5, 0.5, 0.5]]
CASES = {f"case_{i:03d}": (20, 24, 22) for i in range(6)}
LABELS = [1, 2]
# (p_binary_op, p_per_label, strel_size, p_remove_component,
#  max_size_percent): the trainer's defaults (AugmentParams), the cascade
# presets' levels (e2enet_tpu/training/variants.py apply_da_level:
# cascade_noconncomp, _smallstrel, _eg, _eg2, _eg3) and every branch taken
KNOBS = {
    "default": (0.4, 1.0, (1, 8), 0.2, 0.15),
    "noconncomp": (0.4, 1.0, (1, 8), 0.0, 0.15),
    "smallstrel": (0.4, 1.0, (1, 5), 0.2, 0.15),
    "eg": (0.5, 0.5, (1, 5), 0.2, 0.10),
    "eg2": (0.5, 0.5, (1, 5), 0.0, 0.10),
    "eg3": (1.0, 0.33, (1, 5), 0.0, 0.10),
    "every_branch": (1.0, 1.0, (1, 8), 1.0, 0.5),
}


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def blob_labels(rng, shape, n_labels=3):
    """Labels 0..n_labels-1 of smoothed noise: several connected components
    per label, of varied sizes."""
    v = gaussian_filter(rng.randn(*shape), 1.5)
    edges = np.quantile(v, np.linspace(0, 1, n_labels + 1)[1:-1])
    return np.digitize(v, edges).astype(np.uint8)


def _knob_kwargs(k):
    p, ppl, size, prm, pct = KNOBS[k]
    return dict(p_binary_op=p, p_per_label=ppl, strel_size=size,
                p_remove_component=prm, max_size_percent=pct)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("knobs", sorted(KNOBS))
def test_onehot_and_cascade_augmentation_equal(knobs, seed):
    rng = np.random.RandomState(100 + seed)
    data = rng.randn(2, 1, *PATCH).astype(np.float32)
    prev = np.stack([blob_labels(rng, PATCH) for _ in range(2)]).astype(
        np.float32)
    a = tcas.move_seg_as_onehot_to_data(data, prev, LABELS)
    b = jcas.move_seg_as_onehot_to_data(data, prev, LABELS)
    assert a.shape == (2, 3, *PATCH) and a.dtype == np.float32
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(a[:, 1], prev == 1)
    rt, rj = np.random.RandomState(seed), np.random.RandomState(seed)
    ta = tcas.cascade_augment_onehot(a[:, 1:].copy(), rt,
                                     **_knob_kwargs(knobs))
    ja = jcas.cascade_augment_onehot(b[:, 1:].copy(), rj,
                                     **_knob_kwargs(knobs))
    assert ta.dtype == ja.dtype
    np.testing.assert_array_equal(ta, ja)
    # the same draws taken: both generators at the same state after
    assert rt.uniform() == rj.uniform()
    if knobs == "every_branch":
        assert not np.array_equal(ta, a[:, 1:])


@pytest.mark.parametrize("target", [(30, 36, 33), (10, 12, 11),
                                    (40, 12, 22)])
def test_resample_and_save_equal(target, tmp_path):
    rng = np.random.RandomState(sum(target))
    logits = gaussian_filter(rng.randn(3, 20, 24, 22), (0, 1, 1, 1))
    probs = np.exp(logits) / np.exp(logits).sum(0, keepdims=True)
    files = [str(tmp_path / f"{n}_segFromPrevStage.npz")
             for n in ("port", "jax")]
    tcas.resample_and_save(probs.astype(np.float32), target, files[0])
    jcas.resample_and_save(probs.astype(np.float32), target, files[1])
    a, b = (np.load(f)["data"] for f in files)
    assert a.dtype == b.dtype == np.uint8 and a.shape == tuple(target)
    np.testing.assert_array_equal(a, b)
    assert tcas.seg_from_prev_stage_file(str(tmp_path), "port") == files[0]


@pytest.fixture(scope="module")
def task(tmp_path_factory):
    """chip_smoke.write_train_task's six cases with a segFromPrevStage file
    each (blob labels of the case's shape), unpacked as the trainer does."""
    base = str(tmp_path_factory.mktemp("cascade_data"))
    paths = chip_smoke.write_train_task(base, "Task778_Cascade", CASES,
                                        PATCH, POOLS, 3)
    folder = os.path.join(paths["task"], "nnUNetData_plans_v2.1_stage0")
    rng = np.random.RandomState(5)
    for case, shape in CASES.items():
        np.savez_compressed(tcas.seg_from_prev_stage_file(folder, case),
                            data=blob_labels(rng, shape))
    tds.unpack_dataset(folder)
    assert list(tds.load_dataset(folder)) == sorted(CASES)
    return folder


def _params(**kw):
    return dict(patch_size=PATCH, deep_supervision_scales=SCALES,
                move_last_seg_channel_to_data=True,
                all_segmentation_labels=LABELS, **kw)


def _samplers(dataset, big, seed):
    return (tsamp.PatchSampler3D(dataset, big, PATCH, 2, has_prev_stage=True,
                                 seed=seed),
            jsamp.PatchSampler3D(dataset, big, PATCH, 2, has_prev_stage=True,
                                 seed=seed))


def test_sampler_with_prev_stage_equal(task):
    dataset = tds.load_dataset(task)
    big = taug.get_patch_size(PATCH, (-0.5236, 0.5236), (-0.5236, 0.5236),
                              (-0.5236, 0.5236), (0.7, 1.4))
    for patch, seed in ((big, 0), (PATCH, 3)):
        ts, js = _samplers(dataset, patch, seed)
        for _ in range(3):
            a, b = ts.generate_train_batch(), js.generate_train_batch()
            _assert_batches_equal(a, b)
            assert a["seg"].shape == (2, 2, *[int(p) for p in patch])
            # the second seg channel: the previous stage's labels, or the
            # padding's -1
            assert set(np.unique(a["seg"][:, 1])) <= {-1, 0, 1, 2}


@pytest.mark.parametrize("knobs", ["default", "every_branch", "eg3"])
def test_augment_batch_with_cascade_equal(task, knobs):
    dataset = tds.load_dataset(task)
    big = taug.get_patch_size(PATCH, (-0.5236, 0.5236), (-0.5236, 0.5236),
                              (-0.5236, 0.5236), (0.7, 1.4))
    p, ppl, size, prm, pct = KNOBS[knobs]
    kw = _params(cascade_do_cascade_augmentations=True,
                 cascade_random_binary_transform_p=p,
                 cascade_random_binary_transform_p_per_label=ppl,
                 cascade_random_binary_transform_size=size,
                 cascade_remove_conn_comp_p=prm,
                 cascade_remove_conn_comp_max_size_percent_threshold=pct)
    ts, _ = _samplers(dataset, big, 1)
    rt, rj = np.random.RandomState(4), np.random.RandomState(4)
    for _ in range(2):
        batch = ts.generate_train_batch()
        a = taug.augment_batch({k: batch[k].copy() for k in ("data", "seg")},
                               taug.AugmentParams(**kw), rt)
        b = jaug.augment_batch({k: batch[k].copy() for k in ("data", "seg")},
                               jaug.AugmentParams(**kw), rj)
        _assert_batches_equal(a, b)
        assert a["data"].shape == (2, 3, *PATCH)
        assert [t.shape for t in a["target"]] == [(2, 16, 16, 16),
                                                  (2, 8, 8, 8)]
    # validation: the one-hot channels as they are, 0/1 and at most one
    # per voxel
    ts, _ = _samplers(dataset, PATCH, 2)
    batch = ts.generate_train_batch()
    a = taug.augment_batch(dict(batch), taug.AugmentParams(**kw), rt, True)
    b = jaug.augment_batch(dict(batch), jaug.AugmentParams(**kw), rj, True)
    _assert_batches_equal(a, b)
    onehot = a["data"][:, 1:]
    assert set(np.unique(onehot)) <= {0.0, 1.0}
    assert float(onehot.sum(1).max()) <= 1.0


def test_pipeline_with_cascade_equal(task):
    """BatchPipeline with one thread, the trainer's cascade parameters for
    training batches and for validation ones."""
    dataset = tds.load_dataset(task)
    big = taug.get_patch_size(PATCH, (-0.5236, 0.5236), (-0.5236, 0.5236),
                              (-0.5236, 0.5236), (0.7, 1.4))
    for patch, validation, kw in (
            (big, False, _params(cascade_do_cascade_augmentations=True)),
            (PATCH, True, _params())):
        ts, js = _samplers(dataset, patch, 0)
        pipes = [tpipe.BatchPipeline(ts, taug.AugmentParams(**kw),
                                     validation=validation, seed=0),
                 jpipe.BatchPipeline(js, jaug.AugmentParams(**kw),
                                     validation=validation, seed=0)]
        try:
            for _ in range(3):
                _assert_batches_equal(next(pipes[0]), next(pipes[1]))
        finally:
            for p in pipes:
                p.stop()


@pytest.mark.parametrize("cin", [3, 16])
def test_model_at_the_cascade_input_width_matches_reference(cin):
    """One modality and cin - 1 one-hot labels: the first block's (48 or
    here 4 base features, cin input channels) weights cross both ways and
    the float32 forward matches the JAX model's (XLA path, HIGHEST)."""
    kw = dict(input_channels=cin, num_classes=cin if cin < 16 else 16,
              pool_op_kernel_sizes=((2, 2, 2),) * 3, base_num_features=4)
    shape = (1, 16, 16, 16, cin)
    params = numpy_params(seed=cin, kw=kw, shape=shape)
    net = tunetpp.ShiftUNetPlusPlus(**kw, compute_dtype=torch.float32,
                                    device="cpu")
    net.load_state_dict(from_jax_params(params), strict=True)
    back = to_jax_params(net.state_dict())
    want = params["params"] if set(params) == {"params"} else params
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(dict(want)))
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(a, np.asarray(b))
    rng = np.random.RandomState(cin)
    x = rng.randn(*shape).astype(np.float32)
    x[..., 1:] = np.eye(cin)[rng.randint(0, cin, shape[1:4])][..., 1:]
    jnet = JaxNet(**kw, compute_dtype=jnp.float32, remat=False,
                  quadrant=False)
    ref = np.asarray(jnet.apply(params, jnp.asarray(x), do_ds=False))
    with torch.no_grad():
        out = net(torch.from_numpy(x), do_ds=False)
    assert tuple(out.shape) == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-3, atol=1e-3)
