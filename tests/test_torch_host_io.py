"""The port's copies of the host modules against the JAX package's own, on
the same seeded inputs: NIfTI I/O, cropping, resampling, the
preprocessor's test-case path, both export functions (the written files
compared voxel for voxel and header for header), connected components,
the Plans dict round trip, and the small utilities (paths, task names,
files, registry, configuration). Every comparison is exact."""
import copy
import gzip
import os

import numpy as np
import pytest

import e2enet_tpu.configuration as jconf
import e2enet_tpu.inference.export as jexp
import e2enet_tpu.io.nifti as jnii
import e2enet_tpu.paths as jpaths
import e2enet_tpu.plans as jplans
import e2enet_tpu.postprocessing.connected_components as jcc
import e2enet_tpu.preprocessing.cropping as jcrop
import e2enet_tpu.preprocessing.preprocessor as jpre
import e2enet_tpu.preprocessing.resampling as jres
import e2enet_tpu.utils.files as jfiles
import e2enet_tpu.utils.task_names as jtask
import e2enet_tpu_torch.configuration as tconf
import e2enet_tpu_torch.inference.export as texp
import e2enet_tpu_torch.io.nifti as tnii
import e2enet_tpu_torch.paths as tpaths
import e2enet_tpu_torch.plans as tplans
import e2enet_tpu_torch.postprocessing.connected_components as tcc
import e2enet_tpu_torch.preprocessing.cropping as tcrop
import e2enet_tpu_torch.preprocessing.preprocessor as tpre
import e2enet_tpu_torch.preprocessing.resampling as tres
import e2enet_tpu_torch.utils.files as tfiles
import e2enet_tpu_torch.utils.task_names as ttask
from e2enet_tpu_torch.utils.registry import PREPROCESSORS


def assert_same(a, b, path="value"):
    """Equal trees of dicts, sequences, arrays and scalars, exactly."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), path
        for k in a:
            assert_same(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, path


def raw_bytes(path):
    with open(path, "rb") as f:
        data = f.read()
    return gzip.decompress(data) if path.endswith(".gz") else data


def volume(seed, shape=(14, 18, 16), border=2):
    """Seeded data that is zero on a border, so cropping has work."""
    rng = np.random.RandomState(seed)
    vol = np.zeros(shape, np.float32)
    inner = tuple(slice(border, s - border) for s in shape)
    vol[inner] = rng.randn(*[s - 2 * border for s in shape]) + 3.0
    return vol


GEOM = dict(spacing=(0.8, 0.9, 2.6), origin=(12.5, -3.0, 40.0),
            direction=(0.0, 1.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0, -1.0))


@pytest.mark.parametrize("dtype", [np.float32, np.int16, np.uint8])
@pytest.mark.parametrize("suffix", [".nii.gz", ".nii"])
def test_nifti_round_trip(tmp_path, dtype, suffix):
    arr = (volume(1) * 10).astype(dtype)
    a, b = str(tmp_path / f"a{suffix}"), str(tmp_path / f"b{suffix}")
    tnii.write_nifti(a, tnii.NiftiImage(arr, **GEOM))
    jnii.write_nifti(b, jnii.NiftiImage(arr, **GEOM))
    assert raw_bytes(a) == raw_bytes(b)
    for path in (a, b):
        x, y = tnii.read_nifti(path), jnii.read_nifti(path)
        assert_same(x.array, y.array)
        assert_same(x.geometry, y.geometry)
        np.testing.assert_array_equal(x.array, arr)


def test_cropping(tmp_path):
    data = np.stack([volume(2), volume(3) * (volume(2) != 0)])
    seg = (np.random.RandomState(4).rand(1, *data.shape[1:]) > 0.7
           ).astype(np.float32)
    assert_same(tcrop.create_nonzero_mask(data),
                jcrop.create_nonzero_mask(data))
    mask = tcrop.create_nonzero_mask(data)
    assert_same(tcrop.get_bbox_from_mask(mask), jcrop.get_bbox_from_mask(mask))
    assert_same(tcrop.crop_to_nonzero(data.copy(), seg.copy()),
                jcrop.crop_to_nonzero(data.copy(), seg.copy()))
    files = []
    for m in range(2):
        f = str(tmp_path / f"case_{m:04d}.nii.gz")
        jnii.write_nifti(f, jnii.NiftiImage(data[m], **GEOM))
        files.append(f)
    sfile = str(tmp_path / "seg.nii.gz")
    jnii.write_nifti(sfile, jnii.NiftiImage(seg[0].astype(np.uint8), **GEOM))
    assert_same(tcrop.ImageCropper.crop_from_list_of_files(files, sfile),
                jcrop.ImageCropper.crop_from_list_of_files(files, sfile))
    assert_same(tcrop.ImageCropper.crop_from_list_of_files(files),
                jcrop.ImageCropper.crop_from_list_of_files(files))


@pytest.mark.parametrize("is_seg", [False, True])
@pytest.mark.parametrize("separate_z,order", [(False, 3), (False, 1),
                                              (True, 3), (True, 1)])
def test_resample_data_or_seg(is_seg, separate_z, order):
    rng = np.random.RandomState(5)
    if is_seg:
        data = rng.randint(0, 4, (1, 10, 12, 6)).astype(np.float32)
    else:
        data = rng.randn(2, 10, 12, 6).astype(np.float32)
    kw = dict(is_seg=is_seg, axis=[2] if separate_z else None, order=order,
              do_separate_z=separate_z, order_z=0)
    for new_shape in ((13, 9, 15), (10, 12, 6)):
        assert_same(tres.resample_data_or_seg(data, new_shape, **kw),
                    jres.resample_data_or_seg(data, new_shape, **kw))
    spacing = np.array([2.6, 0.8, 0.8])
    for target in ([1.0, 1.0, 1.0], [2.6, 0.8, 0.8], [1.5, 1.0, 0.9]):
        assert_same(
            tres.resample_patient(data, None, spacing, np.array(target)),
            jres.resample_patient(data, None, spacing, np.array(target)))
    assert_same(tres.resize_segmentation(data[0], (7, 15, 9), order),
                jres.resize_segmentation(data[0], (7, 15, 9), order))


def test_resample_float16_separate_z():
    """The port's one repair: a float16 softmax resamples its low-res axis
    on its own (the reference's scipy call refuses float16) to the float32
    result in float64 rounded to float16."""
    p = np.random.RandomState(6).rand(3, 10, 12, 6).astype(np.float16)
    kw = dict(is_seg=False, axis=[2], order=1, do_separate_z=True,
              order_z=0)
    with pytest.raises(RuntimeError):
        jres.resample_data_or_seg(p, (13, 9, 15), **kw)
    got = tres.resample_data_or_seg(p, (13, 9, 15), **kw)
    want = jres.resample_data_or_seg(p.astype(np.float64), (13, 9, 15), **kw)
    assert got.dtype == np.float16
    np.testing.assert_array_equal(got, want.astype(np.float16))


INTENSITY = {0: {"mean": 3.1, "sd": 0.9, "percentile_00_5": 1.0,
                 "percentile_99_5": 5.0},
             1: {"mean": 0.5, "sd": 2.0, "percentile_00_5": -1.0,
                 "percentile_99_5": 3.0}}


@pytest.mark.parametrize("schemes,nonzero,transpose", [
    ({0: "CT", 1: "CT2"}, {0: False, 1: True}, [0, 1, 2]),
    ({0: "MRI", 1: "noNorm"}, {0: True, 1: False}, [2, 0, 1]),
    ({0: "MRI", 1: "CT"}, {0: False, 1: False}, [1, 0, 2])])
def test_preprocess_test_case(tmp_path, schemes, nonzero, transpose):
    files = []
    for m in range(2):
        f = str(tmp_path / f"case_{m:04d}.nii.gz")
        jnii.write_nifti(f, jnii.NiftiImage(volume(7 + m) + m, **GEOM))
        files.append(f)
    spacing = [1.2, 1.0, 1.1]
    args = (schemes, nonzero, transpose, INTENSITY)
    assert "GenericPreprocessor" in PREPROCESSORS
    got = tpre.GenericPreprocessor(*args).preprocess_test_case(files,
                                                               spacing)
    want = jpre.GenericPreprocessor(*args).preprocess_test_case(files,
                                                                spacing)
    assert_same(got, want)


def props_and_softmax(tmp_path, seed):
    """A case's properties from the preprocessor and a softmax at its
    preprocessed shape."""
    f = str(tmp_path / f"p{seed}_0000.nii.gz")
    jnii.write_nifti(f, jnii.NiftiImage(volume(seed), **GEOM))
    data, _seg, props = jpre.GenericPreprocessor(
        {0: "MRI"}, {0: True}, [0, 1, 2]).preprocess_test_case(
        [f], [1.0, 1.0, 1.0])
    logits = np.random.RandomState(seed).randn(4, *data.shape[1:])
    p = np.exp(logits) / np.exp(logits).sum(0)
    return props, p.astype(np.float32)


def test_export_from_softmax(tmp_path):
    props, p = props_and_softmax(tmp_path, 9)
    for tag, mod in (("t", texp), ("j", jexp)):
        mod.save_segmentation_nifti_from_softmax(
            p, str(tmp_path / f"{tag}.nii.gz"), copy.deepcopy(props), 1,
            None, None, None, str(tmp_path / f"{tag}.npz"))
    t, j = str(tmp_path / "t.nii.gz"), str(tmp_path / "j.nii.gz")
    assert raw_bytes(t) == raw_bytes(j)
    assert_same(tnii.read_nifti(t).array, jnii.read_nifti(j).array)
    assert_same(dict(np.load(tmp_path / "t.npz")),
                dict(np.load(tmp_path / "j.npz")))
    assert_same(tfiles.load_pickle(str(tmp_path / "t.pkl")),
                jfiles.load_pickle(str(tmp_path / "j.pkl")))


def test_export_label_map(tmp_path):
    props, p = props_and_softmax(tmp_path, 10)
    seg = p.argmax(0).astype(np.uint8)
    for tag, mod in (("t", texp), ("j", jexp)):
        mod.save_segmentation_nifti(seg, str(tmp_path / f"{tag}.nii.gz"),
                                    copy.deepcopy(props), 1)
    t, j = str(tmp_path / "t.nii.gz"), str(tmp_path / "j.nii.gz")
    assert raw_bytes(t) == raw_bytes(j)
    assert tnii.read_nifti(t).array.shape == volume(10).shape


def test_connected_components(tmp_path):
    rng = np.random.RandomState(11)
    img = (rng.rand(16, 16, 16) > 0.6).astype(np.uint8)
    img[rng.rand(16, 16, 16) > 0.8] = 2
    for classes, mvos in (([1, 2], None), ([(1, 2)], None),
                          ([1], {1: 3.0}), (None, None)):
        assert_same(
            tcc.remove_all_but_the_largest_connected_component(
                img.copy(), classes, 2.0, mvos),
            jcc.remove_all_but_the_largest_connected_component(
                img.copy(), classes, 2.0, mvos))
    src = str(tmp_path / "src.nii.gz")
    jnii.write_nifti(src, jnii.NiftiImage(img, **GEOM))
    for tag, mod in (("t", tcc), ("j", jcc)):
        out = mod.load_remove_save(src, str(tmp_path / f"{tag}.nii.gz"),
                                   [1, 2])
        assert_same(out, jcc.load_remove_save(
            src, str(tmp_path / "j2.nii.gz"), [1, 2]))
    assert raw_bytes(str(tmp_path / "t.nii.gz")) == \
        raw_bytes(str(tmp_path / "j.nii.gz"))
    pj = str(tmp_path / "postprocessing.json")
    jfiles.save_json({"for_which_classes": [[1, 2], 2],
                      "min_valid_object_sizes": "None"}, pj)
    assert_same(tcc.load_postprocessing(pj), jcc.load_postprocessing(pj))
    ft, fj = tcc.load_postprocessing_fn(pj), jcc.load_postprocessing_fn(pj)
    assert_same(ft["fn"](img.copy()), fj["fn"](img.copy()))
    jfiles.save_json({"for_which_classes": []}, pj)
    assert tcc.load_postprocessing_fn(pj) is None


def test_plans_round_trip(tmp_path):
    stage = jplans.StagePlan(
        batch_size=2, num_pool_per_axis=[4, 5, 5], patch_size=[80, 160, 160],
        median_patient_size_in_voxels=[120, 400, 400],
        current_spacing=[2.5, 0.8, 0.8], original_spacing=[2.5, 0.8, 0.8],
        do_dummy_2D_data_aug=True,
        pool_op_kernel_sizes=[[1, 2, 2]] + [[2, 2, 2]] * 4,
        conv_kernel_sizes=[[1, 3, 3]] * 6)
    plans = jplans.Plans(
        num_stages=1, num_modalities=2, modalities={0: "CT", 1: "MR"},
        normalization_schemes={0: "CT", 1: "nonCT"},
        dataset_properties={"a": 1}, list_of_npz_files=["x.npz"],
        original_spacings=[[2.5, 0.8, 0.8]], original_sizes=[[120, 400, 400]],
        preprocessed_data_folder=None, num_classes=15,
        all_classes=list(range(1, 16)), base_num_features=32,
        use_mask_for_norm={0: False, 1: True}, keep_only_largest_region=None,
        min_region_size_per_class=None, min_size_per_class=None,
        transpose_forward=[0, 1, 2], transpose_backward=[0, 1, 2],
        data_identifier="d", plans_per_stage={0: stage},
        intensity_properties=INTENSITY)
    d = plans.to_dict()
    port = tplans.Plans.from_dict(d)
    assert_same(port.to_dict(), d)
    pj, pt = str(tmp_path / "j.json"), str(tmp_path / "t.json")
    plans.save(pj)
    port.save(pt)
    assert open(pj).read() == open(pt).read()
    assert_same(tplans.Plans.load(pj).to_dict(),
                jplans.Plans.load(pj).to_dict())


def test_utilities(tmp_path, monkeypatch):
    for name in ("nnUNet_raw_data_base", "nnUNet_preprocessed",
                 "RESULTS_FOLDER"):
        monkeypatch.setenv(name, str(tmp_path / name))
    for fn in ("get_raw_data_base", "get_raw_data_dir", "get_cropped_data_dir",
               "get_preprocessing_output_dir", "get_results_dir"):
        assert getattr(tpaths, fn)() == getattr(jpaths, fn)()
    os.makedirs(os.path.join(tpaths.get_results_dir(), "Task042_Foo"))
    assert ttask.convert_id_to_task_name(42) == \
        jtask.convert_id_to_task_name(42) == "Task042_Foo"
    assert tconf.default_num_threads == jconf.default_num_threads
    assert tconf.RESAMPLING_SEPARATE_Z_ANISO_THRESHOLD == \
        jconf.RESAMPLING_SEPARATE_Z_ANISO_THRESHOLD
    for f in ("b.txt", "a.nii.gz", "c.nii.gz"):
        open(tmp_path / f, "w").close()
    assert tfiles.subfiles(str(tmp_path), suffix=".nii.gz") == \
        jfiles.subfiles(str(tmp_path), suffix=".nii.gz")
    obj = {"a": np.float32(1.5), "b": [np.int64(2)], "c": np.arange(3)}
    tfiles.save_json(obj, str(tmp_path / "t.json"))
    jfiles.save_json(obj, str(tmp_path / "j.json"))
    assert open(tmp_path / "t.json").read() == \
        open(tmp_path / "j.json").read()
