"""The port's ensembling of saved softmax
(e2enet_tpu_torch/inference/ensemble_predictions.py) and its consolidation
of cross-validation folds (postprocessing/consolidate.py) against the JAX
package's on the same seeded inputs: merged label maps and npz files equal
to the bit, with a region model's regions_class_order and a crop box, a
refused mismatch of that order, a postprocessing file applied; the
consolidated postprocessing.json and both summaries equal but for the
timestamp and the id (an md5 over the timestamp) of aggregate_scores'.
Then a process in which jax and the JAX package cannot be imported runs
every module of the slice (trouble spot: the reference's model selection
loads its NIfTI reader by name)."""
import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

from e2enet_tpu.inference import ensemble_predictions as jens
from e2enet_tpu.postprocessing import consolidate as jcons
from e2enet_tpu_torch.evaluation import evaluator as tev
from e2enet_tpu_torch.inference import ensemble_predictions as tens
from e2enet_tpu_torch.io.nifti import NiftiImage, read_nifti, write_nifti
from e2enet_tpu_torch.postprocessing import consolidate as tcons
from e2enet_tpu_torch.utils.files import load_json, save_json

from test_torch_collectors import _strip, write_selection_tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = (10, 12, 9)
CASES = ("case_000", "case_001")
GEOM = dict(itk_spacing=(0.8, 0.8, 1.5), itk_origin=(3.0, -2.0, 7.5),
            itk_direction=tuple(np.eye(3).flatten()))


def _props(shape=SHAPE, bbox=None, original=None, regions=None):
    p = {"size_after_cropping": shape,
         "original_size_of_raw_data": original or shape,
         "original_spacing": (1.5, 0.8, 0.8),
         "spacing_after_resampling": (1.5, 0.8, 0.8),
         "crop_bbox": bbox, **GEOM}
    if regions is not None:
        p["regions_class_order"] = regions
    return p


def _blob_probs(rng, k, shape=SHAPE):
    """Class probabilities whose argmax has two separate objects of class 1
    (so that keeping the largest component changes the labels) beside
    seeded noise."""
    logits = rng.randn(k, *shape).astype(np.float32)
    logits[1, 1:4, 1:4, 1:4] += 4.0
    logits[1, 6:9, 7:11, 5:8] += 5.0
    e = np.exp(logits - logits.max(0))
    return e / e.sum(0)


def write_model_outputs(base, n_models, k=3, props=None, seed=0,
                        sigmoid=False):
    """n_models folders of -z outputs: per case <case>.npz (float16
    softmax) and <case>.pkl (the export's properties)."""
    rng = np.random.RandomState(seed)
    folders = []
    for m in range(n_models):
        f = os.path.join(base, f"model{m}")
        os.makedirs(f)
        for c in CASES:
            p = _blob_probs(rng, k)
            if sigmoid:
                p = 1.0 / (1.0 + np.exp(-4.0 * (p - 0.3)))
            np.savez_compressed(os.path.join(f, c + ".npz"),
                                softmax=p.astype(np.float16))
            with open(os.path.join(f, c + ".pkl"), "wb") as fh:
                pickle.dump(props(m, c) if callable(props)
                            else (props or _props()), fh)
        folders.append(f)
    return folders


def assert_same_outputs(a, b, npz=False):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    for n in names:
        pa, pb = os.path.join(a, n), os.path.join(b, n)
        if n.endswith(".nii.gz"):
            ia, ib = read_nifti(pa), read_nifti(pb)
            np.testing.assert_array_equal(ia.array, ib.array)
            for k in ("spacing", "origin", "direction"):
                np.testing.assert_array_equal(getattr(ia, k), getattr(ib, k))
        elif n.endswith(".npz"):
            np.testing.assert_array_equal(np.load(pa)["softmax"],
                                          np.load(pb)["softmax"])
        elif n.endswith(".pkl"):
            with open(pa, "rb") as x, open(pb, "rb") as y:
                assert pickle.load(x) == pickle.load(y)
        else:
            assert open(pa, "rb").read() == open(pb, "rb").read(), n
    assert npz == any(n.endswith(".npz") for n in names)
    return names


def test_merge_matches_reference(tmp_path):
    """Three models averaged per case: the labels and the stored npz equal
    the JAX package's; the label map is the mean softmax's argmax."""
    folders = write_model_outputs(str(tmp_path), 3)
    for pkg, out in ((jens, "j"), (tens, "t")):
        pkg.merge(folders, str(tmp_path / out), store_npz=True)
    names = assert_same_outputs(str(tmp_path / "j"), str(tmp_path / "t"),
                                npz=True)
    assert names == sorted([c + s for c in CASES
                            for s in (".nii.gz", ".npz", ".pkl")])
    for c in CASES:
        mean = np.mean([np.load(os.path.join(f, c + ".npz"))["softmax"]
                        for f in folders], 0)
        seg = read_nifti(str(tmp_path / "t" / (c + ".nii.gz")))
        np.testing.assert_array_equal(seg.array, mean.argmax(0))
        np.testing.assert_allclose(seg.spacing, GEOM["itk_spacing"])


def test_merge_files_crop_box_and_resampling(tmp_path):
    """merge_files on one case whose softmax is at another shape than
    size_after_cropping (the export resamples it, order 3) and is pasted
    into its crop box."""
    box = [[2, 2 + 14], [1, 1 + 12], [3, 3 + 11]]
    props = _props(shape=(14, 12, 11), bbox=box, original=(18, 15, 16))
    folders = write_model_outputs(str(tmp_path), 2, props=props, seed=1)
    files = [os.path.join(f, CASES[0] + ".npz") for f in folders]
    pkls = [f[:-4] + ".pkl" for f in files]
    os.makedirs(tmp_path / "j")
    os.makedirs(tmp_path / "t")
    jens.merge_files(files, pkls, str(tmp_path / "j" / "x.nii.gz"),
                     override=True, store_npz=True)
    tens.merge_files(files, pkls, str(tmp_path / "t" / "x.nii.gz"),
                     store_npz=True)
    assert_same_outputs(str(tmp_path / "j"), str(tmp_path / "t"), npz=True)
    seg = read_nifti(str(tmp_path / "t" / "x.nii.gz")).array
    assert seg.shape == (18, 15, 16)
    assert seg[:2].max() == 0 and seg[2:, 1:13, 3:14].max() > 0


def test_merge_regions_class_order(tmp_path):
    """A region model's outputs (sigmoid probabilities, the pkl naming its
    regions_class_order): labels by region order, equal to the JAX
    package's."""
    props = _props(regions=(1, 2, 3))
    folders = write_model_outputs(str(tmp_path), 2, props=props, seed=2,
                                  sigmoid=True)
    for pkg, out in ((jens, "j"), (tens, "t")):
        pkg.merge(folders, str(tmp_path / out), store_npz=True)
    assert_same_outputs(str(tmp_path / "j"), str(tmp_path / "t"), npz=True)
    for c in CASES:
        mean = np.mean([np.load(os.path.join(f, c + ".npz"))["softmax"]
                        for f in folders], 0)
        want = np.zeros(SHAPE, np.uint8)
        for i, r in enumerate((1, 2, 3)):
            want[mean[i] > 0.5] = r
        got = read_nifti(str(tmp_path / "t" / (c + ".nii.gz"))).array
        np.testing.assert_array_equal(got, want)
        with open(tmp_path / "t" / (c + ".pkl"), "rb") as fh:
            assert pickle.load(fh)["regions_class_order"] == (1, 2, 3)


@pytest.mark.parametrize("orders", [((1, 2, 3), (3, 2, 1)),
                                    ((1, 2, 3), None)])
def test_merge_refuses_mismatched_regions(tmp_path, orders):
    """Models whose regions_class_order differ (or one model without one)
    raise in both packages; nothing is written for the case."""
    folders = write_model_outputs(
        str(tmp_path), 2, props=lambda m, c: _props(regions=orders[m]),
        seed=3, sigmoid=True)
    for pkg, out in ((jens, "j"), (tens, "t")):
        with pytest.raises(AssertionError, match="regions_class_order"):
            pkg.merge(folders, str(tmp_path / out))
        assert os.listdir(tmp_path / out) == []


@pytest.mark.parametrize("classes", [[1], []])
def test_merge_applies_postprocessing(tmp_path, classes):
    """merge with a postprocessing file: the file copied beside the
    outputs. A decision [1]: each label map with all but the largest
    component of class 1 removed, the same as the JAX package's and not
    the merge without it. An empty decision: the label maps of the merge
    without it, as prediction skips an empty decision (the JAX package's
    merge reads [] as every class present)."""
    folders = write_model_outputs(str(tmp_path), 2, seed=4)
    pp = str(tmp_path / "pp.json")
    save_json({"for_which_classes": classes, "dc_per_class_raw": {},
               "min_valid_object_sizes": "None"}, pp)
    tens.merge(folders, str(tmp_path / "t"), postprocessing_file=pp)
    tens.merge(folders, str(tmp_path / "t_raw"))
    assert load_json(str(tmp_path / "t" / "postprocessing.json")) == \
        load_json(pp)
    if not classes:
        os.remove(str(tmp_path / "t" / "postprocessing.json"))
        assert_same_outputs(str(tmp_path / "t_raw"), str(tmp_path / "t"))
        return
    jens.merge(folders, str(tmp_path / "j"), postprocessing_file=pp)
    assert_same_outputs(str(tmp_path / "j"), str(tmp_path / "t"))
    from scipy.ndimage import label
    changed = 0
    for c in CASES:
        got = read_nifti(str(tmp_path / "t" / (c + ".nii.gz"))).array
        raw = read_nifti(str(tmp_path / "t_raw" / (c + ".nii.gz"))).array
        assert label(got == 1)[1] == 1
        assert ((got == raw) | ((raw == 1) & (got == 0))).all()
        changed += int((got != raw).sum())
    assert changed > 0


def write_cv_tree(base, folds=(0, 1)):
    """A trained configuration's folder with two folds' validation label
    maps and summaries (the port's evaluator), and the ground truth."""
    rng = np.random.RandomState(5)
    gt_dir = os.path.join(base, "gt")
    os.makedirs(gt_dir)
    out = os.path.join(base, "TPUTrainer__nnUNetPlansv2.1")
    for f in folds:
        val = os.path.join(out, f"fold_{f}", "validation_raw")
        os.makedirs(val)
        pairs = []
        for i in range(2):
            name = f"case_{2 * f + i:03d}.nii.gz"
            probs = _blob_probs(rng, 3)
            gt = probs.argmax(0).astype(np.uint8)
            gt[gt == 1] = 0
            gt[1:4, 1:4, 1:4] = 1
            pred = probs.argmax(0).astype(np.uint8)
            pred[rng.rand(*SHAPE) < 0.03] = 2             # specks
            for path, arr in ((os.path.join(gt_dir, name), gt),
                              (os.path.join(val, name), pred)):
                write_nifti(path, NiftiImage(arr, GEOM["itk_spacing"]))
            pairs.append([os.path.join(val, name),
                          os.path.join(gt_dir, name)])
        tev.aggregate_scores(pairs, labels=[0, 1, 2], num_threads=1,
                             json_output_file=os.path.join(val,
                                                           "summary.json"))
    return out, gt_dir


def test_consolidate_folds_matches_reference(tmp_path):
    """Two folds pooled into cv_niftis_raw, scored, postprocessing
    determined on the pool: postprocessing.json and both summaries equal
    the JAX package's, on copies of one tree at the same path."""
    import shutil
    src = tmp_path / "src"
    write_cv_tree(str(src))
    work = tmp_path / "work"
    got = {}
    for name, pkg in (("jax", jcons), ("port", tcons)):
        shutil.copytree(src, work)
        out = str(work / "TPUTrainer__nnUNetPlansv2.1")
        got[name] = pkg.consolidate_folds(out, str(work / "gt"),
                                          folds=(0, 1), processes=1)
        shutil.move(str(work), str(tmp_path / name))
    assert _strip(got["jax"]) == _strip(got["port"])
    rel = "TPUTrainer__nnUNetPlansv2.1"
    for f in ("postprocessing.json", "cv_niftis_raw/summary.json",
              "cv_niftis_postprocessed/summary.json"):
        a = load_json(str(tmp_path / "jax" / rel / f))
        b = load_json(str(tmp_path / "port" / rel / f))
        assert _strip(a) == _strip(b), f
    port = tmp_path / "port" / rel
    assert sorted(os.listdir(port / "cv_niftis_raw")) == sorted(
        [f"case_{i:03d}.nii.gz" for i in range(4)] + ["summary.json"])
    assert len(load_json(str(port / "cv_niftis_raw" / "summary.json"))
               ["results"]["all"]) == 4
    for n in sorted(os.listdir(port / "cv_niftis_postprocessed")):
        if n.endswith(".nii.gz"):
            np.testing.assert_array_equal(
                read_nifti(str(port / "cv_niftis_postprocessed" / n)).array,
                read_nifti(str(tmp_path / "jax" / rel
                               / "cv_niftis_postprocessed" / n)).array)


NO_JAX = r"""
import sys
for m in ("jax", "jaxlib", "flax", "e2enet_tpu"):
    sys.modules[m] = None
base = sys.argv[1]
import os
os.environ["RESULTS_FOLDER"] = os.path.join(base, "results")
from e2enet_tpu_torch.evaluation import collectors, model_selection
from e2enet_tpu_torch.inference import amos2022, ensemble_predictions
from e2enet_tpu_torch.postprocessing import consolidate
report = model_selection.figure_out_what_to_submit(
    "Task042_Tiny", networks=("3d_fullres", "2d"), folds=(0,),
    gt_folder=os.path.join(base, "gt"))
assert any(k.startswith("ensemble_") for k in report["candidates"]), report
bad = [k for k in sys.modules if k.split(".")[0] in
       ("jax", "jaxlib", "flax", "e2enet_tpu") and sys.modules[k] is not None]
assert not bad, bad
print("ok", report["best"])
"""


def test_slice_runs_without_jax(tmp_path):
    """Every module of the slice imports, and figure_out_what_to_submit
    builds its ensemble, in a process where jax and e2enet_tpu cannot be
    imported; neither is in sys.modules at the end."""
    write_selection_tree(tmp_path)
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", NO_JAX, str(tmp_path)],
                       cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    assert r.stdout.strip().splitlines()[-1].startswith("ok ")
    assert json.load(open(tmp_path / "results" / "nnUNet"
                          / "model_selection_Task042_Tiny.json"))["best"]
