"""The port's evaluation (e2enet_tpu_torch/evaluation/, cli/evaluate.py)
and determine_postprocessing (postprocessing/connected_components.py)
against the JAX package's on the same NIfTI pairs: seeded label maps with
several components per class, predictions that miss, split and spill.
The summaries equal the JAX package's but for the timestamp, the id (an
md5 over the timestamp) and the file paths; postprocessing.json equals to
the key."""
import json
import os
import shutil

import numpy as np
import pytest

from e2enet_tpu.cli import evaluate as jcli
from e2enet_tpu.evaluation import evaluator as jev
from e2enet_tpu.io.nifti import NiftiImage, write_nifti
from e2enet_tpu.postprocessing import connected_components as jcc
from e2enet_tpu_torch.cli import evaluate as tcli
from e2enet_tpu_torch.evaluation import evaluator as tev
from e2enet_tpu_torch.postprocessing import connected_components as tcc

SHAPE = (18, 20, 22)
CASES = ("c0", "c1", "c2")


def _blobs(rng, n_classes=3):
    seg = np.zeros(SHAPE, np.uint8)
    zz, yy, xx = np.ogrid[:SHAPE[0], :SHAPE[1], :SHAPE[2]]
    for c in range(1, n_classes):
        for _ in range(2):
            ctr = rng.rand(3) * np.array(SHAPE)
            r = 2 + 3 * rng.rand()
            seg[((zz - ctr[0]) ** 2 + (yy - ctr[1]) ** 2
                 + (xx - ctr[2]) ** 2) < r * r] = c
    return seg


@pytest.fixture(scope="module")
def folders(tmp_path_factory):
    """base/validation_raw/<case>.nii.gz predictions, gt/<case>.nii.gz."""
    base = tmp_path_factory.mktemp("evaluation")
    raw, gt = base / "validation_raw", base / "gt"
    raw.mkdir()
    gt.mkdir()
    rng = np.random.RandomState(0)
    for name in CASES:
        ref = _blobs(rng)
        pred = ref.copy()
        pred[rng.rand(*SHAPE) < 0.02] = 1           # specks: small objects
        pred[np.roll(ref, 2, axis=1) == 2] = 2      # a shifted copy
        pred[:, :, :3] = 0                          # a miss
        spacing = (1.0, 1.5, 0.8)
        write_nifti(str(gt / f"{name}.nii.gz"), NiftiImage(ref, spacing))
        write_nifti(str(raw / f"{name}.nii.gz"), NiftiImage(pred, spacing))
    return base


def _strip(d):
    """A summary without what names its run (timestamp, id) or its files."""
    d = json.loads(json.dumps(d))
    for k in ("timestamp", "id"):
        d.pop(k, None)
    for res in d.get("results", d)["all"]:
        res.pop("test", None)
        res.pop("reference", None)
    return d


def test_aggregate_scores_equal(folders, tmp_path):
    pairs = [[str(folders / "validation_raw" / f"{c}.nii.gz"),
              str(folders / "gt" / f"{c}.nii.gz")] for c in CASES]
    out = {}
    for tag, mod in (("port", tev), ("jax", jev)):
        f = str(tmp_path / f"summary_{tag}.json")
        res = mod.aggregate_scores(pairs, labels=[0, 1, 2],
                                   json_output_file=f, json_name="fold 0",
                                   num_threads=2, advanced=True)
        out[tag] = (res, json.load(open(f)))
    assert _strip(out["port"][1]) == _strip(out["jax"][1])
    assert _strip(out["port"][0]) == _strip(out["jax"][0])
    assert out["port"][1]["results"]["all"][0]["test"] == pairs[0][0]
    assert np.isfinite(out["port"][1]["results"]["mean"]["1"]["Dice"])


def test_evaluate_cli_equal(folders, tmp_path):
    for tag, cli in (("port", tcli), ("jax", jcli)):
        pred = tmp_path / tag
        shutil.copytree(folders / "validation_raw", pred)
        cli.main(["-ref", str(folders / "gt"), "-pred", str(pred),
                  "-l", "1", "2"])
    got, want = (json.load(open(tmp_path / t / "summary.json"))
                 for t in ("port", "jax"))
    assert _strip(got) == _strip(want)


def test_determine_postprocessing_equal(folders, tmp_path):
    """On copies of the same fold folder: postprocessing.json equal, and
    the postprocessed predictions equal voxel for voxel."""
    for tag, mod in (("port", tcc), ("jax", jcc)):
        base = tmp_path / tag
        shutil.copytree(folders / "validation_raw", base / "validation_raw")
        pairs = [[str(base / "validation_raw" / f"{c}.nii.gz"),
                  str(folders / "gt" / f"{c}.nii.gz")] for c in CASES]
        (tev if tag == "port" else jev).aggregate_scores(
            pairs, labels=[0, 1, 2], num_threads=1, json_output_file=str(
                base / "validation_raw" / "summary.json"))
        mod.determine_postprocessing(str(base), str(folders / "gt"),
                                     "validation_raw",
                                     final_subf_name="validation_pp",
                                     processes=2)
    got, want = (json.load(open(tmp_path / t / "postprocessing.json"))
                 for t in ("port", "jax"))
    assert got == want
    assert got["for_which_classes"], "no postprocessing chosen: a weak test"
    from e2enet_tpu_torch.io.nifti import read_nifti
    for c in CASES:
        a, b = (read_nifti(str(tmp_path / t / "validation_pp"
                               / f"{c}.nii.gz")).array
                for t in ("port", "jax"))
        np.testing.assert_array_equal(a, b)
    fn = tcc.load_postprocessing_fn(str(tmp_path / "port"
                                        / "postprocessing.json"))
    assert fn is not None
    assert os.path.isfile(tmp_path / "port" / "validation_pp"
                          / "summary.json")


@pytest.mark.parametrize("spacing,tol,ball", [
    (None, 1.0, True), ((1.0, 1.0, 1.0), 2.0, True),
    ((1.5, 0.8, 0.8), 1.0, True), ((1.0, 0.78125, 0.78125), 1.5, True),
    ((0.6, 0.8, 1.0), 1.0, False), ((0.3, 0.3, 0.3), 1.0, False)])
def test_surface_dice_equal(spacing, tol, ball):
    """The port's surface Dice (a dilation by the ball of offsets within
    the tolerance, where it is exact) equals the JAX package's (a distance
    transform) to the bit on seeded specks and blobs, at spacings with
    offsets exactly at the tolerance (1 mm), and falls back to the
    transform where an offset is within rounding of it (0.6 x 0.8 mm: 1.0
    mm by float arithmetic only) or the ball is wide."""
    from scipy.ndimage import binary_dilation
    from e2enet_tpu.evaluation import metrics as jm
    from e2enet_tpu_torch.evaluation import metrics as tm
    assert (tm._tolerance_ball(spacing, tol, 3) is not None) == ball
    rng = np.random.RandomState(2)
    values = []
    for i in range(8):
        a = rng.rand(*SHAPE) < (0.02, 0.3)[i % 2]
        b = rng.rand(*SHAPE) < (0.05, 0.2)[i // 4]
        if i % 4 >= 2:
            a, b = binary_dilation(a), binary_dilation(b, iterations=2)
        got = tm.surface_dice_at_tolerance(a, b, voxel_spacing=spacing,
                                           tolerance_mm=tol)
        want = jm.surface_dice_at_tolerance(a, b, voxel_spacing=spacing,
                                            tolerance_mm=tol)
        assert got == want, (i, got, want)
        values.append(got)
    assert 0 < min(values) < 1


def test_determine_postprocessing_empty_decision(tmp_path):
    """Predictions equal to a ground truth of two objects per class: every
    removal lowers the Dice, so the decision is empty, and the final
    folder holds the raw predictions with their raw scores (the JAX
    package applies the empty list as every class present, which keeps
    one object of each class and reports its lower Dice as the
    postprocessed one)."""
    from e2enet_tpu_torch.io.nifti import read_nifti
    base, gt = tmp_path / "fold", tmp_path / "gt"
    (base / "validation_raw").mkdir(parents=True)
    gt.mkdir()
    rng = np.random.RandomState(1)
    pairs = []
    for c in CASES:
        seg = np.zeros(SHAPE, np.uint8)
        seg[2:6, 2:6, 2:6] = 1
        seg[10:15, 12:17, 14:19] = 1
        seg[2:5, 12:16, 2:6] = 2
        seg[12:16, 2:5, 14:18] = 2
        seg[rng.rand(*SHAPE) < 0.002] = 0
        for d in (base / "validation_raw", gt):
            write_nifti(str(d / f"{c}.nii.gz"), NiftiImage(seg, (1., 1., 1.)))
        pairs.append([str(base / "validation_raw" / f"{c}.nii.gz"),
                      str(gt / f"{c}.nii.gz")])
    tev.aggregate_scores(pairs, labels=[0, 1, 2], num_threads=1,
                         json_output_file=str(base / "validation_raw"
                                              / "summary.json"))
    got = tcc.determine_postprocessing(str(base), str(gt), processes=1)
    assert got["for_which_classes"] == []
    assert got["dc_per_class_pp"] == got["dc_per_class_raw"] == \
        {"1": 1.0, "2": 1.0}
    for c in CASES:
        np.testing.assert_array_equal(
            read_nifti(str(base / "validation_final" / f"{c}.nii.gz")).array,
            read_nifti(str(base / "validation_raw" / f"{c}.nii.gz")).array)
    assert tcc.load_postprocessing_fn(str(base / "postprocessing.json")) \
        is None


@pytest.mark.parametrize("min_sizes", [None, {1: 3.0, 2: 40.0, (1, 2): 5.0}])
def test_largest_component_removal_equal(min_sizes):
    """The port's one-pass removal against the reference's per-object loop
    on a speckled map (hundreds of objects per class, ties in size, a
    union of classes): the image, the largest removed and the kept sizes
    equal."""
    rng = np.random.RandomState(3)
    img = (rng.rand(*SHAPE) < 0.08).astype(np.uint8)
    img[rng.rand(*SHAPE) < 0.05] = 2
    img[2:8, 3:9, 4:10] = 1
    img[10:14, 12:16, 12:16] = 2
    for classes in ([1, 2], [(1, 2)], [2]):
        a = tcc.remove_all_but_the_largest_connected_component(
            img.copy(), classes, 1.5, min_sizes)
        b = jcc.remove_all_but_the_largest_connected_component(
            img.copy(), classes, 1.5, min_sizes)
        np.testing.assert_array_equal(a[0], b[0])
        assert a[1] == b[1] and a[2] == b[2]
        assert len(b[1]) == 0 or max(v for v in b[1].values()
                                     if v is not None) > 0
