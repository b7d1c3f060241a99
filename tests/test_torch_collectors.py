"""The port's result collectors and model selection
(e2enet_tpu_torch/evaluation/collectors.py, model_selection.py): the seven
cases of tests/test_collectors.py on the port, each also run by the JAX
package on a copy of the same tree at the same path (the JAX package
first, then the port, the tree restored between them), so that paths
written into the outputs agree. JSON files equal but for the timestamp and
the id (an md5 over the timestamp) of aggregate_scores' summaries; CSV,
prediction_commands.txt and every other text file equal byte for byte;
NIfTI arrays and geometry equal."""
import os
import pickle
import shutil
from types import SimpleNamespace

import numpy as np

from e2enet_tpu.evaluation import collectors as jcol
from e2enet_tpu.evaluation import model_selection as jms
from e2enet_tpu.io.nifti import read_nifti as jread
from e2enet_tpu.plans import Plans as JPlans
from e2enet_tpu.plans import StagePlan as JStagePlan
from e2enet_tpu_torch.evaluation import collectors as tcol
from e2enet_tpu_torch.evaluation import evaluator as tev
from e2enet_tpu_torch.evaluation import model_selection as tms
from e2enet_tpu_torch.io.nifti import NiftiImage, read_nifti, write_nifti
from e2enet_tpu_torch.utils.files import load_json, maybe_mkdir_p, save_json

PKGS = {"jax": SimpleNamespace(collectors=jcol, model_selection=jms),
        "port": SimpleNamespace(collectors=tcol, model_selection=tms)}
RUN_KEYS = ("timestamp", "id")


def _summary(mean_dices):
    return {"results": {
        "mean": {str(i): {"Dice": d, "Jaccard": d / 2}
                 for i, d in enumerate(mean_dices)},
        "all": []}}


def _mk_tree(root, net, task, trainer, fold_dices, folds=(0, 1)):
    for f in folds:
        d = os.path.join(root, net, task, trainer, f"fold_{f}",
                         "validation_raw")
        maybe_mkdir_p(d)
        save_json(_summary(fold_dices[f]), os.path.join(d, "summary.json"))


def run_both(tmp_path, build, run, monkeypatch=None):
    """build(work) writes a tree under `work`; run(pkg, work) runs one
    package there. The JAX package runs first, then the port, each on a
    fresh copy of the tree at the same path; the trees they leave are
    moved to tmp_path/jax and tmp_path/port. Returns ({name: result},
    {name: tree})."""
    src, work = tmp_path / "src", tmp_path / "work"
    src.mkdir()
    build(src)
    out, trees = {}, {}
    for name, pkg in PKGS.items():
        shutil.copytree(src, work)
        if monkeypatch is not None:
            monkeypatch.setenv("RESULTS_FOLDER", str(work / "results"))
        out[name] = run(pkg, work)
        trees[name] = tmp_path / name
        shutil.move(str(work), str(trees[name]))
    return out, trees


def _strip(d):
    if isinstance(d, dict):
        return {k: _strip(v) for k, v in d.items() if k not in RUN_KEYS}
    if isinstance(d, list):
        return [_strip(v) for v in d]
    return d


def assert_same_tree(a, b):
    """The same files under a and b, each equal as its kind is compared;
    returns the relative paths."""
    files = sorted(os.path.relpath(os.path.join(r, f), a)
                   for r, _, fs in os.walk(a) for f in fs)
    files_b = sorted(os.path.relpath(os.path.join(r, f), b)
                     for r, _, fs in os.walk(b) for f in fs)
    assert files == files_b
    for rel in files:
        fa, fb = os.path.join(a, rel), os.path.join(b, rel)
        if rel.endswith(".json"):
            assert _strip(load_json(fa)) == _strip(load_json(fb)), rel
        elif rel.endswith(".nii.gz"):
            ia, ib = read_nifti(fa), read_nifti(fb)
            np.testing.assert_array_equal(ia.array, ib.array, err_msg=rel)
            for k in ("spacing", "origin", "direction"):
                np.testing.assert_array_equal(getattr(ia, k), getattr(ib, k))
        elif rel.endswith(".npz"):
            za, zb = np.load(fa), np.load(fb)
            assert sorted(za.files) == sorted(zb.files)
            for k in za.files:
                np.testing.assert_array_equal(za[k], zb[k])
        elif rel.endswith(".pkl"):
            with open(fa, "rb") as x, open(fb, "rb") as y:
                assert pickle.load(x) == pickle.load(y), rel
        else:
            with open(fa, "rb") as x, open(fb, "rb") as y:
                assert x.read() == y.read(), rel
    return files


def test_foreground_mean(tmp_path):
    def build(work):
        save_json(_summary([0.99, 0.8, 0.6]), str(work / "s.json"))

    _, trees = run_both(tmp_path, build, lambda pkg, work:
                        pkg.collectors.foreground_mean(str(work / "s.json")))
    assert_same_tree(trees["jax"], trees["port"])
    res = load_json(str(trees["port"] / "s.json"))["results"]["mean"]
    np.testing.assert_allclose(res["mean"]["Dice"], 0.7)
    np.testing.assert_allclose(res["mean"]["Jaccard"], 0.35)


def test_summarize_and_csv(tmp_path, monkeypatch):
    def build(work):
        root = str(work / "results")
        _mk_tree(root, "3d_fullres", "Task001_Foo", "TPUTrainer__plansA",
                 {0: [0.9, 0.8, 0.7], 1: [0.9, 0.6, 0.5]})
        _mk_tree(root, "2d", "Task001_Foo", "TPUTrainer__plansA",
                 {0: [0.9, 0.5, 0.5], 1: [0.9, 0.5, 0.5]})

    def run(pkg, work):
        root = str(work / "results")
        written = pkg.collectors.summarize(
            ("1",), output_dir=str(work / "sums"), folds=(0, 1),
            results_dir=root)
        csv = pkg.collectors.collect_results_csv(
            str(work / "out.csv"), folds=(0,), results_dir=root,
            output_dir=str(work / "sums_f0"))
        return ([os.path.relpath(w, work) for w in written],
                os.path.relpath(csv, work))

    out, trees = run_both(tmp_path, build, run, monkeypatch)
    assert out["jax"] == out["port"]
    files = assert_same_tree(trees["jax"], trees["port"])
    assert "out.csv" in files
    written, csv = out["port"]
    assert len(written) == 2
    full = [w for w in written if "3d_fullres" in os.path.basename(w)][0]
    res = load_json(str(trees["port"] / full))["results"]["mean"]
    np.testing.assert_allclose(res["1"]["Dice"], 0.7)   # (0.8+0.6)/2
    np.testing.assert_allclose(res["mean"]["Dice"], 0.65)
    lines = open(trees["port"] / csv).read().strip().splitlines()
    assert len(lines) == 3  # header + 2 configs
    assert any("3d_fullres" in ln and "0.7500" in ln for ln in lines)


def test_crawl_and_copy(tmp_path):
    def build(work):
        src = work / "tree" / "a" / "fold_0"
        src.mkdir(parents=True)
        save_json({"x": 1}, str(src / "summary.json"))
        (work / "tree" / "b").mkdir()
        save_json({"x": 2}, str(work / "tree" / "b" / "summary.json"))

    _, trees = run_both(tmp_path, build, lambda pkg, work:
                        pkg.collectors.crawl_and_copy(str(work / "tree"),
                                                      str(work / "out")))
    assert_same_tree(trees["jax"], trees["port"])
    files = os.listdir(trees["port"] / "out")
    assert len(files) == 1 and "fold_0" in files[0]


def test_rank_candidates():
    results = {
        "trainerA": {"t1": 0.9, "t2": 0.8},
        "trainerB": {"t1": 0.8, "t2": 0.9},
        "trainerC": {"t1": 0.95, "t2": 0.85},
    }
    ranked = tcol.rank_candidates(results)
    assert ranked == jcol.rank_candidates(results)
    assert ranked[0][1] == "trainerC"        # best mean rank
    assert len(ranked) == 3
    assert tcol.rank_candidates({}) == jcol.rank_candidates({}) == []


def test_rank_trained_candidates(tmp_path, monkeypatch):
    def build(work):
        root = str(work / "results")
        _mk_tree(root, "3d_fullres", "Task001_Foo", "A__p",
                 {0: [0.9, 0.9, 0.9]}, folds=(0,))
        _mk_tree(root, "3d_fullres", "Task001_Foo", "B__p",
                 {0: [0.9, 0.5, 0.5]}, folds=(0,))
        _mk_tree(root, "3d_fullres", "Task002_Bar", "B__p",
                 {0: [0.9, 0.7, 0.7]}, folds=(0,))

    out, trees = run_both(
        tmp_path, build, lambda pkg, work:
        pkg.collectors.rank_trained_candidates(
            ["Task001_Foo", "Task002_Bar"], results_dir=str(work / "results")),
        monkeypatch)
    assert out["jax"] == out["port"]
    assert_same_tree(trees["jax"], trees["port"])
    assert out["port"][0][1] == "A__p"


def test_write_plans_summary(tmp_path):
    sp = JStagePlan(batch_size=2, patch_size=[64, 128, 128],
                    current_spacing=[2.0, 1.0, 1.0],
                    original_spacing=[3.0, 1.5, 1.5],
                    pool_op_kernel_sizes=[[2, 2, 2]] * 4,
                    conv_kernel_sizes=[[1, 3, 3]] * 5,
                    num_pool_per_axis=[4, 4, 4],
                    median_patient_size_in_voxels=[100, 200, 200],
                    do_dummy_2D_data_aug=False)
    sp_low = JStagePlan(batch_size=2, patch_size=[48, 96, 96],
                        current_spacing=[4.0, 2.0, 2.0],
                        original_spacing=[3.0, 1.5, 1.5],
                        pool_op_kernel_sizes=[[2, 2, 2]] * 3,
                        conv_kernel_sizes=[[3, 3, 3]] * 4,
                        num_pool_per_axis=[3, 3, 3],
                        median_patient_size_in_voxels=[50, 100, 100],
                        do_dummy_2D_data_aug=False)

    def build(work):
        for name, stages in (("plans.json", {0: sp}),
                             ("plans2.json", {0: sp_low, 1: sp})):
            plans = JPlans(
                num_stages=len(stages), num_modalities=1,
                modalities={0: "CT"}, normalization_schemes={0: "CT"},
                dataset_properties={}, list_of_npz_files=[],
                original_spacings=[[3.0, 1.5, 1.5]],
                original_sizes=[[100, 200, 200]],
                preprocessed_data_folder=None, num_classes=2,
                all_classes=[1, 2], base_num_features=48,
                use_mask_for_norm={0: False}, keep_only_largest_region=None,
                min_region_size_per_class=None, min_size_per_class=None,
                transpose_forward=[0, 1, 2], transpose_backward=[0, 1, 2],
                data_identifier="x", plans_per_stage=stages)
            plans.save(str(work / name))

    def run(pkg, work):
        pfs = [str(work / "plans.json"), str(work / "plans2.json")]
        pkg.collectors.write_plans_summary(pfs, str(work / "p.csv"))
        pkg.collectors.write_plans_summary(pfs, str(work / "p0.csv"), 0)

    run_both(tmp_path, build, run)
    assert_same_tree(tmp_path / "jax", tmp_path / "port")
    lines = open(tmp_path / "port" / "p.csv").read().strip().splitlines()
    assert len(lines) == 3
    assert "128.000,128.000,128.000" in lines[1]
    assert "192.000,192.000,192.000" in open(
        tmp_path / "port" / "p0.csv").read().splitlines()[2]


TASK, TRAINER = "Task042_Tiny", "TPUTrainer__nnUNetPlansv2.1"
SHAPE = (6, 7, 8)
CASES = ("case_000", "case_001")
PROPS = {"size_after_cropping": SHAPE,
         "original_size_of_raw_data": SHAPE,
         "original_spacing": (1.0, 1.0, 1.0),
         "spacing_after_resampling": (1.0, 1.0, 1.0),
         "crop_bbox": None,
         "itk_spacing": (1, 1, 1), "itk_origin": (0, 0, 0),
         "itk_direction": tuple(np.eye(3).flatten())}


def write_selection_tree(work, configs=(("3d_fullres", 0.02),
                                        ("2d", 0.30))):
    """tests/test_collectors.py's tree, written with the port's io: ground
    truth under work/gt, and per configuration a fold 0 whose validation
    holds each case's float16 softmax (npz + pkl), its label map and the
    summary the evaluator writes. Returns the gt folder."""
    rng = np.random.RandomState(0)
    root = str(work / "results" / "nnUNet")
    gt_dir = work / "gt"
    maybe_mkdir_p(str(gt_dir))
    gts = {}
    for c in CASES:
        gt = (rng.rand(*SHAPE) < 0.35).astype(np.uint8)
        gt[2:4, 2:4, 2:4] = 2
        gts[c] = gt
        write_nifti(str(gt_dir / f"{c}.nii.gz"),
                    NiftiImage(array=gt, spacing=(1, 1, 1),
                               origin=(0, 0, 0),
                               direction=tuple(np.eye(3).flatten())))
    for net, pflip in configs:
        val = os.path.join(root, net, TASK, TRAINER, "fold_0",
                           "validation_raw")
        maybe_mkdir_p(val)
        pairs = []
        for c in CASES:
            lab = gts[c].copy()
            flip = rng.rand(*SHAPE) < pflip           # corrupted voxels
            lab[flip] = (lab[flip] + 1) % 3
            soft = np.stack([(lab == k).astype(np.float32) * 0.9 + 0.05
                             for k in range(3)])
            soft /= soft.sum(0, keepdims=True)
            np.savez_compressed(os.path.join(val, f"{c}.npz"),
                                softmax=soft.astype(np.float16))
            with open(os.path.join(val, f"{c}.pkl"), "wb") as f:
                pickle.dump(PROPS, f)
            write_nifti(os.path.join(val, f"{c}.nii.gz"),
                        NiftiImage(array=soft.argmax(0).astype(np.uint8),
                                   spacing=(1, 1, 1), origin=(0, 0, 0),
                                   direction=tuple(np.eye(3).flatten())))
            pairs.append([os.path.join(val, f"{c}.nii.gz"),
                          str(gt_dir / f"{c}.nii.gz")])
        tev.aggregate_scores(pairs, labels=[0, 1, 2], num_threads=1,
                             json_output_file=os.path.join(val,
                                                           "summary.json"))
    return str(gt_dir)


def test_figure_out_what_to_submit_with_ensembling(tmp_path, monkeypatch):
    """Full submission decision incl. AUTOMATIC pairwise-ensemble build +
    score + postprocessing determination (figure_out_what_to_submit.py:47+,
    ensemble.py:39): two tiny trained configs with saved validation
    softmax -> the ensemble is constructed, scored, ranked, and the
    decision JSON / prediction_commands.txt / summary.csv are written; the
    port's tree, report and ensembled NIfTIs equal the JAX package's."""
    def run(pkg, work):
        return pkg.model_selection.figure_out_what_to_submit(
            TASK, networks=("3d_fullres", "2d"), trainer_plan=TRAINER,
            folds=(0,), gt_folder=str(work / "gt"))

    out, trees = run_both(tmp_path, write_selection_tree, run, monkeypatch)
    report = out["port"]
    assert report.keys() == out["jax"].keys()
    for k in report:
        assert report[k] == out["jax"][k], k
    files = assert_same_tree(trees["jax"], trees["port"])

    ens_name = f"ensemble_2d__{TRAINER}--3d_fullres__{TRAINER}"
    assert ens_name in report["candidates"], report["candidates"].keys()
    assert set(report["ranking"]) == {"3d_fullres", "2d", ens_name}
    assert report["best"] in report["ranking"]
    # the low-noise config must beat the high-noise one
    assert (report["candidates"]["3d_fullres"]["mean_fg_dice"]
            > report["candidates"]["2d"]["mean_fg_dice"])
    root = trees["port"] / "results" / "nnUNet"
    ens = os.path.join("results", "nnUNet", "ensembles", TASK, ens_name)
    raw = [f for f in files if f.startswith(os.path.join(ens,
                                                         "ensembled_raw"))]
    assert sorted(os.path.basename(f) for f in raw) == sorted(
        [f"{c}.nii.gz" for c in CASES] + ["summary.json"])
    for c in CASES:   # each ensembled NIfTI: the mean softmax's argmax
        got = read_nifti(str(trees["port"] / ens / "ensembled_raw"
                             / f"{c}.nii.gz")).array
        np.testing.assert_array_equal(got, jread(str(
            trees["jax"] / ens / "ensembled_raw" / f"{c}.nii.gz")).array)
    # postprocessing determination ran on the ensemble
    assert os.path.isfile(trees["port"] / ens / "postprocessing.json")
    sf = root / "ensembles" / TASK
    assert os.path.isfile(sf / "prediction_commands.txt")
    csv = open(sf / "summary.csv").read().splitlines()
    assert csv[0] == "model,class1,class2,average"
    assert len(csv) == 4
    # the decision JSON exists and round-trips
    rep2 = load_json(str(root / f"model_selection_{TASK}.json"))
    assert rep2["best"] == report["best"]
