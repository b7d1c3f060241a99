"""The port's plan-and-preprocess CLI (e2enet_tpu_torch/cli/
plan_and_preprocess.py) against the JAX package's on the CPU, each into
folders of its own, on two seeded synthetic raw tasks:

  ct  one CT modality, written directly in the raw layout (each package's
      generate_dataset_json), spacings that differ from case to case so
      that the preprocessor resamples;
  mr  two MR modalities given as 4D Medical Segmentation Decathlon images
      and converted by each package's convert_decathlon_task, about 3 mm
      along the array's last axis and 0.8 mm in plane (the 10th-percentile
      target spacing, a transpose, separate-z resampling) and a zero
      border that crops away more than a quarter of each volume (the
      nonzero mask for normalisation).

Both runs plan 3D and 2D (-pl2d) and preprocess both; the port's with two
spawned workers per step, the JAX package's in one process. Every file
they write is equal, arrays loaded and pickles unpickled, after the root
folder's path is replaced: the converted raw files, the cropped cases and
gt_segmentations, dataset_properties.pkl and the intensity properties,
the plans, every stage folder's npz and pkl (with class_locations).
Nothing is compared with a tolerance. Also every registered preprocessor
on the same cropped cases, and verify_dataset_integrity refusing the same
broken tasks in both packages."""
import gzip
import json
import os
import pickle
import shutil

import numpy as np
import pytest

from e2enet_tpu.cli import plan_and_preprocess as jcli
from e2enet_tpu.dataset_conversion import utils as jconv
from e2enet_tpu.planning.sanity import verify_dataset_integrity as jverify
from e2enet_tpu.plans import Plans as JPlans
from e2enet_tpu.utils.registry import PREPROCESSORS as JPREPROCESSORS
from e2enet_tpu_torch.cli import plan_and_preprocess as tcli
from e2enet_tpu_torch.dataset_conversion import utils as tconv
from e2enet_tpu_torch.io.nifti import NiftiImage, read_nifti, write_nifti
from e2enet_tpu_torch.planning.sanity import verify_dataset_integrity as \
    tverify
from e2enet_tpu_torch.plans import Plans as TPlans
from e2enet_tpu_torch.utils.registry import PREPROCESSORS as TPREPROCESSORS

CT_TASK = "Task091_PlanCT"
MR_TASK = "Task092_PlanMR"
LABELS = {0: "background", 1: "organ", 2: "lesion"}
# (z, y, x) array shapes and ITK (x, y, z) spacings
CT_CASES = {"ct_000": ((18, 24, 22), (1.0, 1.0, 1.5)),
            "ct_001": ((20, 22, 24), (0.9, 1.05, 1.4)),
            "ct_002": ((17, 25, 21), (1.1, 0.95, 1.6)),
            "ct_003": ((19, 23, 23), (1.0, 1.0, 1.5))}
MR_CASES = {"mr_000": ((36, 40, 8), (3.0, 0.8, 0.8)),
            "mr_001": ((34, 38, 8), (3.4, 0.78, 0.82)),
            "mr_002": ((38, 40, 9), (2.7, 0.8, 0.8)),
            "mr_003": ((36, 42, 7), (3.6, 0.82, 0.79))}
MR_BORDER = 5   # zero voxels on each side of z and y


def body_case(rng, shape, modalities, border=0, background=0.0):
    """An ellipsoid of noise (per modality) inside `background` with two
    labelled blobs; `border` voxels of zeros on both sides of z and y.
    Returns (images (M, z, y, x) float32, labels uint8)."""
    zz, yy, xx = np.meshgrid(*[np.arange(s) for s in shape], indexing="ij")
    c = [(s - 1) / 2 for s in shape]
    r = [max(s / 2 - border, 1) for s in shape[:2]] + [shape[2] / 2 + 0.5]
    body = (((zz - c[0]) / r[0]) ** 2 + ((yy - c[1]) / r[1]) ** 2
            + ((xx - c[2]) / r[2]) ** 2) < 1
    seg = np.zeros(shape, np.uint8)
    for cls, off in ((1, -2.0), (2, 2.5)):
        m = body & (((zz - c[0] - off) ** 2 + (yy - c[1] + off) ** 2)
                    < (2.5 + cls) ** 2)
        seg[m] = cls
    imgs = np.full((modalities,) + shape, background, np.float32)
    for m in range(modalities):
        vals = 100.0 * (m + 1) + 20 * rng.randn(*shape).astype(np.float32)
        vals += 60.0 * seg
        imgs[m][body] = vals[body]
    if border:
        for a in (0, 1):
            sl = [slice(None)] * 4
            sl[a + 1] = np.r_[:border, shape[a] - border:shape[a]]
            imgs[tuple(sl)] = 0
    return imgs, seg


def write_nifti_4d(path, array, spacing):
    """A 4D NIfTI (a decathlon image, array (t, z, y, x)): the port's 3D
    header with the time axis added."""
    write_nifti(path, NiftiImage(array[0], spacing))
    with gzip.open(path, "rb") as f:
        raw = bytearray(f.read())
    dims = list(np.frombuffer(bytes(raw[40:56]), "<i2"))
    dims[0], dims[4] = 4, array.shape[0]
    raw[40:56] = np.array(dims, "<i2").tobytes()
    with gzip.open(path, "wb") as f:
        f.write(bytes(raw[:352]) + np.ascontiguousarray(array).tobytes())


def write_ct_task(base, conv):
    task = os.path.join(base, "nnUNet_raw_data", CT_TASK)
    for sub in ("imagesTr", "labelsTr"):
        os.makedirs(os.path.join(task, sub))
    rng = np.random.RandomState(0)
    for name, (shape, spacing) in CT_CASES.items():
        imgs, seg = body_case(rng, shape, 1, background=-1000.0)
        write_nifti(os.path.join(task, "imagesTr", f"{name}_0000.nii.gz"),
                    NiftiImage(imgs[0], spacing))
        write_nifti(os.path.join(task, "labelsTr", f"{name}.nii.gz"),
                    NiftiImage(seg, spacing))
    return conv.generate_dataset_json(
        os.path.join(task, "dataset.json"), os.path.join(task, "imagesTr"),
        None, ("CT",), LABELS, "PlanCT")


def write_decathlon_task(folder):
    """Task92_PlanMR in the decathlon's layout: 4D images of two
    modalities, a test image, a resource-fork file the conversion skips."""
    for sub in ("imagesTr", "labelsTr", "imagesTs"):
        os.makedirs(os.path.join(folder, sub))
    rng = np.random.RandomState(1)
    training = []
    for name, (shape, spacing) in MR_CASES.items():
        imgs, seg = body_case(rng, shape, 2, border=MR_BORDER)
        write_nifti_4d(os.path.join(folder, "imagesTr", f"{name}.nii.gz"),
                       imgs, spacing)
        write_nifti(os.path.join(folder, "labelsTr", f"{name}.nii.gz"),
                    NiftiImage(seg, spacing))
        training.append({"image": f"./imagesTr/{name}.nii.gz",
                         "label": f"./labelsTr/{name}.nii.gz"})
    imgs, _ = body_case(rng, (30, 36, 8), 2, border=MR_BORDER)
    write_nifti_4d(os.path.join(folder, "imagesTs", "mr_100.nii.gz"), imgs,
                   (3.2, 0.8, 0.8))
    with open(os.path.join(folder, "imagesTr", "._mr_000.nii.gz"), "wb") as f:
        f.write(b"\0" * 64)
    with open(os.path.join(folder, "dataset.json"), "w") as f:
        json.dump({"name": "PlanMR", "modality": {"0": "FLAIR", "1": "T1w"},
                   "labels": {str(k): v for k, v in LABELS.items()},
                   "numTraining": len(training), "numTest": 1,
                   "training": training, "test": ["./imagesTs/mr_100.nii.gz"]},
                  f)


def normalise(x, root):
    if isinstance(x, str):
        return x.replace(root, "<root>")
    if isinstance(x, dict):
        return {k: normalise(v, root) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(normalise(v, root) for v in x)
    return x


def same(a, b):
    """Exact equality of nested containers, arrays to the bit with their
    dtypes (NaN equal to NaN)."""
    if isinstance(a, dict) and isinstance(b, dict):
        return list(a) == list(b) and all(same(a[k], b[k]) for k in a)
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return (a.shape == b.shape and a.dtype == b.dtype
                and np.array_equal(a, b, equal_nan=a.dtype.kind == "f"))
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(same(x, y) for x, y in zip(a, b)))
    if isinstance(a, float) and isinstance(b, float) and np.isnan(a):
        return np.isnan(b)
    return type(a) is type(b) and a == b


def load(path, root):
    if path.endswith(".npz"):
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
    if path.endswith(".pkl"):
        with open(path, "rb") as f:
            return normalise(pickle.load(f), root)
    if path.endswith(".json"):
        with open(path) as f:
            return normalise(json.load(f), root)
    if path.endswith(".nii.gz"):
        img = read_nifti(path)
        return {"array": img.array, "geometry": (img.spacing, img.origin,
                                                 img.direction)}
    with open(path, "rb") as f:
        return f.read()


def files_under(folder):
    out = []
    for d, _, names in os.walk(folder):
        out += [os.path.relpath(os.path.join(d, n), folder) for n in names]
    return sorted(out)


def assert_trees_equal(jdir, jroot, tdir, troot):
    names = files_under(jdir)
    assert names == files_under(tdir)
    for n in names:
        assert same(load(os.path.join(jdir, n), jroot),
                    load(os.path.join(tdir, n), troot)), n
    return names


def run_cli(cli, root, task_id, extra, monkeypatch):
    monkeypatch.setenv("nnUNet_raw_data_base", os.path.join(root, "raw"))
    monkeypatch.setenv("nnUNet_preprocessed",
                       os.path.join(root, "preprocessed"))
    cli.main(["-t", str(task_id), "--verify_dataset_integrity",
              "-pl2d", "ExperimentPlanner2D_v21"] + extra)


@pytest.fixture(scope="module", params=["ct", "mr"])
def runs(request, tmp_path_factory):
    """Both CLIs on one variant: {"jax": root, "torch": root, "task"}."""
    kind = request.param
    base = str(tmp_path_factory.mktemp(f"plan_{kind}"))
    roots = {pkg: os.path.join(base, pkg) for pkg in ("jax", "torch")}
    conv = {"jax": jconv, "torch": tconv}
    task = CT_TASK if kind == "ct" else MR_TASK
    datasets = {}
    if kind == "mr":
        decathlon = os.path.join(base, "Task92_PlanMR")
        write_decathlon_task(decathlon)
    for pkg, root in roots.items():
        raw = os.path.join(root, "raw")
        if kind == "ct":
            datasets[pkg] = write_ct_task(raw, conv[pkg])
        else:
            out = conv[pkg].convert_decathlon_task(
                decathlon, os.path.join(raw, "nnUNet_raw_data"))
            assert out == os.path.join(raw, "nnUNet_raw_data", MR_TASK)
    mp = pytest.MonkeyPatch()
    try:
        run_cli(jcli, roots["jax"], task[4:7], ["-tf", "1", "-tl", "1"], mp)
        run_cli(tcli, roots["torch"], task[4:7], ["-tf", "2", "-tl", "2"],
                mp)
    finally:
        mp.undo()
    return {"kind": kind, "task": task, "datasets": datasets, **roots}


def test_raw_tasks_equal(runs):
    """The converted (or written) raw task: every file, images and labels
    loaded, dataset.json parsed; the 4D images split per modality."""
    j, t = runs["jax"], runs["torch"]
    sub = os.path.join("raw", "nnUNet_raw_data", runs["task"])
    names = assert_trees_equal(os.path.join(j, sub), j, os.path.join(t, sub),
                               t)
    if runs["kind"] == "ct":
        assert same(runs["datasets"]["jax"], runs["datasets"]["torch"])
    else:
        assert "imagesTr/mr_003_0001.nii.gz" in names
        assert "imagesTs/mr_100_0001.nii.gz" in names
        assert not any("._" in n for n in names)
        img = read_nifti(os.path.join(t, sub, "imagesTr",
                                      "mr_001_0001.nii.gz"))
        assert img.array.shape == MR_CASES["mr_001"][0]
        assert img.spacing == pytest.approx(MR_CASES["mr_001"][1])


def test_cropped_equal(runs):
    """nnUNet_cropped_data/<task>: every case's npz and pkl,
    gt_segmentations, dataset.json, dataset_properties.pkl,
    props_per_case.pkl and (CT) intensityproperties.pkl."""
    j, t = runs["jax"], runs["torch"]
    sub = os.path.join("raw", "nnUNet_cropped_data", runs["task"])
    names = assert_trees_equal(os.path.join(j, sub), j, os.path.join(t, sub),
                               t)
    assert "dataset_properties.pkl" in names
    assert ("intensityproperties.pkl" in names) == (runs["kind"] == "ct")
    props = load(os.path.join(t, sub, "dataset_properties.pkl"), t)
    if runs["kind"] == "mr":
        assert np.median(list(props["size_reductions"].values())) < 0.75


def test_preprocessed_equal(runs):
    """nnUNet_preprocessed/<task>: the 3D and 2D plans, every stage
    folder's npz and pkl (class_locations in each), gt_segmentations."""
    j, t = runs["jax"], runs["torch"]
    sub = os.path.join("preprocessed", runs["task"])
    names = assert_trees_equal(os.path.join(j, sub), j, os.path.join(t, sub),
                               t)
    stages = {n.split("/")[0] for n in names if "_stage" in n}
    assert stages == {"nnUNetData_plans_v2.1_stage0",
                      "nnUNetData_plans_v2.1_2D_stage0"}
    plans = TPlans.load(os.path.join(t, sub, "nnUNetPlansv2.1_plans_3D.json"))
    assert TPlans.load(os.path.join(t, sub, "nnUNetPlansv2.1_plans_2D.json")
                       ).plans_per_stage[0].patch_size[0] == 1
    resampled = 0
    for n in names:
        if n.startswith("nnUNetData_plans_v2.1_stage0/") and n.endswith(".pkl"):
            p = load(os.path.join(t, sub, n), t)
            assert set(p["class_locations"]) == {1, 2}
            assert all(len(v) for v in p["class_locations"].values())
            resampled += tuple(p["size_after_resampling"]) != tuple(
                np.array(p["size_after_cropping"])[plans.transpose_forward])
    assert resampled >= 2, "no case was resampled"
    if runs["kind"] == "mr":
        assert plans.transpose_forward == [2, 0, 1]
        assert plans.use_mask_for_norm == {0: True, 1: True}
        spacing = plans.plans_per_stage[0].current_spacing
        assert spacing[0] < np.median([s[0] for _, s in MR_CASES.values()])
    else:
        assert plans.normalization_schemes == {0: "CT"}
        assert plans.intensity_properties[0]["sd"] > 0


def test_plans_load_across(runs):
    """Each package loads the other's plans files to the same Plans."""
    j, t = runs["jax"], runs["torch"]
    sub = os.path.join("preprocessed", runs["task"])
    for name in ("nnUNetPlansv2.1_plans_3D.json",
                 "nnUNetPlansv2.1_plans_2D.json"):
        for loader in (TPlans, JPlans):
            a = normalise(loader.load(os.path.join(j, sub, name)).to_dict(),
                          j)
            b = normalise(loader.load(os.path.join(t, sub, name)).to_dict(),
                          t)
            assert same(a, b)
            assert all(type(k) is int for k in a["plans_per_stage"])


@pytest.mark.parametrize("name", sorted(JPREPROCESSORS.keys()))
def test_every_preprocessor_matches(runs, name, tmp_path):
    """Each registered preprocessor's run on the port's cropped cases with
    the 3D plan's settings, in both packages."""
    t = runs["torch"]
    cropped = os.path.join(t, "raw", "nnUNet_cropped_data", runs["task"])
    plans = TPlans.load(os.path.join(t, "preprocessed", runs["task"],
                                     "nnUNetPlansv2.1_plans_3D.json"))
    spacing = plans.plans_per_stage[0].current_spacing
    outs = {}
    for pkg, registry in (("jax", JPREPROCESSORS), ("torch", TPREPROCESSORS)):
        pre = registry.get(name)(plans.normalization_schemes,
                                 plans.use_mask_for_norm,
                                 plans.transpose_forward,
                                 plans.intensity_properties)
        outs[pkg] = str(tmp_path / pkg)
        pre.run([spacing, [s * 1.5 for s in spacing]], cropped, outs[pkg],
                "ident", 1)
    names = assert_trees_equal(outs["jax"], outs["jax"], outs["torch"],
                               outs["torch"])
    assert len(names) == 4 * len(CT_CASES)


BREAKS = ["unexpected_label", "missing_image", "label_geometry",
          "labels_not_consecutive"]


@pytest.mark.parametrize("how", BREAKS)
def test_integrity_rejects_alike(runs, how, tmp_path):
    """A broken copy of the raw task: both packages' verify_dataset_integrity
    refuse it with the same message; the intact task passes both."""
    src = os.path.join(runs["torch"], "raw", "nnUNet_raw_data", runs["task"])
    assert jverify(src) and tverify(src)
    task = str(tmp_path / runs["task"])
    shutil.copytree(src, task)
    first = sorted(os.listdir(os.path.join(task, "labelsTr")))[0]
    label = os.path.join(task, "labelsTr", first)
    if how == "unexpected_label":
        img = read_nifti(label)
        arr = img.array.copy()
        arr[0, 0, 0] = 7
        write_nifti(label, NiftiImage(arr, img.spacing))
    elif how == "missing_image":
        os.remove(os.path.join(task, "imagesTr",
                               first.replace(".nii.gz", "_0000.nii.gz")))
    elif how == "label_geometry":
        img = read_nifti(label)
        write_nifti(label, NiftiImage(img.array, tuple(
            s * 1.1 for s in img.spacing)))
    else:
        with open(os.path.join(task, "dataset.json")) as f:
            d = json.load(f)
        d["labels"] = {"0": "background", "1": "organ", "3": "lesion"}
        with open(os.path.join(task, "dataset.json"), "w") as f:
            json.dump(d, f)
    msgs = []
    for verify in (jverify, tverify):
        with pytest.raises(AssertionError) as e:
            verify(task)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
