"""The long-tail per-challenge converters (reference dataset_conversion/).

Completes the inventory beyond tasks.py: MetaImage, NRRD, TIFF, PNG, HDF5
and DICOM sources, orientation-normalized spine CTs, and csv-driven label
maps. Each function cites the reference script it mirrors.

The port's own copy of e2enet_tpu/dataset_conversion/tasks_extra.py,
unchanged but for this note and four unused imports left out: the port
imports nothing of the JAX package. h5py (convert_cremi), pandas
(convert_mnms, convert_ribfrac*) and io.dicom (convert_chaos) are
imported inside the functions that use them, and PIL inside io.images2d's
readers and writers (the TIFF and PNG sources), so the module imports
without the optional libraries.
"""
import os
import shutil

import numpy as np

from ..io.images2d import read_2d_image, read_tiff_stack
from ..io.metaimage import read_mhd, write_mhd
from ..io.nifti import NiftiImage, read_nifti, write_nifti
from ..preprocessing.reorientation import (
    reorient_all_images_in_folder_to_ras)
from ..utils.files import isdir, isfile, join, maybe_mkdir_p, subdirs, subfiles
from .file_conversions import convert_2d_image_to_nifti
from .tasks import _out_base
from .utils import generate_dataset_json


# ---------------------------------------------------------------------------
# Task024 PROMISE12 (MetaImage prostate MR)

def convert_promise2012(base: str, task_id: int = 24,
                        task_name: str = "Promise"):
    """Task024_Promise2012.py:34-81: train/*.mhd (images +
    *segmentation.mhd labels), test/*.mhd."""
    out_base = _out_base(task_id, task_name)
    train_dir = join(base, "train")
    segs = subfiles(train_dir, suffix="segmentation.mhd")
    raws = [f for f in subfiles(train_dir, suffix="mhd")
            if not f.endswith("segmentation.mhd")]
    for f in raws:
        name = os.path.basename(f)[:-4]
        write_nifti(join(out_base, "imagesTr", name + "_0000.nii.gz"),
                    read_mhd(f))
    for f in segs:
        name = os.path.basename(f)[:-len("segmentation.mhd")].rstrip("_")
        seg = read_mhd(f)
        seg.array = seg.array.astype(np.uint8)
        write_nifti(join(out_base, "labelsTr", name + ".nii.gz"), seg)
    test_dir = join(base, "test")
    if isdir(test_dir):
        for f in subfiles(test_dir, suffix="mhd"):
            name = os.path.basename(f)[:-4]
            write_nifti(join(out_base, "imagesTs", name + "_0000.nii.gz"),
                        read_mhd(f))
    generate_dataset_json(join(out_base, "dataset.json"),
                          join(out_base, "imagesTr"),
                          join(out_base, "imagesTs"), ("MRI",),
                          {0: "background", 1: "prostate"}, "PROMISE12",
                          dataset_description="prostate")
    return out_base


def export_promise_submission(source_dir: str, target_dir: str):
    """Task024_Promise2012.py:19-31: promise wants mhd."""
    maybe_mkdir_p(target_dir)
    for f in subfiles(source_dir, suffix=".nii.gz", join=False):
        img = read_nifti(join(source_dir, f))
        write_mhd(join(target_dir, f[:-7] + ".mhd"), img)


# ---------------------------------------------------------------------------
# Task035 ISBI MS lesion (4-modality longitudinal MR)

def convert_isbi_mslesion(base: str, task_id: int = 35,
                          task_name: str = "ISBILesionSegmentation"):
    """Task035_ISBI_MSLesionSegmentationChallenge.py: per (patient,
    timestep) cases with flair/mprage/pd/t2 modalities; each of the two
    rater masks becomes its own training case (case__PP__TT__maskM)."""
    out_base = _out_base(task_id, task_name)
    train_dir, test_dir = join(base, "imagesTr"), join(base, "imagesTs")
    label_dir = join(base, "labelsTr")
    mods = ["flair_pp", "mprage_pp", "pd_pp", "t2_pp"]

    def find_cases(folder):
        cases = {}
        for f in subfiles(folder, suffix=".nii", join=False) + \
                subfiles(folder, suffix=".nii.gz", join=False):
            parts = os.path.basename(f).split("_")
            for pid in range(1, 15):
                for t in range(1, 10):
                    key = "%02d_%02d_" % (pid, t)
                    if key in f:
                        cases.setdefault((pid, t), []).append(f)
        return cases

    tr_files = []
    for (pid, t), files in sorted(find_cases(train_dir).items()):
        mask_files = [f for f in subfiles(
            label_dir, join=False)
            if ("%02d_%02d" % (pid, t)) in f and "mask" in f]
        for m, mf in enumerate(sorted(mask_files), 1):
            ident = "case__%02.0d__%02.0d__mask%d" % (pid, t, m)
            for j, mod in enumerate(mods):
                src = [f for f in files if f.endswith(mod + ".nii")
                       or f.endswith(mod + ".nii.gz")]
                if not src:
                    continue
                write_nifti(join(out_base, "imagesTr",
                                 f"{ident}_{j:04d}.nii.gz"),
                            read_nifti(join(train_dir, src[0])))
            seg = read_nifti(join(label_dir, mf))
            seg.array = seg.array.astype(np.uint8)
            write_nifti(join(out_base, "labelsTr", ident + ".nii.gz"), seg)
            tr_files.append(ident)
    if isdir(test_dir):
        for (pid, t), files in sorted(find_cases(test_dir).items()):
            ident = "case__%02.0d__%02.0d" % (pid, t)
            for j, mod in enumerate(mods):
                src = [f for f in files if f.endswith(mod + ".nii")
                       or f.endswith(mod + ".nii.gz")]
                if not src:
                    continue
                write_nifti(join(out_base, "imagesTs",
                                 f"{ident}_{j:04d}.nii.gz"),
                            read_nifti(join(test_dir, src[0])))
    generate_dataset_json(
        join(out_base, "dataset.json"), join(out_base, "imagesTr"),
        join(out_base, "imagesTs"), ("flair", "mprage", "pd", "t2"),
        {0: "background", 1: "lesion"},
        "ISBI_Lesion_Segmentation_Challenge_2015")
    return out_base


# ---------------------------------------------------------------------------
# Task056/083 VerSe (vertebra CT, arbitrary orientations)

VERSE_LABELS = {i: str(i) for i in range(26)}


def convert_verse2019(base: str, task_id: int = 56,
                      task_name: str = "VerSe"):
    """Task056_VerSe2019.py:119-180: train/*_seg.nii.gz + image, test/
    images; then every image is reoriented to RAS with affine sidecars."""
    out_base = _out_base(task_id, task_name)
    train_names = [f[:-len("_seg.nii.gz")] for f in subfiles(
        join(base, "train"), join=False, suffix="_seg.nii.gz")]
    for p in train_names:
        shutil.copy(join(base, "train", p + ".nii.gz"),
                    join(out_base, "imagesTr", p + "_0000.nii.gz"))
        shutil.copy(join(base, "train", p + "_seg.nii.gz"),
                    join(out_base, "labelsTr", p + ".nii.gz"))
    if isdir(join(base, "test")):
        for f in subfiles(join(base, "test"), join=False,
                          suffix=".nii.gz"):
            shutil.copy(join(base, "test", f),
                        join(out_base, "imagesTs", f[:-7] + "_0000.nii.gz"))
    generate_dataset_json(join(out_base, "dataset.json"),
                          join(out_base, "imagesTr"),
                          join(out_base, "imagesTs"), ("CT",),
                          VERSE_LABELS, "VerSe2019")
    reorient_all_images_in_folder_to_ras(join(out_base, "imagesTr"))
    reorient_all_images_in_folder_to_ras(join(out_base, "imagesTs"))
    reorient_all_images_in_folder_to_ras(join(out_base, "labelsTr"))
    return out_base


def convert_verse2020(base: str, task_id: int = 83,
                      task_name: str = "VerSe2020"):
    """Task083_VerSe2020.py: training_data/<site>/*_seg.nii.gz."""
    out_base = _out_base(task_id, task_name)
    for site in subdirs(join(base, "training_data"), join=False):
        curr = join(base, "training_data", site)
        for f in subfiles(curr, join=False, suffix="_seg.nii.gz"):
            p = f[:-len("_seg.nii.gz")]
            shutil.copy(join(curr, p + ".nii.gz"),
                        join(out_base, "imagesTr", p + "_0000.nii.gz"))
            shutil.copy(join(curr, f),
                        join(out_base, "labelsTr", p + ".nii.gz"))
    generate_dataset_json(join(out_base, "dataset.json"),
                          join(out_base, "imagesTr"), None, ("CT",),
                          VERSE_LABELS, "VerSe2020")
    reorient_all_images_in_folder_to_ras(join(out_base, "imagesTr"))
    reorient_all_images_in_folder_to_ras(join(out_base, "labelsTr"))
    return out_base


# ---------------------------------------------------------------------------
# Task058/059 EM stacks (multipage tiff, 5 copies for 5-fold CV)

def _write_replicated(img: NiftiImage, seg: NiftiImage, out_base: str,
                      n: int = 5):
    for i in range(n):
        write_nifti(join(out_base, "imagesTr",
                         f"training{i}_0000.nii.gz"), img)
        write_nifti(join(out_base, "labelsTr", f"training{i}.nii.gz"), seg)


def convert_isbi_em_seg(base: str, task_id: int = 58,
                        task_name: str = "ISBI_EM_SEG"):
    """Task058_ISBI_EM_SEG.py:38-104: single training tiff stack
    replicated 5x (5-fold CV needs >= 5 cases); walls are foreground."""
    out_base = _out_base(task_id, task_name)
    vol = read_tiff_stack(join(base, "train-volume.tif"))
    lab = read_tiff_stack(join(base, "train-labels.tif")).copy()
    lab[lab == 255] = 1
    lab = (1 - lab).astype(np.uint8)      # walls foreground
    sp = (4.0, 4.0, 50.0)
    _write_replicated(
        NiftiImage(vol.astype(np.float32), sp),
        NiftiImage(lab, sp), out_base)
    test = read_tiff_stack(join(base, "test-volume.tif"))
    write_nifti(join(out_base, "imagesTs", "testing_0000.nii.gz"),
                NiftiImage(test.astype(np.float32), sp))
    generate_dataset_json(join(out_base, "dataset.json"),
                          join(out_base, "imagesTr"),
                          join(out_base, "imagesTs"), ("EM",),
                          {0: "0", 1: "1"}, task_name)
    return out_base


def export_em_submission(predicted_npz: str, out_file: str):
    """Task058_ISBI_EM_SEG.py:23-35: 32-bit 3D tif of non-membrane
    probability."""
    from ..io.images2d import write_tiff_stack
    a = np.load(predicted_npz)["softmax"]
    a = a / a.sum(0)[None]
    assert out_file.endswith(".tif")
    write_tiff_stack(out_file, a[0].astype(np.float32))


def convert_epfl_em_mito(base: str, task_id: int = 59,
                         task_name: str = "EPFL_EM_MITO_SEG"):
    """Task059_EPFL_EM_MITO_SEG.py:27-98."""
    out_base = _out_base(task_id, task_name)
    maybe_mkdir_p(join(out_base, "labelsTs"))
    sp = (5.0, 5.0, 5.0)
    vol = read_tiff_stack(join(base, "training.tif"))
    lab = read_tiff_stack(join(base, "training_groundtruth.tif")).copy()
    lab[lab == 255] = 1
    _write_replicated(NiftiImage(vol.astype(np.float32), sp),
                      NiftiImage(lab.astype(np.uint8), sp), out_base)
    test = read_tiff_stack(join(base, "testing.tif"))
    test_lab = read_tiff_stack(
        join(base, "testing_groundtruth.tif")).copy()
    test_lab[test_lab == 255] = 1
    write_nifti(join(out_base, "imagesTs", "testing_0000.nii.gz"),
                NiftiImage(test.astype(np.float32), sp))
    write_nifti(join(out_base, "labelsTs", "testing.nii.gz"),
                NiftiImage(test_lab.astype(np.uint8), sp))
    generate_dataset_json(join(out_base, "dataset.json"),
                          join(out_base, "imagesTr"),
                          join(out_base, "imagesTs"), ("EM",),
                          {0: "0", 1: "1"}, task_name)
    return out_base


# ---------------------------------------------------------------------------
# Task061 CREMI (synaptic clefts, HDF5)

def convert_cremi(base: str, task_id: int = 61, task_name: str = "CREMI"):
    """Task061_CREMI.py:28-145: volumes/raw + volumes/labels/clefts
    (clefts are low values, background 0xffffffffffffffff)."""
    import h5py
    out_base = _out_base(task_id, task_name)
    sp = (4.0, 4.0, 40.0)

    def load_sample(fname):
        with h5py.File(fname, "r") as f:
            data = np.array(f["volumes"]["raw"])
            labels = None
            if "labels" in f["volumes"].keys():
                labels = (np.array(f["volumes"]["labels"]["clefts"])
                          < 100000).astype(np.uint8)
        return data, labels

    for s in "ABC":
        img, lab = load_sample(join(base, f"sample_{s}_20160501.hdf"))
        write_nifti(join(out_base, "imagesTr",
                         f"sample_{s.lower()}_0000.nii.gz"),
                    NiftiImage(img.astype(np.float32), sp))
        write_nifti(join(out_base, "labelsTr",
                         f"sample_{s.lower()}.nii.gz"),
                    NiftiImage(lab, sp))
    for s in "ABC":
        test = join(base, f"sample_{s}+_20160601.hdf")
        if isfile(test):
            img, _ = load_sample(test)
            write_nifti(join(out_base, "imagesTs",
                             f"sample_{s.lower()}+_0000.nii.gz"),
                        NiftiImage(img.astype(np.float32), sp))
    generate_dataset_json(join(out_base, "dataset.json"),
                          join(out_base, "imagesTr"),
                          join(out_base, "imagesTs"), ("EM",),
                          {0: "background", 1: "synaptic cleft"},
                          task_name)
    return out_base


# ---------------------------------------------------------------------------
# Task065 KiTS Nick's labels

def convert_kits_nicks_labels(kits_data_dir: str, filled_labels_dir: str,
                              task_id: int = 65,
                              task_name: str = "KiTS_NicksLabels"):
    """Task065_KiTS_NicksLabels.py:25-87: kits19 case folders + external
    filled labels; first 210 cases train, rest test."""
    out_base = _out_base(task_id, task_name)
    all_cases = subdirs(kits_data_dir, join=False)
    for p in all_cases[:210]:
        shutil.copy(join(kits_data_dir, p, "imaging.nii.gz"),
                    join(out_base, "imagesTr", p + "_0000.nii.gz"))
        shutil.copy(join(filled_labels_dir, p + ".nii.gz"),
                    join(out_base, "labelsTr", p + ".nii.gz"))
    for p in all_cases[210:]:
        shutil.copy(join(kits_data_dir, p, "imaging.nii.gz"),
                    join(out_base, "imagesTs", p + "_0000.nii.gz"))
    generate_dataset_json(join(out_base, "dataset.json"),
                          join(out_base, "imagesTr"),
                          join(out_base, "imagesTs"), ("CT",),
                          {0: "background", 1: "kidney", 2: "tumor"},
                          task_name)
    return out_base


# ---------------------------------------------------------------------------
# Task075/076/089 cell tracking challenge (tiff sequences)

def _convert_ctc_task(base: str, task_id: int, task_name: str, spacing,
                      seg_prefix: str = "man_seg"):
    """Task075_Fluo_C3DH_A549_ManAndSim.py prepare_task: sequences
    <seq>/t*.tif with <seq>_GT/SEG/man_seg*.tif labels (binarized)."""
    out_base = _out_base(task_id, task_name)
    for split, sub in (("_train", "imagesTr"), ("_test", "imagesTs")):
        root = base + split
        if not isdir(root):
            continue
        for seq in [s for s in subdirs(root, join=False)
                    if not s.endswith("_GT")]:
            for t in subfiles(join(root, seq), suffix=".tif", join=False):
                casename = seq + "_" + t[:-4]
                lab_file = join(root, seq + "_GT", "SEG",
                                seg_prefix + t[1:])
                if split == "_train" and not isfile(lab_file):
                    continue
                img = read_tiff_stack(join(root, seq, t))
                write_nifti(join(out_base, sub,
                                 casename + "_0000.nii.gz"),
                            NiftiImage(img.astype(np.float32),
                                       tuple(spacing)[::-1]))
                if split == "_train":
                    lab = read_tiff_stack(lab_file).copy()
                    lab[lab > 0] = 1
                    write_nifti(join(out_base, "labelsTr",
                                     casename + ".nii.gz"),
                                NiftiImage(lab.astype(np.uint8),
                                           tuple(spacing)[::-1]))
    generate_dataset_json(join(out_base, "dataset.json"),
                          join(out_base, "imagesTr"),
                          join(out_base, "imagesTs"), ("BF",),
                          {0: "background", 1: "cell"}, task_name)
    return out_base


def convert_fluo_c3dh_a549(base: str, task_id: int = 75,
                           task_name: str = "Fluo_C3DH_A549_ManAndSim"):
    """Task075: spacing (1, 0.126, 0.126) z,y,x."""
    return _convert_ctc_task(base, task_id, task_name,
                             (1.0, 0.126, 0.126))


def convert_fluo_n3dh_sim(base: str, task_id: int = 76,
                          task_name: str = "Fluo_N3DH_SIM"):
    """Task076: spacing (2, 0.126, 0.126) z,y,x (border-class variant of
    the reference generates borders; plain cell/background here, the
    trainer-side border loss is a reference experiment)."""
    return _convert_ctc_task(base, task_id, task_name,
                             (2.0, 0.126, 0.126))


def generate_border_as_suggested_by_twollmann_2d(
        label_img: np.ndarray, spacing, border_thickness: float = 2.0) \
        -> np.ndarray:
    """Task089_Fluo-N2DH-SIM.py:46-60: per-instance erosion leaves a
    border ring (scipy replaces skimage.morphology)."""
    from scipy.ndimage import binary_erosion
    border = np.zeros_like(label_img)
    radius_vox = np.maximum(
        np.round(border_thickness / np.array(spacing)).astype(int), 1)
    yy, xx = np.ogrid[-radius_vox[0]:radius_vox[0] + 1,
                      -radius_vox[1]:radius_vox[1] + 1]
    selem = ((yy / max(radius_vox[0], 1)) ** 2
             + (xx / max(radius_vox[1], 1)) ** 2) <= 1.0
    for lab in np.unique(label_img):
        if lab == 0:
            continue
        mask = label_img == lab
        eroded = binary_erosion(mask, structure=selem)
        border[mask & ~eroded] = 1
    return border


def convert_fluo_n2dh_sim(base: str, task_id: int = 89,
                          task_name: str = "Fluo-N2DH-SIM",
                          border_thickness: float = 0.7):
    """Task089_Fluo-N2DH-SIM.py: 2D sequences as pseudo-3D cases with a
    cell-border class (label 2)."""
    out_base = _out_base(task_id, task_name)
    spacing = (0.125, 0.125)
    for split, sub in (("_train", "imagesTr"), ("_test", "imagesTs")):
        root = base + split
        if not isdir(root):
            continue
        for seq in [s for s in subdirs(root, join=False)
                    if not s.endswith("_GT")]:
            for t in subfiles(join(root, seq), suffix=".tif", join=False):
                casename = seq + "_" + t[:-4]
                lab_file = join(root, seq + "_GT", "SEG",
                                "man_seg" + t[1:])
                if split == "_train" and not isfile(lab_file):
                    continue
                img = read_tiff_stack(join(root, seq, t))
                write_nifti(
                    join(out_base, sub, casename + "_0000.nii.gz"),
                    NiftiImage(img.astype(np.float32)[None],
                               (*spacing[::-1], 999.0)))
                if split == "_train":
                    lab = read_tiff_stack(lab_file).copy()
                    borders = generate_border_as_suggested_by_twollmann_2d(
                        lab, spacing, border_thickness)
                    lab[lab > 0] = 1
                    lab[borders == 1] = 2
                    write_nifti(
                        join(out_base, "labelsTr", casename + ".nii.gz"),
                        NiftiImage(lab.astype(np.uint8)[None],
                                   (*spacing[::-1], 999.0)))
    generate_dataset_json(join(out_base, "dataset.json"),
                          join(out_base, "imagesTr"),
                          join(out_base, "imagesTs"), ("BF",),
                          {0: "background", 1: "cell", 2: "border"},
                          task_name)
    return out_base


# ---------------------------------------------------------------------------
# Task114 M&Ms cardiac MR

def convert_mnms(data_root: str, info_csv: str, task_id: int = 114,
                 task_name: str = "heart_MNMs"):
    """Task114_heart_MNMs.py: 4D sa.nii.gz per patient; only the ED/ES
    frames (from the dataset info table) are annotated and used. Case ids
    carry vendor+centre for domain-aware splits. info_csv: the 'M&Ms
    Dataset Information' sheet exported as csv."""
    import pandas as pd
    out_base = _out_base(task_id, task_name)
    table = pd.read_csv(info_csv, index_col="External code")

    files_raw, files_gt = [], []
    for r, dirs, files in os.walk(data_root):
        for f in files:
            if f.endswith("nii.gz"):
                (files_gt if "_gt" in f else files_raw).append(join(r, f))

    def frame(path, ts):
        img = read_nifti(path)
        arr = img.array
        if arr.ndim == 4:          # (t, z, y, x)
            arr = arr[ts]
        return NiftiImage(np.ascontiguousarray(arr), img.spacing,
                          img.origin, img.direction)

    for idx in table.index:
        ed, es = int(table.loc[idx, "ED"]), int(table.loc[idx, "ES"])
        vendor = table.loc[idx, "Vendor"]
        centre = table.loc[idx, "Centre"]
        if vendor == "C":          # vendor C is test data
            continue
        raw = [f for f in files_raw if idx in os.path.basename(f)]
        gt = [f for f in files_gt if idx in os.path.basename(f)]
        if not raw or not gt:
            continue
        for ts in (ed, es):
            ident = f"{idx}_{str(ts).zfill(4)}_{vendor}_{centre}"
            write_nifti(join(out_base, "imagesTr",
                             ident + "_0000.nii.gz"), frame(raw[0], ts))
            seg = frame(gt[0], ts)
            seg.array = seg.array.astype(np.uint8)
            write_nifti(join(out_base, "labelsTr", ident + ".nii.gz"),
                        seg)
    generate_dataset_json(
        join(out_base, "dataset.json"), join(out_base, "imagesTr"), None,
        ("MRI",), {0: "background", 1: "LVBP", 2: "LVM", 3: "RV"},
        task_name)
    return out_base


# ---------------------------------------------------------------------------
# Task115 COVID-19-20 challenge

def convert_covidseg_challenge(downloaded_data_dir: str,
                               task_id: int = 115,
                               task_name: str = "COVIDSegChallenge"):
    """Task115_COVIDSegChallenge.py __main__: Train/*_ct.nii.gz (+
    _seg_corrected or _seg), Validation images."""
    out_base = _out_base(task_id, task_name)
    maybe_mkdir_p(join(out_base, "imagesVal"))
    train_orig = join(downloaded_data_dir, "Train")
    for f in subfiles(train_orig, suffix="_ct.nii.gz", join=False):
        c = f[:-10]
        seg = join(train_orig, c + "_seg_corrected.nii.gz")
        if not isfile(seg):
            seg = join(train_orig, c + "_seg.nii.gz")
        shutil.copy(join(train_orig, f),
                    join(out_base, "imagesTr", c + "_0000.nii.gz"))
        shutil.copy(seg, join(out_base, "labelsTr", c + ".nii.gz"))
    val_orig = join(downloaded_data_dir, "Validation")
    if isdir(val_orig):
        for f in subfiles(val_orig, suffix="_ct.nii.gz", join=False):
            c = f[:-10]
            shutil.copy(join(val_orig, f),
                        join(out_base, "imagesVal", c + "_0000.nii.gz"))
    generate_dataset_json(
        join(out_base, "dataset.json"), join(out_base, "imagesTr"), None,
        ("CT",), {0: "background", 1: "covid"}, task_name,
        dataset_reference=
        "https://covid-segmentation.grand-challenge.org/COVID-19-20/")
    return out_base


# ---------------------------------------------------------------------------
# Task120 Massachusetts roads (2D png)

def convert_road_segm(base: str, task_id: int = 120,
                      task_name: str = "MassRoadsSeg"):
    """Task120_Massachusetts_RoadSegm.py: RGB png images, labels 255 ->
    1, via the 2D pseudo-3D convention."""
    out_base = _out_base(task_id, task_name)
    maybe_mkdir_p(join(out_base, "labelsTs"))
    for split, img_sub, lab_sub in (("training", "imagesTr", "labelsTr"),
                                    ("testing", "imagesTs", "labelsTs")):
        labels_dir = join(base, split, "output")
        images_dir = join(base, split, "input")
        if not isdir(labels_dir):
            continue
        for t in subfiles(labels_dir, suffix=".png", join=False):
            name = t[:-4]
            convert_2d_image_to_nifti(
                join(images_dir, t), join(out_base, img_sub, name),
                is_seg=False)
            convert_2d_image_to_nifti(
                join(labels_dir, t), join(out_base, lab_sub, name),
                is_seg=True,
                transform=lambda x: (x == 255).astype(int))
    generate_dataset_json(join(out_base, "dataset.json"),
                          join(out_base, "imagesTr"),
                          join(out_base, "imagesTs"),
                          ("Red", "Green", "Blue"),
                          {0: "background", 1: "street"}, task_name)
    return out_base


# ---------------------------------------------------------------------------
# Task154/155 RibFrac, Task156 RibSeg

def _ribfrac_meta(dataset_load_path: str):
    import pandas as pd
    meta = {}
    for csv in ("ribfrac-train-info-1.csv", "ribfrac-train-info-2.csv",
                "ribfrac-val-info.csv"):
        p = join(dataset_load_path, csv)
        if not isfile(p):
            continue
        df = pd.read_csv(p)
        for _, row in df.iterrows():
            meta.setdefault(row["public_id"], []).append(
                {"instance": row["label_id"],
                 "class_label": row["label_code"]})
    return meta


def convert_ribfrac(dataset_load_path: str, task_id: int = 154,
                    task_name: str = "RibFrac_multi_label",
                    binary: bool = False):
    """Task154_RibFrac_multi_label.py / Task155_RibFrac_binary.py:
    instance masks + csv -> semantic labels (multi: fracture classes 1-4,
    ignore -1 -> 5; binary: any fracture -> 1)."""
    out_base = _out_base(task_id, task_name)
    meta = _ribfrac_meta(dataset_load_path)
    img_dir = join(dataset_load_path, "imagesTr")
    msk_dir = join(dataset_load_path, "labelsTr")
    for name, entries in sorted(meta.items()):
        cid = int(name[7:])
        img = read_nifti(join(img_dir, name + "-image.nii.gz"))
        inst = read_nifti(join(msk_dir, name + "-label.nii.gz"))
        sem = np.zeros_like(inst.array, dtype=np.int16)
        for e in entries:
            sem[inst.array == e["instance"]] = e["class_label"]
        if binary:
            sem = (sem != 0).astype(np.uint8)
        else:
            sem[sem == -1] = 5     # ignore label
        ident = "RibFrac_" + str(cid).zfill(4)
        write_nifti(join(out_base, "imagesTr", ident + "_0000.nii.gz"),
                    img)
        write_nifti(join(out_base, "labelsTr", ident + ".nii.gz"),
                    NiftiImage(sem.astype(np.uint8), inst.spacing,
                               inst.origin, inst.direction))
    test_dir = join(dataset_load_path, "imagesTs")
    if isdir(test_dir):
        for f in subfiles(test_dir, suffix="-image.nii.gz", join=False):
            cid = int(f.split("-")[0][7:])
            shutil.copy(join(test_dir, f),
                        join(out_base, "imagesTs",
                             "RibFrac_" + str(cid).zfill(4)
                             + "_0000.nii.gz"))
    labels = ({0: "background", 1: "fracture"} if binary else
              {0: "background", 1: "displaced", 2: "non-displaced",
               3: "buckle", 4: "segmental", 5: "ignore"})
    generate_dataset_json(join(out_base, "dataset.json"),
                          join(out_base, "imagesTr"),
                          join(out_base, "imagesTs"), ("CT",), labels,
                          task_name)
    return out_base


def convert_ribfrac_binary(dataset_load_path: str, task_id: int = 155,
                           task_name: str = "RibFrac_binary"):
    return convert_ribfrac(dataset_load_path, task_id, task_name,
                           binary=True)


def convert_ribseg(ribfrac_load_path: str, ribseg_load_path: str,
                   task_id: int = 156, task_name: str = "RibSeg"):
    """Task156_RibSeg.py: RibFrac images + RibSeg masks; ids > 500 are
    test."""
    out_base = _out_base(task_id, task_name)
    maybe_mkdir_p(join(out_base, "labelsTs"))
    for f in subfiles(join(ribseg_load_path, "labelsTr"), join=False,
                      suffix=".nii.gz"):
        if "-cl.nii.gz" in f:
            continue
        cid = int(f.split("-")[0][7:])
        image_set = "imagesTr" if cid <= 500 else "imagesTs"
        mask_set = "labelsTr" if cid <= 500 else "labelsTs"
        ident = "RibSeg_" + str(cid).zfill(4)
        shutil.copy(join(ribfrac_load_path, image_set,
                         f"RibFrac{cid}-image.nii.gz"),
                    join(out_base, image_set, ident + "_0000.nii.gz"))
        shutil.copy(join(ribseg_load_path, "labelsTr", f),
                    join(out_base, mask_set, ident + ".nii.gz"))
    generate_dataset_json(join(out_base, "dataset.json"),
                          join(out_base, "imagesTr"),
                          join(out_base, "imagesTs"), ("CT",),
                          {0: "background", 1: "rib"}, task_name)
    return out_base


# ---------------------------------------------------------------------------
# Task159 MyoPS 2020

_MYOPS_LABEL_MAP = ((500, 1), (600, 2), (200, 3), (1220, 4), (2221, 5))


def convert_myops_labels_to_nnunet(source_nifti: str, target_nifti: str):
    """Task159_MyoPS2020.py:22-35."""
    img = read_nifti(source_nifti)
    seg = np.zeros(img.array.shape, dtype=np.uint8)
    for myops, ours in _MYOPS_LABEL_MAP:
        seg[img.array == myops] = ours
    write_nifti(target_nifti, NiftiImage(seg, img.spacing, img.origin,
                                         img.direction))


def convert_labels_back_to_myops(source_nifti: str, target_nifti: str):
    """Task159_MyoPS2020.py:38-51."""
    img = read_nifti(source_nifti)
    seg = np.zeros(img.array.shape, dtype=np.uint16)
    for myops, ours in _MYOPS_LABEL_MAP:
        seg[img.array == ours] = myops
    write_nifti(target_nifti, NiftiImage(seg, img.spacing, img.origin,
                                         img.direction))


def convert_myops2020(base: str, task_id: int = 159,
                      task_name: str = "MyoPS2020"):
    """Task159_MyoPS2020.py __main__: train25 C0/DE/T2 modalities,
    train25_myops_gd labels with intensity codes."""
    out_base = _out_base(task_id, task_name)
    imagestr_source = join(base, "train25")
    imagests_source = join(base, "test20")
    labels_source = join(base, "train25_myops_gd")
    mods = ("_C0.nii.gz", "_DE.nii.gz", "_T2.nii.gz")
    idents = sorted({f.split("_")[2] for f in subfiles(
        imagestr_source, join=False, suffix=".nii.gz")})
    for ident in idents:
        case = f"myops_training_{ident}"
        for j, m in enumerate(mods):
            shutil.copy(join(imagestr_source, case + m),
                        join(out_base, "imagesTr",
                             f"{case}_{j:04d}.nii.gz"))
        convert_myops_labels_to_nnunet(
            join(labels_source, case + "_gd.nii.gz"),
            join(out_base, "labelsTr", case + ".nii.gz"))
    if isdir(imagests_source):
        tidents = sorted({f.split("_")[2] for f in subfiles(
            imagests_source, join=False, suffix=".nii.gz")})
        for ident in tidents:
            case = f"myops_test_{ident}"
            for j, m in enumerate(mods):
                src = join(imagests_source, case + m)
                if isfile(src):
                    shutil.copy(src, join(out_base, "imagesTs",
                                          f"{case}_{j:04d}.nii.gz"))
    generate_dataset_json(
        join(out_base, "dataset.json"), join(out_base, "imagesTr"),
        join(out_base, "imagesTs"), ("C0", "DE", "T2"),
        {0: "background", 1: "LV blood pool", 2: "RV blood pool",
         3: "LV myocardium", 4: "LV edema", 5: "LV scars"}, task_name)
    return out_base


# ---------------------------------------------------------------------------
# Task037/038 CHAOS (DICOM MR + png labels)

def _load_png_stack(folder: str) -> np.ndarray:
    """Task037_038_Chaos_Challenge.py:26-33 (stack reversed in z)."""
    pngs = subfiles(folder, suffix="png")
    return np.stack([read_2d_image(p) for p in sorted(pngs)], 0)[::-1]


def convert_MR_seg(loaded_png: np.ndarray) -> np.ndarray:
    """Task037_038_Chaos_Challenge.py:38-44."""
    result = np.zeros(loaded_png.shape, dtype=np.uint8)
    result[(loaded_png > 55) & (loaded_png <= 70)] = 1     # liver
    result[(loaded_png > 110) & (loaded_png <= 135)] = 2   # right kidney
    result[(loaded_png > 175) & (loaded_png <= 200)] = 3   # left kidney
    result[(loaded_png > 240) & (loaded_png <= 255)] = 4   # spleen
    return result


def convert_seg_to_intensity_task5(seg: np.ndarray) -> np.ndarray:
    seg_new = np.zeros(seg.shape, dtype=np.uint8)
    for k, v in ((1, 63), (2, 126), (3, 189), (4, 252)):
        seg_new[seg == k] = v
    return seg_new


def convert_seg_to_intensity_task3(seg: np.ndarray) -> np.ndarray:
    seg_new = np.zeros(seg.shape, dtype=np.uint8)
    seg_new[seg == 1] = 63
    return seg_new


def convert_chaos(base: str, task_id: int = 37,
                  task_name: str = "CHAOS_Task_3_5_Variant1"):
    """Task037_038_Chaos_Challenge.py (variant 1, T1 in/out as two
    modalities + T2): MR DICOM series (io.dicom replaces dicom2nifti) +
    Ground/*.png label stacks."""
    out_base = _out_base(task_id, task_name)
    from ..io.dicom import read_dicom_series
    d = join(base, "MR")
    for p in subdirs(d, join=False):
        # T1 DUAL in/out phase
        t1_in = read_dicom_series(join(d, p, "T1DUAL", "DICOM_anon",
                                       "InPhase"))
        t1_out = read_dicom_series(join(d, p, "T1DUAL", "DICOM_anon",
                                        "OutPhase"))
        write_nifti(join(out_base, "imagesTr", f"T1_{p}_0000.nii.gz"),
                    t1_in)
        write_nifti(join(out_base, "imagesTr", f"T1_{p}_0001.nii.gz"),
                    t1_out)
        seg = convert_MR_seg(_load_png_stack(
            join(d, p, "T1DUAL", "Ground")))
        write_nifti(join(out_base, "labelsTr", f"T1_{p}.nii.gz"),
                    NiftiImage(seg, t1_in.spacing, t1_in.origin,
                               t1_in.direction))
        # T2 SPIR (single modality: duplicated channel, reference :262)
        t2 = read_dicom_series(join(d, p, "T2SPIR", "DICOM_anon"))
        write_nifti(join(out_base, "imagesTr", f"T2_{p}_0000.nii.gz"), t2)
        write_nifti(join(out_base, "imagesTr", f"T2_{p}_0001.nii.gz"), t2)
        seg2 = convert_MR_seg(_load_png_stack(
            join(d, p, "T2SPIR", "Ground")))
        write_nifti(join(out_base, "labelsTr", f"T2_{p}.nii.gz"),
                    NiftiImage(seg2, t2.spacing, t2.origin, t2.direction))
    generate_dataset_json(
        join(out_base, "dataset.json"), join(out_base, "imagesTr"), None,
        ("MRI_in_or_t2", "MRI_out_or_t2"),
        {0: "background", 1: "liver", 2: "right kidney",
         3: "left kidney", 4: "spleen"}, task_name)
    return out_base
