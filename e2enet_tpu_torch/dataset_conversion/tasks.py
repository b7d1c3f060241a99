"""Per-challenge dataset converters for the headline benchmark tasks.

Parity: reference e2enet/dataset_conversion/ (36 scripts). The benchmark
tasks of BASELINE.json are covered here:
  * AMOS 2022 task1/task2 (Task216/217, reference Task216_Amos2022_task1.py)
  * BTCV / BeyondTheCranialVault (Task017,
    reference Task017_BeyondCranialVaultAbdominalOrganSegmentation.py)
  * BraTS-style 4-modality conversion (Task032/043/082 pattern: relabel
    4 -> 3, modalities t1/t1ce/t2/flair)
  * KiTS (Task040 pattern)
Decathlon tasks (Hippocampus/Prostate/Heart/...) use
utils.convert_decathlon_task.

The port's own copy of e2enet_tpu/dataset_conversion/tasks.py, unchanged
but for this note: the port imports nothing of the JAX package. The
output's .nii.gz files hold the same images as the JAX package's, at the
port's gzip level (io/nifti.py).
"""
import os
import shutil

from .. import paths
from ..io.nifti import read_nifti, write_nifti, NiftiImage
from ..utils.files import join, load_json, maybe_mkdir_p, subfiles
from .utils import generate_dataset_json

BTCV_LABELS = {
    0: "background", 1: "spleen", 2: "right kidney", 3: "left kidney",
    4: "gallbladder", 5: "esophagus", 6: "liver", 7: "stomach", 8: "aorta",
    9: "inferior vena cava", 10: "portal vein and splenic vein",
    11: "pancreas", 12: "right adrenal gland", 13: "left adrenal gland",
}

AMOS_LABELS = {
    0: "background", 1: "spleen", 2: "right kidney", 3: "left kidney",
    4: "gall bladder", 5: "esophagus", 6: "liver", 7: "stomach", 8: "aorta",
    9: "postcava", 10: "pancreas", 11: "right adrenal gland",
    12: "left adrenal gland", 13: "duodenum", 14: "bladder",
    15: "prostate/uterus",
}


def _out_base(task_id: int, task_name: str) -> str:
    foldername = "Task%03.0d_%s" % (task_id, task_name)
    out_base = join(paths.require(paths.get_raw_data_dir(), "raw data dir"),
                    foldername)
    for sub in ("imagesTr", "imagesTs", "labelsTr"):
        maybe_mkdir_p(join(out_base, sub))
    return out_base


def convert_amos2022(amos_base: str, task_id: int = 216,
                     task_name: str = "AMOS2022_task1",
                     dataset_json_name: str = "task1_dataset.json"):
    """AMOS22 download -> nnU-Net raw layout (Task216_Amos2022_task1.py)."""
    out_base = _out_base(task_id, task_name)
    src_json = join(amos_base, dataset_json_name)
    if not os.path.isfile(src_json):
        src_json = join(amos_base, "dataset.json")
    dataset_json_source = load_json(src_json)

    training_identifiers = [i["image"].split("/")[-1][:-7]
                            for i in dataset_json_source["training"]]
    for tr in training_identifiers:
        shutil.copy(join(amos_base, "imagesTr", tr + ".nii.gz"),
                    join(out_base, "imagesTr", f"{tr}_0000.nii.gz"))
        shutil.copy(join(amos_base, "labelsTr", tr + ".nii.gz"),
                    join(out_base, "labelsTr", f"{tr}.nii.gz"))
    test_identifiers = [i.split("/")[-1][:-7]
                        for i in dataset_json_source.get("test", [])]
    for ts in test_identifiers:
        shutil.copy(join(amos_base, "imagesTs", ts + ".nii.gz"),
                    join(out_base, "imagesTs", f"{ts}_0000.nii.gz"))
    labels = dataset_json_source.get("labels") or \
        {str(k): v for k, v in AMOS_LABELS.items()}
    labels = {int(k): v for k, v in labels.items()}
    generate_dataset_json(join(out_base, "dataset.json"),
                          join(out_base, "imagesTr"),
                          join(out_base, "imagesTs"), ("CT",), labels,
                          os.path.basename(out_base))
    return out_base


def convert_btcv(btcv_base: str, task_id: int = 17,
                 task_name: str = "AbdominalOrganSegmentation"):
    """BTCV (Synapse Abdomen) RawData.zip layout -> nnU-Net raw
    (Task017_BeyondCranialVaultAbdominalOrganSegmentation.py): images in
    Training/img/imgXXXX.nii.gz, labels Training/label/labelXXXX.nii.gz."""
    out_base = _out_base(task_id, task_name)
    train_img = join(btcv_base, "Training", "img")
    train_lbl = join(btcv_base, "Training", "label")
    test_img = join(btcv_base, "Testing", "img")
    for f in subfiles(train_img, join=False, suffix=".nii.gz"):
        ident = f[3:-7]  # imgXXXX.nii.gz -> XXXX
        shutil.copy(join(train_img, f),
                    join(out_base, "imagesTr", f"img{ident}_0000.nii.gz"))
        shutil.copy(join(train_lbl, f"label{ident}.nii.gz"),
                    join(out_base, "labelsTr", f"img{ident}.nii.gz"))
    if os.path.isdir(test_img):
        for f in subfiles(test_img, join=False, suffix=".nii.gz"):
            ident = f[3:-7]
            shutil.copy(join(test_img, f),
                        join(out_base, "imagesTs",
                             f"img{ident}_0000.nii.gz"))
    generate_dataset_json(join(out_base, "dataset.json"),
                          join(out_base, "imagesTr"),
                          join(out_base, "imagesTs"), ("CT",), BTCV_LABELS,
                          os.path.basename(out_base))
    return out_base


def convert_brats(brats_base: str, task_id: int, task_name: str,
                  year: str = "2020"):
    """BraTS training download -> nnU-Net raw (Task082_BraTS_2020.py
    pattern): per-case folders with _t1/_t1ce/_t2/_flair modalities and _seg
    labels; label 4 (enhancing) -> 3."""
    out_base = _out_base(task_id, task_name)
    case_dirs = [d for d in os.listdir(brats_base)
                 if os.path.isdir(join(brats_base, d))]
    for case in sorted(case_dirs):
        cdir = join(brats_base, case)
        mods = ["t1", "t1ce", "t2", "flair"]
        if not all(os.path.isfile(join(cdir, f"{case}_{m}.nii.gz"))
                   for m in mods):
            print("skipping incomplete case", case)
            continue
        for i, m in enumerate(mods):
            shutil.copy(join(cdir, f"{case}_{m}.nii.gz"),
                        join(out_base, "imagesTr",
                             f"{case}_{i:04d}.nii.gz"))
        seg_file = join(cdir, f"{case}_seg.nii.gz")
        if os.path.isfile(seg_file):
            img = read_nifti(seg_file)
            seg = img.array.copy()
            seg[seg == 4] = 3
            write_nifti(join(out_base, "labelsTr", f"{case}.nii.gz"),
                        NiftiImage(seg.astype("uint8"), img.spacing,
                                   img.origin, img.direction))
    generate_dataset_json(
        join(out_base, "dataset.json"), join(out_base, "imagesTr"), None,
        ("T1", "T1ce", "T2", "FLAIR"),
        {0: "background", 1: "edema", 2: "non-enhancing", 3: "enhancing"},
        os.path.basename(out_base))
    return out_base


def convert_kits(kits_base: str, task_id: int = 64,
                 task_name: str = "KiTS_labelsFixed"):
    """KiTS19 download (case_XXXXX/imaging.nii.gz + segmentation.nii.gz) ->
    nnU-Net raw (Task064_KiTS_labelsFixed.py pattern)."""
    out_base = _out_base(task_id, task_name)
    cases = sorted(d for d in os.listdir(kits_base)
                   if d.startswith("case_"))
    for case in cases:
        img = join(kits_base, case, "imaging.nii.gz")
        seg = join(kits_base, case, "segmentation.nii.gz")
        if not os.path.isfile(img):
            continue
        shutil.copy(img, join(out_base, "imagesTr",
                              f"{case}_0000.nii.gz"))
        if os.path.isfile(seg):
            shutil.copy(seg, join(out_base, "labelsTr", f"{case}.nii.gz"))
        else:
            shutil.copy(img, join(out_base, "imagesTs",
                                  f"{case}_0000.nii.gz"))
            os.remove(join(out_base, "imagesTr", f"{case}_0000.nii.gz"))
    generate_dataset_json(join(out_base, "dataset.json"),
                          join(out_base, "imagesTr"),
                          join(out_base, "imagesTs"), ("CT",),
                          {0: "background", 1: "kidney", 2: "tumor"},
                          os.path.basename(out_base))
    return out_base


def convert_lits(train_dir: str, test_dir: str = None, task_id: int = 29,
                 task_name: str = "LITS"):
    """LiTS challenge (volume-N.nii / segmentation-N.nii) -> nnU-Net raw
    (Task029_LiverTumorSegmentationChallenge.py pattern: train_N ids)."""
    out_base = _out_base(task_id, task_name)
    for f in sorted(os.listdir(train_dir)):
        if f.startswith("volume-"):
            n = f.split("-")[-1].split(".")[0]
            img = read_nifti(join(train_dir, f))
            write_nifti(join(out_base, "imagesTr",
                             f"train_{n}_0000.nii.gz"), img)
        elif f.startswith("segmentation-"):
            n = f.split("-")[-1].split(".")[0]
            seg = read_nifti(join(train_dir, f))
            write_nifti(join(out_base, "labelsTr", f"train_{n}.nii.gz"), seg)
    if test_dir:
        for f in sorted(os.listdir(test_dir)):
            if f.startswith("test-volume-"):
                n = f.split("-")[-1].split(".")[0]
                img = read_nifti(join(test_dir, f))
                write_nifti(join(out_base, "imagesTs",
                                 f"test_{n}_0000.nii.gz"), img)
    generate_dataset_json(join(out_base, "dataset.json"),
                          join(out_base, "imagesTr"),
                          join(out_base, "imagesTs"), ("CT",),
                          {0: "background", 1: "liver", 2: "tumor"},
                          os.path.basename(out_base))
    return out_base


def convert_acdc(train_folder: str, test_folder: str = None,
                 task_id: int = 27, task_name: str = "ACDC"):
    """ACDC cardiac MRI (patientXXX/ dirs with *_frameYY.nii.gz +
    *_frameYY_gt.nii.gz) -> nnU-Net raw
    (Task027_AutomaticCardiacDetectionChallenge.py: every annotated frame
    becomes a training case)."""
    out_base = _out_base(task_id, task_name)

    def frames_of(pdir):
        out = []
        for f in sorted(os.listdir(pdir)):
            if "_gt" in f or "_4d" in f or not f.endswith(".nii.gz"):
                continue
            if "_frame" not in f:
                continue
            gt = f.replace(".nii.gz", "_gt.nii.gz")
            out.append((join(pdir, f),
                        join(pdir, gt) if os.path.isfile(join(pdir, gt))
                        else None, f[:-7]))
        return out

    for p in sorted(os.listdir(train_folder)):
        pdir = join(train_folder, p)
        if not os.path.isdir(pdir) or not p.startswith("patient"):
            continue
        for img, gt, ident in frames_of(pdir):
            if gt is None:
                continue
            shutil.copy(img, join(out_base, "imagesTr",
                                  f"{ident}_0000.nii.gz"))
            shutil.copy(gt, join(out_base, "labelsTr", f"{ident}.nii.gz"))
    if test_folder:
        for p in sorted(os.listdir(test_folder)):
            pdir = join(test_folder, p)
            if not os.path.isdir(pdir) or not p.startswith("patient"):
                continue
            for img, _gt, ident in frames_of(pdir):
                shutil.copy(img, join(out_base, "imagesTs",
                                      f"{ident}_0000.nii.gz"))
    generate_dataset_json(join(out_base, "dataset.json"),
                          join(out_base, "imagesTr"),
                          join(out_base, "imagesTs"), ("MRI",),
                          {0: "background", 1: "RV", 2: "MLV", 3: "LVC"},
                          os.path.basename(out_base))
    return out_base


def convert_segthor(train_folder: str, test_folder: str = None,
                    task_id: int = 55, task_name: str = "SegTHOR"):
    """SegTHOR thoracic organs at risk (Patient_XX/Patient_XX.nii.gz + GT)
    -> nnU-Net raw (Task055_SegTHOR.py)."""
    out_base = _out_base(task_id, task_name)
    for p in sorted(os.listdir(train_folder)):
        pdir = join(train_folder, p)
        if not os.path.isdir(pdir):
            continue
        img = join(pdir, p + ".nii.gz")
        gt = join(pdir, "GT.nii.gz")
        if os.path.isfile(img) and os.path.isfile(gt):
            shutil.copy(img, join(out_base, "imagesTr", f"{p}_0000.nii.gz"))
            shutil.copy(gt, join(out_base, "labelsTr", f"{p}.nii.gz"))
    if test_folder:
        for f in sorted(os.listdir(test_folder)):
            if f.endswith(".nii.gz"):
                shutil.copy(join(test_folder, f),
                            join(out_base, "imagesTs",
                                 f"{f[:-7]}_0000.nii.gz"))
    generate_dataset_json(join(out_base, "dataset.json"),
                          join(out_base, "imagesTr"),
                          join(out_base, "imagesTs"), ("CT",),
                          {0: "background", 1: "esophagus", 2: "heart",
                           3: "trachea", 4: "aorta"},
                          os.path.basename(out_base))
    return out_base


def convert_nih_pancreas(base: str, task_id: int = 62,
                         task_name: str = "NIHPancreas"):
    """NIH-CT pancreas (data/PANCREAS_XXXX.nii.gz +
    TCIA_pancreas_labels-*/labelXXXX.nii.gz) -> nnU-Net raw
    (Task062_NIHPancreas.py; pancreas label only)."""
    out_base = _out_base(task_id, task_name)
    data_dir = join(base, "data")
    label_dirs = [d for d in os.listdir(base) if d.startswith(
        "TCIA_pancreas_labels")]
    assert label_dirs, f"no TCIA_pancreas_labels-* dir in {base}"
    label_dir = join(base, sorted(label_dirs)[0])
    for f in sorted(os.listdir(data_dir)):
        if not (f.startswith("PANCREAS_") and f.endswith(".nii.gz")):
            continue
        num = f[len("PANCREAS_"):-7]
        lab = join(label_dir, f"label{num}.nii.gz")
        if not os.path.isfile(lab):
            continue
        case = f"pancreas_{num}"
        shutil.copy(join(data_dir, f),
                    join(out_base, "imagesTr", f"{case}_0000.nii.gz"))
        shutil.copy(lab, join(out_base, "labelsTr", f"{case}.nii.gz"))
    generate_dataset_json(join(out_base, "dataset.json"),
                          join(out_base, "imagesTr"),
                          join(out_base, "imagesTs"), ("CT",),
                          {0: "background", 1: "pancreas"},
                          os.path.basename(out_base))
    return out_base


def convert_covidseg(download_dir: str, task_id: int = 69,
                     task_name: str = "CovidSeg"):
    """medicalsegmentation.com COVID-19 set: tr_im/tr_mask are stacked 2D
    slices -> 5 pseudo-3D training volumes by slice interleave
    (Task069_CovidSeg.py semantics)."""
    import numpy as np
    out_base = _out_base(task_id, task_name)
    img = read_nifti(join(download_dir, "tr_im.nii.gz"))
    msk = read_nifti(join(download_dir, "tr_mask.nii.gz"))
    arr, lab = img.array, msk.array
    for f in range(5):
        name = f"part_{f}"
        write_nifti(join(out_base, "imagesTr", f"{name}_0000.nii.gz"),
                    NiftiImage(np.ascontiguousarray(arr[f::5]), img.spacing))
        write_nifti(join(out_base, "labelsTr", f"{name}.nii.gz"),
                    NiftiImage(np.ascontiguousarray(lab[f::5]), msk.spacing))
    val = join(download_dir, "val_im.nii.gz")
    if os.path.isfile(val):
        shutil.copy(val, join(out_base, "imagesTs", "val_im_0000.nii.gz"))
    generate_dataset_json(join(out_base, "dataset.json"),
                          join(out_base, "imagesTr"),
                          join(out_base, "imagesTs"), ("CT",),
                          {0: "background", 1: "ground glass",
                           2: "consolidation", 3: "pleural effusion"},
                          os.path.basename(out_base))
    return out_base


def convert_kits2021(kits_data_dir: str, task_id: int = 135,
                     task_name: str = "KiTS2021"):
    """KiTS21 (case_XXXXX/imaging.nii.gz + aggregated_MAJ_seg.nii.gz) ->
    nnU-Net raw (Task135_KiTS2021.py)."""
    out_base = _out_base(task_id, task_name)
    for c in sorted(d for d in os.listdir(kits_data_dir)
                    if d.startswith("case_")):
        seg = join(kits_data_dir, c, "aggregated_MAJ_seg.nii.gz")
        img = join(kits_data_dir, c, "imaging.nii.gz")
        if os.path.isfile(seg) and os.path.isfile(img):
            shutil.copy(img, join(out_base, "imagesTr",
                                  f"{c}_0000.nii.gz"))
            shutil.copy(seg, join(out_base, "labelsTr", f"{c}.nii.gz"))
    generate_dataset_json(join(out_base, "dataset.json"),
                          join(out_base, "imagesTr"),
                          join(out_base, "imagesTs"), ("CT",),
                          {0: "background", 1: "kidney", 2: "tumor",
                           3: "cyst"},
                          os.path.basename(out_base))
    return out_base
