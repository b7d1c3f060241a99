"""The port's dataset converters (dataset_conversion/tasks.py and
dataset_conversion/tasks_extra.py) against the JAX package's, one case
of test_converter_matches for every public function of the two modules.

Each case forges a small seeded source tree in the layout of its
challenge's download. Both packages convert the same tree, each into a
raw data base of its own (nnUNet_raw_data_base, read at call time), and
the two output trees must hold the same files: a .nii.gz by its decoded
array, dtype, spacing, origin and direction (the port writes gzip level
1, io/nifti.py, so the bytes differ), dataset.json and the reorientation
sidecars by their loaded contents, every other file byte for byte. The
exports write into a folder given to them, and the label helpers return
arrays, compared exactly. A case whose source or converter needs PIL,
h5py or pandas skips where it is missing.

Also: the label tables are equal, and each new module of the port
imports in a fresh interpreter in which jax, flax, e2enet_tpu, PIL,
h5py, pandas and matplotlib cannot be imported."""
import gzip
import inspect
import json
import os
import pickle
import struct
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import chip_smoke
import e2enet_tpu.dataset_conversion.tasks as jtasks
import e2enet_tpu.dataset_conversion.tasks_extra as jextra
import e2enet_tpu.io.nifti as jnii
import e2enet_tpu_torch.dataset_conversion.tasks as ttasks
import e2enet_tpu_torch.dataset_conversion.tasks_extra as textra
from e2enet_tpu_torch.io import images2d as timg
from e2enet_tpu_torch.io.metaimage import write_mhd
from e2enet_tpu_torch.io.nifti import NiftiImage, read_nifti, write_nifti

REPO = Path(__file__).resolve().parents[1]
SHAPE = (3, 4, 5)
GEOM = dict(origin=(4.0, -7.5, 12.0),
            direction=(0.0, 1.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0, -1.0))


def nii(path, arr, spacing=(0.8, 0.9, 2.5), **geom):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    write_nifti(str(path), NiftiImage(np.asarray(arr), spacing,
                                      **{**GEOM, **geom}))


def nii4d(path, arr, spacing=(0.8, 0.9, 2.5)):
    """A (t, z, y, x) series as one 4D NIfTI-1 file (both packages'
    writers write 3D only): the 3D header of its first frame with the
    fourth dimension set, then every frame's voxels."""
    nii(path, arr[0], spacing)
    with open(path, "rb") as f:
        hdr = bytearray(gzip.decompress(f.read())[:352])
    t, z, y, x = arr.shape
    struct.pack_into("<8h", hdr, 40, 4, x, y, z, t, 1, 1, 1)
    with open(path, "wb") as f:
        f.write(gzip.compress(bytes(hdr) + np.ascontiguousarray(
            arr, "<" + arr.dtype.str[1:]).tobytes(), mtime=0))


def ct(rng, shape=SHAPE):
    return (rng.randn(*shape) * 300 + 40).astype(np.float32)


def seg(rng, n, shape=SHAPE, dtype=np.uint8):
    return rng.randint(0, n, shape).astype(dtype)


def tif(path, arr):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    timg.write_tiff_stack(str(path), arr)


def png(path, arr):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    timg.write_2d_image(str(path), arr)


def text(path, s):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(s)


# ---------------------------------------------------------------------------
# the forged downloads: forge(src, rng) writes the tree under `src`;
# call(fn, src, out) runs the package's function on it (the converters
# write under $nnUNet_raw_data_base, which the test points at `out`)

def forge_amos(src, rng):
    for i in (1, 2):
        nii(f"{src}/imagesTr/amos_000{i}.nii.gz", ct(rng))
        nii(f"{src}/labelsTr/amos_000{i}.nii.gz", seg(rng, 16))
    nii(f"{src}/imagesTs/amos_0005.nii.gz", ct(rng))
    text(f"{src}/task1_dataset.json", json.dumps({
        "training": [{"image": f"./imagesTr/amos_000{i}.nii.gz",
                      "label": f"./labelsTr/amos_000{i}.nii.gz"}
                     for i in (1, 2)],
        "test": ["./imagesTs/amos_0005.nii.gz"],
        "labels": {str(k): v for k, v in jtasks.AMOS_LABELS.items()}}))


def forge_btcv(src, rng):
    for i in ("0001", "0002"):
        nii(f"{src}/Training/img/img{i}.nii.gz", ct(rng))
        nii(f"{src}/Training/label/label{i}.nii.gz", seg(rng, 14))
    nii(f"{src}/Testing/img/img0061.nii.gz", ct(rng))


def forge_brats(src, rng):
    for case in ("BraTS20_Training_001", "BraTS20_Training_002"):
        for m in ("t1", "t1ce", "t2", "flair"):
            nii(f"{src}/{case}/{case}_{m}.nii.gz", ct(rng), (1.0,) * 3)
        s = seg(rng, 5)
        s[s == 3] = 4
        nii(f"{src}/{case}/{case}_seg.nii.gz", s, (1.0,) * 3)
    # an incomplete case, which both skip
    nii(f"{src}/BraTS20_Training_003/BraTS20_Training_003_t1.nii.gz",
        ct(rng))


def forge_kits(src, rng):
    nii(f"{src}/case_00000/imaging.nii.gz", ct(rng))
    nii(f"{src}/case_00000/segmentation.nii.gz", seg(rng, 3))
    nii(f"{src}/case_00001/imaging.nii.gz", ct(rng))
    os.makedirs(f"{src}/case_00002")


def forge_lits(src, rng):
    nii(f"{src}/train/volume-0.nii", ct(rng).astype(np.int16))
    nii(f"{src}/train/segmentation-0.nii", seg(rng, 3))
    nii(f"{src}/train/volume-1.nii", ct(rng).astype(np.int16))
    nii(f"{src}/train/segmentation-1.nii", seg(rng, 3))
    nii(f"{src}/test/test-volume-0.nii", ct(rng).astype(np.int16))


def forge_acdc(src, rng):
    for p in ("patient001", "patient002"):
        for fr in ("01", "12"):
            nii(f"{src}/training/{p}/{p}_frame{fr}.nii.gz", ct(rng))
            nii(f"{src}/training/{p}/{p}_frame{fr}_gt.nii.gz", seg(rng, 4))
        nii(f"{src}/training/{p}/{p}_frame05.nii.gz", ct(rng))
        nii4d(f"{src}/training/{p}/{p}_4d.nii.gz", ct(rng, (2, *SHAPE)))
        text(f"{src}/training/{p}/Info.cfg", "ED: 1\nES: 12\n")
    nii(f"{src}/testing/patient101/patient101_frame01.nii.gz", ct(rng))


def forge_segthor(src, rng):
    for p in ("Patient_01", "Patient_02"):
        nii(f"{src}/train/{p}/{p}.nii.gz", ct(rng))
        nii(f"{src}/train/{p}/GT.nii.gz", seg(rng, 5))
    nii(f"{src}/test/Patient_41.nii.gz", ct(rng))


def forge_nih_pancreas(src, rng):
    for n in ("0001", "0002", "0003"):
        nii(f"{src}/data/PANCREAS_{n}.nii.gz", ct(rng))
    for n in ("0001", "0003"):
        nii(f"{src}/TCIA_pancreas_labels-02-05-2017/label{n}.nii.gz",
            seg(rng, 2))


def forge_covidseg(src, rng):
    nii(f"{src}/tr_im.nii.gz", ct(rng, (10, 4, 5)))
    nii(f"{src}/tr_mask.nii.gz", seg(rng, 4, (10, 4, 5)))
    nii(f"{src}/val_im.nii.gz", ct(rng, (6, 4, 5)))


def forge_kits2021(src, rng):
    for c in ("case_00000", "case_00001"):
        nii(f"{src}/{c}/imaging.nii.gz", ct(rng))
        nii(f"{src}/{c}/aggregated_MAJ_seg.nii.gz", seg(rng, 4))
    nii(f"{src}/case_00002/imaging.nii.gz", ct(rng))


def forge_promise(src, rng):
    os.makedirs(f"{src}/train")
    os.makedirs(f"{src}/test")
    for i, case in enumerate(("Case00", "Case01")):
        write_mhd(f"{src}/train/{case}.mhd",
                  NiftiImage(ct(rng), (0.6, 0.6, 3.6), **GEOM),
                  compressed=i == 1)
        write_mhd(f"{src}/train/{case}_segmentation.mhd",
                  NiftiImage(seg(rng, 2), (0.6, 0.6, 3.6), **GEOM),
                  compressed=i == 1)
    write_mhd(f"{src}/test/Case10.mha",
              NiftiImage(ct(rng), (0.6, 0.6, 3.6)))
    write_mhd(f"{src}/test/Case11.mhd", NiftiImage(ct(rng), (0.6, 0.6, 3.6)))


def forge_predictions(src, rng):
    for c in ("Case10", "Case11"):
        nii(f"{src}/pred/{c}.nii.gz", seg(rng, 2))


def forge_isbi_mslesion(src, rng):
    mods = ("flair_pp", "mprage_pp", "pd_pp", "t2_pp")
    for pid, t in ((1, 1), (1, 2), (2, 1)):
        for j, m in enumerate(mods):
            ext = ".nii" if j % 2 else ".nii.gz"
            nii(f"{src}/imagesTr/training{pid:02d}_{t:02d}_{m}{ext}",
                ct(rng))
        for r in (1, 2):
            nii(f"{src}/labelsTr/training{pid:02d}_{t:02d}_mask{r}.nii",
                seg(rng, 2))
    for m in mods:
        nii(f"{src}/imagesTs/test01_01_{m}.nii.gz", ct(rng))


def forge_verse2019(src, rng):
    pir = dict(direction=chip_smoke.PIR)
    nii(f"{src}/train/verse004.nii.gz", ct(rng), **pir)
    nii(f"{src}/train/verse004_seg.nii.gz", seg(rng, 26), **pir)
    nii(f"{src}/train/verse007.nii.gz", ct(rng),
        direction=(1, 0, 0, 0, -1, 0, 0, 0, 1))
    nii(f"{src}/train/verse007_seg.nii.gz", seg(rng, 26),
        direction=(1, 0, 0, 0, -1, 0, 0, 0, 1))
    nii(f"{src}/test/verse005.nii.gz", ct(rng), **pir)


def forge_verse2020(src, rng):
    for site, p in (("siteA", "sub-verse500"), ("siteB", "sub-gl003")):
        nii(f"{src}/training_data/{site}/{p}.nii.gz", ct(rng),
            direction=chip_smoke.PIR)
        nii(f"{src}/training_data/{site}/{p}_seg.nii.gz", seg(rng, 26),
            direction=chip_smoke.PIR)


def forge_isbi_em(src, rng):
    tif(f"{src}/train-volume.tif", seg(rng, 256, (3, 8, 9)))
    tif(f"{src}/train-labels.tif", seg(rng, 2, (3, 8, 9)) * 255)
    tif(f"{src}/test-volume.tif", seg(rng, 256, (3, 8, 9)))


def forge_em_softmax(src, rng):
    os.makedirs(src)
    np.savez(f"{src}/pred.npz", softmax=rng.rand(2, 3, 8, 9)
             .astype(np.float32))


def forge_epfl(src, rng):
    for name in ("training", "testing"):
        tif(f"{src}/{name}.tif", seg(rng, 256, (3, 8, 9)))
        tif(f"{src}/{name}_groundtruth.tif", seg(rng, 2, (3, 8, 9)) * 255)


def forge_cremi(src, rng):
    import h5py
    os.makedirs(src)
    for s in "ABC":
        with h5py.File(f"{src}/sample_{s}_20160501.hdf", "w") as f:
            f["volumes/raw"] = seg(rng, 256)
            clefts = np.full(SHAPE, 0xFFFFFFFFFFFFFFFF, np.uint64)
            clefts[rng.rand(*SHAPE) < 0.3] = 7
            f["volumes/labels/clefts"] = clefts
    with h5py.File(f"{src}/sample_A+_20160601.hdf", "w") as f:
        f["volumes/raw"] = seg(rng, 256)


def forge_kits_nicks(src, rng):
    for c in ("case_00000", "case_00001", "case_00002"):
        nii(f"{src}/kits/{c}/imaging.nii.gz", ct(rng))
        nii(f"{src}/filled/{c}.nii.gz", seg(rng, 3))


def forge_ctc_3d(src, rng):
    for split in ("_train", "_test"):
        for t in ("000", "001"):
            tif(f"{src}/ctc{split}/01/t{t}.tif", seg(rng, 256, (3, 8, 9)))
    tif(f"{src}/ctc_train/01_GT/SEG/man_seg000.tif",
        seg(rng, 4, (3, 8, 9)))


def _cells(rng, n=40):
    lab = np.zeros((n, n), np.uint16)
    yy, xx = np.mgrid[:n, :n]
    for k in range(1, 4):
        cy, cx = rng.randint(8, n - 8, 2)
        lab[(yy - cy) ** 2 + (xx - cx) ** 2 < 36] = k
    return lab


def forge_ctc_2d(src, rng):
    for split in ("_train", "_test"):
        for t in ("000", "001"):
            tif(f"{src}/ctc{split}/01/t{t}.tif", seg(rng, 256, (40, 40)))
    tif(f"{src}/ctc_train/01_GT/SEG/man_seg000.tif", _cells(rng))


def forge_mnms(src, rng):
    rows = (("A0S9V9", "Siemens", "A", 1, 0, 2),
            ("B1C2D3", "Philips", "B", 2, 1, 2),
            ("C9C9C9", "Canon", "C", 4, 0, 1))
    text(f"{src}/info.csv",
         "External code,VendorName,Vendor,Centre,ED,ES\n"
         + "".join(",".join(map(str, r)) + "\n" for r in rows))
    for code, *_ in rows:
        d = f"{src}/data/Training/Labeled/{code}"
        nii4d(f"{d}/{code}_sa.nii.gz", ct(rng, (3, *SHAPE)))
        nii4d(f"{d}/{code}_sa_gt.nii.gz", seg(rng, 4, (3, *SHAPE)))


def forge_covid_challenge(src, rng):
    for c in ("volume-covid19-A-0001", "volume-covid19-A-0002"):
        nii(f"{src}/Train/{c}_ct.nii.gz", ct(rng))
        nii(f"{src}/Train/{c}_seg.nii.gz", seg(rng, 2))
    nii(f"{src}/Train/volume-covid19-A-0002_seg_corrected.nii.gz",
        seg(rng, 2))
    nii(f"{src}/Validation/volume-covid19-A-0101_ct.nii.gz", ct(rng))


def forge_roads(src, rng):
    for split in ("training", "testing"):
        for t in ("img-1", "img-2"):
            png(f"{src}/{split}/input/{t}.png", seg(rng, 256, (8, 9, 3)))
            png(f"{src}/{split}/output/{t}.png", seg(rng, 2, (8, 9)) * 255)


def forge_ribfrac(src, rng):
    for n in (1, 2):
        nii(f"{src}/ribfrac/imagesTr/RibFrac{n}-image.nii.gz", ct(rng))
        nii(f"{src}/ribfrac/labelsTr/RibFrac{n}-label.nii.gz",
            seg(rng, 4))
    nii(f"{src}/ribfrac/imagesTs/RibFrac501-image.nii.gz", ct(rng))
    text(f"{src}/ribfrac/ribfrac-train-info-1.csv",
         "public_id,label_id,label_code\nRibFrac1,0,0\nRibFrac1,1,2\n"
         "RibFrac1,2,-1\nRibFrac1,3,4\n")
    text(f"{src}/ribfrac/ribfrac-val-info.csv",
         "public_id,label_id,label_code\nRibFrac2,0,0\nRibFrac2,1,1\n"
         "RibFrac2,2,3\n")
    for n in (1, 501):
        nii(f"{src}/ribseg/labelsTr/RibFrac{n}-rib-seg.nii.gz", seg(rng, 2))
    nii(f"{src}/ribseg/labelsTr/RibFrac1-rib-cl.nii.gz", seg(rng, 2))


def forge_myops(src, rng):
    codes = np.array([0, 500, 600, 200, 1220, 2221], np.int16)
    for ident in ("101", "102"):
        c = f"myops_training_{ident}"
        for m in ("C0", "DE", "T2"):
            nii(f"{src}/train25/{c}_{m}.nii.gz", ct(rng))
        nii(f"{src}/train25_myops_gd/{c}_gd.nii.gz",
            codes[seg(rng, 6)])
    for m in ("C0", "DE"):
        nii(f"{src}/test20/myops_test_201_{m}.nii.gz", ct(rng))
    nii(f"{src}/ours.nii.gz", seg(rng, 6))


def forge_chaos(src, rng):
    for series in ("T1DUAL/DICOM_anon/InPhase", "T1DUAL/DICOM_anon/OutPhase",
                   "T2SPIR/DICOM_anon"):
        d = f"{src}/MR/1/{series}"
        os.makedirs(d)
        for z in rng.permutation(3):
            chip_smoke.write_dicom_slice(
                f"{d}/IMG-0004-000{z}.dcm", seg(rng, 1000, (6, 7), np.int16),
                (0.0, 0.0, 5.5 * z), int(z) + 1, spacing=(1.5, 1.5))
    for ground in ("T1DUAL/Ground", "T2SPIR/Ground"):
        for z in range(3):
            png(f"{src}/MR/1/{ground}/IMG-0004-000{z}.png",
                np.array([0, 63, 126, 189, 252], np.uint8)[seg(rng, 5,
                                                                (6, 7))])


def _arrays(seed, n=9):
    rng = np.random.RandomState(seed)
    return rng.randint(0, 256, (4, 12, 13)).astype(np.uint8), \
        rng.randint(0, n, (4, 12, 13)).astype(np.uint8)


CASES = {
    # tasks.py
    "convert_amos2022": (None, forge_amos, lambda f, s, o: f(s)),
    "convert_btcv": (None, forge_btcv, lambda f, s, o: f(s)),
    "convert_brats": (None, forge_brats,
                      lambda f, s, o: f(s, 82, "BraTS2020")),
    "convert_kits": (None, forge_kits, lambda f, s, o: f(s)),
    "convert_lits": (None, forge_lits,
                     lambda f, s, o: f(f"{s}/train", f"{s}/test")),
    "convert_acdc": (None, forge_acdc,
                     lambda f, s, o: f(f"{s}/training", f"{s}/testing")),
    "convert_segthor": (None, forge_segthor,
                        lambda f, s, o: f(f"{s}/train", f"{s}/test")),
    "convert_nih_pancreas": (None, forge_nih_pancreas, lambda f, s, o: f(s)),
    "convert_covidseg": (None, forge_covidseg, lambda f, s, o: f(s)),
    "convert_kits2021": (None, forge_kits2021, lambda f, s, o: f(s)),
    # tasks_extra.py
    "convert_promise2012": (None, forge_promise, lambda f, s, o: f(s)),
    "export_promise_submission": (
        None, forge_predictions, lambda f, s, o: f(f"{s}/pred", f"{o}/sub")),
    "convert_isbi_mslesion": (None, forge_isbi_mslesion,
                              lambda f, s, o: f(s)),
    "convert_verse2019": (None, forge_verse2019, lambda f, s, o: f(s)),
    "convert_verse2020": (None, forge_verse2020, lambda f, s, o: f(s)),
    "convert_isbi_em_seg": ("PIL", forge_isbi_em, lambda f, s, o: f(s)),
    "export_em_submission": ("PIL", forge_em_softmax,
                             lambda f, s, o: f(f"{s}/pred.npz",
                                               f"{o}/sub.tif")),
    "convert_epfl_em_mito": ("PIL", forge_epfl, lambda f, s, o: f(s)),
    "convert_cremi": ("h5py", forge_cremi, lambda f, s, o: f(s)),
    "convert_kits_nicks_labels": (
        None, forge_kits_nicks,
        lambda f, s, o: f(f"{s}/kits", f"{s}/filled")),
    "convert_fluo_c3dh_a549": ("PIL", forge_ctc_3d,
                               lambda f, s, o: f(f"{s}/ctc")),
    "convert_fluo_n3dh_sim": ("PIL", forge_ctc_3d,
                              lambda f, s, o: f(f"{s}/ctc")),
    "convert_fluo_n2dh_sim": ("PIL", forge_ctc_2d,
                              lambda f, s, o: f(f"{s}/ctc")),
    "convert_mnms": ("pandas", forge_mnms,
                     lambda f, s, o: f(f"{s}/data", f"{s}/info.csv")),
    "convert_covidseg_challenge": (None, forge_covid_challenge,
                                   lambda f, s, o: f(s)),
    "convert_road_segm": ("PIL", forge_roads, lambda f, s, o: f(s)),
    "convert_ribfrac": ("pandas", forge_ribfrac,
                        lambda f, s, o: f(f"{s}/ribfrac")),
    "convert_ribfrac_binary": ("pandas", forge_ribfrac,
                               lambda f, s, o: f(f"{s}/ribfrac")),
    "convert_ribseg": (None, forge_ribfrac,
                       lambda f, s, o: f(f"{s}/ribfrac", f"{s}/ribseg")),
    "convert_myops_labels_to_nnunet": (
        None, forge_myops,
        lambda f, s, o: f(f"{s}/train25_myops_gd/myops_training_101_gd."
                          f"nii.gz", f"{o}/ours.nii.gz")),
    "convert_labels_back_to_myops": (
        None, forge_myops,
        lambda f, s, o: f(f"{s}/ours.nii.gz", f"{o}/myops.nii.gz")),
    "convert_myops2020": (None, forge_myops, lambda f, s, o: f(s)),
    "convert_chaos": ("PIL", forge_chaos, lambda f, s, o: f(s)),
    # the label helpers, on random arrays
    "convert_MR_seg": (None, None, lambda f, s, o: f(_arrays(0)[0])),
    "convert_seg_to_intensity_task5": (None, None,
                                       lambda f, s, o: f(_arrays(1, 6)[1])),
    "convert_seg_to_intensity_task3": (None, None,
                                       lambda f, s, o: f(_arrays(2, 3)[1])),
    "generate_border_as_suggested_by_twollmann_2d": (
        "scipy", None,
        lambda f, s, o: f(_cells(np.random.RandomState(3)), (0.125, 0.25),
                          0.7)),
}


def public_functions(module):
    return {n for n, v in vars(module).items()
            if inspect.isfunction(v) and v.__module__ == module.__name__
            and not n.startswith("_")}


def test_every_public_function_has_a_case():
    for j, t in ((jtasks, ttasks), (jextra, textra)):
        assert public_functions(t) == public_functions(j)
    assert set(CASES) == public_functions(jtasks) | public_functions(jextra)


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def assert_same_value(a, b, where):
    if isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    elif isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b), where
        for x, y in zip(a, b):
            assert_same_value(x, y, where)
    else:
        assert a == b, where


def assert_same_trees(a, b):
    assert _files(a) == _files(b)
    for f in _files(a):
        pa, pb = os.path.join(a, f), os.path.join(b, f)
        if f.endswith(".nii.gz") or f.endswith(".nii"):
            ia, ib = jnii.read_nifti(pa), read_nifti(pb)
            assert_same_value(ia.array, ib.array, f)
            for k in ("spacing", "origin", "direction"):
                assert tuple(getattr(ia, k)) == tuple(getattr(ib, k)), (f, k)
        elif f.endswith(".json"):
            with open(pa) as fa, open(pb) as fb:
                assert json.load(fa) == json.load(fb), f
        elif f.endswith(".pkl"):
            with open(pa, "rb") as fa, open(pb, "rb") as fb:
                assert_same_value(pickle.load(fa), pickle.load(fb), f)
        else:
            with open(pa, "rb") as fa, open(pb, "rb") as fb:
                assert fa.read() == fb.read(), f


@pytest.mark.parametrize("name", list(CASES))
def test_converter_matches(tmp_path, monkeypatch, name):
    needs, forge, call = CASES[name]
    if needs:
        pytest.importorskip(needs)
    src = str(tmp_path / "src")
    if forge is not None:
        forge(src, np.random.RandomState(sorted(CASES).index(name)))
    got = {}
    for pkg, mods in (("jax", (jtasks, jextra)), ("port", (ttasks, textra))):
        fn = next(getattr(m, name) for m in mods if hasattr(m, name))
        out = tmp_path / pkg
        out.mkdir()
        monkeypatch.setenv("nnUNet_raw_data_base", str(out))
        r = call(fn, src, str(out))
        got[pkg] = os.path.relpath(r, out) if isinstance(r, str) else r
    assert_same_value(got["jax"], got["port"], "the returned value")
    assert_same_trees(str(tmp_path / "jax"), str(tmp_path / "port"))
    if forge is None:
        assert isinstance(got["port"], np.ndarray)
    else:
        assert [f for f in _files(str(tmp_path / "port"))
                if not f.endswith("dataset.json")]


def test_label_tables_match():
    assert ttasks.BTCV_LABELS == jtasks.BTCV_LABELS
    assert ttasks.AMOS_LABELS == jtasks.AMOS_LABELS
    assert textra.VERSE_LABELS == jextra.VERSE_LABELS
    assert textra._MYOPS_LABEL_MAP == jextra._MYOPS_LABEL_MAP


NEW_MODULES = (
    "e2enet_tpu_torch.io.metaimage", "e2enet_tpu_torch.io.nrrd",
    "e2enet_tpu_torch.io.dicom", "e2enet_tpu_torch.io.images2d",
    "e2enet_tpu_torch.preprocessing.reorientation",
    "e2enet_tpu_torch.dataset_conversion.file_conversions",
    "e2enet_tpu_torch.dataset_conversion.tasks",
    "e2enet_tpu_torch.dataset_conversion.tasks_extra",
    "e2enet_tpu_torch.utils.overlay_plots",
    "e2enet_tpu_torch.inference.pretrained_models")


def test_new_modules_import_without_optional_libraries():
    """Each new module imports in a fresh interpreter where jax, flax,
    e2enet_tpu, PIL, h5py, pandas and matplotlib cannot be imported, and
    a MetaImage, NRRD and DICOM round trip runs there."""
    code = """
import sys, importlib
for m in ("jax", "jaxlib", "flax", "e2enet_tpu", "PIL", "h5py", "pandas",
          "matplotlib"):
    sys.modules[m] = None
for n in sys.argv[1:]:
    importlib.import_module(n)
import numpy as np, os, tempfile
import chip_smoke
from e2enet_tpu_torch.io.nifti import NiftiImage
from e2enet_tpu_torch.io import dicom, metaimage, nrrd
img = NiftiImage(np.arange(24, dtype=np.int16).reshape(2, 3, 4), (1, 2, 3))
with tempfile.TemporaryDirectory() as d:
    metaimage.write_mhd(os.path.join(d, "a.mha"), img, compressed=True)
    nrrd.write_nrrd(os.path.join(d, "a.nrrd"), img)
    for z in range(2):
        chip_smoke.write_dicom_slice(os.path.join(d, f"s{z}"),
                                     img.array[z], (0, 0, 3.0 * z), z + 1)
    for back in (metaimage.read_mhd(os.path.join(d, "a.mha")),
                 nrrd.read_nrrd(os.path.join(d, "a.nrrd")),
                 dicom.read_dicom_series(d)):
        assert np.array_equal(back.array, img.array)
blocked = ("jax", "flax", "e2enet_tpu", "PIL", "h5py", "pandas",
           "matplotlib")
assert not any(k.split(".")[0] in blocked and sys.modules[k] is not None
               for k in sys.modules)
print("imported", len(sys.argv) - 1)
"""
    r = subprocess.run([sys.executable, "-c", code, *NEW_MODULES], cwd=REPO,
                       capture_output=True, text=True, timeout=300,
                       env={**os.environ, "PYTHONPATH": str(REPO)})
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.split()[-1] == str(len(NEW_MODULES))
