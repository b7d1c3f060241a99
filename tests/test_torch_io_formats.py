"""The port's readers and writers of the other image formats
(io/metaimage.py, io/nrrd.py, io/dicom.py, io/images2d.py), its RAS
reorientation (preprocessing/reorientation.py), its 2D/3D file
conversions (dataset_conversion/file_conversions.py) and its overlay
plots (utils/overlay_plots.py) against the JAX package's own, on seeded
synthetic data.

Each reader reads the other package's files and gives what that
package's own reader gives: the array, its dtype and the geometry, all
exactly. The deterministic writers' files equal the JAX package's byte
for byte: MetaImage raw, zlib and .mha, NRRD raw, PNG and TIFF through
PIL. NRRD's gzip member carries the time of writing, so a compressed
NRRD is held by its header text and its decompressed payload. A .nii.gz
is compared by its decoded image, never by its bytes: the port writes
gzip level 1 (io/nifti.py). The tests that need PIL or matplotlib skip
where it is missing."""
import gzip
import os
import pickle
import struct

import numpy as np
import pytest

import chip_smoke
import e2enet_tpu.dataset_conversion.file_conversions as jconv
import e2enet_tpu.io.dicom as jdicom
import e2enet_tpu.io.images2d as jimg
import e2enet_tpu.io.metaimage as jmhd
import e2enet_tpu.io.nifti as jnii
import e2enet_tpu.io.nrrd as jnrrd
import e2enet_tpu.preprocessing.reorientation as jreo
import e2enet_tpu.utils.overlay_plots as jov
import e2enet_tpu_torch.dataset_conversion.file_conversions as tconv
import e2enet_tpu_torch.io.dicom as tdicom
import e2enet_tpu_torch.io.images2d as timg
import e2enet_tpu_torch.io.metaimage as tmhd
import e2enet_tpu_torch.io.nifti as tnii
import e2enet_tpu_torch.io.nrrd as tnrrd
import e2enet_tpu_torch.preprocessing.reorientation as treo
import e2enet_tpu_torch.utils.overlay_plots as tov

PACKAGES = {"jax": (jmhd, jnrrd, jdicom, jimg, jnii),
            "port": (tmhd, tnrrd, tdicom, timg, tnii)}
GEOM = dict(spacing=(0.8, 0.9, 2.6), origin=(12.5, -3.0, 40.0),
            direction=(0.0, 1.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0, -1.0))
# LPS direction cosines (columns: the data x, y, z axes) of several
# orientations: as stored (LPS), RAS, PIR, LAS and one a few degrees off
# the axes
_c, _s = np.cos(0.1), np.sin(0.1)
ORIENTATIONS = {
    "LPS": (1, 0, 0, 0, 1, 0, 0, 0, 1),
    "RAS": (-1, 0, 0, 0, -1, 0, 0, 0, 1),
    "PIR": chip_smoke.PIR,
    "LAS": (1, 0, 0, 0, -1, 0, 0, 0, 1),
    "oblique": (_c, -_s, 0, _s, _c, 0, 0, 0, 1),
}


def image(pkg, seed, shape=(4, 5, 6), dtype=np.float32, **geom):
    rng = np.random.RandomState(seed)
    arr = (rng.rand(*shape) * 200 - 50).astype(dtype)
    return PACKAGES[pkg][4].NiftiImage(arr, **{**GEOM, **geom})


def assert_same_image(a, b):
    assert a.array.dtype == b.array.dtype and a.array.shape == b.array.shape
    np.testing.assert_array_equal(a.array, b.array)
    assert tuple(a.spacing) == tuple(b.spacing)
    assert tuple(a.origin) == tuple(b.origin)
    assert tuple(a.direction) == tuple(b.direction)


def read_bytes(path):
    with open(path, "rb") as f:
        return f.read()


def write_both(tmp_path, module_index, fname, write):
    """write(module, path) with each package's module into a folder of
    its own; returns {package: path}."""
    out = {}
    for pkg, mods in PACKAGES.items():
        d = tmp_path / pkg
        d.mkdir(exist_ok=True)
        out[pkg] = str(d / fname)
        write(mods[module_index], pkg, out[pkg])
    return out


def cross_read(paths, module_index, read):
    """Each package's reader on each package's file gives the same
    image."""
    got = {(r, w): read(PACKAGES[r][module_index], p)
           for r in PACKAGES for w, p in paths.items()}
    first = next(iter(got.values()))
    for img in got.values():
        assert_same_image(img, first)
    return first


# ---------------------------------------------------------------------------
# MetaImage

@pytest.mark.parametrize("shape", [(4, 5, 6), (5, 7)], ids=["3d", "2d"])
@pytest.mark.parametrize("dtype", [np.int16, np.float32, np.uint8])
@pytest.mark.parametrize("ext,compressed", [(".mha", False), (".mha", True),
                                            (".mhd", False), (".mhd", True)])
def test_metaimage_bytes_and_cross_read(tmp_path, ext, compressed, dtype,
                                        shape):
    def write(mod, pkg, path):
        img = image(pkg, 0, shape, dtype)
        mod.write_mhd(path, img, compressed=compressed)
    paths = write_both(tmp_path, 0, "vol" + ext, write)
    files = sorted(os.listdir(tmp_path / "jax"))
    assert files == sorted(os.listdir(tmp_path / "port"))
    assert len(files) == (1 if ext == ".mha" else 2)
    for f in files:
        assert read_bytes(tmp_path / "jax" / f) == \
            read_bytes(tmp_path / "port" / f), f
    img = cross_read(paths, 0, lambda mod, p: mod.read_mhd(p))
    src = image("port", 0, shape, dtype)
    np.testing.assert_array_equal(img.array, src.array)
    if len(shape) == 2:
        # a 2D image reads back as a 3D geometry with unit z spacing
        assert img.spacing[2] == 1.0 and img.origin[2] == 0.0


def test_metaimage_header_rounds_geometry_to_six_digits(tmp_path):
    """Both writers format spacing, origin and direction with ':g' (six
    significant digits): -123.456789 is written, and read back, as
    -123.457. NRRD keeps 17 digits."""
    geom = dict(spacing=(0.123456789, 1.0, 2.5),
                origin=(-123.456789, 7.0, 1e-7), direction=ORIENTATIONS[
                    "oblique"])
    for mod, pkg in ((jmhd, "jax"), (tmhd, "port")):
        p = str(tmp_path / f"{pkg}.mha")
        mod.write_mhd(p, image(pkg, 1, **geom))
        with open(p, "rb") as f:
            header = f.read().split(b"ElementDataFile")[0].decode()
        assert "Offset = -123.457 7 1e-07" in header
        assert "ElementSpacing = 0.123457 1 2.5" in header
        assert f"TransformMatrix = {_c:g} {-_s:g} 0" in header
        back = tmhd.read_mhd(p)
        assert back.origin == (-123.457, 7.0, 1e-7)
        assert back.spacing == (0.123457, 1.0, 2.5)
        p = str(tmp_path / f"{pkg}.nrrd")
        PACKAGES[pkg][1].write_nrrd(p, image(pkg, 1, **geom),
                                    compressed=False)
        np.testing.assert_allclose(tnrrd.read_nrrd(p).origin,
                                   geom["origin"], rtol=1e-15)


def test_metaimage_reads_other_headers(tmp_path):
    """Headers another MetaIO writer makes: big-endian data, ElementSize
    and Position for spacing and origin, no TransformMatrix, channels."""
    rng = np.random.RandomState(2)
    arr = rng.randint(0, 1000, (3, 4, 5, 2)).astype(">u2")
    (tmp_path / "v.raw").write_bytes(arr.tobytes())
    (tmp_path / "v.mhd").write_text(
        "ObjectType = Image\nNDims = 3\nElementByteOrderMSB = True\n"
        "ElementSize = 1.5 2 3\nPosition = 1 2 3\nDimSize = 5 4 3\n"
        "ElementNumberOfChannels = 2\nElementType = MET_USHORT\n"
        "ElementDataFile = v.raw\n")
    img = cross_read({"file": str(tmp_path / "v.mhd")}, 0,
                     lambda mod, p: mod.read_mhd(p))
    np.testing.assert_array_equal(img.array, arr.astype(np.uint16))
    assert img.spacing == (1.5, 2.0, 3.0) and img.origin == (1.0, 2.0, 3.0)


# ---------------------------------------------------------------------------
# NRRD

def _nrrd_parts(path):
    data = read_bytes(path)
    header, payload = data.split(b"\n\n", 1)
    return header, payload


@pytest.mark.parametrize("dtype", [np.float32, np.int16, np.uint8])
@pytest.mark.parametrize("compressed", [False, True])
def test_nrrd_bytes_and_cross_read(tmp_path, compressed, dtype):
    def write(mod, pkg, path):
        mod.write_nrrd(path, image(pkg, 3, dtype=dtype), compressed)
    paths = write_both(tmp_path, 1, "vol.nrrd", write)
    if compressed:
        (hj, pj), (hp, pp) = (_nrrd_parts(paths[k]) for k in ("jax", "port"))
        assert hj == hp and b"encoding: gzip" in hj
        assert gzip.decompress(pj) == gzip.decompress(pp)
    else:
        assert read_bytes(paths["jax"]) == read_bytes(paths["port"])
    img = cross_read(paths, 1, lambda mod, p: mod.read_nrrd(p))
    np.testing.assert_array_equal(img.array, image("port", 3,
                                                   dtype=dtype).array)
    np.testing.assert_allclose(img.direction, GEOM["direction"], atol=1e-15)


@pytest.mark.parametrize("encoding", ["raw", "gzip", "zlib", "ascii"])
def test_nrrd_detached_header_and_encodings(tmp_path, encoding):
    """A .nhdr with its data in a file of its own, in each encoding, in a
    right-anterior-superior space (flipped to LPS on read)."""
    import zlib
    arr = (np.arange(60, dtype=np.int16).reshape(3, 4, 5) - 20) * 7
    payload = {"raw": arr.astype("<i2").tobytes(),
               "gzip": gzip.compress(arr.astype("<i2").tobytes(), mtime=0),
               "zlib": zlib.compress(arr.astype("<i2").tobytes()),
               "ascii": " ".join(str(v) for v in arr.ravel()).encode()}
    (tmp_path / "vol.data").write_bytes(payload[encoding])
    (tmp_path / "vol.nhdr").write_text(
        "NRRD0004\n# a comment\ntype: short\ndimension: 3\n"
        "space: right-anterior-superior\nsizes: 5 4 3\n"
        "space directions: (0,1.5,0) (2,0,0) (0,0,-3)\n"
        f"kinds: domain domain domain\nendian: little\nencoding: {encoding}\n"
        "space origin: (10,-20,30)\ndata file: vol.data\n\n")
    img = cross_read({"file": str(tmp_path / "vol.nhdr")}, 1,
                     lambda mod, p: mod.read_nrrd(p))
    np.testing.assert_array_equal(img.array, arr)
    assert img.spacing == (1.5, 2.0, 3.0)
    assert img.origin == (-10.0, 20.0, 30.0)


# ---------------------------------------------------------------------------
# DICOM

def _series(folder, seed, explicit, part10, orientation, names):
    """A seeded series written in a shuffled order; returns the pixels in
    slice order and the geometry it must read back as."""
    rng = np.random.RandomState(seed)
    pix = rng.randint(-500, 2500, (5, 6, 7)).astype(np.int16)
    row, col = np.array(orientation[:3], float), np.array(orientation[3:])
    normal = np.cross(row, col)
    first = np.array([-40.0, 12.5, 80.0])
    os.makedirs(folder)
    for z in rng.permutation(5):
        pos = first + 2.5 * z * normal
        chip_smoke.write_dicom_slice(
            os.path.join(folder, names(z)), pix[z], pos, int(z) + 1,
            spacing=(0.7, 0.9), orientation=orientation, slope=2.0,
            intercept=-1024.0, explicit=explicit, part10=part10)
    return pix, first, np.stack([row, col, normal], axis=1)


@pytest.mark.parametrize("explicit,part10,orientation", [
    (True, True, (1, 0, 0, 0, 1, 0)),
    (False, True, (1, 0, 0, 0, 0, -1)),
    (False, False, (_c, _s, 0, -_s, _c, 0))],
    ids=["explicit", "implicit_coronal", "bare_oblique"])
def test_dicom_series_out_of_order(tmp_path, explicit, part10, orientation):
    """Slices written out of order, half of them without an extension,
    beside files the filter skips: both readers sort along the normal and
    give the rescaled pixels and the series' LPS geometry."""
    folder = str(tmp_path / "series")
    pix, first, direction = _series(
        folder, 4, explicit, part10, orientation,
        lambda z: f"IM{z}" + (".dcm" if z % 2 else ""))
    (tmp_path / "series" / "notes.txt").write_text("not a slice")
    (tmp_path / "series" / "overview.png").write_bytes(b"not a slice")
    img = cross_read({"file": folder}, 2,
                     lambda mod, p: mod.read_dicom_series(p))
    np.testing.assert_array_equal(img.array,
                                  pix.astype(np.float32) * 2.0 - 1024.0)
    np.testing.assert_allclose(img.spacing, (0.9, 0.7, 2.5))
    np.testing.assert_allclose(img.origin, first)
    np.testing.assert_allclose(np.reshape(img.direction, (3, 3)), direction,
                               atol=1e-12)


def test_dicom_sorts_ties_by_instance(tmp_path):
    """Slices at one position sort by their instance number."""
    folder = tmp_path / "series"
    folder.mkdir()
    pix = np.arange(3 * 4 * 5, dtype=np.int16).reshape(3, 4, 5)
    for z in (2, 0, 1):
        chip_smoke.write_dicom_slice(str(folder / f"s{z}"), pix[z],
                                     (0, 0, 0), z + 1)
    img = cross_read({"file": str(folder)}, 2,
                     lambda mod, p: mod.read_dicom_series(p))
    np.testing.assert_array_equal(img.array, pix.astype(np.float32))


@pytest.mark.parametrize("explicit", [True, False])
def test_dicom_element_scanner(tmp_path, explicit):
    """_read_elements on the same bytes: the same elements, the sequence
    of undefined length skipped, the scan stopped after the pixel
    data."""
    p = str(tmp_path / "s.dcm")
    chip_smoke.write_dicom_slice(p, np.ones((2, 3), np.int16), (1, 2, 3), 7,
                                 explicit=explicit)
    # an element after the pixel data, which the scan must not reach
    buf = read_bytes(p) + struct.pack("<HHI", 0x7FE1, 0x0010, 0)
    start = 132 + 12 + struct.unpack_from("<I", buf, 132 + 8)[0]
    got = [mod._read_elements(buf, start, explicit)
           for mod in (jdicom, tdicom)]
    assert got[0] == got[1]
    assert (0x0008, 0x1140) not in got[1]
    assert max(got[1]) == (0x7FE0, 0x0010)
    meta = [mod._read_elements(buf[:start], 132, True,
                               stop_after_pixeldata=False)
            for mod in (jdicom, tdicom)]
    assert meta[0] == meta[1]
    assert meta[1][(0x0002, 0x0010)].rstrip(b"\0") == (
        b"1.2.840.10008.1.2.1" if explicit else b"1.2.840.10008.1.2")


def test_dicom_refuses_compressed_transfer_syntax(tmp_path):
    p = str(tmp_path / "s.dcm")
    chip_smoke.write_dicom_slice(p, np.ones((2, 3), np.int16), (0, 0, 0), 1)
    data = read_bytes(p).replace(b"1.2.840.10008.1.2.1\0",
                                 b"1.2.840.10008.1.2.5\0")
    with open(p, "wb") as f:
        f.write(data)
    for mod in (jdicom, tdicom):
        with pytest.raises(NotImplementedError):
            mod.read_dicom_slice(p)


# ---------------------------------------------------------------------------
# PNG and TIFF through PIL

@pytest.mark.parametrize("kind", ["png_gray", "png_rgb", "png_u16",
                                  "tif_stack", "tif_f32_stack", "tif_single"])
def test_images2d_bytes_and_cross_read(tmp_path, kind):
    pytest.importorskip("PIL")
    rng = np.random.RandomState(5)
    arr = {"png_gray": rng.randint(0, 256, (9, 11)).astype(np.uint8),
           "png_rgb": rng.randint(0, 256, (9, 11, 3)).astype(np.uint8),
           "png_u16": rng.randint(0, 65536, (9, 11)).astype(np.uint16),
           "tif_stack": rng.randint(0, 256, (4, 9, 11)).astype(np.uint8),
           "tif_f32_stack": rng.rand(3, 9, 11).astype(np.float32),
           "tif_single": rng.randint(0, 256, (9, 11)).astype(np.uint8)}[kind]
    ext = ".png" if kind.startswith("png") else ".tif"
    paths = {}
    for pkg, mod in (("jax", jimg), ("port", timg)):
        paths[pkg] = str(tmp_path / f"{pkg}{ext}")
        write = mod.write_2d_image if ext == ".png" else mod.write_tiff_stack
        write(paths[pkg], arr)
    assert read_bytes(paths["jax"]) == read_bytes(paths["port"])
    for p in paths.values():
        for mod in (jimg, timg):
            read = mod.read_2d_image if ext == ".png" else mod.read_tiff_stack
            got = read(p)
            assert got.dtype == arr.dtype
            np.testing.assert_array_equal(got, arr)


# ---------------------------------------------------------------------------
# RAS reorientation

@pytest.mark.parametrize("orientation", list(ORIENTATIONS))
def test_reorientation_functions_match(orientation):
    img = image("port", 6, direction=ORIENTATIONS[orientation])
    jimg_ = image("jax", 6, direction=ORIENTATIONS[orientation])
    A = treo.ras_affine(img)
    np.testing.assert_array_equal(A, jreo.ras_affine(jimg_))
    np.testing.assert_array_equal(treo.io_orientation(A),
                                  jreo.io_orientation(A))
    assert treo.aff2axcodes(A) == jreo.aff2axcodes(A)
    (t, tA), (j, jA) = (mod.reorient_image_to_ras(i) for mod, i in
                        ((treo, img), (jreo, jimg_)))
    assert_same_image(t, j)
    np.testing.assert_array_equal(tA, jA)
    assert treo.aff2axcodes(treo.ras_affine(t)) == ("R", "A", "S")
    back = treo.revert_image_orientation(t, tA)
    np.testing.assert_array_equal(back.array, img.array)
    np.testing.assert_allclose(back.spacing, img.spacing, rtol=1e-15)
    np.testing.assert_allclose(back.origin, img.origin, atol=1e-12)
    np.testing.assert_allclose(back.direction, img.direction, atol=1e-15)


@pytest.mark.parametrize("orientation", list(ORIENTATIONS))
@pytest.mark.parametrize("first,then", [("port", "jax"), ("jax", "port")])
def test_reorientation_sidecar_crosses_packages(tmp_path, first, then,
                                                orientation):
    """One package reorients a file to RAS and writes the sidecar; the
    other reverts it: every voxel of the source, the sidecar a pickle of
    a numpy array and a tuple of strings only."""
    mods = {"jax": (jreo, jnii), "port": (treo, tnii)}
    seg = (np.random.RandomState(7).rand(4, 5, 6) * 5).astype(np.uint8)
    p = str(tmp_path / "case.nii.gz")
    src = tnii.NiftiImage(seg, **{**GEOM,
                                  "direction": ORIENTATIONS[orientation]})
    tnii.write_nifti(p, src)
    source = tnii.read_nifti(p)
    mods[first][0].reorient_to_ras(p)
    sidecar = p[:-7] + "_originalAffine.pkl"
    with open(sidecar, "rb") as f:
        A, codes = pickle.load(f)
    assert type(A) is np.ndarray and A.shape == (4, 4)
    assert type(codes) is tuple and all(type(c) is str for c in codes)
    np.testing.assert_array_equal(A, treo.ras_affine(source))
    ras = {pkg: m[1].read_nifti(p) for pkg, m in mods.items()}
    assert_same_image(ras["jax"], ras["port"])
    assert jreo.aff2axcodes(jreo.ras_affine(ras["jax"])) == ("R", "A", "S")
    mods[then][0].revert_reorientation(p)
    assert not os.path.exists(sidecar)
    back = tnii.read_nifti(p)
    assert back.array.dtype == seg.dtype
    np.testing.assert_array_equal(back.array, seg)
    np.testing.assert_allclose(back.spacing, source.spacing, rtol=1e-6)
    np.testing.assert_allclose(back.origin, source.origin, atol=1e-4)
    np.testing.assert_allclose(back.direction, source.direction, atol=1e-6)


def test_reorient_folder_skips_reoriented_files(tmp_path):
    """A file with a sidecar is left as it is; the folder variants of both
    packages give equal files."""
    for pkg, (reo, nii) in (("jax", (jreo, jnii)), ("port", (treo, tnii))):
        d = tmp_path / pkg
        d.mkdir()
        for i, o in enumerate(("PIR", "LAS")):
            nii.write_nifti(str(d / f"c{i}.nii.gz"),
                            image(pkg, 8 + i, direction=ORIENTATIONS[o]))
        reo.reorient_all_images_in_folder_to_ras(str(d))
        before = read_bytes(d / "c0.nii.gz")
        reo.reorient_all_images_in_folder_to_ras(str(d))
        assert read_bytes(d / "c0.nii.gz") == before
    for i in range(2):
        assert_same_image(tnii.read_nifti(str(tmp_path / "jax" /
                                              f"c{i}.nii.gz")),
                          tnii.read_nifti(str(tmp_path / "port" /
                                              f"c{i}.nii.gz")))
    for pkg, reo in (("jax", treo), ("port", jreo)):
        reo.revert_orientation_on_all_images_in_folder(str(tmp_path / pkg))
        for i in range(2):
            np.testing.assert_array_equal(
                tnii.read_nifti(str(tmp_path / pkg / f"c{i}.nii.gz")).array,
                image("port", 8 + i).array)


# ---------------------------------------------------------------------------
# 2D / 3D file conversions

def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def assert_same_files(a, b):
    """The same file names; .nii.gz by the decoded image, the rest byte
    for byte."""
    assert _tree(a) == _tree(b)
    for f in _tree(a):
        pa, pb = os.path.join(a, f), os.path.join(b, f)
        if f.endswith(".nii.gz"):
            assert_same_image(jnii.read_nifti(pa), tnii.read_nifti(pb))
        else:
            assert read_bytes(pa) == read_bytes(pb), f


@pytest.mark.parametrize("case", ["png_rgb", "png_seg", "tiff_3d",
                                  "tiff_3d_seg", "seg_to_png",
                                  "seg_to_tiff"])
def test_file_conversions_match(tmp_path, case):
    pytest.importorskip("PIL")
    rng = np.random.RandomState(9)
    src = tmp_path / "src"
    src.mkdir()
    timg.write_2d_image(str(src / "rgb.png"),
                        rng.randint(0, 256, (10, 12, 3)).astype(np.uint8))
    timg.write_2d_image(str(src / "seg.png"),
                        (rng.rand(10, 12) > 0.5).astype(np.uint8) * 255)
    timg.write_tiff_stack(str(src / "a.tif"),
                          rng.randint(0, 256, (3, 10, 12)).astype(np.uint8))
    timg.write_tiff_stack(str(src / "b.tif"),
                          rng.randint(0, 256, (3, 10, 12)).astype(np.uint8))
    tnii.write_nifti(str(src / "seg2d.nii.gz"), tnii.NiftiImage(
        rng.randint(0, 3, (1, 10, 12)).astype(np.uint8), (1.0, 1.0, 999.0)))
    tnii.write_nifti(str(src / "seg3d.nii.gz"), tnii.NiftiImage(
        rng.randint(0, 3, (3, 10, 12)).astype(np.uint8), (1.0, 1.0, 2.0)))
    calls = {
        "png_rgb": lambda m, o: m.convert_2d_image_to_nifti(
            str(src / "rgb.png"), o + "/case", spacing=(999, 0.5, 0.25)),
        "png_seg": lambda m, o: m.convert_2d_image_to_nifti(
            str(src / "seg.png"), o + "/case", is_seg=True,
            transform=lambda x: (x == 255).astype(int)),
        "tiff_3d": lambda m, o: m.convert_3d_tiff_to_nifti(
            [str(src / "a.tif"), str(src / "b.tif")], o + "/case",
            spacing=(2.0, 0.5, 0.5)),
        "tiff_3d_seg": lambda m, o: m.convert_3d_tiff_to_nifti(
            [str(src / "a.tif")], o + "/case", spacing=(2.0, 0.5, 0.5),
            transform=lambda x: (x > 127).astype(np.uint8), is_seg=True),
        "seg_to_png": lambda m, o: m.convert_2d_segmentation_nifti_to_img(
            str(src / "seg2d.nii.gz"), o + "/seg.png"),
        "seg_to_tiff": lambda m, o: m.convert_3d_segmentation_nifti_to_tiff(
            str(src / "seg3d.nii.gz"), o + "/seg.tif",
            transform=lambda x: x * 100)}
    for pkg, mod in (("jax", jconv), ("port", tconv)):
        (tmp_path / pkg).mkdir()
        calls[case](mod, str(tmp_path / pkg))
    assert _tree(tmp_path / "port")
    assert_same_files(str(tmp_path / "jax"), str(tmp_path / "port"))


# ---------------------------------------------------------------------------
# overlay plots

@pytest.mark.parametrize("seed", range(4))
def test_generate_overlay_matches(seed):
    rng = np.random.RandomState(seed)
    img = rng.randn(7, 24, 20) * 100 + seed
    seg = rng.randint(0, 3 + 5 * seed, (7, 24, 20))
    seg[:, :4] = 0
    if seed == 3:
        seg[:] = 0
    assert tov.select_slice(seg) == jov.select_slice(seg)
    s = tov.select_slice(seg)
    for intensity in (0.6, 0.25):
        got = tov.generate_overlay(img[s], seg[s], intensity)
        assert got.dtype == np.uint8 and got.shape == (24, 20, 3)
        np.testing.assert_array_equal(
            got, jov.generate_overlay(img[s], seg[s], intensity))
    assert tov.COLORS == jov.COLORS


def test_plot_overlay_png(tmp_path):
    """plot_overlay writes a PNG whose pixels are generate_overlay's at
    the largest-foreground slice, as the JAX one does; the folder variant
    writes one PNG per case."""
    pytest.importorskip("matplotlib")
    PIL = pytest.importorskip("PIL.Image")
    rng = np.random.RandomState(11)
    images, segs = tmp_path / "images", tmp_path / "segs"
    images.mkdir()
    segs.mkdir()
    for c in range(2):
        img = (rng.randn(6, 16, 18) * 50).astype(np.float32)
        seg = np.zeros((6, 16, 18), np.uint8)
        seg[2 + c, 3:9, 4:12] = 1
        seg[2 + c, 10:14, 4:6] = 2
        tnii.write_nifti(str(images / f"case{c}_0000.nii.gz"),
                         tnii.NiftiImage(img, (1.0, 1.0, 1.0)))
        tnii.write_nifti(str(segs / f"case{c}.nii.gz"),
                         tnii.NiftiImage(seg, (1.0, 1.0, 1.0)))
    for pkg, mod in (("jax", jov), ("port", tov)):
        mod.plot_overlay_folder(str(images), str(segs), str(tmp_path / pkg))
    for c in range(2):
        img = tnii.read_nifti(str(images / f"case{c}_0000.nii.gz")).array
        seg = tnii.read_nifti(str(segs / f"case{c}.nii.gz")).array
        want = tov.generate_overlay(img[2 + c], seg[2 + c])
        pix = {}
        for pkg in ("jax", "port"):
            with PIL.open(str(tmp_path / pkg / f"case{c}.png")) as im:
                pix[pkg] = np.asarray(im.convert("RGBA"))
        np.testing.assert_array_equal(pix["port"], pix["jax"])
        np.testing.assert_array_equal(pix["port"][..., :3], want)
        assert (pix["port"][..., 3] == 255).all()
