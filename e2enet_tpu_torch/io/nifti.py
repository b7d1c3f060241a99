"""Pure-numpy NIfTI-1 reader/writer.

The reference delegates medical-image I/O to SimpleITK (ITK C++,
e2enet/preprocessing/cropping.py:60-82, inference/segmentation_export.py);
neither SimpleITK nor nibabel is available here, so this module implements
the NIfTI-1 format directly. Conventions match SimpleITK so the ported
pipeline logic is 1:1:

  * `array` is returned (z, y, x)-ordered (like sitk.GetArrayFromImage);
  * `spacing`, `origin`, `direction` are ITK-style: (x, y, z) spacing,
    LPS-frame origin and row-major 3x3 direction cosines
    (NIfTI affines are RAS; ITK uses LPS — we flip x/y on read and write).

Supports .nii and .nii.gz, the standard scalar dtypes, scl_slope/scl_inter
rescaling, and sform/qform affines (sform preferred).

The port's own copy of e2enet_tpu/io/nifti.py, with one change: a .nii.gz
is written at gzip level 1, not at gzip's default 9 as the JAX package
writes it. The image read back is the same and the file a little larger;
level 9 spends seconds on a barely trained model's speckled label map,
which every export, merge and postprocessing step writes. The port
imports nothing of the JAX package.
"""
import gzip
import struct
from dataclasses import dataclass
from typing import Tuple

import numpy as np

_DTYPES = {
    2: np.uint8, 4: np.int16, 8: np.int32, 16: np.float32, 64: np.float64,
    256: np.int8, 512: np.uint16, 768: np.uint32, 1024: np.int64,
    1280: np.uint64,
}
_DTYPE_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}

_RAS2LPS = np.diag([-1.0, -1.0, 1.0])


@dataclass
class NiftiImage:
    array: np.ndarray                      # (z, y, x) or (t, z, y, x)
    spacing: Tuple[float, float, float]    # (x, y, z)
    origin: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    direction: Tuple[float, ...] = (1, 0, 0, 0, 1, 0, 0, 0, 1)

    @property
    def geometry(self):
        return {"spacing": tuple(self.spacing), "origin": tuple(self.origin),
                "direction": tuple(self.direction)}


def _quaternion_to_matrix(b, c, d, qfac):
    a2 = 1.0 - (b * b + c * c + d * d)
    a = np.sqrt(max(a2, 0.0))
    R = np.array([
        [a * a + b * b - c * c - d * d, 2 * b * c - 2 * a * d,
         2 * b * d + 2 * a * c],
        [2 * b * c + 2 * a * d, a * a + c * c - b * b - d * d,
         2 * c * d - 2 * a * b],
        [2 * b * d - 2 * a * c, 2 * c * d + 2 * a * b,
         a * a + d * d - c * c - b * b]])
    if qfac < 0:
        R[:, 2] *= -1
    return R


def read_nifti(path: str, dtype=None) -> NiftiImage:
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "rb") as f:
        raw = f.read()

    hdr = raw[:348]
    sizeof_hdr = struct.unpack("<i", hdr[0:4])[0]
    if sizeof_hdr != 348:
        raise ValueError(f"{path}: not a NIfTI-1 file (sizeof_hdr="
                         f"{sizeof_hdr}); NIfTI-2 is not supported")
    dim = struct.unpack("<8h", hdr[40:56])
    ndim = dim[0]
    shape = dim[1:1 + ndim]
    datatype = struct.unpack("<h", hdr[70:72])[0]
    pixdim = struct.unpack("<8f", hdr[76:108])
    vox_offset = int(struct.unpack("<f", hdr[108:112])[0])
    scl_slope = struct.unpack("<f", hdr[112:116])[0]
    scl_inter = struct.unpack("<f", hdr[116:120])[0]
    qform_code = struct.unpack("<h", hdr[252:254])[0]
    sform_code = struct.unpack("<h", hdr[254:256])[0]
    quatern = struct.unpack("<6f", hdr[256:280])
    srow = np.array(struct.unpack("<12f", hdr[280:328])).reshape(3, 4)

    if datatype not in _DTYPES:
        raise ValueError(f"{path}: unsupported NIfTI datatype {datatype}")
    np_dtype = np.dtype(_DTYPES[datatype])

    n_vox = int(np.prod(shape))
    data = np.frombuffer(raw, dtype=np_dtype.newbyteorder("<"),
                         count=n_vox, offset=vox_offset)
    # NIfTI stores x fastest (Fortran order); reshape to (x,y,z[,t]) then
    # transpose so array is (t,)z,y,x like sitk.GetArrayFromImage
    data = data.reshape(shape, order="F")
    data = data.transpose(tuple(range(data.ndim))[::-1])

    if scl_slope not in (0.0, 1.0) and not np.isnan(scl_slope):
        data = data.astype(np.float32) * scl_slope + scl_inter
    elif scl_inter not in (0.0,) and not np.isnan(scl_inter) and scl_slope != 0:
        data = data.astype(np.float32) + scl_inter
    if dtype is not None:
        data = data.astype(dtype)
    else:
        data = np.ascontiguousarray(data)

    # affine (RAS): sform preferred, then qform, then pixdim-only
    if sform_code > 0:
        A = srow
    elif qform_code > 0:
        R = _quaternion_to_matrix(quatern[0], quatern[1], quatern[2],
                                  pixdim[0] if pixdim[0] != 0 else 1.0)
        A = np.concatenate(
            [R * np.array(pixdim[1:4]), np.array(quatern[3:6])[:, None]], 1)
    else:
        A = np.concatenate([np.diag(pixdim[1:4]), np.zeros((3, 1))], 1)

    spacing = tuple(float(np.linalg.norm(A[:, i])) for i in range(3))
    spacing = tuple(s if s > 0 else 1.0 for s in spacing)
    rot = A[:, :3] / np.array(spacing)
    direction_lps = _RAS2LPS @ rot
    origin_lps = _RAS2LPS @ A[:, 3]
    return NiftiImage(array=data, spacing=spacing,
                      origin=tuple(map(float, origin_lps)),
                      direction=tuple(map(float, direction_lps.reshape(-1))))


def write_nifti(path: str, image: NiftiImage):
    data = np.asarray(image.array)
    assert data.ndim == 3, "write_nifti writes 3D volumes"
    if data.dtype not in _DTYPE_CODES:
        data = data.astype(np.float32)
    datatype = _DTYPE_CODES[np.dtype(data.dtype)]
    bitpix = data.dtype.itemsize * 8

    spacing = np.array(image.spacing, float)
    direction = np.array(image.direction, float).reshape(3, 3)
    origin = np.array(image.origin, float)
    # ITK(LPS) -> NIfTI(RAS) affine
    A = np.zeros((3, 4))
    A[:, :3] = _RAS2LPS @ (direction * spacing)
    A[:, 3] = _RAS2LPS @ origin

    hdr = bytearray(348)
    struct.pack_into("<i", hdr, 0, 348)
    dims = data.shape[::-1]  # back to (x, y, z)
    struct.pack_into("<8h", hdr, 40, 3, dims[0], dims[1], dims[2], 1, 1, 1, 1)
    struct.pack_into("<h", hdr, 70, datatype)
    struct.pack_into("<h", hdr, 72, bitpix)
    struct.pack_into("<8f", hdr, 76, 1.0, spacing[0], spacing[1], spacing[2],
                     0, 0, 0, 0)
    struct.pack_into("<f", hdr, 108, 352.0)   # vox_offset
    struct.pack_into("<f", hdr, 112, 1.0)     # scl_slope
    struct.pack_into("<f", hdr, 116, 0.0)     # scl_inter
    struct.pack_into("<h", hdr, 252, 0)       # qform_code
    struct.pack_into("<h", hdr, 254, 2)       # sform_code: aligned
    struct.pack_into("<12f", hdr, 280, *A.reshape(-1))
    struct.pack_into("<4s", hdr, 344, b"n+1\0")

    payload = bytes(hdr) + b"\0\0\0\0" + np.asfortranarray(
        data.transpose(2, 1, 0)).tobytes(order="F")
    if str(path).endswith(".gz"):
        f = gzip.open(path, "wb", compresslevel=1)
    else:
        f = open(path, "wb")
    with f:
        f.write(payload)


def copy_geometry(target: NiftiImage, source: NiftiImage) -> NiftiImage:
    """Parity: utilities/sitk_stuff.py:19 copy_geometry."""
    target.spacing = source.spacing
    target.origin = source.origin
    target.direction = source.direction
    return target
