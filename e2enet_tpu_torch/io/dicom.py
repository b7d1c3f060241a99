"""Minimal pure-python DICOM reader for uncompressed CT/MR slices.

The reference converts DICOM series with dicom2nifti
(dataset_conversion/Task037_038_Chaos_Challenge.py:208), which is not a
dependency, so this reads the common case directly: Part-10 files, explicit or
implicit VR little endian, native (uncompressed) pixel data.  Enough for
the CHAOS challenge T1DUAL/T2SPIR MR series and similar CT series.

The port's own copy of e2enet_tpu/io/dicom.py, unchanged but for this
docstring: the port imports nothing of the JAX package.
"""
import os
import struct
from typing import Dict, Optional, Tuple

import numpy as np

from .nifti import NiftiImage

# tags we care about: (group, element)
_TAG_TRANSFER_SYNTAX = (0x0002, 0x0010)
_TAG_ROWS = (0x0028, 0x0010)
_TAG_COLS = (0x0028, 0x0011)
_TAG_BITS_ALLOC = (0x0028, 0x0100)
_TAG_PIXEL_REPR = (0x0028, 0x0103)
_TAG_SPACING = (0x0028, 0x0030)
_TAG_SLOPE = (0x0028, 0x1053)
_TAG_INTERCEPT = (0x0028, 0x1052)
_TAG_POSITION = (0x0020, 0x0032)
_TAG_ORIENTATION = (0x0020, 0x0037)
_TAG_INSTANCE = (0x0020, 0x0013)
_TAG_SLICE_THICK = (0x0018, 0x0050)
_TAG_PIXEL_DATA = (0x7FE0, 0x0010)

_EXPLICIT_LONG_VRS = {b"OB", b"OW", b"OF", b"SQ", b"UT", b"UN", b"OD",
                     b"OL", b"UC", b"UR"}

_SUPPORTED_TS = {
    "1.2.840.10008.1.2",        # implicit VR little endian
    "1.2.840.10008.1.2.1",      # explicit VR little endian
}


def _read_elements(buf: bytes, start: int, explicit: bool,
                   stop_after_pixeldata: bool = True) -> Dict[Tuple, bytes]:
    """Linear scan of data elements; skips sequences by their byte length
    (undefined-length sequences are skipped item-wise)."""
    out = {}
    i = start
    n = len(buf)
    while i + 8 <= n:
        group, elem = struct.unpack_from("<HH", buf, i)
        tag = (group, elem)
        if explicit and group != 0xFFFE:
            vr = buf[i + 4:i + 6]
            if vr in _EXPLICIT_LONG_VRS:
                length = struct.unpack_from("<I", buf, i + 8)[0]
                hdr = 12
            else:
                length = struct.unpack_from("<H", buf, i + 6)[0]
                hdr = 8
        else:
            vr = b""
            length = struct.unpack_from("<I", buf, i + 4)[0]
            hdr = 8
        if length == 0xFFFFFFFF:
            # undefined length (sequence): scan for sequence delimiter
            j = i + hdr
            depth = 1
            while j + 8 <= n and depth > 0:
                g2, e2, l2 = struct.unpack_from("<HHI", buf, j)
                if (g2, e2) == (0xFFFE, 0xE0DD):
                    depth -= 1
                    j += 8
                elif (g2, e2) == (0xFFFE, 0xE000) and l2 == 0xFFFFFFFF:
                    j += 8
                elif (g2, e2) == (0xFFFE, 0xE00D):
                    j += 8
                else:
                    j += 8 + (l2 if l2 != 0xFFFFFFFF else 0)
            i = j
            continue
        value = buf[i + hdr:i + hdr + length]
        out[tag] = value
        i += hdr + length
        if stop_after_pixeldata and tag == _TAG_PIXEL_DATA:
            break
    return out


def _ascii(v: Optional[bytes]) -> str:
    return (v or b"").decode("latin-1").strip("\x00 ").strip()


def _floats(v: Optional[bytes]):
    s = _ascii(v)
    return [float(x) for x in s.split("\\")] if s else []


def read_dicom_slice(path: str):
    """Returns (pixel array (rows, cols) float32 with rescale applied,
    meta dict)."""
    with open(path, "rb") as f:
        buf = f.read()
    if buf[128:132] == b"DICM":
        # file meta group is always explicit VR
        meta = _read_elements(buf, 132, True, stop_after_pixeldata=False)
        ts = _ascii(meta.get(_TAG_TRANSFER_SYNTAX))
        if ts and ts not in _SUPPORTED_TS:
            raise NotImplementedError(
                f"{path}: transfer syntax {ts} (compressed?) unsupported")
        # find start of the main dataset: first non-group-2 element
        i = 132
        while i + 8 <= len(buf):
            group = struct.unpack_from("<H", buf, i)[0]
            if group != 0x0002:
                break
            vr = buf[i + 4:i + 6]
            if vr in _EXPLICIT_LONG_VRS:
                length = struct.unpack_from("<I", buf, i + 8)[0]
                i += 12 + length
            else:
                length = struct.unpack_from("<H", buf, i + 6)[0]
                i += 8 + length
        explicit = ts != "1.2.840.10008.1.2"
        elems = _read_elements(buf, i, explicit)
    else:
        # raw dataset, guess implicit VR
        elems = _read_elements(buf, 0, False)

    rows = struct.unpack("<H", elems[_TAG_ROWS][:2])[0]
    cols = struct.unpack("<H", elems[_TAG_COLS][:2])[0]
    bits = struct.unpack("<H", elems[_TAG_BITS_ALLOC][:2])[0]
    signed = elems.get(_TAG_PIXEL_REPR) and \
        struct.unpack("<H", elems[_TAG_PIXEL_REPR][:2])[0] == 1
    dt = {8: np.uint8, 16: np.int16 if signed else np.uint16,
          32: np.int32 if signed else np.uint32}[bits]
    pix = np.frombuffer(elems[_TAG_PIXEL_DATA], dtype=np.dtype(dt),
                        count=rows * cols).reshape(rows, cols)
    slope = _floats(elems.get(_TAG_SLOPE)) or [1.0]
    inter = _floats(elems.get(_TAG_INTERCEPT)) or [0.0]
    arr = pix.astype(np.float32) * slope[0] + inter[0]
    meta = {
        "position": _floats(elems.get(_TAG_POSITION)) or [0, 0, 0],
        "orientation": _floats(elems.get(_TAG_ORIENTATION))
        or [1, 0, 0, 0, 1, 0],
        "spacing": _floats(elems.get(_TAG_SPACING)) or [1.0, 1.0],
        "instance": int(_ascii(elems.get(_TAG_INSTANCE)) or 0),
        "slice_thickness": (_floats(elems.get(_TAG_SLICE_THICK))
                            or [1.0])[0],
    }
    return arr, meta


def read_dicom_series(folder: str, suffixes=(".dcm", ".ima", "")) \
        -> NiftiImage:
    """Reads every DICOM slice in `folder`, sorts along the slice normal,
    returns a NiftiImage with ITK conventions (array (z, y, x), spacing
    (x, y, z), LPS geometry — DICOM patient coordinates ARE LPS)."""
    files = sorted(
        os.path.join(folder, f) for f in os.listdir(folder)
        if os.path.isfile(os.path.join(folder, f))
        and (not suffixes or any(f.lower().endswith(s) for s in suffixes
                                 if s) or "." not in f))
    slices = [read_dicom_slice(f) for f in files]
    if not slices:
        raise ValueError(f"no DICOM slices in {folder}")
    ori = np.array(slices[0][1]["orientation"], float)
    row, col = ori[:3], ori[3:]
    normal = np.cross(row, col)
    slices.sort(key=lambda s: (np.dot(normal, s[1]["position"]),
                               s[1]["instance"]))
    vol = np.stack([s[0] for s in slices])
    positions = np.array([s[1]["position"] for s in slices])
    if len(slices) > 1:
        zsp = float(np.median(np.linalg.norm(np.diff(positions, axis=0),
                                             axis=1)))
        if zsp <= 0:
            zsp = slices[0][1]["slice_thickness"]
    else:
        zsp = slices[0][1]["slice_thickness"]
    rsp, csp = slices[0][1]["spacing"]  # (row spacing, col spacing)
    direction = np.stack([row, col, normal], axis=1)
    return NiftiImage(
        array=vol,
        spacing=(float(csp), float(rsp), zsp),
        origin=tuple(map(float, positions[0])),
        direction=tuple(map(float, direction.reshape(-1))))
