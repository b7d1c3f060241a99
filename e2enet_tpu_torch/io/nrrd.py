"""Pure-numpy NRRD (.nrrd/.nhdr) reader/writer.

The reference reads NRRD through SimpleITK (e.g. the VerSe and CREMI-style
conversions); neither SimpleITK nor pynrrd is a dependency.  Conventions match
io.nifti: array (z, y, x), ITK-style (x, y, z) spacing, LPS origin,
row-major direction cosines (NRRD's canonical 'left-posterior-superior'
space IS the ITK frame; RAS spaces are flipped on read).

The port's own copy of e2enet_tpu/io/nrrd.py, unchanged but for this
docstring: the port imports nothing of the JAX package. As there, the gzip
encoding carries the time of writing in its member header (bytes 4-7),
so two compressed writes of one image may differ there; the raw encoding
is deterministic.
"""
import gzip
import os
import zlib
from typing import Dict

import numpy as np

from .nifti import NiftiImage

_NRRD_TYPES = {
    "signed char": np.int8, "int8": np.int8, "int8_t": np.int8,
    "uchar": np.uint8, "unsigned char": np.uint8, "uint8": np.uint8,
    "uint8_t": np.uint8,
    "short": np.int16, "short int": np.int16, "signed short": np.int16,
    "int16": np.int16, "int16_t": np.int16,
    "ushort": np.uint16, "unsigned short": np.uint16, "uint16": np.uint16,
    "uint16_t": np.uint16,
    "int": np.int32, "signed int": np.int32, "int32": np.int32,
    "int32_t": np.int32,
    "uint": np.uint32, "unsigned int": np.uint32, "uint32": np.uint32,
    "uint32_t": np.uint32,
    "longlong": np.int64, "long long": np.int64, "int64": np.int64,
    "int64_t": np.int64,
    "ulonglong": np.uint64, "unsigned long long": np.uint64,
    "uint64": np.uint64, "uint64_t": np.uint64,
    "float": np.float32, "double": np.float64,
}
_NRRD_NAMES = {np.dtype(np.int8): "int8", np.dtype(np.uint8): "uint8",
               np.dtype(np.int16): "int16", np.dtype(np.uint16): "uint16",
               np.dtype(np.int32): "int32", np.dtype(np.uint32): "uint32",
               np.dtype(np.int64): "int64", np.dtype(np.uint64): "uint64",
               np.dtype(np.float32): "float", np.dtype(np.float64): "double"}


def _parse_vector(s):
    s = s.strip()
    if s.lower() == "none":
        return None
    assert s.startswith("(") and s.endswith(")"), s
    return [float(v) for v in s[1:-1].split(",")]


def read_nrrd(path: str, dtype=None) -> NiftiImage:
    path = str(path)
    fields: Dict[str, str] = {}
    with open(path, "rb") as fh:
        magic = fh.readline()
        if not magic.startswith(b"NRRD"):
            raise ValueError(f"{path}: not a NRRD file")
        while True:
            line = fh.readline()
            if not line:
                break
            line = line.decode("latin-1").rstrip("\r\n")
            if line == "":          # blank line ends the header
                break
            if line.startswith("#"):
                continue
            key, sep, value = line.partition(":")
            if not sep:
                continue
            fields[key.strip().lower()] = value.lstrip("= ").strip()
        payload = fh.read()

    dim = int(fields["dimension"])
    sizes = [int(s) for s in fields["sizes"].split()]
    assert len(sizes) == dim
    np_dtype = np.dtype(_NRRD_TYPES[fields["type"].strip()])
    endian = ">" if fields.get("endian", "little") == "big" else "<"
    encoding = fields.get("encoding", "raw").lower()

    datafile = fields.get("data file", fields.get("datafile"))
    if datafile is not None:
        dpath = datafile if os.path.isabs(datafile) else os.path.join(
            os.path.dirname(path), datafile)
        with open(dpath, "rb") as df:
            payload = df.read()

    count = int(np.prod(sizes))
    if encoding in ("gzip", "gz"):
        payload = gzip.decompress(payload)
    elif encoding == "zlib":
        payload = zlib.decompress(payload)
    elif encoding not in ("raw", "ascii", "text", "txt"):
        raise NotImplementedError(f"NRRD encoding {encoding!r}")
    if encoding in ("ascii", "text", "txt"):
        data = np.array(payload.split(), dtype=np.float64)[:count]
        data = data.astype(np_dtype)
    else:
        data = np.frombuffer(payload, dtype=np_dtype.newbyteorder(endian),
                             count=count)
    # NRRD lists sizes fastest-first (x, y, z): buffer index order is zyx
    data = data.reshape(sizes[::-1])
    data = np.ascontiguousarray(data if dtype is None
                                else data.astype(dtype))

    # geometry: 'space directions' columns are the axis vectors (x,y,z per
    # axis); spacing = column norms. Fall back to 'spacings'.
    space = fields.get("space", "").lower()
    flip = np.ones(3)
    if "right" in space:
        flip[0] = -1.0
    if "anterior" in space:
        flip[1] = -1.0
    if "inferior" in space:
        flip[2] = -1.0

    if "space directions" in fields:
        import re
        toks = re.findall(r"\([^)]*\)|none", fields["space directions"],
                          re.IGNORECASE)
        vecs = [v for v in (_parse_vector(t) for t in toks)
                if v is not None]
        M = np.array(vecs, float).T            # columns = axis vectors
        if M.shape != (3, 3):
            M = np.eye(3) * np.array(
                [np.linalg.norm(v) for v in vecs] + [1.0] * (3 - len(vecs)))
        spacing = tuple(float(np.linalg.norm(M[:, i])) for i in range(3))
        spacing = tuple(s if s > 0 else 1.0 for s in spacing)
        direction = (np.diag(flip) @ (M / np.array(spacing))).reshape(-1)
    else:
        sp = [float(s) for s in fields.get(
            "spacings", " ".join(["1"] * dim)).split()][:3]
        spacing = tuple(sp + [1.0] * (3 - len(sp)))
        direction = np.eye(3).reshape(-1)

    origin = fields.get("space origin")
    if origin is not None:
        o = _parse_vector(origin) or [0, 0, 0]
        origin = tuple(float(v) for v in (np.diag(flip) @ np.array(o)))
    else:
        origin = (0.0, 0.0, 0.0)
    return NiftiImage(array=data, spacing=spacing, origin=origin,
                      direction=tuple(float(v) for v in direction))


def write_nrrd(path: str, image: NiftiImage, compressed: bool = True):
    data = np.asarray(image.array)
    assert data.ndim == 3
    if data.dtype not in _NRRD_NAMES:
        data = data.astype(np.float32)
    spacing = np.array(image.spacing, float)
    direction = np.array(image.direction, float).reshape(3, 3)
    M = direction * spacing        # columns = axis vectors (LPS frame)
    origin = np.array(image.origin, float)

    def vec(v):
        return "(" + ",".join(f"{x:.17g}" for x in v) + ")"

    lines = [
        "NRRD0004",
        f"type: {_NRRD_NAMES[np.dtype(data.dtype)]}",
        "dimension: 3",
        "space: left-posterior-superior",
        "sizes: " + " ".join(str(s) for s in data.shape[::-1]),
        "space directions: " + " ".join(vec(M[:, i]) for i in range(3)),
        "kinds: domain domain domain",
        "endian: little",
        f"encoding: {'gzip' if compressed else 'raw'}",
        "space origin: " + vec(origin),
    ]
    payload = np.ascontiguousarray(data).tobytes()
    if compressed:
        payload = gzip.compress(payload)
    with open(path, "wb") as f:
        f.write(("\n".join(lines) + "\n\n").encode("latin-1"))
        f.write(payload)
