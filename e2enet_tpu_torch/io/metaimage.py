"""Pure-numpy MetaImage (.mhd/.mha) reader/writer.

The reference reads MetaImage volumes through SimpleITK (e.g.
dataset_conversion/Task024_Promise2012.py:38-44,
Task035_ISBI_MSLesionSegmentationChallenge.py:19-27); SimpleITK is not a
dependency, so this implements the MetaIO format directly.  Returns
the same conventions as io.nifti: array (z, y, x), ITK-style (x, y, z)
spacing, LPS origin, row-major direction cosines.

The port's own copy of e2enet_tpu/io/metaimage.py, unchanged but for this
docstring: the port imports nothing of the JAX package. As there, write_mhd
formats spacing, origin and direction with ':g', six significant digits,
so an origin of -123.456789 is written and read back as -123.457; zlib
payloads carry no timestamp, so both encodings are deterministic.
"""
import os
import zlib
from typing import Dict

import numpy as np

from .nifti import NiftiImage

_MET_TYPES = {
    "MET_CHAR": np.int8, "MET_UCHAR": np.uint8,
    "MET_SHORT": np.int16, "MET_USHORT": np.uint16,
    "MET_INT": np.int32, "MET_UINT": np.uint32,
    "MET_LONG": np.int64, "MET_ULONG": np.uint64,
    "MET_LONG_LONG": np.int64, "MET_ULONG_LONG": np.uint64,
    "MET_FLOAT": np.float32, "MET_DOUBLE": np.float64,
}
_MET_NAMES = {np.dtype(v): k for k, v in reversed(list(_MET_TYPES.items()))}


def _parse_header(fh) -> Dict[str, str]:
    """Reads 'Key = Value' lines until ElementDataFile (always last)."""
    fields = {}
    while True:
        line = fh.readline()
        if not line:
            raise ValueError("MetaImage header ended before ElementDataFile")
        line = line.decode("latin-1").strip()
        if not line:
            continue
        key, _, value = line.partition("=")
        key = key.strip()
        fields[key] = value.strip()
        if key == "ElementDataFile":
            return fields


def read_mhd(path: str, dtype=None) -> NiftiImage:
    path = str(path)
    with open(path, "rb") as fh:
        fields = _parse_header(fh)
        inline_payload = fh.read() if fields["ElementDataFile"] == "LOCAL" \
            else None

    ndims = int(fields.get("NDims", 3))
    shape_xyz = [int(s) for s in fields["DimSize"].split()]
    assert len(shape_xyz) == ndims
    np_dtype = np.dtype(_MET_TYPES[fields.get("ElementType", "MET_UCHAR")])
    n_chan = int(fields.get("ElementNumberOfChannels", 1))
    msb = fields.get("BinaryDataByteOrderMSB",
                     fields.get("ElementByteOrderMSB", "False")) == "True"
    compressed = fields.get("CompressedData", "False") == "True"

    datafile = fields["ElementDataFile"]
    if inline_payload is not None:
        payload = inline_payload
    else:
        if datafile.upper() == "LIST":
            raise NotImplementedError("MetaImage LIST data files")
        dpath = datafile if os.path.isabs(datafile) else os.path.join(
            os.path.dirname(path), datafile)
        with open(dpath, "rb") as df:
            payload = df.read()
    if compressed:
        payload = zlib.decompress(payload)

    count = int(np.prod(shape_xyz)) * n_chan
    data = np.frombuffer(
        payload, dtype=np_dtype.newbyteorder(">" if msb else "<"),
        count=count)
    # MetaIO stores x fastest; index order of the buffer is (z, y, x[, c])
    shape_zyx = shape_xyz[::-1] + ([n_chan] if n_chan > 1 else [])
    data = data.reshape(shape_zyx)
    data = np.ascontiguousarray(data if dtype is None
                                else data.astype(dtype))

    spacing = tuple(float(s) for s in fields.get(
        "ElementSpacing", fields.get("ElementSize",
                                     " ".join(["1"] * ndims))).split())
    origin = tuple(float(s) for s in fields.get(
        "Offset", fields.get("Origin", fields.get(
            "Position", " ".join(["0"] * ndims)))).split())
    direction = fields.get("TransformMatrix", fields.get("Rotation"))
    if direction is not None:
        direction = tuple(float(s) for s in direction.split())
    else:
        direction = tuple(np.eye(ndims).reshape(-1))
    if ndims == 2:
        spacing = (*spacing, 1.0)
        origin = (*origin, 0.0)
        d = np.eye(3)
        d[:2, :2] = np.array(direction).reshape(2, 2)
        direction = tuple(d.reshape(-1))
    return NiftiImage(array=data, spacing=spacing, origin=origin,
                      direction=direction)


def write_mhd(path: str, image: NiftiImage, compressed: bool = False):
    """Writes .mha (inline) or .mhd + .raw/.zraw (detached)."""
    path = str(path)
    data = np.asarray(image.array)
    ndims = data.ndim
    assert ndims in (2, 3)
    if data.dtype not in _MET_NAMES:
        data = data.astype(np.float32)
    shape_xyz = data.shape[::-1]
    spacing = tuple(image.spacing)[:ndims]
    origin = tuple(image.origin)[:ndims]
    direction = np.array(image.direction, float).reshape(3, 3)
    if ndims == 2:
        direction = direction[:2, :2]

    inline = path.endswith(".mha")
    payload = np.ascontiguousarray(data).tobytes()
    if compressed:
        payload = zlib.compress(payload)
    if inline:
        datafile = "LOCAL"
    else:
        datafile = os.path.basename(path)[:-4] + (
            ".zraw" if compressed else ".raw")

    lines = [
        "ObjectType = Image",
        f"NDims = {ndims}",
        "BinaryData = True",
        "BinaryDataByteOrderMSB = False",
        f"CompressedData = {compressed}",
        "TransformMatrix = " + " ".join(
            f"{v:g}" for v in direction.reshape(-1)),
        "Offset = " + " ".join(f"{v:g}" for v in origin),
        f"ElementSpacing = " + " ".join(f"{v:g}" for v in spacing),
        "DimSize = " + " ".join(str(s) for s in shape_xyz),
        f"ElementType = {_MET_NAMES[np.dtype(data.dtype)]}",
        f"ElementDataFile = {datafile}",
    ]
    header = ("\n".join(lines) + "\n").encode("latin-1")
    with open(path, "wb") as f:
        f.write(header)
        if inline:
            f.write(payload)
    if not inline:
        with open(os.path.join(os.path.dirname(path), datafile), "wb") as f:
            f.write(payload)
