"""2D image / TIFF-stack I/O via PIL, imported inside each function.

Mirrors what the reference gets from skimage.io + tifffile in
utilities/file_conversions.py:1-5 and the EM/Fluo/RoadSegm conversions
(Task058/059/075/076/089/120).

The port's own copy of e2enet_tpu/io/images2d.py, unchanged but for this
docstring and an unused import left out: the port imports nothing of the JAX
package. PIL is optional: the module imports without it, and only these
functions need it.
"""
import numpy as np


def read_2d_image(path: str) -> np.ndarray:
    """Returns (H, W) grayscale or (H, W, C) color uint arrays, like
    skimage.io.imread (utilities/file_conversions.py:33)."""
    from PIL import Image
    with Image.open(path) as im:
        if im.mode == "P":
            im = im.convert("RGB")
        arr = np.asarray(im)
    return arr


def write_2d_image(path: str, arr: np.ndarray):
    """Like skimage.io.imsave (file_conversions.py:106)."""
    from PIL import Image
    Image.fromarray(np.asarray(arr)).save(path)


def read_tiff_stack(path: str) -> np.ndarray:
    """Multipage/3D tiff -> (Z, H, W[, C]), like tifffile.imread
    (file_conversions.py:85)."""
    from PIL import Image, ImageSequence
    with Image.open(path) as im:
        frames = [np.asarray(f) for f in ImageSequence.Iterator(im)]
    if len(frames) == 1:
        return frames[0]
    return np.stack(frames)


def write_tiff_stack(path: str, arr: np.ndarray):
    """(Z, H, W) or (H, W) -> (multipage) tiff, like tifffile.imsave
    (file_conversions.py:115)."""
    from PIL import Image
    arr = np.asarray(arr)
    if arr.ndim == 2:
        Image.fromarray(arr).save(path)
        return
    frames = [Image.fromarray(a) for a in arr]
    frames[0].save(path, save_all=True, append_images=frames[1:])
