"""Qualitative overlay PNGs: center slice of each case tinted by its
segmentation.

Parity: reference e2enet/utilities/overlay_plots.py (:46-191):
generate_overlay picks the largest-foreground slice, window-levels the first
modality and alpha-blends per-class colors; the folder variant writes one
PNG per case.

The port's own copy of e2enet_tpu/utils/overlay_plots.py, unchanged but
for this docstring: the port imports nothing of the JAX package. Only the
PNG writers import matplotlib (its 'agg' backend).
"""
import os

import numpy as np

from ..io.nifti import read_nifti
from ..utils.files import join, maybe_mkdir_p, subfiles

# distinguishable class colors (RGB)
COLORS = [
    (255, 0, 0), (0, 255, 0), (0, 0, 255), (255, 255, 0), (255, 0, 255),
    (0, 255, 255), (255, 128, 0), (128, 0, 255), (0, 128, 255),
    (128, 255, 0), (255, 0, 128), (0, 255, 128),
]


def select_slice(seg: np.ndarray) -> int:
    """Axis-0 slice with the most foreground voxels."""
    fg_per_slice = (seg > 0).reshape(seg.shape[0], -1).sum(1)
    if fg_per_slice.max() == 0:
        return seg.shape[0] // 2
    return int(np.argmax(fg_per_slice))


def generate_overlay(image: np.ndarray, seg: np.ndarray,
                     overlay_intensity: float = 0.6) -> np.ndarray:
    """image/seg: 2D arrays -> (H, W, 3) uint8 blended RGB."""
    image = image.astype(float)
    lo, hi = np.percentile(image, 0.5), np.percentile(image, 99.5)
    image = np.clip((image - lo) / max(hi - lo, 1e-8), 0, 1) * 255
    rgb = np.stack([image] * 3, -1)
    for i, c in enumerate(sorted(int(v) for v in np.unique(seg) if v > 0)):
        color = np.array(COLORS[i % len(COLORS)], float)
        mask = seg == c
        rgb[mask] = (1 - overlay_intensity) * rgb[mask] \
            + overlay_intensity * color
    return rgb.astype(np.uint8)


def plot_overlay(image_file: str, seg_file: str, output_file: str,
                 overlay_intensity: float = 0.6):
    import matplotlib
    matplotlib.use("agg")
    import matplotlib.pyplot as plt
    img = read_nifti(image_file).array
    seg = read_nifti(seg_file).array
    assert img.shape == seg.shape, "image and seg must have the same shape"
    s = select_slice(seg)
    rgb = generate_overlay(img[s], seg[s], overlay_intensity)
    plt.imsave(output_file, rgb)


def plot_overlay_folder(images_folder: str, segs_folder: str,
                        output_folder: str, overlay_intensity: float = 0.6,
                        modality: int = 0):
    maybe_mkdir_p(output_folder)
    segs = subfiles(segs_folder, join=False, suffix=".nii.gz")
    for s in segs:
        img = join(images_folder, s[:-7] + "_%04d.nii.gz" % modality)
        if not os.path.isfile(img):
            img = join(images_folder, s)
        if not os.path.isfile(img):
            print("no image for", s)
            continue
        plot_overlay(img, join(segs_folder, s),
                     join(output_folder, s[:-7] + ".png"),
                     overlay_intensity)
