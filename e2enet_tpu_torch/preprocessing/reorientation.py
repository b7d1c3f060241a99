"""RAS reorientation utilities (pure numpy, no nibabel).

Parity: reference e2enet/utilities/image_reorientation.py:30-80
(reorient_to_ras / revert_reorientation / folder variants, nibabel-based)
and preprocessing/sanity_checks.py:238 (reorient_to_RAS). Used by the
VerSe conversions (Task056/083) whose volumes come in arbitrary
orientations.

The transform is the nibabel ``io_orientation`` one: transpose + flip the
voxel grid so the RAS affine becomes positive-dominant-diagonal ("closest
to RAS axis-aligned"). The original affine + axis codes are pickled to a
``*_originalAffine.pkl`` sidecar (same name/format as the reference) so
predictions can be mapped back for submission.

The port's own copy of e2enet_tpu/preprocessing/reorientation.py,
unchanged but for this note: the port imports nothing of the JAX
package. The sidecar holds only a numpy array and a tuple of strings, so
either package reverts what the other reoriented.
"""
import os
import pickle

import numpy as np

from ..io.nifti import NiftiImage, read_nifti, write_nifti

_RAS2LPS = np.diag([-1.0, -1.0, 1.0])
_AXCODES = (("L", "R"), ("P", "A"), ("I", "S"))


def ras_affine(image: NiftiImage) -> np.ndarray:
    """4x4 RAS (nifti) affine from the ITK-style geometry."""
    spacing = np.array(image.spacing, float)
    direction = np.array(image.direction, float).reshape(3, 3)
    A = np.eye(4)
    A[:3, :3] = _RAS2LPS @ (direction * spacing)
    A[:3, 3] = _RAS2LPS @ np.array(image.origin, float)
    return A


def geometry_from_ras_affine(A: np.ndarray) -> dict:
    spacing = tuple(float(np.linalg.norm(A[:3, i])) for i in range(3))
    spacing = tuple(s if s > 0 else 1.0 for s in spacing)
    rot = A[:3, :3] / np.array(spacing)
    return dict(
        spacing=spacing,
        origin=tuple(map(float, _RAS2LPS @ A[:3, 3])),
        direction=tuple(map(float, (_RAS2LPS @ rot).reshape(-1))))


def io_orientation(affine: np.ndarray) -> np.ndarray:
    """(3, 2) array: row j = (output axis, sign) for data axis j — which
    RAS world axis data axis j is most aligned with."""
    R = np.asarray(affine, float)[:3, :3]
    lens = np.linalg.norm(R, axis=0)
    lens[lens == 0] = 1.0
    Rn = R / lens
    ornt = np.zeros((3, 2))
    used = set()
    for j in range(3):
        for ax in np.argsort(-np.abs(Rn[:, j])):
            if int(ax) not in used:
                used.add(int(ax))
                ornt[j] = (ax, 1.0 if Rn[ax, j] >= 0 else -1.0)
                break
    return ornt


def aff2axcodes(affine: np.ndarray):
    ornt = io_orientation(affine)
    return tuple(_AXCODES[int(ax)][1 if sign > 0 else 0]
                 for ax, sign in ornt)


def _apply_ornt_xyz(arr_xyz: np.ndarray, ornt: np.ndarray) -> np.ndarray:
    for j, (_, sign) in enumerate(ornt):
        if sign < 0:
            arr_xyz = np.flip(arr_xyz, axis=j)
    perm = np.argsort(ornt[:, 0], kind="stable")
    return arr_xyz.transpose(tuple(int(p) for p in perm))


def _unapply_ornt_xyz(arr_xyz: np.ndarray, ornt: np.ndarray) -> np.ndarray:
    perm = np.argsort(ornt[:, 0], kind="stable")
    arr_xyz = arr_xyz.transpose(tuple(int(p) for p in np.argsort(perm)))
    for j, (_, sign) in enumerate(ornt):
        if sign < 0:
            arr_xyz = np.flip(arr_xyz, axis=j)
    return arr_xyz


def _ornt_affine(ornt: np.ndarray, shape_xyz) -> np.ndarray:
    """4x4 T with old_index = T @ new_index (homogeneous)."""
    T = np.zeros((4, 4))
    T[3, 3] = 1.0
    for j, (ax, sign) in enumerate(ornt):
        T[j, int(ax)] = sign
        if sign < 0:
            T[j, 3] = shape_xyz[j] - 1
    return T


def reorient_image_to_ras(image: NiftiImage):
    """Returns (reoriented NiftiImage, original 4x4 RAS affine)."""
    A = ras_affine(image)
    ornt = io_orientation(A)
    arr_xyz = np.asarray(image.array).transpose(2, 1, 0)
    new_xyz = _apply_ornt_xyz(arr_xyz, ornt)
    A_new = A @ _ornt_affine(ornt, arr_xyz.shape)
    geo = geometry_from_ras_affine(A_new)
    return NiftiImage(array=np.ascontiguousarray(
        new_xyz.transpose(2, 1, 0)), **geo), A


def revert_image_orientation(image: NiftiImage,
                             original_affine: np.ndarray) -> NiftiImage:
    ornt = io_orientation(original_affine)
    arr_xyz = np.asarray(image.array).transpose(2, 1, 0)
    old_xyz = _unapply_ornt_xyz(arr_xyz, ornt)
    geo = geometry_from_ras_affine(np.asarray(original_affine, float))
    return NiftiImage(array=np.ascontiguousarray(
        old_xyz.transpose(2, 1, 0)), **geo)


def reorient_to_ras(image_file: str) -> None:
    """Overwrites image_file; writes *_originalAffine.pkl sidecar
    (image_reorientation.py:30-47 semantics, same sidecar name)."""
    assert image_file.endswith(".nii.gz")
    sidecar = image_file[:-7] + "_originalAffine.pkl"
    if os.path.isfile(sidecar):
        return
    img = read_nifti(image_file)
    reoriented, A = reorient_image_to_ras(img)
    write_nifti(image_file, reoriented)
    with open(sidecar, "wb") as f:
        pickle.dump((A, aff2axcodes(A)), f)


def revert_reorientation(image_file: str) -> None:
    """image_reorientation.py:50-66."""
    assert image_file.endswith(".nii.gz")
    sidecar = image_file[:-7] + "_originalAffine.pkl"
    assert os.path.isfile(sidecar), \
        f"missing original-affine sidecar {sidecar}"
    with open(sidecar, "rb") as f:
        original_affine, _ = pickle.load(f)
    img = read_nifti(image_file)
    write_nifti(image_file, revert_image_orientation(img, original_affine))
    os.remove(sidecar)


def reorient_all_images_in_folder_to_ras(folder: str,
                                         num_processes: int = 8):
    from ..utils.files import subfiles
    for f in subfiles(folder, suffix=".nii.gz"):
        reorient_to_ras(f)


def revert_orientation_on_all_images_in_folder(folder: str,
                                               num_processes: int = 8):
    from ..utils.files import subfiles
    for f in subfiles(folder, suffix=".nii.gz"):
        revert_reorientation(f)
