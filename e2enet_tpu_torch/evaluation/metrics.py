"""Segmentation metrics: confusion-matrix scores + surface distances.

Parity: reference e2enet/evaluation/metrics.py (ConfusionMatrix :26-104,
scalar metrics :106-390, surface-distance suite :393-599 and the MedPy-based
Hausdorff95/ASD/ASSD :792-885 — MedPy is absent here so the surface
distances are computed directly with scipy EDT using MedPy's definitions)
and evaluation/surface_dice.py:20 (normalized surface Dice at tolerance).
All metrics share the reference's registry-and-kwargs calling convention so
the Evaluator is drop-in compatible.

The port's own copy of e2enet_tpu/evaluation/metrics.py, with one change
that leaves every score the same: surface_dice_at_tolerance counts the
border voxels within the tolerance of the other border by a dilation of
that border with the ball of offsets within the tolerance, not by a
distance transform of the whole volume, where the ball is small and no
offset lies within rounding of the tolerance (_tolerance_ball); on a
160³ label map the two transforms per label were nearly all of a scoring
pass. The port imports nothing of the JAX package.
"""
from fractions import Fraction

import numpy as np
from scipy.ndimage import binary_dilation, binary_erosion, \
    distance_transform_edt, generate_binary_structure


class ConfusionMatrix:
    def __init__(self, test=None, reference=None):
        self.tp = self.fp = self.tn = self.fn = None
        self.size = None
        self.reference_empty = None
        self.reference_full = None
        self.test_empty = None
        self.test_full = None
        self.set_reference(reference)
        self.set_test(test)

    def set_test(self, test):
        self.test = test
        self.reset()

    def set_reference(self, reference):
        self.reference = reference
        self.reset()

    def reset(self):
        self._computed = False
        self.tp = self.fp = self.tn = self.fn = None
        self.size = None
        self.test_empty = self.test_full = None
        self.reference_empty = self.reference_full = None

    def _ensure(self):
        if not self._computed:
            self.compute()
        return self

    def compute(self):
        if self.test is None or self.reference is None:
            raise ValueError("'test' and 'reference' must both be set")
        assert self.test.shape == self.reference.shape, \
            f"shape mismatch {self.test.shape} vs {self.reference.shape}"
        t = self.test.astype(bool)
        r = self.reference.astype(bool)
        self.tp = int((t & r).sum())
        self.fp = int((t & ~r).sum())
        self.tn = int((~t & ~r).sum())
        self.fn = int((~t & r).sum())
        self.size = int(np.prod(self.reference.shape, dtype=np.int64))
        self.test_empty = not t.any()
        self.test_full = t.all()
        self.reference_empty = not r.any()
        self.reference_full = r.all()
        self._computed = True

    def get_matrix(self):
        self._ensure()
        return self.tp, self.fp, self.tn, self.fn

    def get_size(self):
        return self._ensure().size

    def get_existence(self):
        self._ensure()
        return (self.test_empty, self.test_full, self.reference_empty,
                self.reference_full)


def _cm(test, reference, confusion_matrix):
    if confusion_matrix is None:
        return ConfusionMatrix(test, reference)
    return confusion_matrix


def dice(test=None, reference=None, confusion_matrix=None,
         nan_for_nonexisting=True, **kwargs):
    """2TP / (2TP + FP + FN)"""
    cm = _cm(test, reference, confusion_matrix)
    tp, fp, tn, fn = cm.get_matrix()
    test_empty, test_full, reference_empty, reference_full = \
        cm.get_existence()
    if test_empty and reference_empty:
        return float("NaN") if nan_for_nonexisting else 0.0
    return float(2. * tp / (2 * tp + fp + fn))


def jaccard(test=None, reference=None, confusion_matrix=None,
            nan_for_nonexisting=True, **kwargs):
    cm = _cm(test, reference, confusion_matrix)
    tp, fp, tn, fn = cm.get_matrix()
    test_empty, test_full, reference_empty, reference_full = \
        cm.get_existence()
    if test_empty and reference_empty:
        return float("NaN") if nan_for_nonexisting else 0.0
    return float(tp / (tp + fp + fn))


def precision(test=None, reference=None, confusion_matrix=None,
              nan_for_nonexisting=True, **kwargs):
    cm = _cm(test, reference, confusion_matrix)
    tp, fp, tn, fn = cm.get_matrix()
    test_empty, _, _, _ = cm.get_existence()
    if test_empty:
        return float("NaN") if nan_for_nonexisting else 0.0
    return float(tp / (tp + fp))


def sensitivity(test=None, reference=None, confusion_matrix=None,
                nan_for_nonexisting=True, **kwargs):
    """TP / (TP + FN) — a.k.a. recall."""
    cm = _cm(test, reference, confusion_matrix)
    tp, fp, tn, fn = cm.get_matrix()
    _, _, reference_empty, _ = cm.get_existence()
    if reference_empty:
        return float("NaN") if nan_for_nonexisting else 0.0
    return float(tp / (tp + fn))


def recall(test=None, reference=None, confusion_matrix=None,
           nan_for_nonexisting=True, **kwargs):
    return sensitivity(test, reference, confusion_matrix,
                       nan_for_nonexisting, **kwargs)


def specificity(test=None, reference=None, confusion_matrix=None,
                nan_for_nonexisting=True, **kwargs):
    """TN / (TN + FP) — a.k.a. true negative rate."""
    cm = _cm(test, reference, confusion_matrix)
    tp, fp, tn, fn = cm.get_matrix()
    _, _, _, reference_full = cm.get_existence()
    if reference_full:
        return float("NaN") if nan_for_nonexisting else 0.0
    return float(tn / (tn + fp))


def accuracy(test=None, reference=None, confusion_matrix=None, **kwargs):
    cm = _cm(test, reference, confusion_matrix)
    tp, fp, tn, fn = cm.get_matrix()
    return float((tp + tn) / cm.get_size())


def fscore(test=None, reference=None, confusion_matrix=None,
           nan_for_nonexisting=True, beta=1., **kwargs):
    p = precision(test, reference, confusion_matrix, nan_for_nonexisting)
    r = recall(test, reference, confusion_matrix, nan_for_nonexisting)
    if (beta * beta * p + r) == 0:
        return 0.0
    return float((1 + beta * beta) * p * r / (beta * beta * p + r))


def false_positive_rate(test=None, reference=None, confusion_matrix=None,
                        nan_for_nonexisting=True, **kwargs):
    s = specificity(test, reference, confusion_matrix, nan_for_nonexisting)
    return 1 - s if s == s else s


def false_omission_rate(test=None, reference=None, confusion_matrix=None,
                        nan_for_nonexisting=True, **kwargs):
    cm = _cm(test, reference, confusion_matrix)
    tp, fp, tn, fn = cm.get_matrix()
    if (fn + tn) == 0:
        return float("NaN") if nan_for_nonexisting else 0.0
    return float(fn / (fn + tn))


def false_negative_rate(test=None, reference=None, confusion_matrix=None,
                        nan_for_nonexisting=True, **kwargs):
    s = sensitivity(test, reference, confusion_matrix, nan_for_nonexisting)
    return 1 - s if s == s else s


def true_negative_rate(test=None, reference=None, confusion_matrix=None,
                       nan_for_nonexisting=True, **kwargs):
    return specificity(test, reference, confusion_matrix,
                       nan_for_nonexisting)


def false_discovery_rate(test=None, reference=None, confusion_matrix=None,
                         nan_for_nonexisting=True, **kwargs):
    p = precision(test, reference, confusion_matrix, nan_for_nonexisting)
    return 1 - p if p == p else p


def negative_predictive_value(test=None, reference=None,
                              confusion_matrix=None,
                              nan_for_nonexisting=True, **kwargs):
    f = false_omission_rate(test, reference, confusion_matrix,
                            nan_for_nonexisting)
    return 1 - f if f == f else f


def total_positives_test(test=None, reference=None, confusion_matrix=None,
                         **kwargs):
    cm = _cm(test, reference, confusion_matrix)
    tp, fp, tn, fn = cm.get_matrix()
    return int(tp + fp)


def total_negatives_test(test=None, reference=None, confusion_matrix=None,
                         **kwargs):
    cm = _cm(test, reference, confusion_matrix)
    tp, fp, tn, fn = cm.get_matrix()
    return int(tn + fn)


def total_positives_reference(test=None, reference=None,
                              confusion_matrix=None, **kwargs):
    cm = _cm(test, reference, confusion_matrix)
    tp, fp, tn, fn = cm.get_matrix()
    return int(tp + fn)


def total_negatives_reference(test=None, reference=None,
                              confusion_matrix=None, **kwargs):
    cm = _cm(test, reference, confusion_matrix)
    tp, fp, tn, fn = cm.get_matrix()
    return int(tn + fp)


# ------------------------------------------------------- surface distances
def _surface_distances(result, reference, voxel_spacing=None,
                       connectivity=1):
    """MedPy __surface_distances semantics: distances from the border voxels
    of `result` to the border of `reference` (in mm via voxel_spacing)."""
    result = np.atleast_1d(result.astype(bool))
    reference = np.atleast_1d(reference.astype(bool))
    if not result.any():
        raise RuntimeError("result is empty")
    if not reference.any():
        raise RuntimeError("reference is empty")
    result_border = _border(result, connectivity)
    reference_border = _border(reference, connectivity)
    dt = distance_transform_edt(~reference_border, sampling=voxel_spacing)
    return dt[result_border]


def hausdorff_distance(test=None, reference=None, confusion_matrix=None,
                       nan_for_nonexisting=True, voxel_spacing=None,
                       connectivity=1, **kwargs):
    cm = _cm(test, reference, confusion_matrix)
    test_empty, test_full, reference_empty, reference_full = \
        cm.get_existence()
    if test_empty or test_full or reference_empty or reference_full:
        return float("NaN") if nan_for_nonexisting else 0.0
    test_arr, ref_arr = cm.test, cm.reference
    hd1 = _surface_distances(test_arr, ref_arr, voxel_spacing, connectivity)
    hd2 = _surface_distances(ref_arr, test_arr, voxel_spacing, connectivity)
    return float(max(hd1.max(), hd2.max()))


def hausdorff_distance_95(test=None, reference=None, confusion_matrix=None,
                          nan_for_nonexisting=True, voxel_spacing=None,
                          connectivity=1, **kwargs):
    cm = _cm(test, reference, confusion_matrix)
    test_empty, test_full, reference_empty, reference_full = \
        cm.get_existence()
    if test_empty or test_full or reference_empty or reference_full:
        return float("NaN") if nan_for_nonexisting else 0.0
    test_arr, ref_arr = cm.test, cm.reference
    hd1 = _surface_distances(test_arr, ref_arr, voxel_spacing, connectivity)
    hd2 = _surface_distances(ref_arr, test_arr, voxel_spacing, connectivity)
    return float(np.percentile(np.hstack((hd1, hd2)), 95))


def avg_surface_distance(test=None, reference=None, confusion_matrix=None,
                         nan_for_nonexisting=True, voxel_spacing=None,
                         connectivity=1, **kwargs):
    cm = _cm(test, reference, confusion_matrix)
    test_empty, test_full, reference_empty, reference_full = \
        cm.get_existence()
    if test_empty or test_full or reference_empty or reference_full:
        return float("NaN") if nan_for_nonexisting else 0.0
    sd = _surface_distances(cm.test, cm.reference, voxel_spacing,
                            connectivity)
    return float(sd.mean())


def avg_surface_distance_symmetric(test=None, reference=None,
                                   confusion_matrix=None,
                                   nan_for_nonexisting=True,
                                   voxel_spacing=None, connectivity=1,
                                   **kwargs):
    cm = _cm(test, reference, confusion_matrix)
    test_empty, test_full, reference_empty, reference_full = \
        cm.get_existence()
    if test_empty or test_full or reference_empty or reference_full:
        return float("NaN") if nan_for_nonexisting else 0.0
    sd1 = _surface_distances(cm.test, cm.reference, voxel_spacing,
                             connectivity)
    sd2 = _surface_distances(cm.reference, cm.test, voxel_spacing,
                             connectivity)
    return float(np.hstack((sd1, sd2)).mean())


def _border(mask, connectivity):
    footprint = generate_binary_structure(mask.ndim, connectivity)
    return mask ^ binary_erosion(mask, structure=footprint, iterations=1)


def _tolerance_ball(voxel_spacing, tolerance_mm, ndim):
    """The offsets o whose distance, as distance_transform_edt computes it
    (float64: o_i * s_i, squared, summed over the axes in order, square
    root), is at most tolerance_mm, as a boolean structure. None, for the
    transform, where the ball is wider than 7 voxels on an axis, or where
    an offset's distance lies within rounding of the tolerance without
    being exactly it: there the transform's choice among near-equal
    nearest voxels would decide. Everywhere else a voxel is within the
    tolerance of a border iff the border dilated by the ball holds it."""
    if voxel_spacing is None:
        s = np.ones(ndim)
    else:
        s = np.broadcast_to(np.asarray(voxel_spacing, np.float64), (ndim,))
    if not (s > 0).all():
        return None
    r = [int(tolerance_mm // v) + 1 for v in s]
    if max(r) > 3:
        return None
    o = np.indices([2 * k + 1 for k in r]) - np.reshape(r, (-1,)
                                                         + (1,) * ndim)
    d = o.astype(np.float64)
    for i in range(ndim):
        d[i] *= s[i]
    np.multiply(d, d, d)
    d = np.sqrt(np.add.reduce(d, axis=0))
    near = np.abs(d - tolerance_mm) <= 1e-9 * max(tolerance_mm, 1.0)
    for at in zip(*np.nonzero(near)):
        if not _exactly(o[(slice(None),) + at], s, tolerance_mm):
            return None
    return d <= tolerance_mm


def _exactly(offset, s, tolerance_mm):
    """Whether every float64 step of the offset's distance is exact and
    the distance is the tolerance."""
    acc, exact = 0.0, Fraction(0)
    for o, v in zip(offset, s):
        p = float(o) * float(v)
        q = p * p
        if Fraction(p) != int(o) * Fraction(float(v)) \
                or Fraction(q) != Fraction(p) ** 2:
            return False
        acc, exact = acc + q, exact + Fraction(q)
        if Fraction(acc) != exact:
            return False
    return exact == Fraction(tolerance_mm) ** 2 \
        and float(np.sqrt(acc)) == tolerance_mm


def surface_dice_at_tolerance(test=None, reference=None,
                              confusion_matrix=None,
                              nan_for_nonexisting=True, voxel_spacing=None,
                              tolerance_mm: float = 1.0, connectivity=1,
                              **kwargs):
    """Normalized surface Dice: fraction of both surfaces within
    tolerance_mm of the other (evaluation/surface_dice.py:20)."""
    cm = _cm(test, reference, confusion_matrix)
    test_empty, test_full, reference_empty, reference_full = \
        cm.get_existence()
    if test_empty or test_full or reference_empty or reference_full:
        return float("NaN") if nan_for_nonexisting else 0.0
    test_arr = np.atleast_1d(cm.test.astype(bool))
    ref_arr = np.atleast_1d(cm.reference.astype(bool))
    ball = _tolerance_ball(voxel_spacing, tolerance_mm, test_arr.ndim)
    if ball is None:
        d_t2r = _surface_distances(test_arr, ref_arr, voxel_spacing,
                                   connectivity)
        d_r2t = _surface_distances(ref_arr, test_arr, voxel_spacing,
                                   connectivity)
        num = (d_t2r <= tolerance_mm).sum() + (d_r2t <= tolerance_mm).sum()
        denom = len(d_t2r) + len(d_r2t)
    else:
        t_border = _border(test_arr, connectivity)
        r_border = _border(ref_arr, connectivity)
        num = ((t_border & binary_dilation(r_border, structure=ball)).sum()
               + (r_border & binary_dilation(t_border, structure=ball)).sum())
        denom = t_border.sum() + r_border.sum()
    return float(num / denom) if denom > 0 else float("NaN")


ALL_METRICS = {
    "False Positive Rate": false_positive_rate,
    "Dice": dice,
    "Jaccard": jaccard,
    "Hausdorff Distance": hausdorff_distance,
    "Hausdorff Distance 95": hausdorff_distance_95,
    "Precision": precision,
    "Recall": recall,
    "Avg. Symmetric Surface Distance": avg_surface_distance_symmetric,
    "Avg. Surface Distance": avg_surface_distance,
    "Accuracy": accuracy,
    "False Omission Rate": false_omission_rate,
    "Negative Predictive Value": negative_predictive_value,
    "False Negative Rate": false_negative_rate,
    "True Negative Rate": true_negative_rate,
    "False Discovery Rate": false_discovery_rate,
    "Total Positives Test": total_positives_test,
    "Total Negatives Test": total_negatives_test,
    "Total Positives Reference": total_positives_reference,
    # lowercase 't' matches the reference registry key verbatim
    # (evaluation/metrics.py:883)
    "total Negatives Reference": total_negatives_reference,
    "fscore": fscore,
    "surface_dice_at_tolerance": surface_dice_at_tolerance,
}
