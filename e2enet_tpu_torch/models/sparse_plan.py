"""DSFF row-sparse inference plan: the port's own copy of the reference's
e2enet_tpu/models/sparse_plan.py (with training/dsff.rows_alive).

A ROW-structured DSFF mask (in, out) kills whole input channels of a nest
conv, shared by every output. Its alive rows are one static gather: the
conv then contracts only those rows, chained up-links emit only the
columns their consumer reads, and every nest node emits only the union of
what its consumers read (models/unetpp.py). Dead rows carry w == 0 once the
masks are baked (models/masks.apply_masks), so the plan changes results
only by floating-point summation order.

Masks are keyed by the port's parameter names ('loc0_0.block0.kernel');
plan entries by the module path with '/' ('loc0_0/block0', 'up0_0'), as
the reference's.
"""
from typing import Dict, Optional, Tuple

import numpy as np

Plan = Tuple[Tuple[str, Tuple[int, ...]], ...]


def rows_alive(mask) -> Optional[np.ndarray]:
    """The alive row indices of a row-structured (in, out) mask (every row
    fully alive or fully dead), else None."""
    m = np.asarray(mask)
    if m.ndim != 2:
        return None
    row_any = m.any(axis=1)
    if not np.array_equal(row_any, m.all(axis=1)):
        return None
    return np.nonzero(row_any)[0].astype(np.int64)


def _entry_key(name: str) -> str:
    return "/".join(name.split(".")[:-1])


def build_sparse_plan(masks: Dict[str, np.ndarray]) -> Optional[Plan]:
    """(module path, alive rows) for every masked conv whose mask is
    row-structured with some rows dead and some alive, sorted; None when no
    conv qualifies (unstructured masks run dense)."""
    entries = []
    for name, m in masks.items():
        alive = rows_alive(m)
        if alive is None or len(alive) in (0, np.asarray(m).shape[0]):
            continue
        entries.append((_entry_key(name), tuple(int(i) for i in alive)))
    return tuple(sorted(entries)) if entries else None


def plan_density(plan: Optional[Plan], masks: Dict[str, np.ndarray]
                 ) -> float:
    """Fraction of the planned convs' input rows the plan keeps."""
    if not plan:
        return 1.0
    rows = {_entry_key(n): np.asarray(m).shape[0] for n, m in masks.items()}
    kept = sum(len(alive) for _, alive in plan)
    return kept / max(sum(rows[key] for key, _ in plan), 1)
