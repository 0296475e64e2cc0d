"""The statistics every reader uses, in one place."""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def percentile(values: Sequence[float], q: float) -> Optional[float]:
    """The ``q``-th percentile, linear between closest ranks (NumPy's
    default); None for no values."""
    v = np.asarray(values, dtype=np.float64)
    return float(np.percentile(v, q)) if len(v) else None


def union(intervals) -> np.ndarray:
    """The union of ``(start, end)`` intervals as disjoint ``[n, 2]``
    intervals in order."""
    iv = np.asarray(intervals, dtype=np.float64).reshape(-1, 2)
    iv = iv[iv[:, 1] > iv[:, 0]]
    if len(iv) == 0:
        return iv
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    reach = np.maximum.accumulate(iv[:, 1])
    new = np.r_[True, iv[1:, 0] > reach[:-1]]
    ends = reach[np.r_[np.flatnonzero(new)[1:] - 1, len(iv) - 1]]
    return np.stack([iv[new, 0], ends], axis=1)


def union_s(intervals) -> float:
    """Seconds covered by the union of ``(start, end)`` intervals."""
    u = union(intervals)
    return float((u[:, 1] - u[:, 0]).sum())
