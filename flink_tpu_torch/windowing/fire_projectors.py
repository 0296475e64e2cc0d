"""Fire-time projection of window results (port of
``flink_tpu/windowing/fire_projectors.py``).

The mesh engine merges a window's rows on the device, brings them to the
host, and reduces them there with ``project_host`` — NumPy, exactly as the
reference has it, so the kept rows and their order match the reference
bit for bit (``lax.top_k``'s device form and ``torch.topk`` order ties
differently; the fused device form belongs to the single-device slice).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


class FireProjector:
    """Reduces the rows of one fired window before they leave the engine."""

    #: number of output rows per fired window
    num_out: int = 1

    def project_host(self, keys: np.ndarray, cols: Dict[str, np.ndarray]
                     ) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
        raise NotImplementedError


class TopKFireProjector(FireProjector):
    """Keep the k rows with the largest (or smallest) ``order_col``.

    Exact for any consumer that keeps at most k rows ordered by that
    column (rank/Top-N, per-window arg-max). Ties beyond the k-th row are
    truncated.
    """

    def __init__(self, order_col: str, k: int = 16, descending: bool = True):
        self.order_col = order_col
        self.k = int(k)
        self.descending = descending
        self.num_out = self.k

    def project_host(self, keys, cols):
        score = np.asarray(cols[self.order_col], dtype=np.float64)
        k = min(self.k, len(score))
        if self.descending:
            idx = np.argpartition(-score, k - 1)[:k] if k < len(score) \
                else np.arange(len(score))
            idx = idx[np.argsort(-score[idx], kind="stable")]
        else:
            idx = np.argpartition(score, k - 1)[:k] if k < len(score) \
                else np.arange(len(score))
            idx = idx[np.argsort(score[idx], kind="stable")]
        return keys[idx], {name: np.asarray(c)[idx]
                           for name, c in cols.items()}
