"""Fire-time projection of window results (port of
``flink_tpu/windowing/fire_projectors.py``).

A projector reduces each fired window's rows before they leave the
engine: ``project`` on the device, inside the single-device fire, so that
only its rows cross to the host; ``project_host`` in NumPy, exactly as the
reference has it, where rows are merged on the host (the mesh engine, the
spill tier's hybrid fire).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from flink_tpu_torch.stateplane.fold import order_key


class FireProjector:
    """Reduces the rows of one fired window before they leave the engine."""

    #: number of output rows per fired window
    num_out: int = 1

    def cache_key(self) -> tuple:
        raise NotImplementedError

    def project(self, cols: Dict[str, torch.Tensor], valid: torch.Tensor
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor],
                           torch.Tensor]:
        """(result cols [wp], valid [wp]) -> (row indices [n], cols [n],
        valid [n]) on the device. Indices, not keys: the host resolves
        keys."""
        raise NotImplementedError

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

    def cache_key(self) -> tuple:
        return (type(self).__module__, type(self).__qualname__,
                self.order_col, self.k, self.descending)

    def project(self, cols, valid):
        """The reference's ``lax.top_k`` form: an integer column sorted
        descending stays in its own dtype (a float32 cast collapses counts
        above 2**24), invalid rows at ``iinfo.min``; any other column
        becomes float32, negated for ascending, invalid rows at -inf.
        ``lax.top_k`` orders the scores by their bits as a total order
        (NaN above +inf, a negative NaN below -inf, -0.0 below +0.0) and
        ties lowest index first: a stable descending sort of the float's
        order key gives the same rows in the same order (``torch.topk``
        breaks ties otherwise)."""
        score = cols[self.order_col]
        if not score.dtype.is_floating_point and self.descending:
            key = score.masked_fill(~valid, torch.iinfo(score.dtype).min)
        else:
            score = score.to(torch.float32)
            if not self.descending:
                # -score as a flip of the sign bit: lax.neg on the CPU
                # keeps a NaN's payload, the card's neg.f32 does not
                score = (score.view(torch.int32)
                         ^ torch.iinfo(torch.int32).min).view(torch.float32)
            key = order_key(score.masked_fill(~valid, float("-inf")))
        k = min(self.k, int(key.shape[0]))
        idx = torch.sort(key, descending=True, stable=True).indices[:k]
        return idx, {name: c[idx] for name, c in cols.items()}, valid[idx]

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
