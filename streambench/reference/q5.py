"""Plain reference of NEXmark Q5 over the events a run handed out.

NumPy only (the control adds torch on the CPU for bfloat16); it imports
nothing of the program. Counts per (slide pane, auction), each window the sum
of its panes, and per window the maximum count and every auction that has
it. A window that holds no event fires nothing.

The program keeps the top ``k`` rows of a window before the arg-max, so where
more than ``k`` auctions tie for the maximum, its rows are ``k`` of them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np

#: every number compared, with its limit. Counts are exact integers.
LIMITS = {"wrong_windows": 0}

#: a (pane, auction) or (window, auction) key: the pane << KEY_BITS | auction
KEY_BITS = 24
#: events a block of the pane count, and the most bins a dense block takes
BLOCK = 1 << 22
DENSE_BINS = 1 << 26


@dataclass
class Expected:
    windows: Dict[int, Tuple[int, np.ndarray]]   # end -> (count, auctions)
    cells: int          # (pane, auction) accumulators with a count
    panes_per_window: int
    top_k: int


def _block_counts(pane: np.ndarray, auction: np.ndarray):
    """Sorted (pane, auction) keys of a block and their counts."""
    p0, a0 = int(pane.min()), int(auction.min())
    width = int(auction.max()) - a0 + 1
    if (int(pane.max()) - p0 + 1) * width > DENSE_BINS:
        return np.unique((pane << KEY_BITS) | auction, return_counts=True)
    b = np.bincount((pane - p0) * width + (auction - a0))
    nz = np.flatnonzero(b)
    return ((nz // width + p0) << KEY_BITS) | (nz % width + a0), b[nz]


def _pane_counts(log, slide: int):
    """Every (slide pane, auction) with a count: sorted keys and counts."""
    keys, counts = [], []
    for _, cols, ts in log.chunks():
        auction = np.asarray(cols["auction"], dtype=np.int64)
        if len(auction) and (auction.min() < 0
                             or auction.max() >= 1 << KEY_BITS):
            raise ValueError(f"auction ids outside [0, 2**{KEY_BITS})")
        for s in range(0, len(auction), BLOCK):
            k, c = _block_counts(ts[s:s + BLOCK] // slide,
                                 auction[s:s + BLOCK])
            keys.append(k)
            counts.append(c)
    if not keys:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    return _summed(np.concatenate(keys), np.concatenate(counts))


def _summed(keys: np.ndarray, counts: np.ndarray):
    """The counts of equal keys summed, by key in order."""
    order = np.argsort(keys, kind="stable")
    k = keys[order]
    starts = np.flatnonzero(np.r_[True, k[1:] != k[:-1]])
    return k[starts], np.add.reduceat(counts[order], starts)


def expected(log, cfg, control: bool = False) -> Expected:
    """The reference's results. ``control``: each window's count summed from
    its panes in bfloat16, the precision below the configuration's."""
    p = cfg["job_params"]
    slide, size = p["slide_ms"], p["size_ms"]
    if size % slide:
        raise ValueError("the window size is not a whole number of slides")
    per = size // slide
    keys, counts = _pane_counts(log, slide)
    # the window whose last pane is j holds panes j - per + 1 .. j
    shifted = [keys + (d << KEY_BITS) for d in range(per)]
    wkeys, wc = _summed(np.concatenate(shifted),
                        np.concatenate([counts] * per))
    if control:
        import torch

        acc = torch.zeros(len(wkeys), dtype=torch.bfloat16)
        for d in reversed(range(per)):      # the window's first pane first
            part = np.zeros(len(wkeys), dtype=np.float32)
            part[np.searchsorted(wkeys, shifted[d])] = counts
            acc = acc + torch.from_numpy(part).to(torch.bfloat16)
        wc = acc.to(torch.float32).numpy().astype(np.int64)
    return Expected(windows=_windows(wkeys, wc, slide), cells=len(keys),
                    panes_per_window=per, top_k=int(p["top_k"]))


def _windows(wkeys: np.ndarray, wc: np.ndarray,
             slide: int) -> Dict[int, Tuple[int, np.ndarray]]:
    if len(wkeys) == 0:
        return {}
    last = wkeys >> KEY_BITS
    auctions = wkeys & ((1 << KEY_BITS) - 1)
    starts = np.flatnonzero(np.r_[True, last[1:] != last[:-1]])
    stops = np.r_[starts[1:], len(last)]
    best = np.maximum.reduceat(wc, starts)
    out = {}
    for s, t, b in zip(starts.tolist(), stops.tolist(), best.tolist()):
        if b > 0:
            out[(int(last[s]) + 1) * slide] = (
                int(b), auctions[s:t][wc[s:t] == b])
    return out


def as_results(exp: Expected) -> Dict[str, np.ndarray]:
    """``exp`` as the rows the job would emit (the first ``k`` of a tie)."""
    ends, auctions, counts = [], [], []
    for end, (best, winners) in exp.windows.items():
        w = winners[:exp.top_k]
        ends.append(np.full(len(w), end))
        auctions.append(w)
        counts.append(np.full(len(w), best))
    cat = (lambda xs: np.concatenate(xs) if xs
           else np.zeros(0, dtype=np.int64))
    return {"window_end": cat(ends), "auction": cat(auctions),
            "count": cat(counts)}


def _by_window(rows):
    ends = np.asarray(rows["window_end"], dtype=np.int64)
    order = np.argsort(ends, kind="stable")
    e = ends[order]
    if len(e) == 0:
        return {}
    starts = np.flatnonzero(np.r_[True, e[1:] != e[:-1]])
    stops = np.r_[starts[1:], len(e)]
    a = np.asarray(rows["auction"])[order]
    c = np.asarray(rows["count"])[order]
    return {int(e[s]): (a[s:t], c[s:t]) for s, t in zip(starts, stops)}


def compare(rows, exp: Expected, cfg) -> dict:
    """Each window's rows against the reference: every window that holds
    an event fires once, with the maximum count and its auctions; no other
    window fires."""
    got = _by_window(rows)
    wrong = 0
    for end, (best, winners) in exp.windows.items():
        mine = got.pop(end, None)
        if mine is None:
            wrong += 1
            continue
        a, c = mine
        ok = len(np.unique(a)) == len(a) and bool((c == best).all())
        if len(winners) <= exp.top_k:
            ok = ok and np.array_equal(np.sort(a), winners)
        else:
            ok = ok and len(a) == exp.top_k and bool(np.isin(a, winners).all())
        wrong += not ok
    wrong += len(got)
    return {"checks": [("wrong_windows", wrong, LIMITS["wrong_windows"])],
            "attempted": len(exp.windows), "failed": wrong}


def last_events(rows, exp: Expected, log, cfg):
    """Per window result: its first arrival, and the global index of the
    last event that counts in it (the last one before the window's end)."""
    ends = np.asarray(rows["window_end"], dtype=np.int64)
    uniq, first = np.unique(ends, return_index=True)
    rate = cfg["generator_params"]["events_per_s_of_event_time"]
    g_last = np.minimum(-(-uniq * rate // 1000) - 1, log.count - 1)
    return np.asarray(rows["_arrival"])[first], g_last


def device_bytes(exp: Expected, log, cfg) -> int:
    """The least bytes the window's device work moves: each event's slot
    read once (int32), each (pane, auction) count written once and read by
    each of the windows that span its pane (int32), and each window's top k
    written (slot and count)."""
    per = exp.panes_per_window
    return (4 * log.count + 4 * exp.cells + 4 * per * exp.cells
            + 8 * exp.top_k * len(exp.windows))
