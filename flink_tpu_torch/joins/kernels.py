"""The device programs of the two-input join engines (port of
``flink_tpu/joins/kernels.py``).

The reference's four programs are jitted XLA over a ``shard_map``; here
each is a plain torch function over the ``[P, capacity]`` planes of the
logical mesh (``parallel/mesh.py``: one row per key-group shard, on one
device). Torch runs eagerly, so no program cache is kept. Planes are
updated IN PLACE, where the reference donated them.

- :func:`join_put`: scatter staged ``[P, B]`` row blocks (slot + value
  columns) into the planes (restores).
- :func:`join_exchange_put`: the device-mode ingest. Flat staged columns
  (length ``P * C``) are ranked within their destination shard (the
  exchange-rank kernel, ``stateplane/rank.py``, one launch), scattered
  into per-destination buckets, exchanged (the reference's
  ``all_to_all`` is the ``[P_src, P_dst, W] -> [P_dst, P_src, W]``
  transpose, as in ``parallel/shuffle.py``) and written into the planes.
- :func:`join_gather`: plane rows at ``[P, G]`` slot blocks (eviction
  cohorts).
- :func:`banded_probe`: for each probe, the band's candidate slots from
  the sorted-order mirror, masked to in-band AND resident (``slot >= 0``)
  lanes, and the survivors' value columns, as ``[P, B, W]`` blocks in band
  order. Masked lanes read slot 0 and emit zero; the host serves the
  non-resident ones from the page tier.

Slot 0 of every shard is the scratch slot: padded lanes of a staged block
and empty bucket lanes of the exchange carry slot 0 and value 0, so every
write there writes the same zero and its order does not matter. Real rows
never share a slot within one put (the side table allocates fresh slots
after making headroom), so the scatter's result is defined on the card
too. Out-of-range bucket offsets (the rank's sentinel ``P * W``) land in
an extra column that is cut off, where the reference dropped them.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from flink_tpu_torch.stateplane.rank import exchange_rank_flat


def join_put(planes: Sequence[torch.Tensor], slots: torch.Tensor,
             values: Sequence[torch.Tensor]) -> Sequence[torch.Tensor]:
    """``plane[p, slots[p, j]] = values[p][j]`` for ``[P, B]`` blocks;
    padded lanes carry slot 0."""
    idx = slots.long()
    for pl, v in zip(planes, values):
        pl.scatter_(1, idx, v)
    return planes


def join_exchange_put(planes: Sequence[torch.Tensor], dst: torch.Tensor,
                      slots: torch.Tensor, values: Sequence[torch.Tensor],
                      bucket_width: int) -> Sequence[torch.Tensor]:
    """The fused device-mode ingest: ``dst``/``slots``/``values`` are the
    flat staged columns of :func:`~flink_tpu_torch.parallel.shuffle.
    stage_device_exchange` (padded lanes carry the destination ``P``).
    Source shard ``s`` owns lanes ``[s*C, (s+1)*C)``; a lane's rank within
    its destination keeps stream order per destination."""
    P = planes[0].shape[0]
    W = int(bucket_width)
    C = dst.numel() // P
    # [P_src, C] -> int64 bucket offsets in [0, P*W], P*W the sentinel of
    # padded lanes (one rank-kernel launch on the card)
    flat = exchange_rank_flat(dst.view(P, C), P, W)

    def exchange(col: torch.Tensor) -> torch.Tensor:
        # lanes -> buckets [P_src, P_dst * W] (+1 sentinel column, cut
        # off) -> the all_to_all as a transpose -> [P_dst, P_src * W];
        # empty lanes hold 0
        buf = torch.zeros((P, P * W + 1), dtype=col.dtype,
                          device=col.device)
        buf.scatter_(1, flat, col.view(P, C))
        return (buf[:, :P * W].reshape(P, P, W).transpose(0, 1)
                .reshape(P, P * W))

    recv_s = exchange(slots).long()
    for pl, v in zip(planes, values):
        # empty bucket lanes carry slot 0 and value 0: the scratch slot
        pl.scatter_(1, recv_s, exchange(v))
    return planes


def join_gather(planes: Sequence[torch.Tensor], slots: torch.Tensor
                ) -> List[torch.Tensor]:
    """Plane rows at ``[P, G]`` slot blocks, one ``[P, G]`` tensor per
    plane (the caller copies all of them to the host at once)."""
    idx = slots.long()
    return [pl.gather(1, idx) for pl in planes]


def banded_probe(planes: Sequence[torch.Tensor], sorted_slots: torch.Tensor,
                 lo: torch.Tensor, cnt: torch.Tensor, band_width: int
                 ) -> List[torch.Tensor]:
    """The banded probe: ``sorted_slots`` ``[P, S]`` is each shard's slot
    mirror in metadata order (``-1``: spilled, or padding), ``lo``/``cnt``
    ``[P, B]`` each probe's band ``[lo, lo + cnt)`` over it. Returns one
    ``[P, B, W]`` tensor per plane: the value at each in-band resident
    candidate, zero elsewhere."""
    P, S = sorted_slots.shape
    B = lo.shape[1]
    W = int(band_width)
    j = torch.arange(W, dtype=lo.dtype, device=lo.device)
    pos = lo.unsqueeze(-1) + j                                # [P, B, W]
    inband = (j < cnt.unsqueeze(-1)) & (pos < S)
    cslot = sorted_slots.gather(
        1, pos.clamp(0, S - 1).view(P, B * W).long()).view(P, B, W)
    ok = inband & (cslot >= 0)
    sc = cslot.clamp(min=0).view(P, B * W).long()
    outs = []
    for pl in planes:
        g = pl.gather(1, sc).view(P, B, W)
        outs.append(torch.where(
            ok, g, torch.zeros((), dtype=pl.dtype, device=pl.device)))
    return outs
