"""The device programs of the mesh CEP engine (port of
``flink_tpu/cep/kernels.py``).

The device NFA is a *settled-state bitmask automaton*: for the
bounded-partial pattern class (every stage positive with finite
``times``, loop stages ``consecutive()``, stage-to-stage contiguity
STRICT — see :func:`compile_device_pattern`) a partial match is fully
described by its per-stage take counts ``(c_0 .. c_s)``, and the number
of distinct count vectors is a small static constant ``Q`` of the
pattern alone. Each key's live partials therefore pack into ONE int32
``alive`` bitmask (bit ``q`` = "a partial in settled state ``q`` is
live"), and one event advances ALL keys' NFAs with pure bit algebra.

State ids are assigned in the host oracle's *candidate order* (depth
descending, then take/proceed path lexicographic with T < P — the order
``KeyNFA.advance`` walks its partials list), so emission order falls out
of ascending bit order: under ``SKIP_PAST_LAST_EVENT`` the winning match
is the lowest set bit, under ``NO_SKIP`` multiple completions on one
event emit in bit order with the virtual-start completion (bit ``Q``)
last.

Event references ride ``ring`` planes: the last ``R = Σ max_i − 1``
processed event sequence numbers per key. int64 timestamps never reach
the device: the host packs, per (key, event), a ``wok`` bitmask whose bit
``d−1`` says "a partial of depth ``d`` is still inside the window at this
event".

The reference's programs are jitted XLA over a ``shard_map``; here each is
a plain torch function over the ``[P, capacity]`` int32 planes of the
logical mesh (``parallel/mesh.py``), updated IN PLACE where the reference
donated them. Torch runs eagerly, so no program cache is kept.

- :func:`cep_advance`: the batched NFA advance. Where the reference
  unrolls the ``Q`` settled states inside a ``lax.scan`` step, this walks
  the due events and vectorizes over the states, with the layout's tables
  as small device tensors (:class:`AdvanceTables`): per step the live
  states that take the event are ``t[k, q]``, and the successor and match
  masks are ``Σ_q t[k, q]·w[q]`` for per-state weights ``w``. The sum
  equals the reference's OR because no two states (nor the virtual start)
  share a successor bit — a property of every layout
  :func:`compile_device_pattern` builds, checked when the tables are
  built. The ring planes need no loop: after ``nev`` events they hold the
  last ``R`` of (old ring ++ the due sequence numbers).
- :func:`cep_prune`: the watermark ``within``-expiry,
  ``alive[p, slots] &= keep``.
- put / exchange-put / gather: the CEP planes are all-int32 ``[P,
  capacity]`` columns, exactly the join engines' plane shape, so the
  staging scatter, the fused keyBy exchange (one launch of the
  exchange-rank kernel) and the cohort gather are the join engines'
  (re-exported below, as the reference re-exports its join families).

Slot 0 of every shard is the scratch slot: padded lanes carry slot 0 (and
``nev = 0`` or ``keep = -1``), so they write back row 0's own value. Real
lanes have unique non-zero slots, so every scatter's result is defined on
the card too.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

from flink_tpu_torch.cep.pattern import (
    AfterMatchSkipStrategy,
    Contiguity,
    Pattern,
)
from flink_tpu_torch.joins.kernels import (  # noqa: F401  (re-exported)
    join_exchange_put as cep_exchange_put,
    join_gather as cep_gather,
    join_put as cep_put,
)

#: bitmask budget: settled states live in one int32 ``alive`` plane and
#: the virtual-start completion needs one more match bit
MAX_STATES = 30
#: total take budget: ring depth R = Σ max_i − 1 rides int32 planes and
#: the ``wok`` window bitmask spends bit d−1 per live depth d
MAX_TOTAL_TAKES = 32


class UnsupportedCepPattern(ValueError):
    """The pattern is outside the device engine's bounded-partial class
    — the caller must fall back (LOUDLY) to the host ``CepOperator``."""


@dataclasses.dataclass(frozen=True)
class DevicePatternLayout:
    """The compiled pattern layout: the static transition tables of the
    settled-state automaton. ``key`` (times × skip × within-gating)
    identifies it — everything else derives from it."""

    #: per-stage (min_times, max_times)
    times: Tuple[Tuple[int, int], ...]
    skip_past: bool
    has_within: bool
    #: settled states' count vectors, in candidate-rank order (= id)
    counts: Tuple[Tuple[int, ...], ...]
    #: per-state current stage / depth (= number of events taken)
    stage: Tuple[int, ...]
    depth: Tuple[int, ...]
    #: per-state successor bits (None = transition impossible)
    take_bit: Tuple[Optional[int], ...]
    proceed_bit: Tuple[Optional[int], ...]
    #: per-state "a take here completes the pattern"
    match_state: Tuple[bool, ...]
    #: the virtual start's successors / completion (single-stage case)
    v_take: Optional[int]
    v_proceed: Optional[int]
    v_match: bool
    #: ring planes: Σ max_i − 1 event-ref registers per key
    ring: int

    @property
    def n_states(self) -> int:
        return len(self.counts)

    @property
    def n_stages(self) -> int:
        return len(self.times)

    @property
    def key(self) -> Tuple:
        return (self.times, self.skip_past, self.has_within)

    def match_counts(self, bit: int) -> Tuple[int, ...]:
        """Final per-stage take counts of a completion on ``bit`` (the
        settled state's counts plus the completing take; bit
        ``n_states`` is the virtual single-event completion)."""
        if bit == self.n_states:
            return (1,)
        c = self.counts[bit]
        return c[:-1] + (c[-1] + 1,)

    def successor_bits(self) -> List[int]:
        """Every successor bit a transition can set: each state's take and
        proceed bits, then the virtual start's."""
        bits = [b for pair in zip(self.take_bit, self.proceed_bit)
                for b in pair if b is not None]
        return bits + [b for b in (self.v_take, self.v_proceed)
                       if b is not None]


def _rank_path(counts: Tuple[int, ...]) -> str:
    """The candidate-order sort key: the partial's take/proceed history
    as a string with T='a' < P='b' — ``KeyNFA.advance`` appends a
    candidate's take-continuation before its proceed child, and deeper
    partials precede shallower ones in the partials list."""
    s = len(counts) - 1
    return "".join("a" * c + ("b" if i < s else "")
                   for i, c in enumerate(counts))


def compile_device_pattern(pattern: Pattern) -> DevicePatternLayout:
    """Compile ``pattern`` to the settled-state layout, or raise
    :class:`UnsupportedCepPattern` naming the first disqualifier.

    The device class: every stage positive (no notNext/notFollowedBy),
    finite ``times`` (no unbounded oneOrMore), loop stages
    ``consecutive()``, stage contiguity STRICT past the first stage, no
    until / greedy / combinations / iterative conditions, and skip
    strategy NO_SKIP or SKIP_PAST_LAST_EVENT. Everything here keeps the
    partial-match set collapsible to one count vector per partial; each
    relaxation reintroduces combinatorial partials (which event subsets
    were skipped) that a fixed-width bitmask cannot carry — those
    patterns run on the host ``CepOperator``, loudly."""
    pattern = pattern.validate()
    stages = pattern.stages
    if not stages:
        raise UnsupportedCepPattern("empty pattern")
    for i, st in enumerate(stages):
        if st.negated:
            raise UnsupportedCepPattern(
                f"stage {st.name!r}: negative stages (notNext/"
                "notFollowedBy) need the host NFA's invalidation walk")
        if st.until_condition is not None:
            raise UnsupportedCepPattern(
                f"stage {st.name!r}: until() stop conditions")
        if st.iterative_condition is not None:
            raise UnsupportedCepPattern(
                f"stage {st.name!r}: iterative (match-context) "
                "conditions are per-partial, not columnar")
        if st.greedy:
            raise UnsupportedCepPattern(f"stage {st.name!r}: greedy()")
        if st.combinations:
            raise UnsupportedCepPattern(
                f"stage {st.name!r}: allowCombinations() makes the "
                "partial set combinatorial in skipped-event subsets")
        if st.max_times is None:
            raise UnsupportedCepPattern(
                f"stage {st.name!r}: unbounded oneOrMore/timesOrMore")
        if st.min_times < 1:
            raise UnsupportedCepPattern(
                f"stage {st.name!r}: optional stages")
        if i > 0 and st.contiguity is not Contiguity.STRICT:
            raise UnsupportedCepPattern(
                f"stage {st.name!r}: relaxed contiguity (followedBy) "
                "keeps ignored-event partials alive indefinitely")
        if st.max_times > 1 and not st.consecutive_internal:
            raise UnsupportedCepPattern(
                f"stage {st.name!r}: non-consecutive loop (times/"
                "oneOrMore without .consecutive())")
    d_total = sum(st.max_times for st in stages)
    if d_total > MAX_TOTAL_TAKES:
        raise UnsupportedCepPattern(
            f"pattern takes up to {d_total} events > {MAX_TOTAL_TAKES}"
            " (int32 ring/window budget)")

    times = tuple((int(st.min_times), int(st.max_times))
                  for st in stages)
    n = len(times)
    # enumerate the settled states: completed stages carry
    # c_i ∈ [min_i, max_i] (the proceed happened at a legal count);
    # the current stage carries c_s ∈ [1, max_s−1] when s == 0 (stage-0
    # partials exist only mid-loop) and c_s ∈ [0, max_s−1] otherwise
    # (count max_s is never STORED: the take at max either proceeds,
    # completes or dies — exactly the oracle's ``count+1 < max`` gate)
    states = []

    def _extend(s: int, prefix: Tuple[int, ...]) -> None:
        if len(prefix) == s:
            lo = 1 if s == 0 else 0
            for c in range(lo, times[s][1]):
                states.append(prefix + (c,))
            return
        i = len(prefix)
        for c in range(times[i][0], times[i][1] + 1):
            _extend(s, prefix + (c,))

    for s in range(n):
        _extend(s, ())
    states.sort(key=lambda c: (-sum(c), _rank_path(c)))
    if len(states) > MAX_STATES:
        raise UnsupportedCepPattern(
            f"{len(states)} settled states > {MAX_STATES} "
            "(int32 alive-bitmask budget)")
    sid = {c: q for q, c in enumerate(states)}

    take_bit, proceed_bit, match_state = [], [], []
    for c in states:
        s = len(c) - 1
        nc = c[-1] + 1
        take_bit.append(sid.get(c[:-1] + (nc,))
                        if nc < times[s][1] else None)
        proceed_bit.append(sid.get(c[:-1] + (nc, 0))
                           if (s + 1 < n and nc >= times[s][0])
                           else None)
        match_state.append(s == n - 1 and nc >= times[s][0])
    v_take = sid.get((1,)) if times[0][1] > 1 else None
    v_proceed = (sid.get((1, 0))
                 if (n > 1 and times[0][0] <= 1) else None)
    v_match = n == 1 and times[0][0] <= 1

    return DevicePatternLayout(
        times=times,
        skip_past=(pattern.skip
                   is AfterMatchSkipStrategy.SKIP_PAST_LAST_EVENT),
        has_within=pattern.within_ms is not None,
        counts=tuple(states),
        stage=tuple(len(c) - 1 for c in states),
        depth=tuple(sum(c) for c in states),
        take_bit=tuple(take_bit),
        proceed_bit=tuple(proceed_bit),
        match_state=tuple(match_state),
        v_take=v_take,
        v_proceed=v_proceed,
        v_match=v_match,
        ring=max(d_total - 1, 0),
    )


@dataclasses.dataclass(frozen=True)
class AdvanceTables:
    """A layout's transition tables as small int32 tensors on one device:
    per state its stage, its window bit (``depth - 1``), its successor
    weight ``(1 << take_bit) + (1 << proceed_bit)`` and its match weight
    ``1 << q``; the virtual start's successor and match weights."""

    layout: DevicePatternLayout
    stage: torch.Tensor       # [Q]
    wbit: torch.Tensor        # [Q]
    succ_w: torch.Tensor      # [Q]
    match_w: torch.Tensor     # [Q]
    v_succ: int
    v_match: int

    @staticmethod
    def build(layout: DevicePatternLayout,
              device: torch.device) -> "AdvanceTables":
        """The tables of ``layout``; raises when two transitions share a
        successor bit (the weighted sum would then not be the OR)."""
        bits = layout.successor_bits()
        if len(set(bits)) != len(bits):
            raise RuntimeError(
                f"cep layout {layout.key}: two transitions set one "
                "successor bit; the advance's weighted sum needs them "
                "distinct")

        def weight(*bs):
            return sum(1 << b for b in bs if b is not None)

        def t(vals):
            return torch.tensor(vals, dtype=torch.int32, device=device)

        Q = layout.n_states
        return AdvanceTables(
            layout=layout,
            stage=t(layout.stage),
            wbit=t([d - 1 for d in layout.depth]),
            succ_w=t([weight(a, b) for a, b in zip(layout.take_bit,
                                                   layout.proceed_bit)]),
            match_w=t([(1 << q) if layout.match_state[q] else 0
                       for q in range(Q)]),
            v_succ=weight(layout.v_take, layout.v_proceed),
            v_match=(1 << Q) if layout.v_match else 0,
        )


def cep_advance(planes: Sequence[torch.Tensor],
                pending: Sequence[torch.Tensor], slots: torch.Tensor,
                idx: torch.Tensor, wok: torch.Tensor, nev: torch.Tensor,
                tables: AdvanceTables, steps: Optional[int] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Advance every due key's NFA through its due events.

    ``planes`` = (alive, ring_0 .. ring_{R-1}) ``[P, C]`` int32, updated in
    place; ``pending`` = (hits, seqs) ``[P, PB]``; ``slots`` / ``nev``
    ``[P, K]``, ``idx`` (pending rows, padding 0) / ``wok`` ``[P, K, E]``.
    ``steps`` (default ``E``) bounds the event walk: steps at or past
    every lane's ``nev`` change nothing. Returns the per-event match
    masks ``[P, K, E]`` and the final alive masks ``[P, K]``."""
    lay = tables.layout
    R = lay.ring
    P, K, E = idx.shape
    steps = E if steps is None else min(int(steps), E)
    s = slots.long()
    flat = idx.reshape(P, K * E).long()
    h_all = pending[0].gather(1, flat).view(P, K, E)
    q_all = pending[1].gather(1, flat).view(P, K, E)
    ok_all = (torch.arange(E, dtype=nev.dtype, device=nev.device)
              < nev.unsqueeze(-1))
    # per (lane, event, state): the event hits the state's stage and (with
    # within) a partial of the state's depth is still inside the window
    g_all = (h_all.unsqueeze(-1) >> tables.stage) & 1
    if lay.has_within:
        g_all = g_all & ((wok.unsqueeze(-1) >> tables.wbit) & 1)
    hv = h_all & 1          # the virtual start takes on stage 0's hits
    qv = torch.arange(lay.n_states, dtype=torch.int32, device=idx.device)
    a = planes[0].gather(1, s)
    m_out = torch.zeros((P, K, E), dtype=torch.int32, device=idx.device)
    for e in range(steps):
        t = ((a.unsqueeze(-1) >> qv) & 1) & g_all[:, :, e]
        na = (t * tables.succ_w).sum(-1, dtype=torch.int32)
        m = (t * tables.match_w).sum(-1, dtype=torch.int32)
        if tables.v_succ:
            na = na + hv[:, :, e] * tables.v_succ
        if tables.v_match:
            m = m + hv[:, :, e] * tables.v_match
        if lay.skip_past:
            # the match consumed its events: every partial dies and the
            # matched event starts nothing
            na = torch.where(m != 0, torch.zeros_like(na), na)
        ok = ok_all[:, :, e]
        a = torch.where(ok, na, a)
        m_out[:, :, e] = torch.where(ok, m, torch.zeros_like(m))
    planes[0].scatter_(1, s, a)
    if R:
        # the ring after nev steps: the last R of (old ring ++ the due
        # sequence numbers), i.e. positions nev .. nev+R-1 of the concat
        ring = torch.stack([pl.gather(1, s) for pl in planes[1:]], dim=-1)
        cat = torch.cat([ring, q_all], dim=-1)               # [P, K, R+E]
        take = nev.long().unsqueeze(-1) + torch.arange(
            R, dtype=torch.long, device=idx.device)
        new = cat.gather(2, take)
        for r, pl in enumerate(planes[1:]):
            pl.scatter_(1, s, new[:, :, r])
    return m_out, a


def cep_prune(alive: torch.Tensor, slots: torch.Tensor,
              keep: torch.Tensor) -> torch.Tensor:
    """``alive[p, slots[p, j]] &= keep[p, j]`` in place; padded lanes
    carry slot 0 and ``keep = -1``."""
    s = slots.long()
    alive.scatter_(1, s, alive.gather(1, s) & keep)
    return alive
