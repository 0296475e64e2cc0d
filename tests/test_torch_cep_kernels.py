"""The CEP engine's device programs and layout compiler
(``flink_tpu_torch/cep/kernels.py``) against the reference's
(``flink_tpu/cep/kernels.py``) on the CPU: the reference's programs on the
8 virtual devices of ``tests/conftest.py``, the port's on the
``[8, capacity]`` planes of its logical mesh.

- ``compile_device_pattern``: equal to the reference's layout field for
  field over a sweep of 1–3-stage patterns (both skips, with and without
  ``within``), and the same ``UnsupportedCepPattern`` message for every
  disqualifier;
- the successor-bits-distinct property every layout of the sweep has
  (the port's advance sums per-state weights where the reference ORs);
- ``cep_advance`` against ``build_cep_advance`` and ``cep_prune`` against
  ``build_cep_prune`` on random planes (unique non-zero slots plus padded
  zero lanes, random pending rows, window bits and due counts) for
  Q = 1, 2, 4, 29 (R = 7) and 29 (R = 29), with and without ``within``,
  under both skips.

Tolerance: none — every plane (row 0 included), every match mask and every
final alive mask is compared bit for bit.
"""

import itertools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

from flink_tpu.cep import kernels as jk
from flink_tpu.cep.pattern import AfterMatchSkipStrategy as JSkip
from flink_tpu.cep.pattern import Pattern as JPattern
from flink_tpu.parallel.mesh import KEY_AXIS, make_mesh as jmake_mesh
from flink_tpu_torch.cep import kernels
from flink_tpu_torch.cep.pattern import AfterMatchSkipStrategy as Skip
from flink_tpu_torch.cep.pattern import Pattern

P = 8


def build(pkg, times, skip="past", within=None, consecutive=True,
          mods=None):
    """The same pattern in either package (``pkg`` = "port" or "ref"):
    stage i hits ``v % n == i``; ``times[i] = (lo, hi)``; ``mods`` maps a
    stage index to a builder call applied to that stage."""
    Pat, Sk = (Pattern, Skip) if pkg == "port" else (JPattern, JSkip)
    skip = (Sk.SKIP_PAST_LAST_EVENT if skip == "past" else Sk.NO_SKIP)
    n = len(times)
    p = None
    for i, (lo, hi) in enumerate(times):
        name = f"s{i}"
        p = Pat.begin(name, skip=skip) if p is None else p.next(name)
        p = p.where(lambda b, i=i, n=n: np.asarray(b["v"]) % n == i)
        if (lo, hi) != (1, 1):
            p = p.times(lo, hi)
            if consecutive:
                p = p.consecutive()
        if mods and i in mods:
            p = mods[i](p)
    return p.within(within) if within is not None else p


TIMES = [(1, 1), (1, 2), (2, 2), (1, 3), (2, 3), (1, 6)]


def _sweep():
    for n in (1, 2, 3):
        for times in itertools.product(TIMES, repeat=n):
            yield times


@pytest.mark.parametrize("skip,within", [("past", None), ("past", 100),
                                         ("none", None), ("none", 100)])
def test_layouts_equal_reference_over_the_sweep(skip, within):
    compiled = rejected = 0
    for times in _sweep():
        try:
            want = jk.compile_device_pattern(build("ref", times, skip,
                                                   within))
        except jk.UnsupportedCepPattern as e:
            with pytest.raises(kernels.UnsupportedCepPattern) as got:
                kernels.compile_device_pattern(build("port", times, skip,
                                                     within))
            assert str(got.value) == str(e)
            rejected += 1
            continue
        got = kernels.compile_device_pattern(build("port", times, skip,
                                                   within))
        for f in ("times", "skip_past", "has_within", "counts", "stage",
                  "depth", "take_bit", "proceed_bit", "match_state",
                  "v_take", "v_proceed", "v_match", "ring", "key",
                  "n_states", "n_stages"):
            assert getattr(got, f) == getattr(want, f), (times, f)
        for b in range(got.n_states + 1):
            assert got.match_counts(b) == want.match_counts(b)
        compiled += 1
    assert compiled == 258 - rejected and rejected > 0


def test_successor_bits_distinct_over_the_sweep():
    """No two transitions of a layout set the same successor bit: the
    property that makes the advance's weighted sum equal the OR."""
    seen = 0
    for times in _sweep():
        try:
            lay = kernels.compile_device_pattern(build("port", times))
        except kernels.UnsupportedCepPattern:
            continue
        bits = lay.successor_bits()
        assert len(bits) == len(set(bits)), times
        kernels.AdvanceTables.build(lay, torch.device("cpu"))
        seen += 1
    assert seen > 200


def test_colliding_layout_is_refused():
    import dataclasses

    lay = kernels.compile_device_pattern(build("port", [(1, 3)]))
    # states (2,) and (1,): (1,)'s take sets bit 0; a virtual start
    # taking into bit 0 too would collide with it
    assert lay.take_bit == (None, 0)
    bad = dataclasses.replace(lay, v_take=0)
    with pytest.raises(RuntimeError, match="successor bit"):
        kernels.AdvanceTables.build(bad, torch.device("cpu"))


DISQUALIFIERS = [
    ("negated", lambda pkg: (
        (Pattern if pkg == "port" else JPattern).begin("a")
        .where(lambda b: np.asarray(b["v"]) > 0)
        .not_next("n").where(lambda b: np.asarray(b["v"]) < 0)
        .next("b").where(lambda b: np.asarray(b["v"]) > 1))),
    ("until", lambda pkg: (
        (Pattern if pkg == "port" else JPattern).begin("a")
        .where(lambda b: np.asarray(b["v"]) > 0).one_or_more()
        .until(lambda b: np.asarray(b["v"]) > 7))),
    ("iterative", lambda pkg: build(pkg, [(1, 1), (1, 1)], mods={
        1: lambda p: p.where_iterative(lambda ev, ctx: True)})),
    ("greedy", lambda pkg: build(pkg, [(1, 3), (1, 1)], mods={
        0: lambda p: p.greedy()})),
    ("combinations", lambda pkg: build(pkg, [(1, 3), (1, 1)], mods={
        0: lambda p: p.allow_combinations()})),
    ("unbounded", lambda pkg: build(pkg, [(1, 1), (1, 1)], mods={
        0: lambda p: p.times_or_more(2).consecutive()})),
    ("optional", lambda pkg: build(pkg, [(1, 1), (1, 1), (1, 1)], mods={
        1: lambda p: p.optional()})),
    ("relaxed", lambda pkg: (
        (Pattern if pkg == "port" else JPattern).begin("a")
        .where(lambda b: np.asarray(b["v"]) > 0)
        .followed_by("b").where(lambda b: np.asarray(b["v"]) > 1))),
    ("non-consecutive", lambda pkg: build(pkg, [(2, 3), (1, 1)],
                                          consecutive=False)),
    ("too many takes", lambda pkg: build(pkg, [(1, 20), (1, 13)])),
    ("too many states", lambda pkg: build(pkg, [(1, 4), (1, 4), (1, 4)])),
]


@pytest.mark.parametrize("name,make", DISQUALIFIERS,
                         ids=[d[0] for d in DISQUALIFIERS])
def test_disqualifiers_raise_like_reference(name, make):
    with pytest.raises(jk.UnsupportedCepPattern) as want:
        jk.compile_device_pattern(make("ref"))
    with pytest.raises(kernels.UnsupportedCepPattern) as got:
        kernels.compile_device_pattern(make("port"))
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------- programs

LAYOUTS = {
    "Q1": [(1, 2)],
    "Q2": [(1, 1), (1, 1), (1, 1)],
    "Q4": [(1, 5)],
    "Q29_R7": [(1, 3), (1, 3), (1, 2)],
    "Q29_R29": [(1, 30)],
}


def _shard(mesh, a):
    return jax.device_put(np.asarray(a),
                          NamedSharding(mesh, PartitionSpec(KEY_AXIS)))


def _advance_case(rng, lay, C=512, PB=1024, K=64, E=16):
    Q, R = lay.n_states, lay.ring
    planes = [rng.integers(0, 1 << Q, (P, C)).astype(np.int32)]
    planes += [rng.integers(-(1 << 31), 1 << 31, (P, C)).astype(np.int32)
               for _ in range(R)]
    pending = [rng.integers(0, 1 << lay.n_stages, (P, PB)).astype(np.int32),
               rng.integers(1, 1 << 31, (P, PB)).astype(np.int32)]
    slots = np.zeros((P, K), dtype=np.int32)
    nev = np.zeros((P, K), dtype=np.int32)
    idx = np.zeros((P, K, E), dtype=np.int32)
    for p in range(P):
        L = int(rng.integers(0, K + 1)) if p else 0  # shard 0: no lanes
        slots[p, :L] = rng.permutation(np.arange(1, C))[:L]
        nev[p, :L] = rng.integers(0, E + 1, L)
        nev[p, :min(L, 2)] = E                       # full-depth lanes
        for l in range(L):
            idx[p, l, :nev[p, l]] = rng.integers(1, PB, nev[p, l])
    wok = rng.integers(0, 1 << max(R, 1), (P, K, E)).astype(np.int32)
    return planes, pending, slots, idx, wok, nev


@pytest.mark.parametrize("within", [None, 100])
@pytest.mark.parametrize("skip", ["past", "none"])
@pytest.mark.parametrize("name", list(LAYOUTS))
def test_advance_equals_reference_bitwise(name, skip, within):
    times = LAYOUTS[name]
    lay = kernels.compile_device_pattern(build("port", times, skip, within))
    jlay = jk.compile_device_pattern(build("ref", times, skip, within))
    assert lay.key == jlay.key
    assert (lay.n_states, lay.ring) == {
        "Q1": (1, 1), "Q2": (2, 2), "Q4": (4, 4), "Q29_R7": (29, 7),
        "Q29_R29": (29, 29)}[name]
    mesh = jmake_mesh(P)
    rng = np.random.default_rng(sum(map(ord, name + skip)) + (within or 0))
    planes, pending, slots, idx, wok, nev = _advance_case(rng, lay)
    jstate, jm, ja = jk.build_cep_advance(mesh, jlay)(
        tuple(_shard(mesh, a) for a in planes),
        tuple(_shard(mesh, a) for a in pending),
        _shard(mesh, slots), _shard(mesh, idx), _shard(mesh, wok),
        _shard(mesh, nev))
    tables = kernels.AdvanceTables.build(lay, torch.device("cpu"))
    for steps in (None, int(nev.max())):
        tp = [torch.from_numpy(a.copy()) for a in planes]
        m, a = kernels.cep_advance(
            tp, [torch.from_numpy(x) for x in pending],
            torch.from_numpy(slots), torch.from_numpy(idx),
            torch.from_numpy(wok), torch.from_numpy(nev), tables,
            steps=steps)
        np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
        np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
        for g, w in zip(tp, jstate):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert np.asarray(jm).any(), "vacuous: no lane matched"


@pytest.mark.parametrize("seed,C,G", [(0, 256, 64), (1, 4096, 1024)])
def test_prune_equals_reference_bitwise(seed, C, G):
    rng = np.random.default_rng(seed)
    mesh = jmake_mesh(P)
    alive = rng.integers(0, 1 << 30, (P, C)).astype(np.int32)
    slots = np.zeros((P, G), dtype=np.int32)
    keep = np.full((P, G), -1, dtype=np.int32)
    for p in range(1, P):
        L = int(rng.integers(0, G + 1))
        slots[p, :L] = rng.permutation(np.arange(1, C))[:L]
        keep[p, :L] = rng.integers(-(1 << 31), 1 << 31, L)
    want = jk.build_cep_prune(mesh)(_shard(mesh, alive),
                                    _shard(mesh, slots), _shard(mesh, keep))
    got = kernels.cep_prune(torch.from_numpy(alive.copy()),
                            torch.from_numpy(slots), torch.from_numpy(keep))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_put_families_are_the_join_engines():
    from flink_tpu_torch.joins import kernels as joins

    assert kernels.cep_put is joins.join_put
    assert kernels.cep_exchange_put is joins.join_exchange_put
    assert kernels.cep_gather is joins.join_gather
