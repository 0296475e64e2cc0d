"""The port's lock sentinel (``flink_tpu_torch/observe/lock_sentinel.py``)
against the reference's (``flink_tpu/observe/lock_sentinel.py``): the
cases of ``tests/test_lock_sentinel.py`` run on both modules — the
acquisition-order graph (a cycle raised AND recorded, clean orders pass),
the self-edge of two instances of one name, reentrant re-acquisition
recording no edge, hold-budget and contention accounting, the report's
shape, one sentinel at a time — plus a cycle taken in a daemon thread
that only ``check()`` surfaces, and the same acquisition sequence giving
both modules the same graph and counts. (The reference file's state-plane
backend registry cases have no port counterpart: the port has no
backend registry, ROADMAP Queue A item 12h.)"""

import threading
import time

import pytest

from flink_tpu.observe import lock_sentinel as ref_ls
from flink_tpu_torch.observe import lock_sentinel as port_ls


@pytest.fixture(params=["reference", "port"])
def ls(request):
    return ref_ls if request.param == "reference" else port_ls


class TestNamedLock:
    def test_factory_returns_wrapper_with_name(self, ls):
        lk = ls.named_lock("t.basic")
        assert isinstance(lk, ls.NamedLock)
        assert lk.name == "t.basic"
        assert not lk.reentrant

    def test_plain_lock_semantics_without_sentinel(self, ls):
        assert ls.current_sentinel() is None
        lk = ls.named_lock("t.plain")
        with lk:
            assert lk.locked()
            assert not lk.acquire(blocking=False)
        assert not lk.locked()

    def test_reentrant_without_sentinel(self, ls):
        lk = ls.named_lock("t.re0", reentrant=True)
        with lk:
            with lk:
                assert lk.locked()
        assert not lk.locked()


class TestLockSentinel:
    def test_cycle_raises_and_is_recorded(self, ls):
        a, b = ls.named_lock("t.a"), ls.named_lock("t.b")
        s = ls.LockSentinel()
        with s:
            with a:
                with b:
                    pass
            with b:
                with pytest.raises(ls.LockOrderViolation,
                                   match="lock order cycle"):
                    with a:
                        pass
        assert len(s.cycles) == 1
        assert set(s.cycles[0][0]) == {"t.a", "t.b"}
        with pytest.raises(ls.LockOrderViolation):
            s.check()

    def test_consistent_order_is_clean(self, ls):
        a, b = ls.named_lock("t.c"), ls.named_lock("t.d")
        s = ls.LockSentinel()
        with s:
            for _ in range(3):
                with a:
                    with b:
                        pass
        s.check()
        assert s.cycles == []
        assert s.edges == {"t.c": {"t.d"}}

    def test_reentrant_reacquire_records_no_edge(self, ls):
        lk = ls.named_lock("t.re", reentrant=True)
        s = ls.LockSentinel()
        with s:
            with lk:
                with lk:
                    pass
        s.check()
        assert s.edges == {}
        assert s.stats["t.re"].acquisitions == 1  # one real acquire

    def test_same_name_two_instances_nested_is_a_cycle(self, ls):
        # two objects, one name: undefined intra-name order — the ABBA
        # hazard the 'staggered, never nested' discipline prevents
        l1, l2 = ls.named_lock("t.same"), ls.named_lock("t.same")
        s = ls.LockSentinel()
        with s:
            with l1:
                with pytest.raises(ls.LockOrderViolation,
                                   match="two instances"):
                    with l2:
                        pass
        assert s.cycles

    def test_hold_budget(self, ls):
        lk = ls.named_lock("t.hold")
        s = ls.LockSentinel()
        with s:
            with lk:
                time.sleep(0.05)
        s.check()  # no budget: clean
        with pytest.raises(ls.LockOrderViolation, match="hold budget"):
            s.check(hold_budget_s=0.01)
        s.check(hold_budget_s=10.0)

    def test_contention_is_counted(self, ls):
        lk = ls.named_lock("t.cont")
        s = ls.LockSentinel()
        entered = threading.Event()

        def taker():
            entered.wait(5)
            with lk:
                pass

        with s:
            t = threading.Thread(target=taker, daemon=True)
            t.start()
            with lk:
                entered.set()
                time.sleep(0.05)  # taker parks on the held lock
            t.join(5)
        assert s.stats["t.cont"].acquisitions == 2
        assert s.stats["t.cont"].contended >= 1
        assert s.contended_locks() == ["t.cont"]
        assert s.stats["t.cont"].wait_s > 0

    def test_report_shape(self, ls):
        a, b = ls.named_lock("t.r1"), ls.named_lock("t.r2")
        s = ls.LockSentinel()
        with s:
            with a:
                with b:
                    pass
        rep = s.report()
        assert set(rep["locks"]) == {"t.r1", "t.r2"}
        assert rep["locks"]["t.r1"]["acquisitions"] == 1
        assert rep["cycles"] == []
        assert len(rep["edges"]) == 1
        assert rep["edges"][0][:2] == ["t.r1", "t.r2"]
        assert "t.r1@" in rep["edges"][0][2]  # witness carries the site

    def test_second_install_rejected_and_uninstall_clears(self, ls):
        s1, s2 = ls.LockSentinel(), ls.LockSentinel()
        with s1:
            assert ls.current_sentinel() is s1
            with pytest.raises(RuntimeError, match="already installed"):
                s2.install()
        assert ls.current_sentinel() is None
        with s2:
            assert ls.current_sentinel() is s2


class TestAcrossPackages:
    def test_cycle_in_a_daemon_thread_fails_check(self, ls):
        """The violation raised inside a daemon thread is swallowed there,
        but the recorded cycle still fails the final ``check()``."""
        a, b = ls.named_lock("t.da"), ls.named_lock("t.db")
        s = ls.LockSentinel()
        raised = []

        def worker():
            try:
                with b:
                    with a:
                        pass
            except ls.LockOrderViolation:
                raised.append(True)

        with s:
            with a:
                with b:
                    pass
            t = threading.Thread(target=worker, daemon=True)
            t.start()
            t.join(5)
        assert raised and s.cycles
        with pytest.raises(ls.LockOrderViolation):
            s.check()

    def test_same_sequence_same_graph_and_counts(self):
        def run(mod):
            locks = [mod.named_lock(f"t.x{i}", reentrant=i == 2)
                     for i in range(4)]
            s = mod.LockSentinel()
            with s:
                for i in range(3):
                    with locks[i]:
                        with locks[i + 1]:
                            with locks[2]:
                                pass
            rep = s.report()
            return ({k: v for k, v in s.edges.items()},
                    {n: (st["acquisitions"], st["contended"])
                     for n, st in rep["locks"].items()},
                    [e[:2] for e in rep["edges"]], len(s.cycles))

        assert run(port_ls) == run(ref_ls)

    def test_serving_classes_take_named_locks(self):
        """The port's serving plane creates its locks through
        ``named_lock``, as the reference's does."""
        from flink_tpu_torch.tenancy.hot_cache import HotRowCache
        from flink_tpu_torch.tenancy.serving import (
            CoalescerPool,
            LookupCoalescer,
        )

        assert isinstance(LookupCoalescer(lambda k, n: k)._lock,
                          port_ls.NamedLock)
        assert CoalescerPool(lambda k: None)._lock.name == "serving.pool"
        assert HotRowCache()._lock.name == "tenancy.hot_rows"
