"""The port's async-pipeline substrate (``repro_torch.serving.pipeline``)
held against the JAX package's (``repro.serving.pipeline``): the same
scripts on a ``FakeClock`` drive both copies, and every observable —
commit order, stalls and the wait they book, rollback order, the
``GapStats`` dict, the ledger's counters and busy pages — must be equal.
Neither module imports JAX, so these run at host speed.
"""
from __future__ import annotations

import os
import sys
import threading

import pytest

from repro.serving import pipeline as jpipe
from repro_torch.serving import pipeline as tpipe

MODULES = [jpipe, tpipe]


def _queue_script(mod, max_in_flight, kinds, poison_at=None):
    """Push ``kinds`` steps (commit costs 1.5 ms each on the fake clock,
    dispatch 0.25 ms), drain; with ``poison_at`` the commit of that step
    raises. Returns (commits, rollbacks, dispatched_at, stats dict,
    the error if one was raised, steps left in the queue)."""
    clock = mod.FakeClock()
    commits, rollbacks = [], []

    def commit(step):
        clock.advance(1.5)
        if step.payload["n"] == poison_at:
            raise RuntimeError(f"poisoned {step.payload['n']}")
        commits.append(step.payload["n"])

    stats = mod.GapStats()
    q = mod.DispatchQueue(commit, max_in_flight=max_in_flight,
                          rollback=lambda s: rollbacks.append(s.payload["n"]),
                          stats=stats, clock=clock)
    steps, err = [], None
    try:
        for n, kind in enumerate(kinds):
            clock.advance(0.25)
            st = mod.PendingStep(kind, [n % 3], {"n": n})
            steps.append(st)
            q.push(st)
            stats.dispatch_ms += 0.25
        q.drain()
    except RuntimeError as e:
        err = str(e)
    return (commits, rollbacks, [s.dispatched_at_ms for s in steps],
            stats.as_dict(), err, len(q))


@pytest.mark.parametrize("max_in_flight", [1, 2, 3])
def test_commit_order_and_stalls_match_jax(max_in_flight):
    kinds = ["prefill", "decode", "decode", "verify", "decode", "decode"]
    j = _queue_script(jpipe, max_in_flight, kinds)
    t = _queue_script(tpipe, max_in_flight, kinds)
    assert t == j
    commits, rollbacks, _, stats, err, left = t
    assert commits == list(range(len(kinds))) and not rollbacks
    assert err is None and left == 0
    # one stall per push that found the queue full, its wait booked once
    assert stats["stalls"] == max(0, len(kinds) - max_in_flight)
    assert stats["wait_ms"] == pytest.approx(1.5 * len(kinds))
    assert stats["host_gap_ms"] == pytest.approx(
        stats["dispatch_ms"] + stats["wait_ms"])


def test_poisoned_commit_rolls_back_newest_first_as_jax():
    kinds = ["decode"] * 6
    j = _queue_script(jpipe, 3, kinds, poison_at=2)
    t = _queue_script(tpipe, 3, kinds, poison_at=2)
    assert t == j
    commits, rollbacks, _, stats, err, left = t
    assert commits == [0, 1] and err == "poisoned 2" and left == 0
    # steps 3 and 4 were in flight behind the poisoned one; 5 was never
    # pushed (the push that stalled on step 2 raised)
    assert rollbacks == [4, 3]
    assert stats["wait_ms"] == pytest.approx(4.5)   # the poisoned commit too


@pytest.mark.parametrize("mod", MODULES, ids=["jax", "torch"])
def test_pending_for_and_commit_oldest(mod):
    q = mod.DispatchQueue(lambda s: None, max_in_flight=4)
    for ids in ([1, 2], [2], [3]):
        q.push(mod.PendingStep("decode", ids))
    assert [q.pending_for(i) for i in (1, 2, 3, 4)] == [1, 2, 1, 0]
    assert q.commit_oldest().task_ids == [1, 2]
    assert q.pending_for(1) == 0 and q.depth == 2


def _ledger_script(mod):
    led = mod.TransferLedger()
    h1 = led.begin(7, [3, 4])
    h2 = led.begin(7, [9])
    h3 = led.begin(8, [5])
    out = [led.outstanding(), led.outstanding(7), sorted(led.busy_pages()),
           led.handles(7)]
    with pytest.raises(RuntimeError, match="transfer outstanding"):
        led.assert_idle([1, 4], "free")
    led.assert_idle([1, 2], "free")
    led.complete(h2)
    led.complete(h1)
    led.wait(7, timeout=0.1)              # owner 7 idle: returns at once
    with pytest.raises(TimeoutError):
        led.wait(8, timeout=0.05)
    worker = threading.Timer(0.05, led.complete, args=(h3,))
    worker.start()
    led.wait(timeout=5.0)
    worker.join(timeout=5.0)
    assert not worker.is_alive()
    led.check()
    with pytest.raises(ValueError, match="unknown transfer handle"):
        led.complete(h3)
    out += [led.started, led.completed, led.outstanding(),
            sorted(led.busy_pages())]
    return out


def test_ledger_wait_and_assert_idle_match_jax():
    assert _ledger_script(tpipe) == _ledger_script(jpipe) == [
        3, 2, [3, 4, 5, 9], [0, 1], 3, 3, 0, []]


def test_gap_stats_dicts_match_jax():
    """The same dict from both copies; ``add_swap_overlap`` from more
    threads than cores, switching every few microseconds, loses no
    update."""
    def fill(mod):
        g = mod.GapStats()
        g.schedule_ms, g.dispatch_ms, g.wait_ms = 1.25, 2.5, 4.0
        g.cycles, g.stalls = 5, 2
        threads = [threading.Thread(target=lambda: [
            g.add_swap_overlap(0.125) for _ in range(500)])
            for _ in range(2 * (os.cpu_count() or 4))]
        interval = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=30.0)
        finally:
            sys.setswitchinterval(interval)
        assert not any(th.is_alive() for th in threads)
        return g.as_dict(), len(threads)

    (t, n), (j, _) = fill(tpipe), fill(jpipe)
    assert t == j == {
        "schedule_ms": 1.25, "dispatch_ms": 2.5, "wait_ms": 4.0,
        "swap_overlap_ms": 62.5 * n, "host_gap_ms": 6.5, "cycles": 5,
        "stalls": 2}


@pytest.mark.parametrize("mod", MODULES, ids=["jax", "torch"])
def test_fake_clock_and_queue_bound(mod):
    clock = mod.FakeClock(3.0)
    assert clock() == 3.0 and clock.advance(2.0) == 5.0
    with pytest.raises(ValueError):
        clock.advance(-1.0)
    with pytest.raises(ValueError):
        mod.DispatchQueue(lambda s: None, max_in_flight=0)
