"""The open loop stamps on the wall clock: time the scheduler spends
lands in TTFT and TPOT, which the port's own loop clock leaves out."""
import time

import pytest

from repro_torch.core.schedulers import DecodeAction, PrefillAction, Scheduler
from repro_torch.serving.loop import InstanceDriver, run_serving_loop
from repro_torch.serving.pipeline import GapStats
from servebench.harness import engine, openloop, slo
from servebench.harness.traffic import SLO, Request

OP_MS = 2.0


class FakeExecutor:
    """Each op takes OP_MS of host time and reports exactly that."""

    def __init__(self):
        self.gap_stats = GapStats()
        self.progress = {}

    def _work(self):
        time.sleep(OP_MS / 1000.0)
        return OP_MS

    def prefill(self, task):
        return self._work()

    def decode(self, tasks, depths=None):
        return self._work()

    def prompt_progress(self, task):
        return self.progress.get(task.task_id, 0)

    def generated_tokens(self, task):
        return [0] * task.tokens_done

    def release(self, task):
        pass


class SleepyFifo(Scheduler):
    """Prefill arrivals in order, then decode everything prefilled;
    every call plans for ``think_ms`` of host time first."""

    def __init__(self, think_ms):
        self.think_ms = think_ms
        self.waiting, self.running = [], []
        self.trace = None

    def on_arrival(self, task, now):
        self.waiting.append(task)

    def on_finish(self, task, now):
        self.running.remove(task)

    def next_action(self, now):
        time.sleep(self.think_ms / 1000.0)
        if self.waiting:
            t = self.waiting.pop(0)
            self.running.append(t)
            return PrefillAction(t)
        live = [t for t in self.running if not t.finished]
        return DecodeAction(live) if live else None


def _requests(n, gap_ms, out):
    return [Request(1_000_000 + i, 5.0 + gap_ms * i, "qa", 16, out,
                    SLO(False, 2000.0, 100.0), 1.0) for i in range(n)]


def _serve(think_ms, reqs):
    clock = openloop.Clock()
    ex = openloop.TimedExecutor(FakeExecutor(), clock)
    drv = InstanceDriver(SleepyFifo(think_ms), ex)
    ex.drv = drv
    tasks = {r.rid: engine.task(r) for r in reqs}
    stats = openloop.serve(drv, ex, reqs, tasks, clock, 1000.0, 5000.0)
    return ex, stats, tasks


def test_scheduler_time_lands_in_ttft_and_tpot():
    reqs = _requests(3, 150.0, 6)
    ex, stats, tasks = _serve(20.0, reqs)
    assert not stats.failed_at
    for r in reqs:
        st = ex.stamps[r.rid]
        assert len(st) == r.output_len
        # the first token: the plan that chose the prefill, then the op
        assert st[0] - r.due_ms >= 20.0 + OP_MS
        # every later token waited for a plan too
        assert slo.tpot_ms(st) >= 20.0 + OP_MS
        # the driver's stamps are the benchmark's: both on the wall clock
        assert tasks[r.rid].token_times_ms == pytest.approx(st)
    # the port's loop, on the executor's clock alone, never sees the 20 ms
    virt = _requests(3, 150.0, 6)
    vt = [engine.task(r) for r in virt]
    res = run_serving_loop(SleepyFifo(20.0), FakeExecutor(), vt)
    assert max(t.tpot_measured_ms for t in res.tasks) == pytest.approx(OP_MS)


def test_requests_are_delivered_on_time_and_idle_time_is_slept():
    reqs = _requests(4, 200.0, 3)
    t0 = time.perf_counter()
    ex, stats, _ = _serve(0.0, reqs)
    took = (time.perf_counter() - t0) * 1000.0
    assert took >= reqs[-1].due_ms            # slept until the last one
    assert max(stats.lag_ms.values()) < 50.0
    for r in reqs:
        assert ex.stamps[r.rid][0] >= r.due_ms
    assert stats.backlog_end == 0


def test_unfinished_requests_fail_at_the_drain_limit():
    reqs = _requests(2, 10.0, 10_000)          # far more than the drain
    clock = openloop.Clock()
    ex = openloop.TimedExecutor(FakeExecutor(), clock)
    drv = InstanceDriver(SleepyFifo(0.0), ex)
    ex.drv = drv
    tasks = {r.rid: engine.task(r) for r in reqs}
    stats = openloop.serve(drv, ex, reqs, tasks, clock, 100.0, 200.0)
    assert set(stats.failed_at) == {r.rid for r in reqs}
    assert 300.0 <= stats.end_ms < 400.0
