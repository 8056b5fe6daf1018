"""The open loop on the wall clock, over the port's ``InstanceDriver``.

It replaces only the outer loop of ``serving/loop.py``
``run_serving_loop``. Every request is due at a time drawn from the seed
and is handed to ``InstanceDriver.deliver`` at the first step boundary
after that time; how late that was is recorded. Before each step the
driver's clock (``drv.now``) is set to the wall clock (ms since the
window opened), so the scheduler plans at the true time, and each
executor op returns the wall time from that point to its end, so the
driver's stamps land on the wall clock too: a token's time includes the
scheduler's host time, any capture made on a cold shape and any stall.
When the scheduler is idle the loop sleeps until the next request is
due. Requests are due only inside the window; after it closes the loop
follows them to completion, up to the drain limit.

The benchmark takes its own stamps: ``TimedExecutor`` reads the wall
clock around every op and keeps one stamp per output token, and the SLO
arithmetic reads those, never the program's clock.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable, Dict, List, Optional

import torch

from servebench.harness.traffic import Request


class Clock:
    """ms since the window opened, on the host's monotonic clock."""

    def __init__(self):
        self.t0 = time.perf_counter()

    def open(self) -> None:
        self.t0 = time.perf_counter()

    def ms(self) -> float:
        return (time.perf_counter() - self.t0) * 1000.0


def ranges(on: bool) -> Callable[[str], contextlib.AbstractContextManager]:
    """Named host ranges for the profiler (``sb.<phase>``), or none."""
    if not on:
        return lambda name: contextlib.nullcontext()
    return torch.profiler.record_function


@dataclasses.dataclass
class Op:
    """One executor op as the benchmark saw it."""
    kind: str                 # prefill | chunk | decode | suspend | resume
    serial: int
    t0: float                 # wall ms at its call
    t1: float                 # wall ms at its return
    ms: float                 # what the program's own clock returned
    rids: List[int]
    # prefill: [L]; chunk: [q_start, n]; decode: each row's keys attended
    shape: List[int]
    profiled: bool = False


class TimedExecutor:
    """The port's executor as the driver sees it during the window: every
    op timed on the wall clock, one stamp per output token kept, the
    served tokens of each task read before its release."""

    def __init__(self, inner, clock: Clock, ranged: bool = False):
        self._inner = inner
        self._clock = clock
        self._range = ranges(ranged)
        self.drv = None                       # set once the driver exists
        self.ops: List[Op] = []
        self.stamps: Dict[int, List[float]] = {}
        self.served: Dict[int, List[int]] = {}
        self.profiling = False

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def _op(self, kind: str, fn, rids: List[int], shape: List[int]):
        serial = len(self.ops)
        with self._range(f"sb.{kind}#{serial}"):
            t0 = self._clock.ms()
            out = fn()
            t1 = self._clock.ms()
        ms = out[0] if isinstance(out, tuple) else out
        self.ops.append(Op(kind, serial, t0, t1, float(ms), rids, shape,
                           self.profiling))
        return out, t1

    def _until(self, t1: float) -> float:
        """The ms the driver adds to its clock so that it reads ``t1``."""
        return t1 - self.drv.now

    def prefill(self, task) -> float:
        L = task.prompt_len
        _, t1 = self._op("prefill", lambda: self._inner.prefill(task),
                         [task.task_id], [L])
        self.stamps.setdefault(task.task_id, []).append(t1)
        return self._until(t1)

    def prefill_chunk(self, task, n_tokens: int):
        start = self._inner.prompt_progress(task)
        out, t1 = self._op(
            "chunk", lambda: self._inner.prefill_chunk(task, n_tokens),
            [task.task_id], [start, 0])
        self.ops[-1].shape[1] = self._inner.prompt_progress(task) - start
        done = out[1]
        if done:
            self.stamps.setdefault(task.task_id, []).append(t1)
        return self._until(t1), done

    def decode(self, tasks, depths=None) -> float:
        if depths is not None:
            raise NotImplementedError("speculative decoding: one stamp per "
                                      "committed token is not kept here")
        keys = [t.prompt_len + t.tokens_done for t in tasks]
        _, t1 = self._op("decode", lambda: self._inner.decode(tasks),
                         [t.task_id for t in tasks], keys)
        for t in tasks:
            self.stamps.setdefault(t.task_id, []).append(t1)
        return self._until(t1)

    def suspend(self, task) -> float:
        _, t1 = self._op("suspend", lambda: self._inner.suspend(task),
                         [task.task_id], [])
        return self._until(t1)

    def resume(self, task) -> float:
        _, t1 = self._op("resume", lambda: self._inner.resume(task),
                         [task.task_id], [])
        return self._until(t1)

    def release(self, task) -> None:
        with self._range("sb.release"):
            self.served[task.task_id] = self._inner.generated_tokens(task)
            self._inner.release(task)


@dataclasses.dataclass
class LoopStats:
    lag_ms: Dict[int, float]          # due time to delivery
    failed_at: Dict[int, float]       # dropped or given up: wall ms
    end_ms: float                     # when the loop stopped
    backlog_mid: int                  # delivered, unfinished at W / 2
    backlog_end: int                  # the same at W
    actions_window: int               # scheduler actions inside W
    schedule_ms_window: float         # GapStats.schedule_ms inside W


def serve(drv, ex: TimedExecutor, requests: List[Request], tasks: Dict,
          clock: Clock, window_ms: float, drain_ms: float,
          tick: Optional[Callable[[float], None]] = None,
          ranged: bool = False) -> LoopStats:
    """Drive ``drv`` over ``requests`` (sorted by due time) on the wall
    clock, from the window's opening until every request is finished or
    dropped, or ``window_ms + drain_ms`` has passed."""
    rng = ranges(ranged)
    stats = ex.gap_stats
    reqs = sorted(requests, key=lambda r: (r.due_ms, r.rid))
    n, i = len(reqs), 0
    lag: Dict[int, float] = {}
    failed_at: Dict[int, float] = {}
    live: Dict[int, object] = {}
    mid = end = sched1 = None
    actions = 0
    clock.open()
    sched0 = stats.schedule_ms
    while True:
        now = clock.ms()
        drv.now = now
        while i < n and reqs[i].due_ms <= now:
            r = reqs[i]
            with rng("sb.deliver"):
                drv.deliver(tasks[r.rid])
            lag[r.rid] = now - r.due_ms
            live[r.rid] = tasks[r.rid]
            i += 1
        if tick is not None:
            tick(now)
        if mid is None and now >= window_ms / 2:
            mid = len(live)
        if end is None and now >= window_ms:
            end = len(live)
            sched1 = stats.schedule_ms
        if now >= window_ms + drain_ms or (i == n and not live):
            break
        ran = drv.step()
        for rid, t in list(live.items()):
            if t.dropped:
                failed_at[rid] = now
                del live[rid]
            elif t.finished:
                del live[rid]
        if ran:
            if end is None:
                actions += 1
            continue
        # idle: nothing the scheduler will run now
        wake = reqs[i].due_ms if i < n else float("inf")
        if live:
            drv.scheduler.on_idle(now)
            wake = min(wake, now + 1.0)
        with rng("sb.idle"):
            time.sleep(max(0.0, wake - clock.ms()) / 1000.0)
    drv.drain()
    drv.release_dropped()
    stop = clock.ms()
    for rid, t in live.items():
        if t.dropped or not t.finished:
            failed_at.setdefault(rid, stop)
    for r in reqs[i:]:                     # never delivered
        failed_at[r.rid] = stop
    if end is None:
        end = len(live)
        sched1 = stats.schedule_ms
    return LoopStats(lag, failed_at, stop, mid if mid is not None else 0,
                     end, actions, sched1 - sched0)
