"""The traced run's device profile: a steady slice of the window.

torch.profiler (CPU and CUDA activities) runs over the last
``slice_s`` seconds of the window, started and stopped by the loop's
tick, so the whole window is never traced (a decode step is about 1,100
kernels). Its events are read in memory from the kineto results, with
no chrome export. Each device operation is attributed to the executor
op whose host range (``sb.<kind>#<serial>``, put by the benchmark
around the port's public ops) contains its start: the synchronous
engine ends every op on the host only after the step it launched has
finished. Idle gaps between device operations are labelled by the
innermost host range covering them (schedule, an op, release, deliver,
the loop's idle sleep, or ``loop`` for the rest of the driver's step).
"""
from __future__ import annotations

import bisect
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch
from torch.profiler import ProfilerActivity, profile

OPS = ("sb.prefill#", "sb.chunk#", "sb.decode#", "sb.suspend#",
       "sb.resume#")


def _ns(e, what: str) -> int:
    f = getattr(e, f"{what}_ns", None)
    if f is not None:
        return int(f())
    return int(getattr(e, f"{what}_us")() * 1000)


class SliceProfiler:
    """Starts at ``start_ms`` of the window and stops at ``stop_ms``."""

    def __init__(self, start_ms: float, stop_ms: float):
        self.start_ms, self.stop_ms = start_ms, stop_ms
        self.prof: Optional[profile] = None
        self.window_s = 0.0
        self._t0 = 0.0
        self.done = False

    @staticmethod
    def warm(fn) -> None:
        """Profile ``fn`` once in set-up, so that the profiler's own
        first start (CUPTI's initialisation) is not paid in the window."""
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            fn()

    def tick(self, now_ms: float, ex=None) -> None:
        if self.prof is None and not self.done and now_ms >= self.start_ms:
            self.prof = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
            self.prof.start()
            self._t0 = time.perf_counter()
            if ex is not None:
                ex.profiling = True
        elif self.prof is not None and not self.done and now_ms >= self.stop_ms:
            torch.cuda.synchronize()
            self.window_s = time.perf_counter() - self._t0
            self.prof.stop()
            self.done = True
            if ex is not None:
                ex.profiling = False

    def events(self):
        """(device ops [(start_ns, end_ns, name)], host ranges
        [(start_ns, end_ns, name)]) of the slice, each sorted by start."""
        dev, host = [], []
        for e in self.prof.profiler.kineto_results.events():
            s, d = _ns(e, "start"), _ns(e, "duration")
            name = e.name()
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                # the profiler mirrors each host range onto the device's
                # timeline as an annotation spanning the op: not an op
                if not name.startswith("sb."):
                    dev.append((s, s + d, name))
            elif name.startswith("sb."):
                host.append((s, s + d, name))
        dev.sort()
        host.sort()
        return dev, host


def busy_intervals(dev) -> List[Tuple[int, int]]:
    """The union of device intervals, merged, in order."""
    out: List[List[int]] = []
    for s, e, _ in dev:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def by_op(dev, host) -> Dict[int, List[Tuple[str, float]]]:
    """serial of each executor op -> [(device op name, seconds)] of the
    device operations that started inside its host range."""
    ops = [(s, e, name) for s, e, name in host if name.startswith(OPS)]
    starts = [s for s, _, _ in ops]
    out: Dict[int, List[Tuple[str, float]]] = defaultdict(list)
    for s, e, name in dev:
        k = bisect.bisect_right(starts, s) - 1
        if k >= 0 and s <= ops[k][1]:
            out[int(ops[k][2].split("#")[1])].append((name, (e - s) / 1e9))
    return out


def top_device_ops(dev, n: int = 10) -> List[list]:
    tot: Dict[str, float] = defaultdict(float)
    for s, e, name in dev:
        tot[name] += (e - s) / 1e9
    return [[k[:200], v] for k, v in
            sorted(tot.items(), key=lambda kv: -kv[1])[:n]]


def idle_gaps(dev, host, n: int = 10) -> List[list]:
    """Seconds of device idle time between device operations, summed by
    the host phase running at each gap's middle, the largest first. The
    benchmark's host ranges do not nest, so the one that started last
    before the middle is the only candidate."""
    busy = busy_intervals(dev)
    starts = [s for s, _, _ in host]
    tot: Dict[str, float] = defaultdict(float)
    for (_, a), (b, _) in zip(busy, busy[1:]):
        mid = (a + b) // 2
        k = bisect.bisect_right(starts, mid) - 1
        label = "loop"
        if k >= 0 and host[k][1] >= mid:
            label = host[k][2].split("#")[0]
        tot[label] += (b - a) / 1e9
    return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]


def by_kind(kernels_by_op, ops, n: int = 8) -> Dict[str, list]:
    """For each kind of executor op in the slice: how many there were,
    the device operations and device seconds one of them held on average
    (a step whose operations were all recorded holds as many as the
    next), and the device operations that took most of their time, in s."""
    out: Dict[str, list] = {}
    for kind in sorted({o.kind for o in ops if o.profiled}):
        tot: Dict[str, float] = defaultdict(float)
        mine = [o for o in ops if o.profiled and o.kind == kind]
        count = [len(kernels_by_op.get(o.serial, ())) for o in mine]
        for o in mine:
            for name, s in kernels_by_op.get(o.serial, ()):
                tot[name] += s
        top = sorted(tot.items(), key=lambda kv: -kv[1])[:n]
        out[kind] = [len(mine), min(count), max(count),
                     sum(tot.values()) / len(mine),
                     [[k[:160], v] for k, v in top]]
    return out


def op_ms(ops, window_ms: float) -> Dict[str, list]:
    """Mean wall ms of each kind of op inside the window, profiled and
    not: what the profiler's own host work adds to an op."""
    out: Dict[str, list] = {}
    for kind in sorted({o.kind for o in ops}):
        row = []
        for prof in (True, False):
            d = [o.t1 - o.t0 for o in ops if o.kind == kind
                 and o.profiled == prof and o.t0 < window_ms]
            row.append(sum(d) / len(d) if d else None)
        out[kind] = row
    return out
