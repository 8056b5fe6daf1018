"""What one window left behind, as the per-layer readers see it, and the
end-to-end metrics, which the harness computes itself."""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from servebench.harness import registry, slo
from servebench.harness.openloop import LoopStats, Op
from servebench.harness.traffic import Request


@dataclasses.dataclass
class Window:
    model: Dict                       # the configuration's ``port`` block
    elem_bytes: int                   # bytes of one served element
    seconds: float
    requests: List[Request]
    stamps: Dict[int, List[float]]    # wall ms of each output token
    loop: LoopStats
    ops: List[Op]
    trace_events: List = dataclasses.field(default_factory=list)
    # serial of an op -> [(device op name, s)], from the profiled slice
    kernels_by_op: Dict[int, List[Tuple[str, float]]] = dataclasses.field(
        default_factory=dict)
    busy_s: Optional[float] = None
    window_s: Optional[float] = None

    @property
    def window_ms(self) -> float:
        return self.seconds * 1000.0

    def ops_in_window(self, *kinds: str) -> List[Op]:
        return [o for o in self.ops
                if o.kind in kinds and o.t0 < self.window_ms]

    def profiled(self, *kinds: str) -> List[Op]:
        return [o for o in self.ops if o.kind in kinds and o.profiled]

    @staticmethod
    def roofline(name: str):
        return registry.roofline(name)

    @staticmethod
    def peaks() -> Dict:
        return registry.peaks()


def end_to_end(w: Window, setup_s: float) -> Dict[str, float]:
    """The end-to-end metrics of a window, every one on the benchmark's
    own clock, over every request due in the window."""
    met, ttfts, tpots = 0, [], []
    for r in w.requests:
        st = w.stamps.get(r.rid, [])
        failed = r.rid in w.loop.failed_at
        met += slo.slo_met(r, st, failed)
        a, b = slo.latency_samples(r, st, failed,
                                   w.loop.failed_at.get(r.rid, w.loop.end_ms))
        ttfts.append(a)
        tpots.append(b)
    n = len(w.requests)
    in_window = sum(1 for st in w.stamps.values() for t in st
                    if t < w.window_ms)
    return {"slo_attainment": 100.0 * met / n,
            "ttft_p95_ms": slo.percentile(ttfts, 95),
            "tpot_p95_ms": slo.percentile(tpots, 95),
            "output_tokens_per_s": in_window / w.seconds,
            "setup_s": setup_s}


def summary(w: Window) -> Dict[str, float]:
    """Further numbers for the run's earlier lines (not metrics)."""
    done = [r for r in w.requests if r.rid not in w.loop.failed_at]
    ttft = [w.stamps[r.rid][0] - r.due_ms for r in done]
    rt = [r for r in w.requests if r.slo.realtime]
    rt_met = sum(slo.slo_met(r, w.stamps.get(r.rid, []),
                             r.rid in w.loop.failed_at) for r in rt)
    return {"ttft_p50_ms": slo.percentile(ttft, 50),
            "realtime_attainment": 100.0 * rt_met / max(1, len(rt)),
            "lag_p50_ms": slo.percentile(list(w.loop.lag_ms.values()), 50),
            "backlog_mid": w.loop.backlog_mid,
            "backlog_end": w.loop.backlog_end}


def kernel_share(w: Window, kind: str, roofline: str, work) -> Optional[float]:
    """A kernel's share of its roofline over the profiled ops of ``kind``,
    in %: the least time the chip could take for the work those ops
    need (the larger of FLOPs / peak and bytes / bandwidth, summed over
    the ops), over the profiler's time of the kernel's device operations
    in them. ``work(op)`` gives (FLOPs, bytes) of one op. None where the
    slice holds no such kernel."""
    rl, pk = w.roofline(roofline), w.peaks()
    need = took = 0.0
    for op in w.profiled(kind):
        t = sum(s for name, s in w.kernels_by_op.get(op.serial, ())
                if rl.KERNEL.search(name))
        if t <= 0:
            continue
        f, b = work(op)
        need += max(f / pk["bf16_flops_per_s"], b / pk["hbm_bytes_per_s"])
        took += t
    return 100.0 * need / took if took > 0 else None


def step_mfu(w: Window, kinds, flops) -> Optional[float]:
    """The steps' share of the chip's bf16 peak, in %: the FLOPs the
    window's ops of ``kinds`` need over their time on the host clock."""
    ops = w.ops_in_window(*kinds)
    secs = sum(o.t1 - o.t0 for o in ops) / 1000.0
    if secs <= 0:
        return None
    return 100.0 * sum(flops(o) for o in ops) / secs / w.peaks()[
        "bf16_flops_per_s"]
