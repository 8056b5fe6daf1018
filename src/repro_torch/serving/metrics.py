"""SLO attainment metrics (paper §VI-A): TTFT / TPOT / deadline / overall,
split by real-time vs non-real-time, plus completion times and tail
percentiles (p50/p99 TTFT and TPOT — the shared helper every benchmark
consumes instead of reimplementing percentile math locally)."""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.task import Task


def _mean(xs) -> Optional[float]:
    xs = [x for x in xs if x is not None]
    return sum(xs) / len(xs) if xs else None


def percentile(xs: Sequence[Optional[float]], q: float) -> Optional[float]:
    """np.percentile over the non-None entries; None when empty. The one
    percentile definition shared by Attainment and the benchmarks, so
    'p99' means the same thing in every table."""
    xs = [x for x in xs if x is not None]
    return float(np.percentile(xs, q)) if xs else None


@dataclasses.dataclass
class Attainment:
    n: int
    slo: float
    ttft: float
    tpot: float
    deadline: float
    mean_completion_ms: Optional[float]
    mean_tpot_ms: Optional[float]
    # tail latencies: TTFT over every task that produced a first token,
    # steady-state TPOT over finished tasks
    ttft_p50_ms: Optional[float] = None
    ttft_p99_ms: Optional[float] = None
    tpot_p50_ms: Optional[float] = None
    tpot_p99_ms: Optional[float] = None

    def row(self) -> Dict[str, float]:
        return dataclasses.asdict(self)


def summarize(tasks: Sequence[Task]) -> Dict[str, Attainment]:
    """Returns {'all': ..., 'realtime': ..., 'non_realtime': ...}."""
    out = {}
    groups = {
        "all": list(tasks),
        "realtime": [t for t in tasks if t.slo.realtime],
        "non_realtime": [t for t in tasks if not t.slo.realtime],
    }
    for name, ts in groups.items():
        n = len(ts)
        if n == 0:
            out[name] = Attainment(0, 0.0, 0.0, 0.0, 0.0, None, None)
            continue
        slo = sum(t.slo_met() for t in ts) / n
        ttft = sum(t.ttft_met() for t in ts) / n
        tpot = sum(t.tpot_met() for t in ts) / n
        rt = [t for t in ts if t.slo.realtime]
        ddl = (sum(t.slo_met() for t in rt) / len(rt)) if rt else 1.0
        ttfts = [t.ttft_ms for t in ts]
        tpots = [t.tpot_measured_ms for t in ts if t.finished]
        out[name] = Attainment(
            n=n, slo=slo, ttft=ttft, tpot=tpot, deadline=ddl,
            mean_completion_ms=_mean([t.completion_ms for t in ts]),
            mean_tpot_ms=_mean(tpots),
            ttft_p50_ms=percentile(ttfts, 50), ttft_p99_ms=percentile(ttfts, 99),
            tpot_p50_ms=percentile(tpots, 50), tpot_p99_ms=percentile(tpots, 99),
        )
    return out


def per_tier(tasks: Sequence[Task]) -> Dict[str, Attainment]:
    """Fleet routing (DESIGN.md §11): attainment per serving instance,
    keyed by ``Task.served_by`` (spill-aware — a spilled request counts
    under the instance that actually served its tokens, matching the
    per-instance LoopResult partition). Requests no instance ever served
    group under 'unrouted'."""
    groups: Dict[str, List[Task]] = {}
    for t in tasks:
        groups.setdefault(t.served_by or "unrouted", []).append(t)
    return {name: summarize(ts)["all"] for name, ts in sorted(groups.items())}


# --------------------------------------- SLO-violation attribution (§13)

ATTRIBUTION_BUCKETS = ("routing", "queueing", "prefill_interference",
                       "swap_stall", "decode_contention")


def _attribute(t: Task, evs: Sequence) -> str:
    """Classify ONE violated request into its dominant cause. Decision
    tree over the lifecycle stream (DESIGN.md §13):

      1. tier floor unmet           -> routing (the fleet degraded it;
         nothing the serving instance did could have attained it)
      2. first token late / never   -> the time went either to waiting
         for admission (queueing: gap from arrival to the task's first
         own engine span) or to being stretched by co-scheduled work
         after service began (prefill_interference: first-span-to-first-
         token time minus the task's own span durations) — whichever
         share is larger names the bucket; a request with no engine
         spans at all never got service, which is queueing by definition
      3. first token on time, decode phase missed (TPOT / deadline) ->
         swap_stall when the request was ever suspended to host
         (DESIGN.md §7), decode_contention otherwise (its columns ran
         slow/starved under the co-resident batch)
    """
    if not t.tier_met():
        return "routing"
    own = [e for e in evs
           if e.kind in ("prefill", "prefill_chunk", "decode",
                         "suspend", "resume")]
    pre = [e for e in own if e.kind in ("prefill", "prefill_chunk")]
    first_token_late = (t.ttft_ms is None) or (t.ttft_ms > t.slo.ttft_ms)
    if first_token_late:
        if not pre:
            return "queueing"
        first_start = min(e.ts for e in pre)
        wait = first_start - t.arrival_ms
        end = (t.prefill_done_ms if t.prefill_done_ms is not None
               else max(e.ts + e.dur for e in pre))
        stretch = (end - first_start) - sum(e.dur for e in pre)
        return "queueing" if wait >= stretch else "prefill_interference"
    suspended = any(e.kind == "suspend" and e.args.get("ok", True)
                    for e in evs)
    return "swap_stall" if suspended else "decode_contention"


def slo_attribution(tasks: Sequence[Task],
                    events: Sequence) -> Dict[str, object]:
    """Partition the violated-request set into attribution buckets
    (DESIGN.md §13). ``events`` is a TraceRecorder's stream (or any
    sequence of objects with .kind/.task_id/.ts/.dur/.args); with an
    EMPTY stream every non-routing violation degrades to 'queueing' —
    attribution without a trace is a statement of ignorance, not a
    crash. Returns buckets (every key present), the violation total
    (== sum of buckets: each violated request lands in exactly one),
    and the per-task labels."""
    by_task: Dict[int, List] = {}
    for e in events:
        if e.task_id >= 0:
            by_task.setdefault(e.task_id, []).append(e)
    buckets = {b: 0 for b in ATTRIBUTION_BUCKETS}
    by_id: Dict[int, str] = {}
    for t in tasks:
        if t.slo_met():
            continue
        label = _attribute(t, by_task.get(t.task_id, []))
        by_id[t.task_id] = label
        buckets[label] += 1
    return {"buckets": buckets, "violations": len(by_id), "by_task": by_id}


def per_kind_tpot(tasks: Sequence[Task]) -> Dict[str, Dict[str, float]]:
    """Table II style: actual TPOT / rate / attainment per task kind."""
    kinds: Dict[str, List[Task]] = {}
    for t in tasks:
        kinds.setdefault(t.kind, []).append(t)
    rows = {}
    for kind, ts in sorted(kinds.items()):
        fin = [t for t in ts if t.finished]
        tp = _mean([t.tpot_measured_ms for t in fin])
        rows[kind] = {
            "n": len(ts),
            "tpot_slo_ms": ts[0].slo.tpot_ms,
            "actual_tpot_ms": tp,
            "decode_rate_tps": (1000.0 / tp) if tp else None,
            "tpot_satisfied": all(t.tpot_met() for t in fin) and bool(fin),
            "slo_attainment": sum(t.slo_met() for t in ts) / len(ts),
        }
    return rows
