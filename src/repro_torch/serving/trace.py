"""Serving observability spine (DESIGN.md §13): per-request lifecycle
tracing with near-zero overhead when disabled.

``TraceRecorder`` is a ring buffer of structured ``TraceEvent`` rows
stamped on the LOOP clock (``InstanceDriver.now`` — simulated ms for the
sim executors, folded wall-clock ms for the JAX engines), never the wall
clock of the recording call itself: under the async pipelined engine
(DESIGN.md §10) an operation's span is emitted at COMMIT time, after the
loop folded the deferred device wait into ``now``, so timestamps stay
causal whatever the dispatch mode.

The overhead contract:
  * disabled  — tracing off is ``trace=None``; every emission site is a
    single ``is not None`` test, no event objects, no clock reads;
  * enabled   — events are READ-ONLY observations of decisions already
    taken. Policy code never branches on the recorder, so token streams
    and every benchmark-gate metric are byte-identical traced vs.
    untraced (tests/test_trace.py, tests/test_torch_trace.py). On an
    H100 serving edge-6b (the port's benchmark, ``servebench/``), the
    decode ops of a traced run, phases timed (below), took within 1% of
    an untraced run's at each batch size; in a traced run in which
    torch.profiler had been started once before (the benchmark's warm-up)
    they took ~10% longer (PERF.md).

Event kinds (the lifecycle stream of DESIGN.md §13):

  instant   arrive / admit / defer(reason=pages|states|time|batch|tier) /
            route(tier, score, degraded) / spec_grant(depth) / drop /
            finish(tier, ok) / engine_setup(captures, make_ms: the steps
            the engine made before the trace was attached, and their host
            ms; the port's paged engine only)
  span      prefill / prefill_chunk / decode(n, commits, spec_extra) /
            suspend(ok) / resume(ok)     — ``dur`` > 0, one per executed
            loop action, carrying the executor GapStats deltas
            (schedule/dispatch/wait/swap-overlap ms) measured across the
            action when the executor keeps them, and the synchronous
            paged engine's phases of the op (stage_ms, graph_ms, gaps_ms,
            commit_ms, graphs, captures: ``step_graphs.PhaseTimer``)

The trace is a SECOND LEDGER: ``replay_counters`` recomputes the
``LoopResult`` counters (decode iterations, prefills, chunks, suspends,
resumes, spec-extra tokens, defers by reason, per-tier served counts)
purely from the event stream, and the conservation gate requires exact
agreement — any hot-path accounting drift between the loop and the trace
is a test failure, not a silent skew in a dashboard.

``export_perfetto`` writes the stream as Chrome-trace JSON (one track
per serving instance, flow arrows linking each request's arrive →
first-token → finish) loadable in ui.perfetto.dev or chrome://tracing.
"""
from __future__ import annotations

import dataclasses
import json
from collections import deque
from typing import Any, Dict, List, NamedTuple, Optional, Sequence

# span kinds occupy engine time on an instance track; instants do not
SPAN_KINDS = ("prefill", "prefill_chunk", "decode", "suspend", "resume")
DEFER_REASONS = ("pages", "states", "time", "batch", "tier")

# the one shared payload for argless events — TraceEvent.args is always a
# dict so consumers never None-check; READ-ONLY by the trace contract
_NO_ARGS: Dict[str, Any] = {}


class TraceEvent(NamedTuple):
    """One structured trace row. ``ts``/``dur`` are loop-clock ms;
    ``args`` holds the kind-specific payload (defer reason, spec depth,
    route score, decode batch size, GapStats deltas, ...). A NamedTuple,
    not a dataclass: constructed once per loop action on the traced hot
    path, so tuple-speed allocation keeps a traced run's cost low (the
    module docstring gives it)."""
    ts: float
    kind: str
    task_id: int = -1
    instance: str = "engine"
    dur: float = 0.0
    args: Dict[str, Any] = _NO_ARGS


@dataclasses.dataclass
class MetricsSnapshot:
    """Counters/gauges sampled every ``metrics_every`` loop cycles
    (DESIGN.md §13): the low-rate surface benchmarks and dashboards read
    instead of grubbing through executor internals."""
    ts: float
    instance: str = "engine"
    pages_in_use: int = 0
    states_in_use: int = 0
    resident: int = 0                 # delivered, unfinished tasks
    defers_by_reason: Dict[str, int] = dataclasses.field(default_factory=dict)
    spec_accept_rate: Optional[float] = None
    suspends: int = 0
    resumes: int = 0


class TraceRecorder:
    """Ring-buffered lifecycle recorder. ``capacity`` bounds memory; when
    the ring wraps, ``dropped`` counts the evicted rows — conservation
    replay is only exact while ``dropped == 0``, so size the ring to the
    run (the default holds ~10 minutes of the paper-scale sim)."""

    def __init__(self, capacity: int = 1 << 18, metrics_every: int = 0):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self.metrics_every = metrics_every
        self._ring: deque = deque(maxlen=capacity)
        self.dropped = 0
        self.snapshots: List[MetricsSnapshot] = []

    # ---- recording ----
    def emit(self, kind: str, ts: float, task_id: int = -1,
             instance: str = "engine", dur: float = 0.0, **args) -> None:
        ring = self._ring
        if len(ring) == self.capacity:
            self.dropped += 1
        ring.append(TraceEvent(ts, kind, task_id, instance, dur,
                               args or _NO_ARGS))

    def push(self, kind: str, ts: float, task_id: int, instance: str,
             dur: float, args: Dict[str, Any]) -> None:
        """Positional twin of ``emit`` for the two hot recording sites
        (per-action spans in the loop, per-candidate defers in the
        scheduler): no kwargs repacking, and ``tuple.__new__`` skips the
        generated NamedTuple constructor — together these keep the traced
        run's cost low."""
        ring = self._ring
        if len(ring) == self.capacity:
            self.dropped += 1
        ring.append(tuple.__new__(TraceEvent, (ts, kind, task_id,
                                               instance, dur, args)))

    def sample(self, ts: float, instance: str, executor=None,
               scheduler=None, resident: int = 0,
               suspends: int = 0, resumes: int = 0) -> MetricsSnapshot:
        """Build + store one MetricsSnapshot from the executor's gauge
        surface (``Executor.trace_gauges``) and the scheduler's running
        defer counters."""
        gauges = executor.trace_gauges() if executor is not None else {}
        drafted = int(getattr(executor, "drafted_tokens", 0) or 0)
        accepted = int(getattr(executor, "accepted_tokens", 0) or 0)
        snap = MetricsSnapshot(
            ts=ts, instance=instance,
            pages_in_use=int(gauges.get("pages_in_use", 0)),
            states_in_use=int(gauges.get("states_in_use", 0)),
            resident=resident,
            defers_by_reason=dict(getattr(scheduler, "defers_by_reason",
                                          None) or {}),
            spec_accept_rate=(accepted / drafted) if drafted else None,
            suspends=suspends, resumes=resumes)
        self.snapshots.append(snap)
        return snap

    # ---- access ----
    @property
    def events(self) -> List[TraceEvent]:
        return list(self._ring)

    def __len__(self) -> int:
        return len(self._ring)

    def events_for(self, task_id: int) -> List[TraceEvent]:
        return [e for e in self._ring if e.task_id == task_id]

    def spans(self, instance: Optional[str] = None) -> List[TraceEvent]:
        return [e for e in self._ring if e.kind in SPAN_KINDS
                and (instance is None or e.instance == instance)]

    def instances(self) -> List[str]:
        return sorted({e.instance for e in self._ring})

    # ---- the second ledger ----
    def replay_counters(self, instance: Optional[str] = None
                        ) -> Dict[str, Any]:
        return replay_counters(self._ring, instance=instance)

    # ---- Perfetto / Chrome-trace export ----
    def export_perfetto(self, path: str) -> int:
        """Write the stream as Chrome-trace JSON: one pid ("slice"), one
        tid per serving instance (named tracks), ph="X" complete spans
        for engine operations, ph="i" instants for lifecycle points, and
        ph="s"/"t"/"f" flow arrows per request linking arrive → first
        token → finish across tracks. Returns the number of
        traceEvents written. ts unit is microseconds (Chrome convention;
        loop-clock ms * 1000)."""
        tids = {name: i + 1 for i, name in enumerate(self.instances())}
        out: List[Dict[str, Any]] = []
        out.append({"ph": "M", "name": "process_name", "pid": 0,
                    "args": {"name": "slice-serving"}})
        for name, tid in tids.items():
            out.append({"ph": "M", "name": "thread_name", "pid": 0,
                        "tid": tid, "args": {"name": name}})
        seen_arrive: Dict[int, bool] = {}
        for e in self._ring:
            tid = tids.get(e.instance, 0)
            us = e.ts * 1000.0
            args = {"task_id": e.task_id, **e.args}
            if e.kind in SPAN_KINDS:
                row = {"ph": "X", "name": e.kind, "cat": "op",
                       "ts": us, "dur": e.dur * 1000.0,
                       "pid": 0, "tid": tid, "args": args}
            else:
                row = {"ph": "i", "name": e.kind, "cat": "lifecycle",
                       "ts": us, "s": "t", "pid": 0, "tid": tid,
                       "args": args}
            out.append(row)
            # flow arrows: one chain per request over its lifecycle marks
            if e.task_id >= 0 and e.kind in ("arrive", "finish", "drop"):
                start = not seen_arrive.get(e.task_id, False)
                seen_arrive[e.task_id] = True
                out.append({"ph": "s" if start else "f", "bp": "e",
                            "id": e.task_id, "name": "request",
                            "cat": "req-flow", "ts": us, "pid": 0,
                            "tid": tid})
        with open(path, "w") as f:
            json.dump({"traceEvents": out,
                       "displayTimeUnit": "ms",
                       "otherData": {"dropped_events": self.dropped}}, f)
        return len(out)


def replay_counters(events: Sequence[TraceEvent],
                    instance: Optional[str] = None) -> Dict[str, Any]:
    """Recompute the LoopResult counters purely from the event stream —
    the conservation half of the trace contract (DESIGN.md §13). With
    ``instance`` the replay is restricted to one track; default folds
    every track (= the fleet's merged LoopResult)."""
    c: Dict[str, Any] = {
        "decode_iterations": 0, "prefills": 0, "prefill_chunks": 0,
        "suspends": 0, "resumes": 0, "spec_extra_tokens": 0,
        "defers_by_reason": {}, "finished": 0, "dropped": 0,
        "served_by_tier": {}, "served_by_instance": {},
    }
    for e in events:
        if instance is not None and e.instance != instance:
            continue
        k = e.kind
        if k == "decode":
            c["decode_iterations"] += 1
            c["spec_extra_tokens"] += int(e.args.get("spec_extra", 0))
        elif k == "prefill":
            c["prefills"] += 1
        elif k == "prefill_chunk":
            c["prefill_chunks"] += 1
            if e.args.get("done"):
                c["prefills"] += 1
        elif k == "suspend":
            if e.args.get("ok", True):
                c["suspends"] += 1
        elif k == "resume":
            if e.args.get("ok", True):
                c["resumes"] += 1
        elif k == "defer":
            r = e.args.get("reason", "time")
            c["defers_by_reason"][r] = c["defers_by_reason"].get(r, 0) + 1
        elif k == "finish":
            c["finished"] += 1
            tier = e.args.get("tier")
            if tier is not None:
                c["served_by_tier"][tier] = (
                    c["served_by_tier"].get(tier, 0) + 1)
            c["served_by_instance"][e.instance] = (
                c["served_by_instance"].get(e.instance, 0) + 1)
        elif k == "drop":
            c["dropped"] += 1
    return c


def events_conserved(events: Sequence[TraceEvent], result,
                     instance: Optional[str] = None) -> bool:
    """True iff the replayed stream reproduces ``result``'s counters
    exactly (LoopResult — or anything with the same counter fields)."""
    r = replay_counters(events, instance=instance)
    return (r["decode_iterations"] == result.decode_iterations
            and r["prefills"] == result.prefills
            and r["prefill_chunks"] == result.prefill_chunks
            and r["suspends"] == result.suspends
            and r["resumes"] == result.resumes
            and r["spec_extra_tokens"] == result.spec_extra_tokens
            and r["defers_by_reason"] == dict(result.defers_by_reason))
