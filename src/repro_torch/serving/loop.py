"""Discrete-event serving loop driving (scheduler, executor) over a workload.

Time semantics: operations (a whole prefill, one prefill chunk, one decode
iteration) are atomic; arrivals landing inside an operation are delivered
when it completes (iteration-granular interruption, matching the paper's
implementation). The first output token is emitted at prefill completion —
for chunked prefill (DESIGN.md §5) that is the FINAL chunk's completion, so
TTFT accounting is identical across atomic and chunked paths.

Host-offload KV swap (DESIGN.md §7): SuspendAction/ResumeAction move a
task's KV between device and host through the executor; the loop flips
``Task.suspended`` only after the transfer actually lands, counts both
directions, and reports the executor's total swapped bytes in LoopResult.

Speculative decoding (DESIGN.md §8): a DecodeAction carrying per-task
``depths`` commits 1..depth+1 tokens per task in one iteration — every
committed token lands at the iteration's completion (burst delivery),
the scheduler's per-cycle credit learns about the extras through
``note_decoded``, and LoopResult reports the extra/drafted/accepted
token counts. With ``depths=None`` the classic one-token path runs
byte-identically.

Async pipelining (DESIGN.md §10): an executor exposing ``gap_stats`` gets
its host/device gap breakdown (schedule/dispatch/wait/swap-overlap ms)
measured per run and surfaced in LoopResult (in the synchronous torch
engine ``wait_ms`` is each op's own clock, not a wait: see
``serving.pipeline``). Under ``async_dispatch`` the
executor returns dispatch-only times, so the loop folds each commit's
blocked time into ``now`` as it lands (exactly once — tracked by a
wait-ms watermark) and drains the pipeline before reporting, keeping
end_ms meaningful while the policy-visible event ORDER stays identical
to the sync engine's.

Fleet serving (DESIGN.md §11): the per-instance half of the loop lives in
``InstanceDriver`` — clock, action execution, wait folding, drop release —
so ``run_serving_loop`` (one driver, the single-model path, byte-identical
to the pre-fleet loop) and ``repro.serving.fleet.run_fleet_loop`` (N
drivers advanced lowest-clock-first, like N concurrent edge devices) share
one cycle engine. ``merge_results`` folds per-instance LoopResults into a
fleet-wide one.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence

from repro_torch.core.schedulers import (DecodeAction, PrefillAction,
                                   PrefillChunkAction, ResumeAction,
                                   Scheduler, SuspendAction)
from repro_torch.core.task import Task
from repro_torch.serving.executor import Executor
from repro_torch.serving.kv_pool import OutOfPages
from repro_torch.serving.kv_swap import HostArenaFull


@dataclasses.dataclass
class LoopResult:
    tasks: List[Task]
    end_ms: float
    decode_iterations: int
    prefills: int
    prefill_chunks: int = 0
    # host-offload KV swap accounting (DESIGN.md §7): executed transfers
    # and the executor's total bytes moved over the host link (both
    # directions) — surfaced in benchmark JSON (benchmarks/kv_swap.py)
    suspends: int = 0
    resumes: int = 0
    swapped_bytes: float = 0.0
    # speculative decoding (DESIGN.md §8): tokens committed BEYOND the one
    # per task per iteration of classic decode, plus the executor's raw
    # draft/accept counters — surfaced in benchmark JSON
    # (benchmarks/spec_decode.py)
    spec_extra_tokens: int = 0
    drafted_tokens: int = 0
    accepted_tokens: int = 0
    # host/device gap breakdown (DESIGN.md §10): host replanning, host
    # dispatch work, host blocked on device results, and transfer time
    # overlapped on the background swap worker — deltas over this run,
    # from the executor's GapStats (all 0.0 for executors without one).
    # In the port's synchronous engine wait_ms is each op's own clock,
    # not a wait, and its staging before that clock is in no field here
    # (a traced span's stage_ms holds it; pipeline.py's docstring).
    # Timing floats: excluded from the sync/async equivalence contract.
    schedule_ms: float = 0.0
    dispatch_ms: float = 0.0
    wait_ms: float = 0.0
    swap_overlap_ms: float = 0.0
    pipeline_stalls: int = 0
    # observability (DESIGN.md §13): defer decisions by cause
    # (pages | states | time | batch | tier), counted by the scheduler on
    # every replan whether or not a TraceRecorder is attached — the fleet
    # layer folds degraded down-tier routings in as "tier".
    defers_by_reason: Dict[str, int] = dataclasses.field(default_factory=dict)


class InstanceDriver:
    """One (scheduler, executor) pair's share of the serving loop: the
    instance clock, action execution, drop release, and async wait folding.

    ``step()`` runs exactly one scheduler action (returning False when the
    scheduler is idle); arrival delivery stays with the caller — the
    single-model loop delivers from one sorted stream, the fleet loop
    routes each arrival to a driver first (DESIGN.md §11). The body of
    ``step()`` is the pre-fleet loop body verbatim, so the single-driver
    path stays byte-identical to it."""

    def __init__(self, scheduler: Scheduler, executor: Executor,
                 trace=None, name: str = "engine"):
        self.scheduler = scheduler
        self.executor = executor
        # observability (DESIGN.md §13): an optional TraceRecorder shared
        # by every layer of this instance. The driver wires it into the
        # scheduler (defer/admit/spec_grant emission) and stamps every
        # event on the LOOP clock — under async dispatch, spans are
        # emitted AFTER fold_wait() so their timestamps are commit-time
        # and stay causal. trace=None is the zero-overhead default.
        self.trace = trace
        self.name = name
        self.steps = 0
        self.now = 0.0
        # an engine with ``attach_trace`` (the paged torch engine) times
        # its ops' phases once traced: the driver emits its set-up so far
        # as one ``engine_setup`` instant, and adds each op's phases
        # (``last_phases``) to its action's span. A method call, so that a
        # wrapper forwarding attribute reads reaches the engine.
        if trace is not None:
            scheduler.trace = trace
            scheduler.trace_name = name
            attach = getattr(executor, "attach_trace", None)
            if attach is not None:
                trace.emit("engine_setup", self.now, -1, name, **attach())
        self.n_decode = 0
        self.n_prefill = 0
        self.n_chunks = 0
        self.n_suspend = 0
        self.n_resume = 0
        self.n_spec_extra = 0
        self.tracked: List[Task] = []  # delivered, not finished/dropped yet
        # host/device gap accounting (DESIGN.md §10): report per-RUN deltas
        # of the executor's GapStats; under async dispatch, fold commit
        # waits into the clock exactly once via the wait-ms watermark
        # (executor ops return dispatch-only times there).
        self.stats = getattr(executor, "gap_stats", None)
        self.async_mode = bool(getattr(executor, "async_dispatch", False))
        self.base = self.stats.as_dict() if self.stats is not None else None
        self.wait_seen = self.base["wait_ms"] if self.base is not None else 0.0

    def fold_wait(self) -> None:
        if self.stats is None or not self.async_mode:
            return
        d = self.stats.wait_ms - self.wait_seen
        if d > 0:
            self.now += d
        self.wait_seen = self.stats.wait_ms

    def deliver(self, task: Task) -> None:
        self.scheduler.on_arrival(task, now=max(self.now, task.arrival_ms))
        self.tracked.append(task)
        if self.trace is not None:
            self.trace.emit("arrive", max(self.now, task.arrival_ms),
                            task.task_id, self.name, task_kind=task.kind,
                            realtime=task.slo.realtime)

    def _finish(self, t: Task) -> None:
        """Finish path shared by every action branch: scheduler callback,
        KV release, and (when tracing) the lifecycle finish mark."""
        self.scheduler.on_finish(t, self.now)
        self.executor.release(t)
        if self.trace is not None:
            self.trace.emit("finish", self.now, t.task_id, self.name,
                            tier=t.served_tier, ok=t.slo_met())

    def release_dropped(self) -> None:
        # dropped tasks never reach the finish path below, so their KV
        # (slots or pages) must be reclaimed here or it leaks for the rest
        # of the run — and memory-aware admission would over-promise.
        still = []
        for t in self.tracked:
            if t.dropped:
                self.executor.release(t)
                if self.trace is not None:
                    self.trace.emit("drop", self.now, t.task_id, self.name)
            elif not t.finished:
                still.append(t)
        self.tracked[:] = still

    def live_tasks(self) -> List[Task]:
        """Delivered tasks still in flight here — the routing view's load."""
        return [t for t in self.tracked if not t.finished and not t.dropped]

    def step(self) -> bool:
        """Run one scheduler action; False when the scheduler is idle
        (nothing executed, clock untouched — the caller decides whether
        to jump to the next arrival, spill work in, or stop)."""
        scheduler, executor = self.scheduler, self.executor
        tr = self.trace
        g0 = (self.stats.as_dict()
              if (tr is not None and self.stats is not None) else None)
        t_sched = time.perf_counter()
        action = scheduler.next_action(self.now)  # may drop (reschedule)
        if self.stats is not None:
            self.stats.schedule_ms += (time.perf_counter() - t_sched) * 1000.0
        self.release_dropped()
        if action is None:
            return False
        t0 = self.now
        ev = None  # (kind, task_id, args) when tracing; span emitted at end
        if isinstance(action, PrefillAction):
            t = action.task
            ms = executor.prefill(t)
            self.now += ms
            t.prefill_done_tokens = t.prompt_len
            t.prefill_done_ms = self.now
            t.token_times_ms.append(self.now)  # first token at prefill end
            self.n_prefill += 1
            if tr is not None:
                ev = ("prefill", t.task_id, {"tokens": t.prompt_len})
            if hasattr(scheduler, "note_prefilled"):
                scheduler.note_prefilled(t)
            if t.finished:
                self._finish(t)
        elif isinstance(action, PrefillChunkAction):
            t = action.task
            ms, done = executor.prefill_chunk(t, action.n_tokens)
            self.now += ms
            self.n_chunks += 1
            t.prefill_done_tokens = min(t.prompt_len,
                                        t.prefill_done_tokens + action.n_tokens)
            # prefix-cache credit (DESIGN.md §6): an executor that skipped
            # cached prefix chunks reports the larger true progress, so
            # the scheduler stops scheduling chunks the cache already paid
            prog = getattr(executor, "prompt_progress", None)
            if prog is not None:
                t.prefill_done_tokens = max(t.prefill_done_tokens,
                                            min(t.prompt_len, int(prog(t))))
            if tr is not None:
                ev = ("prefill_chunk", t.task_id,
                      {"n": action.n_tokens, "done": bool(done)})
            if done:
                # first token at FINAL chunk completion (TTFT convention)
                t.prefill_done_tokens = t.prompt_len
                t.prefill_done_ms = self.now
                t.token_times_ms.append(self.now)
                self.n_prefill += 1
                if hasattr(scheduler, "note_prefilled"):
                    scheduler.note_prefilled(t)
                if t.finished:
                    self._finish(t)
        elif isinstance(action, SuspendAction):
            # KV to host (DESIGN.md §7); the flag flips only once the
            # executor's transfer actually lands
            t = action.task
            try:
                ms = executor.suspend(t)
            except HostArenaFull:
                # executor rolled the swap back: the task stays resident;
                # the scheduler must stop proposing it (or any victim)
                # until a completion frees space
                if hasattr(scheduler, "note_suspend_failed"):
                    scheduler.note_suspend_failed(t)
                else:
                    raise
                if tr is not None:
                    ev = ("suspend", t.task_id, {"ok": False})
            else:
                self.now += ms
                t.suspended = True
                self.n_suspend += 1
                if tr is not None:
                    ev = ("suspend", t.task_id, {"ok": True})
        elif isinstance(action, ResumeAction):
            t = action.task
            try:
                ms = executor.resume(t)
            except OutOfPages:
                # pool cannot re-host it right now: the task stays
                # suspended; the scheduler backs it out and replans
                if hasattr(scheduler, "note_resume_failed"):
                    scheduler.note_resume_failed(t)
                else:
                    raise
                if tr is not None:
                    ev = ("resume", t.task_id, {"ok": False})
            else:
                self.now += ms
                t.suspended = False
                self.n_resume += 1
                if tr is not None:
                    ev = ("resume", t.task_id, {"ok": True})
        elif isinstance(action, DecodeAction):
            if action.depths is not None:
                # speculative iteration (DESIGN.md §8): the executor
                # commits 1..depth+1 tokens per task (greedy-accepted
                # drafts + bonus); every committed token lands at the
                # iteration's completion time (burst delivery), and the
                # scheduler's per-cycle credit is told about the extras
                ms = executor.decode(action.tasks, action.depths)
                self.now += ms
                self.n_decode += 1
                pre_extra = self.n_spec_extra
                commits = list(getattr(executor, "last_commits", None)
                               or [1] * len(action.tasks))
                for t, c in zip(action.tasks, commits):
                    c = max(1, min(c, t.output_len - t.tokens_done))
                    t.token_times_ms.extend([self.now] * c)
                    self.n_spec_extra += c - 1
                    if c > 1 and hasattr(scheduler, "note_decoded"):
                        scheduler.note_decoded(t, c)
                    if t.finished:
                        self._finish(t)
                if tr is not None:
                    ev = ("decode", -1,
                          {"n": len(action.tasks),
                           "depth": max(action.depths),
                           "spec_extra": self.n_spec_extra - pre_extra})
            else:
                ms = executor.decode(action.tasks)
                self.now += ms
                self.n_decode += 1
                for t in action.tasks:
                    t.token_times_ms.append(self.now)
                    if t.finished:
                        self._finish(t)
                if tr is not None:
                    ev = ("decode", -1,
                          {"n": len(action.tasks), "depth": 0,
                           "spec_extra": 0})
        self.fold_wait()
        if tr is not None:
            if ev is not None:
                kind, tid, args = ev
                if g0 is not None:
                    # host/device gap deltas measured across this action
                    # (schedule time included — g0 precedes next_action)
                    end = self.stats.as_dict()
                    for k in ("schedule_ms", "dispatch_ms", "wait_ms",
                              "swap_overlap_ms"):
                        args[k] = end[k] - g0[k]
                # the op's phases (PagedTorchExecutor.last_phases):
                # stage_ms + graph_ms + gaps_ms + commit_ms is its host
                # time from entry to return
                ph = getattr(executor, "last_phases", None)
                if ph is not None:
                    args.update(ph)
                # span starts at the pre-action clock; under async dispatch
                # the folded commit wait is inside dur, so spans on one
                # track stay monotonic and non-overlapping
                tr.push(kind, t0, tid, self.name, self.now - t0, args)
            self.steps += 1
            if tr.metrics_every and self.steps % tr.metrics_every == 0:
                tr.sample(self.now, self.name, executor=self.executor,
                          scheduler=self.scheduler,
                          resident=len(self.live_tasks()),
                          suspends=self.n_suspend, resumes=self.n_resume)
        return True

    def drain(self) -> None:
        d = getattr(self.executor, "drain", None)
        if d is not None:          # commit in-flight steps + background swaps
            d()
            self.fold_wait()

    def result(self, tasks: List[Task]) -> LoopResult:
        """LoopResult over ``tasks`` — the caller decides attribution: the
        whole workload for the single-model loop, the tasks this instance
        served for the fleet (each request exactly once fleet-wide)."""
        gaps = {}
        stalls = 0
        if self.stats is not None:
            end = self.stats.as_dict()
            gaps = {k: end[k] - self.base[k] for k in
                    ("schedule_ms", "dispatch_ms", "wait_ms",
                     "swap_overlap_ms")}
            stalls = int(end["stalls"] - self.base["stalls"])
        return LoopResult(tasks=tasks, end_ms=self.now,
                          decode_iterations=self.n_decode,
                          prefills=self.n_prefill,
                          prefill_chunks=self.n_chunks,
                          suspends=self.n_suspend, resumes=self.n_resume,
                          swapped_bytes=float(getattr(self.executor,
                                                      "swapped_bytes", 0.0)),
                          spec_extra_tokens=self.n_spec_extra,
                          drafted_tokens=int(getattr(self.executor,
                                                     "drafted_tokens", 0)),
                          accepted_tokens=int(getattr(self.executor,
                                                      "accepted_tokens", 0)),
                          schedule_ms=gaps.get("schedule_ms", 0.0),
                          dispatch_ms=gaps.get("dispatch_ms", 0.0),
                          wait_ms=gaps.get("wait_ms", 0.0),
                          swap_overlap_ms=gaps.get("swap_overlap_ms", 0.0),
                          pipeline_stalls=stalls,
                          defers_by_reason=dict(
                              getattr(self.scheduler, "defers_by_reason",
                                      None) or {}))


def merge_results(per_instance: Dict[str, LoopResult]) -> LoopResult:
    """Fold per-instance LoopResults into one fleet-wide result: counters
    sum, the clock is the latest instance's (instances run concurrently),
    and task lists concatenate — each request appears in exactly ONE
    per-instance result (attributed to the instance that served it), so
    the merge never double-counts a spill-routed request."""
    results = list(per_instance.values())
    if not results:
        return LoopResult(tasks=[], end_ms=0.0, decode_iterations=0,
                          prefills=0)
    defers: Dict[str, int] = {}
    for r in results:
        for k, v in r.defers_by_reason.items():
            defers[k] = defers.get(k, 0) + v
    return LoopResult(
        tasks=[t for r in results for t in r.tasks],
        end_ms=max(r.end_ms for r in results),
        decode_iterations=sum(r.decode_iterations for r in results),
        prefills=sum(r.prefills for r in results),
        prefill_chunks=sum(r.prefill_chunks for r in results),
        suspends=sum(r.suspends for r in results),
        resumes=sum(r.resumes for r in results),
        swapped_bytes=sum(r.swapped_bytes for r in results),
        spec_extra_tokens=sum(r.spec_extra_tokens for r in results),
        drafted_tokens=sum(r.drafted_tokens for r in results),
        accepted_tokens=sum(r.accepted_tokens for r in results),
        schedule_ms=sum(r.schedule_ms for r in results),
        dispatch_ms=sum(r.dispatch_ms for r in results),
        wait_ms=sum(r.wait_ms for r in results),
        swap_overlap_ms=sum(r.swap_overlap_ms for r in results),
        pipeline_stalls=sum(r.pipeline_stalls for r in results),
        defers_by_reason=defers)


def run_serving_loop(scheduler: Scheduler, executor: Executor,
                     workload: Sequence[Task], max_ms: float = 600_000.0,
                     idle_gas: int = 10_000_000,
                     trace=None) -> LoopResult:
    arrivals = sorted(workload, key=lambda t: (t.arrival_ms, t.task_id))
    i = 0
    drv = InstanceDriver(scheduler, executor, trace=trace)
    gas = idle_gas

    def deliver_arrivals(upto: float) -> None:
        nonlocal i
        while i < len(arrivals) and arrivals[i].arrival_ms <= upto:
            drv.deliver(arrivals[i])
            i += 1

    deliver_arrivals(0.0)
    while drv.now < max_ms:
        gas -= 1
        if gas <= 0:
            raise RuntimeError("serving loop did not converge")
        if not drv.step():
            if i < len(arrivals):            # idle -> jump to next arrival
                drv.now = max(drv.now, arrivals[i].arrival_ms)
                deliver_arrivals(drv.now)
                continue
            break                            # drained
        deliver_arrivals(drv.now)
    drv.drain()
    return drv.result(list(arrivals))
