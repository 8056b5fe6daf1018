"""Schedulers: SLICE (Algorithms 1-4), Orca, FastServe — one interface.

The serving loop (repro.serving.loop) drives a scheduler with:
    on_arrival(task, now) / on_finish(task, now)
    next_action(now) -> PrefillAction | DecodeAction | None
Each DecodeAction is ONE decode iteration — one token for every task in
the batch, or, with speculative depths attached (DESIGN.md §8), up to
depth+1 tokens for the tasks the SLICE depth budget accelerates —
Orca-style iteration-level scheduling for all three policies; they
differ in admission and batch composition.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Optional, Sequence

import numpy as np

from repro_torch.core.latency_model import LatencyModel
from repro_torch.core.mask_matrix import (build_mask_matrix, column_batches,
                                    mask_matrix_period_ms, quantized_rate,
                                    stagger_columns)
from repro_torch.core.selection import (PERIOD_BUDGET_MS, PageBudget,
                                  prefill_chunk_budget, select_swap_victims,
                                  spec_depth_budget, task_selection)
from repro_torch.core.task import Task

# interned defer payloads, one per reason ever seen (the taxonomy lives
# in repro.serving.trace.DEFER_REASONS; interning by string keeps this
# module free of a core -> serving import). READ-ONLY by trace contract.
_DEFER_ARGS: dict = {}


@dataclasses.dataclass
class PrefillAction:
    task: Task


@dataclasses.dataclass
class SuspendAction:
    """Swap a resident task's private KV pages to host memory (DESIGN.md
    §7) — the executor's suspend(); the serving loop flips task.suspended
    after it lands. Emitted to free device pages for a higher-priority
    admission."""
    task: Task


@dataclasses.dataclass
class ResumeAction:
    """Bring a suspended task's KV back onto the device before it decodes
    again — the executor's resume(). The restore transfer is priced into
    the cycle (LatencyModel.swap_ms), so schedulers reserve headroom for
    planned resumes."""
    task: Task


@dataclasses.dataclass
class PrefillChunkAction:
    """Process the next n_tokens of a task's prompt (DESIGN.md §5): chunked
    prefill interleaves these with decode columns so long prompts never
    stall admitted decode streams for a whole atomic prefill."""
    task: Task
    n_tokens: int


@dataclasses.dataclass
class DecodeAction:
    tasks: List[Task]
    # Per-task speculation depths (DESIGN.md §8): None = classic one-token
    # decode. With depths, the executor drafts up to depths[i] tokens per
    # task and commits the greedy-accepted prefix plus a bonus token in a
    # single iteration — the scheduler's per-request generation-rate
    # actuator.
    depths: Optional[List[int]] = None


class Scheduler:
    name = "base"
    # observability (DESIGN.md §13): wired by the serving loop's
    # InstanceDriver — a TraceRecorder (or None, the zero-overhead
    # default) and the instance name events are attributed to. Policy
    # code only OBSERVES through these; it never branches on them.
    trace = None
    trace_name = "engine"

    def note_defer(self, task: Task, now: float, reason: str) -> None:
        """Count one defer decision (reason: pages | states | time |
        batch) — always, so LoopResult.defers_by_reason is populated even
        untraced; with a recorder attached, also emit the defer event.
        Counter and event increment together, which is what makes the
        trace replay reproduce the counters exactly. Defers are by far
        the highest-rate instant under saturation (every replan marks
        every still-deferred candidate), so the payload dicts are
        interned and pushed positionally — this is what keeps the traced
        run inside the observability benchmark's 10% overhead band."""
        d = self.defers_by_reason
        d[reason] = d.get(reason, 0) + 1
        tr = self.trace
        if tr is not None:
            tr.push("defer", now, task.task_id, self.trace_name, 0.0,
                    _DEFER_ARGS.setdefault(reason, {"reason": reason}))

    def on_arrival(self, task: Task, now: float) -> None:
        raise NotImplementedError

    def on_finish(self, task: Task, now: float) -> None:
        pass

    def next_action(self, now: float):
        raise NotImplementedError

    def unfinished(self) -> int:
        raise NotImplementedError

    def withdraw(self, task: Task) -> bool:
        """Fleet spill re-routing (DESIGN.md §11): remove a queued task
        this scheduler has NOT started serving, so the fleet can hand it
        to an idle peer. Returns False when the task has engine-side
        progress here (prefilled tokens, decoded tokens, swapped KV) —
        such a task must stay where its state lives."""
        return False

    def on_idle(self, now: float) -> None:
        """Fleet-loop poke after an idle clock tick (DESIGN.md §11):
        admission can be time-dependent (deadline pruning frees Eq. 7
        capacity a blocked plan needs), so an idle instance with deferred
        work gets its clock advanced and this nudge to replan. Default:
        nothing is time-dependent."""


# --------------------------------------------------------------------- SLICE

class SliceScheduler(Scheduler):
    """SLICE-online (Algorithm 4) wrapping SLICE-offline (Algorithms 1-3).

    Arrival/completion events set a reschedule flag (the paper's eventQ);
    the next ``next_action`` call then re-runs task selection (Alg. 2),
    applies the UtilityAdaptor (preemption controller), rebuilds the
    decode-mask matrix (Alg. 3) and restarts column scanning.
    """
    name = "slice"

    def __init__(self, lat: LatencyModel, budget_ms: float = PERIOD_BUDGET_MS,
                 utility_adaptor: Optional[Callable[[Sequence[Task]], None]] = None,
                 drop_expired_realtime: bool = True,
                 stagger: bool = False, prefill_headroom: bool = True,
                 page_budget: Optional[PageBudget] = None,
                 prefill_chunk: Optional[int] = None,
                 prefix_hint: Optional[Callable[[Task], int]] = None,
                 kv_swap: bool = False,
                 spec_decode: bool = False, max_spec_depth: int = 4):
        self.lat = lat
        self.budget_ms = budget_ms
        # Speculative decoding (DESIGN.md §8): each replan prices a per-
        # cycle speculative-token budget out of the Eq. 7 headroom
        # (selection.spec_depth_budget) and hands per-request depths to
        # the lagging/realtime tasks first — depth is the scheduler's
        # generation-RATE actuator, where admission is its WHO actuator.
        # Depth 0 (plain decode) whenever headroom is tight, so the
        # delivered cycle never overruns. Spent tokens carry across
        # reschedules like the delivered credit; a fresh cycle resets.
        self.spec_decode = spec_decode
        self.max_spec_depth = max_spec_depth
        self.depth_of: dict = {}           # task_id -> granted depth
        self._spec_budget_tokens = 0
        self._spec_spent = 0
        self._seen_realtime = False
        # Host-offload KV swap (DESIGN.md §7): when PageBudget cannot admit
        # a time-feasible realtime arrival, suspend the lowest-marginal-
        # utility non-realtime residents (selection.select_swap_victims) to
        # host memory instead of deferring the arrival; suspended tasks
        # re-enter selection and are resumed — restore priced into the
        # Eq. 7 headroom — before they decode again.
        self.kv_swap = kv_swap
        self.suspend_queue: List[Task] = []
        self.resume_queue: List[Task] = []
        self._swap_blocked: set = set()    # failed suspend/resume: retry
                                           # only after a completion
        # Prefix-cache TTFT credit (DESIGN.md §6): an executor with a radix
        # prefix cache reports how many prompt tokens of a task are already
        # resident; deadline-feasibility pricing then charges only the
        # uncached prompt tail, so a cache-hit real-time task is not dropped
        # for a prefill it will never pay.
        self.prefix_hint = prefix_hint
        # Chunked prefill (DESIGN.md §5): when set, prefills are dispatched
        # as PrefillChunkAction slices of at most this many tokens,
        # interleaved with decode columns under a per-cycle token budget
        # derived from the Eq. 7 headroom (selection.prefill_chunk_budget) —
        # instead of atomically ahead of all decoding.
        self.prefill_chunk = prefill_chunk
        self._chunk_budget_tokens = 0
        self._chunk_spent_tokens = 0
        self._chunk_turn = True
        # Memory-aware admission (DESIGN.md §3 adaptation #2): when serving a
        # paged executor, selection reserves each task's peak KV pages and
        # DEFERS tasks that do not fit — the utility ordering decides who gets
        # pages under pressure, and deferred tasks re-enter at the next
        # reschedule instead of crashing the engine on pool exhaustion.
        self.page_budget = page_budget
        self.utility_adaptor = utility_adaptor
        self.drop_expired_realtime = drop_expired_realtime
        self.stagger = stagger
        # Beyond-paper: Eq. 7 budgets decode columns only, but prefills of
        # arriving tasks also consume engine time inside a cycle. Reserve
        # E[arrival rate] * E[prefill ms] of headroom so the *delivered*
        # cycle still fits 1000 ms (EXPERIMENTS.md §Perf, hypothesis P1).
        self.prefill_headroom = prefill_headroom
        self._arr_times: List[float] = []
        self._prefill_ewma: float = 0.0
        self.defers_by_reason: dict = {}    # observability (DESIGN.md §13)
        self.pool: List[Task] = []          # unscheduled, unfinished
        self.batch: List[Task] = []         # selected (sorted by rate desc)
        self.mask: Optional[np.ndarray] = None
        self.col = 0
        self.need_resched = True
        self.prefill_queue: List[Task] = []
        # per-cycle token credit: reschedules rebuild the mask from REMAINING
        # quotas so restarting the column scan never re-delivers tokens a task
        # already received this cycle (Alg. 4 restarts at column 0; without
        # credit, frequent arrivals would over-serve lax tasks and starve the
        # private tail columns of strict tasks — see EXPERIMENTS.md §Perf).
        self.delivered: dict = {}           # task_id -> tokens this cycle

    # -- events (Alg. 4 lines 7-14) --
    def on_arrival(self, task: Task, now: float) -> None:
        self.pool.append(task)
        self.need_resched = True
        if task.slo.realtime:
            self._seen_realtime = True
        self._arr_times.append(now)
        self._arr_times = self._arr_times[-32:]
        p = self.lat.prefill_ms(task.prompt_len)
        self._prefill_ewma = (0.8 * self._prefill_ewma + 0.2 * p
                              if self._prefill_ewma else p)

    def _headroom_ms(self) -> float:
        if not self.prefill_headroom or len(self._arr_times) < 4:
            return 0.0
        span = self._arr_times[-1] - self._arr_times[0]
        if span <= 0:
            return 0.0
        lam = (len(self._arr_times) - 1) / span          # arrivals per ms
        return min(0.5 * self.budget_ms,
                   lam * self._prefill_ewma * self.budget_ms)

    def on_finish(self, task: Task, now: float) -> None:
        self.need_resched = True
        self._swap_blocked.clear()         # space freed: swaps may retry

    def note_suspend_failed(self, task: Task) -> None:
        """Host arena full: the task stayed resident. Stop picking it as
        a victim (a zero-time retry loop otherwise) until a completion
        frees host or device space."""
        self._swap_blocked.add(task.task_id)
        self.need_resched = True

    def note_resume_failed(self, task: Task) -> None:
        """The executor could not re-host a suspended task (OutOfPages —
        admission under-estimated, e.g. shared pages diverged). Back it out
        of the batch; it stays suspended, blocked from resume retries
        until a completion frees pages, and re-enters selection."""
        self._swap_blocked.add(task.task_id)
        if task in self.batch:
            self.batch.remove(task)
            self.pool.append(task)
        self.need_resched = True

    def _swap_headroom_ms(self, candidates: Sequence[Task]) -> float:
        """Eq. 7 headroom for planned swap-ins (DESIGN.md §7): a suspended
        candidate that selection admits must be restored over the host link
        before it decodes, and that transfer spends cycle time exactly like
        a prefill does. Reserving the restore cost up front keeps the
        *delivered* cycle under budget, so resumes never break the mask-
        matrix TPOT guarantees. Conservative (prices every suspended
        candidate, selected or not), capped at a quarter cycle."""
        if not self.kv_swap:
            return 0.0
        cost = sum(self.lat.swap_ms(t.prompt_len + t.tokens_done)
                   for t in candidates if t.suspended)
        return min(0.25 * self.budget_ms, cost)

    def _plan_swaps(self, selected: List[Task], rest: List[Task],
                    sel_budget_ms: float) -> List[Task]:
        """Find the highest-utility realtime task that memory (not time)
        kept out of ``selected`` and pick victims whose suspension would
        admit it (selection.select_swap_victims). One starved arrival per
        replan: each suspension lands, frees its pages, and triggers a
        fresh reschedule that re-evaluates the remainder."""
        budget = self.page_budget
        rt_deferred = [t for t in rest
                       if t.slo.realtime and not t.dropped and not t.finished]
        if not rt_deferred:
            return []
        # memory-starved = a TIME-only selection would admit it. Testing
        # against the final batch instead would under-trigger: a memory-
        # deferred high-utility RT leaves time slack that later low-utility
        # tasks then fill, so the delivered batch always *looks* time-full.
        time_sel, _ = task_selection(selected + rest, self.lat, sel_budget_ms,
                                     page_budget=None)
        time_ids = {t.task_id for t in time_sel}
        starved = [t for t in rt_deferred if t.task_id in time_ids]
        if not starved:
            return []
        starved.sort(key=lambda t: (-t.utility_rate, t.arrival_ms, t.task_id))
        # pages available after every selected task grows to its reserved
        # peak — the same arithmetic task_selection charged
        if budget.free_pages_now is not None:
            free = int(budget.free_pages_now())
        else:
            free = budget.total_pages - sum(
                budget.held_for(x) for x in selected + rest)
        reserved = sum(max(0, budget.pages_for(s) - budget.held_for(s))
                       for s in selected)
        avail = free - reserved
        for t in starved:
            shortfall = (budget.pages_for(t) - budget.held_for(t)) - avail
            if shortfall <= 0:
                continue        # deferred for another reason (e.g. max_tasks)
            eligible = [x for x in selected + rest
                        if x.task_id not in self._swap_blocked]
            victims = select_swap_victims(shortfall, eligible,
                                          budget, protect=[t])
            if victims:
                return victims
        return []

    def _drop_hopeless(self, now: float) -> None:
        """Deadline-feasibility pruning (beyond-paper): a real-time task whose
        remaining tokens cannot fit in its remaining deadline budget — even at
        its full SLO rate — is already a violation; dropping it immediately
        frees cycle capacity for still-feasible tasks."""
        if not self.drop_expired_realtime:
            return
        for t in list(self.batch) + self.pool:
            if not t.slo.realtime or t.finished:
                continue
            remaining_ms = t.slo.deadline_ms - (now - t.arrival_ms)
            need_ms = (t.output_len - t.tokens_done) * t.slo.tpot_ms
            if t.tokens_done == 0:
                # chunked prefill / prefix cache: only the not-yet-cached
                # prompt tail costs
                cached = t.prefill_done_tokens
                if self.prefix_hint is not None:
                    cached = max(cached, int(self.prefix_hint(t)))
                need_ms += self.lat.prefill_ms(
                    max(0, t.prompt_len - cached))
            if need_ms > remaining_ms:
                t.dropped = True
        self.pool = [t for t in self.pool if not t.dropped]

    def _reschedule(self, now: float) -> None:
        # fold still-running unfinished tasks back into the pool (Alg. 1
        # returns them; Alg. 4 re-enters them into selection)
        live = [t for t in self.batch if not t.finished and not t.dropped]
        self.pool = [t for t in self.pool if not t.finished and not t.dropped]
        candidates = live + [t for t in self.pool if t not in live]
        if self.utility_adaptor is not None:
            self.utility_adaptor(candidates)        # Alg. 4 line 17
        self._drop_hopeless(now)
        if self.page_budget is not None:
            # a task whose peak residency can never fit the engine (seq cap
            # or whole pool) would be deferred forever — drop it visibly
            for t in candidates:
                if not t.dropped and self.page_budget.infeasible(t):
                    t.dropped = True
        candidates = [t for t in candidates if not t.dropped]
        sel_budget = (self.budget_ms - self._headroom_ms()
                      - self._swap_headroom_ms(candidates))
        defer_reasons: dict = {}
        selected, rest = task_selection(candidates, self.lat, sel_budget,
                                        page_budget=self.page_budget,
                                        reasons=defer_reasons)
        if defer_reasons:
            by_id = {t.task_id: t for t in candidates}
            for tid, reason in defer_reasons.items():
                self.note_defer(by_id[tid], now, reason)
        self.suspend_queue = []
        if self.kv_swap and self.page_budget is not None:
            victims = self._plan_swaps(selected, rest, sel_budget)
            if victims:
                vids = {v.task_id for v in victims}
                selected = [t for t in selected if t.task_id not in vids]
                rest = rest + [v for v in victims if v not in rest]
                self.suspend_queue = victims
        # suspended tasks that won admission must be re-hosted before they
        # decode; their mask rows are skipped until the resume lands
        # (resume-blocked ones wait for a completion to clear the block)
        self.resume_queue = [t for t in selected if t.suspended
                             and t.task_id not in self._swap_blocked]
        if self.trace is not None:
            # admit marks only batch ENTRIES (a task re-selected across
            # consecutive replans is one admission, not many)
            prev = {t.task_id for t in self.batch}
            for t in selected:
                if t.task_id not in prev:
                    self.trace.emit("admit", now, t.task_id,
                                    self.trace_name)
        self.batch = sorted(selected, key=lambda t: -quantized_rate(t.slo.tpot_ms))
        self.pool = rest
        live_ids = {t.task_id for t in self.batch}
        self.delivered = {k: v for k, v in self.delivered.items() if k in live_ids}
        self._build_mask(remaining=True)
        self.prefill_queue = [t for t in self.batch if t.prefill_done_ms is None]
        self.prefill_queue.sort(key=lambda t: -t.effective_utility)
        if self.prefill_chunk is not None:
            # recompute the cycle's chunk budget for the new batch; spent
            # tokens carry across reschedules (same credit philosophy as
            # ``delivered``) and reset only at a fresh cycle.
            rates = sorted((quantized_rate(t.slo.tpot_ms) for t in self.batch),
                           reverse=True)
            self._chunk_budget_tokens = prefill_chunk_budget(
                rates, self.lat, self.budget_ms, self.prefill_chunk)
        if self.spec_decode:
            self._assign_spec_depths(now)
        self.need_resched = False

    # -- speculative decoding (DESIGN.md §8) --
    def _slo_headroom_ms(self, t: Task, now: float) -> float:
        """How much schedule slack the task has before its SLO breaks —
        the Eq. 7-style pricing that ranks depth grants. Realtime: the
        deadline budget left after the remaining tokens are served at the
        SLO rate (negative = already lagging). Non-realtime: the TPOT
        margin accumulated so far, scaled over the remaining tokens."""
        remaining_toks = max(0, t.output_len - t.tokens_done)
        if t.slo.realtime and t.slo.deadline_ms is not None:
            remaining_ms = t.slo.deadline_ms - (now - t.arrival_ms)
            return remaining_ms - remaining_toks * t.slo.tpot_ms
        measured = t.tpot_measured_ms
        if measured is None:
            return float("inf")            # no evidence of lagging yet
        return (t.slo.tpot_ms - measured) * max(remaining_toks, 1)

    def _assign_spec_depths(self, now: float) -> None:
        """Grant per-request speculation depth out of the cycle's Eq. 7
        headroom. Only LAGGING tasks get depth — comfortable ones stay at
        depth 0 and donate their compute, because a speculative window
        slows its whole decode column (draft + multi-query verify premium)
        for every co-batched task, so indiscriminate grants trade everyone
        else's inter-token gaps for nothing. Realtime tasks whose deadline
        headroom has shrunk below a quarter cycle are served most-lagging
        first; non-realtime tasks speculate only in workloads where no
        realtime task has ever arrived (any realtime presence reserves the
        actuator — measured in EXPERIMENTS.md §Speculative-decoding).
        Each budget unit is one speculative token (draft + marginal
        verify, lat.spec_token_ms); a task decoding v times per cycle at
        depth d spends ~d*v units, so grants scale by the task's
        remaining per-cycle quota."""
        self.depth_of = {}
        rates = sorted((quantized_rate(t.slo.tpot_ms) for t in self.batch),
                       reverse=True)
        # chunked prefill claims Eq. 7 slack too (prefill_chunk_budget is
        # sized to the FULL slack): charge its outstanding token budget
        # against the cycle before pricing speculation, or enabling both
        # actuators would let one cycle spend ~2x the slack and overrun
        # the TPOT budget the mask matrix guarantees
        budget_ms = self.budget_ms
        if self.prefill_chunk is not None:
            outstanding = max(0, self._chunk_budget_tokens
                              - self._chunk_spent_tokens)
            budget_ms -= (outstanding * self.lat.prefill_ms(self.prefill_chunk)
                          / max(self.prefill_chunk, 1))
        self._spec_budget_tokens = spec_depth_budget(
            rates, self.lat, budget_ms, self.max_spec_depth)
        remaining = self._spec_budget_tokens - self._spec_spent
        if remaining <= 0:
            return
        if self._seen_realtime:
            # any realtime presence reserves speculation for realtime:
            # even an RT-free batch must keep its iterations fast, or the
            # next RT arrival waits out a slowed speculative column
            lagging = [t for t in self.batch if t.slo.realtime
                       and self._slo_headroom_ms(t, now)
                       < 0.25 * self.budget_ms]
        else:
            lagging = [t for t in self.batch
                       if self._slo_headroom_ms(t, now) < 0.0]
        lagging.sort(key=lambda t: self._slo_headroom_ms(t, now))
        for t in lagging:
            if remaining <= 0:
                break
            v = max(1, quantized_rate(t.slo.tpot_ms)
                    - self.delivered.get(t.task_id, 0))
            d = min(self.max_spec_depth, remaining // v,
                    max(0, t.output_len - t.tokens_done - 1))
            if d <= 0:
                continue
            self.depth_of[t.task_id] = int(d)
            remaining -= int(d) * v
            if self.trace is not None:
                self.trace.emit("spec_grant", now, t.task_id,
                                self.trace_name, depth=int(d))

    def _column_depths(self, tasks: List[Task]) -> Optional[List[int]]:
        """Depths for one decode column, spending the cycle's speculative-
        token budget; None when nothing speculates (the loop then takes
        the classic one-token path, byte-identical to pre-spec builds)."""
        if not self.depth_of:
            return None
        left = self._spec_budget_tokens - self._spec_spent
        if left <= 0:
            return None
        depths = []
        for t in tasks:
            d = min(self.depth_of.get(t.task_id, 0), left,
                    max(0, t.output_len - t.tokens_done - 1))
            left -= d
            depths.append(d)
        if not any(depths):
            return None
        self._spec_spent += sum(depths)
        return depths

    def note_decoded(self, task: Task, n: int) -> None:
        """Spec-decode feedback: the executor committed ``n`` tokens for
        this task in one iteration. The column scan already credited one;
        the extra n-1 join the cycle's delivered credit so the task's
        quota depletes faster and the rebuilt mask never over-serves it."""
        if n > 1:
            self.delivered[task.task_id] = (
                self.delivered.get(task.task_id, 0) + n - 1)

    def _build_mask(self, remaining: bool) -> None:
        """Rebuild the decode-mask matrix; with remaining=True, row quotas are
        v_i minus tokens already delivered this cycle (credit carry-over)."""
        rates = []
        for t in self.batch:
            v = quantized_rate(t.slo.tpot_ms)
            if remaining:
                v -= self.delivered.get(t.task_id, 0)
            rates.append(max(v, 0))
        order = np.argsort([-r for r in rates], kind="stable")
        self.batch = [self.batch[i] for i in order]
        rates = [rates[i] for i in order]
        rates_nz = [r for r in rates if r > 0]
        self.mask = build_mask_matrix(rates_nz) if rates_nz else None
        if self.mask is not None and self.stagger:
            cand = stagger_columns(self.mask)
            if mask_matrix_period_ms(cand, self.lat) < self.budget_ms:
                self.mask = cand
        self.col = 0

    def _new_cycle(self) -> None:
        self.delivered = {}
        self._chunk_spent_tokens = 0
        self._spec_spent = 0
        self._build_mask(remaining=False)

    def _next_decode_action(self):
        """Column scan (Alg. 3 lines 12-33); scanning past the last column
        completes the cycle and rebuilds the full-quota matrix. Tasks still
        mid-prefill (chunked mode) are skipped — they have no KV yet."""
        if not self.batch:
            return None
        if self.mask is None:       # all quotas consumed -> next cycle
            self._new_cycle()
        if self.mask is None:
            return None
        for _ in range(self.mask.shape[1] + 1):
            if self.col >= self.mask.shape[1]:
                self._new_cycle()
                if self.mask is None:
                    return None
            rows = np.nonzero(self.mask[:, self.col])[0]
            self.col += 1
            tasks = [self.batch[r] for r in rows
                     if not self.batch[r].finished
                     and not self.batch[r].suspended
                     and self.batch[r].prefill_done_ms is not None]
            if tasks:
                for t in tasks:
                    self.delivered[t.task_id] = self.delivered.get(t.task_id, 0) + 1
                if self.spec_decode:
                    return DecodeAction(tasks, self._column_depths(tasks))
                return DecodeAction(tasks)
        return None

    def _prune_prefill_queue(self) -> None:
        self.prefill_queue = [t for t in self.prefill_queue
                              if t.prefill_done_ms is None and not t.dropped]

    def _make_chunk_action(self) -> PrefillChunkAction:
        t = self.prefill_queue[0]
        remaining = max(1, t.prompt_len - t.prefill_done_tokens)
        n = min(self.prefill_chunk, remaining)
        self._chunk_spent_tokens += n
        return PrefillChunkAction(t, n)

    def next_action(self, now: float):
        if self.need_resched:
            self._reschedule(now)
        if self.suspend_queue:
            # one suspension per plan: when it lands the loop comes back
            # here, the replan sees the freed pages and re-evaluates
            t = self.suspend_queue.pop(0)
            self.need_resched = True
            return SuspendAction(t)
        while self.resume_queue:
            t = self.resume_queue.pop(0)
            if t.suspended and not t.dropped and not t.finished:
                return ResumeAction(t)
        if self.prefill_chunk is None:
            # atomic prefill: drain the whole queue ahead of any decode —
            # the head-of-line blocking mode chunked prefill exists to avoid
            if self.prefill_queue:
                return PrefillAction(self.prefill_queue.pop(0))
            return self._next_decode_action()
        # chunked prefill: alternate chunks with decode columns while the
        # Eq. 7 headroom budget lasts; an idle engine prefills regardless
        # (unclaimed slack costs nothing).
        self._prune_prefill_queue()
        want_chunk = bool(self.prefill_queue)
        have_budget = self._chunk_spent_tokens < self._chunk_budget_tokens
        if want_chunk and have_budget and self._chunk_turn:
            self._chunk_turn = False
            return self._make_chunk_action()
        act = self._next_decode_action()
        if act is not None:
            self._chunk_turn = True
            return act
        if want_chunk:
            return self._make_chunk_action()
        return None

    def withdraw(self, task: Task) -> bool:
        if (task.prefill_done_tokens > 0 or task.tokens_done > 0
                or task.suspended):
            return False
        removed = False
        if task in self.pool:
            self.pool.remove(task)
            removed = True
        if task in self.batch:
            self.batch.remove(task)
            removed = True
        if not removed:
            return False
        for q in (self.prefill_queue, self.suspend_queue, self.resume_queue):
            if task in q:
                q.remove(task)
        self.delivered.pop(task.task_id, None)
        self.depth_of.pop(task.task_id, None)
        self.need_resched = True           # mask row is gone: rebuild
        return True

    def unfinished(self) -> int:
        return sum(1 for t in self.batch + self.pool
                   if not t.finished and not t.dropped)

    def on_idle(self, now: float) -> None:
        """A later ``now`` can unblock a plan that admitted nothing: the
        greedy selection prefix stalls behind an alone-infeasible realtime
        head task until _drop_hopeless prunes it at its deadline."""
        self.need_resched = True


def sjf_decay_adaptor(half_life_tokens: float = 64.0):
    """Preemption-controller example (paper §IV-E): decay utility of tasks
    that have already produced many tokens -> long jobs lose admission to
    newcomers, mimicking SJF and avoiding head-of-line blocking."""
    def adapt(tasks: Sequence[Task]) -> None:
        for t in tasks:
            t.effective_utility = t.utility * 0.5 ** (t.tokens_done / half_life_tokens)
    return adapt


# ---------------------------------------------------------------------- Orca

class OrcaScheduler(Scheduler):
    """Orca: FCFS admission + iteration-level dynamic batching. Every admitted
    task joins every decode iteration (the paper's 'coarse-grained' batching).
    """
    name = "orca"

    def __init__(self, max_batch: int = 32):
        self.max_batch = max_batch
        self.defers_by_reason: dict = {}    # observability (DESIGN.md §13)
        self.waiting: List[Task] = []
        self.running: List[Task] = []

    def on_arrival(self, task: Task, now: float) -> None:
        self.waiting.append(task)

    def on_finish(self, task: Task, now: float) -> None:
        if task in self.running:
            self.running.remove(task)

    def next_action(self, now: float):
        self.running = [t for t in self.running if not t.finished]
        if self.waiting and len(self.running) < self.max_batch:
            return PrefillAction(self.waiting.pop(0))  # FCFS
        if self.waiting:
            # head blocked behind the batch cap for this iteration
            self.note_defer(self.waiting[0], now, "batch")
        if self.running:
            return DecodeAction(list(self.running))
        return None

    def note_prefilled(self, task: Task) -> None:
        self.running.append(task)

    def withdraw(self, task: Task) -> bool:
        if task in self.waiting and task.tokens_done == 0:
            self.waiting.remove(task)
            return True
        return False

    def unfinished(self) -> int:
        return len(self.waiting) + sum(1 for t in self.running if not t.finished)


# ----------------------------------------------------------------- FastServe

class FastServeScheduler(Scheduler):
    """FastServe: skip-join MLFQ with iteration-level preemption.

    Tasks enter the queue whose quantum covers their prompt length (skip-join)
    and are demoted once they exceed the current queue's token quantum. Each
    iteration decodes the top max_batch tasks by (queue priority, arrival) —
    under edge loads this merges everything into one batch, reproducing the
    paper's observation that FastServe == Orca there.

    With ``page_budget`` + ``kv_swap=True`` this is the *faithful* FastServe
    (§5.2 of its paper): proactive KV swapping to host memory. A new arrival
    whose pages do not fit triggers swap-out of the lowest-priority resident
    — most-demoted queue first, youngest within a queue — and suspended
    tasks are swapped back in by MLFQ priority as soon as pages allow.
    Without ``kv_swap`` the arrival simply waits (defer-only baseline).
    """
    name = "fastserve"

    def __init__(self, max_batch: int = 32, n_queues: int = 4,
                 base_quantum: int = 16,
                 page_budget: Optional[PageBudget] = None,
                 kv_swap: bool = False):
        self.max_batch = max_batch
        self.n_queues = n_queues
        self.base_quantum = base_quantum
        self.page_budget = page_budget
        self.kv_swap = kv_swap
        self.defers_by_reason: dict = {}    # observability (DESIGN.md §13)
        self.waiting: List[Task] = []
        self.running: List[Task] = []      # prefilled, unfinished (may be
                                           # suspended — excluded from decode)
        self.queue_of = {}                 # task_id -> queue index
        self.tokens_in_queue = {}          # task_id -> tokens since demotion
        self._swap_blocked: set = set()    # failed suspend/resume: retry
                                           # only after a completion

    def _quantum(self, q: int) -> int:
        return self.base_quantum * (2 ** q)

    def _skip_join_queue(self, task: Task) -> int:
        q = 0
        while q < self.n_queues - 1 and task.prompt_len > self._quantum(q):
            q += 1
        return q

    def on_arrival(self, task: Task, now: float) -> None:
        self.waiting.append(task)

    def on_finish(self, task: Task, now: float) -> None:
        if task in self.running:
            self.running.remove(task)
        # MLFQ bookkeeping dies with the task, or queue_of/tokens_in_queue
        # grow without bound across a long serving run
        self.queue_of.pop(task.task_id, None)
        self.tokens_in_queue.pop(task.task_id, None)
        self._swap_blocked.clear()         # space freed: swaps may retry

    def note_prefilled(self, task: Task) -> None:
        self.running.append(task)
        self.queue_of[task.task_id] = self._skip_join_queue(task)
        self.tokens_in_queue[task.task_id] = 0

    def _priority(self, t: Task):
        return (self.queue_of[t.task_id], t.arrival_ms, t.task_id)

    def _prune(self) -> None:
        for t in self.running:
            if t.dropped:                  # dropped mid-run: same cleanup
                self.queue_of.pop(t.task_id, None)
                self.tokens_in_queue.pop(t.task_id, None)
        self.running = [t for t in self.running
                        if not t.finished and not t.dropped]
        self.waiting = [t for t in self.waiting if not t.dropped]

    def _charge(self, t: Task) -> int:
        """Pages a resident is charged for: its PEAK reservation while
        active (a decoding task grows into it — charging current holdings
        would over-promise the pool and crash the engine mid-decode, the
        same rule selection.py applies for SLICE), its current (shared)
        holdings while suspended (it cannot grow until resumed)."""
        b = self.page_budget
        if t.suspended:
            return b.held_for(t)
        return max(b.pages_for(t), b.held_for(t))

    def _free_pages(self) -> int:
        return self.page_budget.total_pages - sum(
            self._charge(t) for t in self.running)

    def _fits(self, task: Task) -> bool:
        need = self.page_budget.pages_for(task) - self.page_budget.held_for(task)
        return need <= self._free_pages()

    def _swap_action(self):
        """Proactive swap (kv_swap=True): make room for the waiting head by
        suspending the lowest-priority resident, but only when the
        residents' pages can actually cover the head — otherwise suspending
        would thrash the host link without ever admitting it."""
        head = self.waiting[0]
        evictable = sorted(
            [t for t in self.running
             if not t.suspended and self.page_budget.held_for(t) > 0
             and t.task_id not in self._swap_blocked],
            key=self._priority, reverse=True)   # most-demoted, youngest first
        coverable = self._free_pages() + sum(
            self._charge(t) for t in evictable)
        if not evictable or coverable < self.page_budget.pages_for(head):
            return None
        return SuspendAction(evictable[0])

    def _resume_action(self):
        """Swap suspended tasks back in by MLFQ priority once pages allow."""
        suspended = sorted([t for t in self.running
                            if t.suspended
                            and t.task_id not in self._swap_blocked],
                           key=self._priority)
        for t in suspended:
            need = (self.page_budget.pages_for(t)
                    - self.page_budget.held_for(t))
            if need <= self._free_pages():
                return ResumeAction(t)
        return None

    def note_suspend_failed(self, task: Task) -> None:
        """Host arena full: the task stayed resident. Stop proposing it
        (and retrying in a zero-time loop) until a completion frees host
        or device space."""
        self._swap_blocked.add(task.task_id)

    def note_resume_failed(self, task: Task) -> None:
        """Pool rejected the swap-in (accounting raced, e.g. prefix pins):
        the task stays suspended; stop retrying until a finish frees pages."""
        self._swap_blocked.add(task.task_id)

    def note_decoded(self, task: Task, n: int) -> None:
        """k-tokens-per-iteration generalization (DESIGN.md §8): MLFQ
        quantum accounting charges every committed token, not every
        iteration — next_action already charged one, the extra n-1 land
        here (demotion itself is re-checked on the next action)."""
        if n > 1 and task.task_id in self.tokens_in_queue:
            self.tokens_in_queue[task.task_id] += n - 1

    def next_action(self, now: float):
        self._prune()
        if self.waiting:
            if self.page_budget is None or self._fits(self.waiting[0]):
                return PrefillAction(self.waiting.pop(0))
            if self.kv_swap:
                act = self._swap_action()
                if act is not None:
                    return act
            # defer-only (or swap cannot help): decode what is resident
            self.note_defer(self.waiting[0], now, "pages")
        if self.page_budget is not None and self.kv_swap:
            act = self._resume_action()
            if act is not None and not self.waiting:
                return act
        active = [t for t in self.running if not t.suspended]
        if not active:
            return None
        batch = sorted(active, key=self._priority)[: self.max_batch]
        for t in batch:  # quantum accounting + demotion
            tid = t.task_id
            self.tokens_in_queue[tid] += 1
            if (self.tokens_in_queue[tid] >= self._quantum(self.queue_of[tid])
                    and self.queue_of[tid] < self.n_queues - 1):
                self.queue_of[tid] += 1
                self.tokens_in_queue[tid] = 0
        return DecodeAction(batch)

    def withdraw(self, task: Task) -> bool:
        if task in self.waiting and task.tokens_done == 0:
            self.waiting.remove(task)
            return True
        return False

    def unfinished(self) -> int:
        return len(self.waiting) + sum(1 for t in self.running if not t.finished)
