"""Task selection (paper §IV-C, Algorithm 2): utility-rate greedy admission
under the 1000 ms cycle-period capacity test (Eq. 7), optionally joined by a
KV page-pool capacity test (beyond-paper, DESIGN.md §3 adaptation #2).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.latency_model import LatencyModel
from repro_torch.core.mask_matrix import estimate_period_ms, quantized_rate
from repro_torch.core.task import Task

PERIOD_BUDGET_MS = 1000.0


@dataclasses.dataclass(frozen=True)
class PageBudget:
    """Memory-side admission constraint: the executor's KV arena holds
    ``total_pages`` pages of ``page_size`` tokens each; a task's peak KV
    residency is its (capped) prompt plus every output token. A slot-array
    executor is the degenerate budget with page_size == max_seq, so both
    layouts flow through the same admission math (EXPERIMENTS.md §KV-paging).

    ``held_pages`` (optional, supplied by the executor) reports pages a task
    holds RIGHT NOW: a running task that loses admission keeps its pages
    until it finishes, so selection must count those holdings or it would
    over-promise the pool and crash the engine mid-decode.

    The latency model's memory ceiling (latency_model.py:112: decode on big
    hosts is bounded by HBM residency, not per-step latency growth) becomes a
    live constraint here instead of a comment.

    Prefix sharing (DESIGN.md §6) adds two optional callables:

    ``free_pages_now`` — pages available for new allocations RIGHT NOW:
    the pool's free list plus pages the radix prefix cache could reclaim
    (pinned by the index only, no running owner). When present, selection
    charges each admission against this live count instead of the static
    ``total_pages``-minus-holdings arithmetic.

    ``prefix_pages`` — ``(prefix_key, n_pages)`` for a task: the identity
    and page count of its shareable page-aligned prompt prefix (key None
    when it has none). Selection counts each distinct prefix ONCE per
    round: the first admitted task with a key pays its prefix pages (a
    fresh compute, or re-pinning reclaimable cached pages — either way
    they come out of ``free_pages_now``); every later admission with the
    same key rides the same physical pages for free. That is what lets
    utility admission see the true headroom of a shared-system-prompt
    workload and admit more residents.
    """
    total_pages: int
    page_size: int
    prompt_cap: Optional[int] = None   # executor truncates prompts to this
    seq_cap: Optional[int] = None      # executor's hard per-task token limit
    max_tasks: Optional[int] = None    # executor's compiled max decode batch
    held_pages: Optional[object] = None  # Callable[[Task], int]
    free_pages_now: Optional[object] = None  # Callable[[], int]
    prefix_pages: Optional[object] = None    # Callable[[Task], (key, int)]

    def peak_tokens(self, task: Task) -> int:
        p = task.prompt_len if self.prompt_cap is None else min(
            task.prompt_len, self.prompt_cap)
        return p + task.output_len

    def pages_for(self, task: Task) -> int:
        return max(1, math.ceil(self.peak_tokens(task) / self.page_size))

    def held_for(self, task: Task) -> int:
        return int(self.held_pages(task)) if self.held_pages else 0

    def prefix_for(self, task: Task):
        """(prefix_key, prefix_pages) — (None, 0) without sharing."""
        if self.prefix_pages is None:
            return None, 0
        key, n = self.prefix_pages(task)
        return key, int(n)

    def infeasible(self, task: Task) -> bool:
        """Task can NEVER run on this executor: its peak residency exceeds
        the per-task sequence cap or the whole pool. Deferring it would be
        silent starvation; the scheduler drops it visibly instead."""
        if self.seq_cap is not None and self.peak_tokens(task) > self.seq_cap:
            return True
        return self.pages_for(task) > self.total_pages

    def fits(self, tasks: Sequence[Task]) -> bool:
        return sum(self.pages_for(t) for t in tasks) <= self.total_pages


@dataclasses.dataclass(frozen=True)
class StateBudget(PageBudget):
    """``PageBudget`` joined by the recurrent-state slot constraint of
    SSM/hybrid architectures (DESIGN.md §12): every resident task pins ONE
    constant-size state slot (the per-layer ``[H, P, N]`` SSD state plus
    conv tail) in addition to its KV pages, so admission must clear BOTH
    headrooms — a mamba2 engine with free pages but no free slot is just
    as full as one out of pages. Pure-SSM archs have zero-width KV pages
    (``page_bytes == 0``); their page ledger still enforces seq_cap and
    the pool arithmetic, so the page tests stay active unchanged.

    ``state_bytes`` / ``page_bytes`` price the two kinds in device bytes
    under one roof — ``bytes_for`` is the cross-kind footprint the router
    and benchmarks report; slots and pages are NOT fungible at allocation
    time, so ``fits``/selection check each kind's count separately."""
    total_states: int = 0
    state_bytes: int = 0               # bytes of one task's recurrent state
    page_bytes: int = 0                # bytes of one KV page (all layers)
    held_states: Optional[object] = None   # Callable[[Task], int]

    def states_for(self, task: Task) -> int:
        return 1 if self.total_states > 0 else 0

    def held_states_for(self, task: Task) -> int:
        return int(self.held_states(task)) if self.held_states else 0

    def bytes_for(self, task: Task) -> int:
        """Peak device bytes across both cache kinds."""
        return (self.pages_for(task) * self.page_bytes
                + self.states_for(task) * self.state_bytes)

    def fits(self, tasks: Sequence[Task]) -> bool:
        return (super().fits(tasks)
                and sum(self.states_for(t) for t in tasks)
                <= self.total_states)


def task_selection(tasks: Sequence[Task], lat: LatencyModel,
                   budget_ms: float = PERIOD_BUDGET_MS,
                   page_budget: Optional[PageBudget] = None,
                   reasons: Optional[Dict[int, str]] = None
                   ) -> Tuple[List[Task], List[Task]]:
    """Algorithm 2. Returns (selected batch b, remaining pool N).

    Step 1: utility rate r_i = U_i * T_TPOT_i (Eq. 6).
    Step 2: non-replacement greedy — admit tasks by descending r_i while the
    estimated cycle period (Eq. 7, over the batch sorted by rate descending)
    stays under budget; the first violating task is returned to the pool and
    iteration stops.

    With a page_budget, each admission additionally reserves the task's peak
    KV pages. A task that does not fit in the remaining pages is DEFERRED
    (returned with the pool, admission continues — a smaller task further
    down the utility ordering may still fit), never dropped: memory pressure
    is transient, so the task re-enters selection at the next reschedule.
    A ``StateBudget`` (SSM/hybrid engines, DESIGN.md §12) adds the same
    reserve-or-defer treatment for recurrent-state slots; MoE decode cost
    enters through ``lat`` itself — an engine-measured curve or an
    ``ExpertScaledLatencyModel`` already prices the activated experts.

    With prefix sharing (budget.prefix_pages / free_pages_now, DESIGN.md §6)
    the pages of a shared prompt prefix are counted ONCE per selection
    round: the first admitted task of a prefix group pays them, later
    admissions with the same key reuse the same physical pages for free.

    ``reasons`` (observability, DESIGN.md §13) is an optional out-dict the
    caller owns: for every task this round DEFERS it records task_id ->
    "batch" | "pages" | "states" | "time" — the Eq. 7 violator and the
    unexamined tail behind it both count as "time" (they were kept out of
    this cycle by the period budget). Pure observation: passing it never
    changes the (selected, deferred) split.
    """
    pool = sorted(tasks, key=lambda t: (-t.utility_rate, t.arrival_ms, t.task_id))
    selected: List[Task] = []
    deferred: List[Task] = []
    rates: List[int] = []
    # prefix key -> pages already paid for this round. Group members may
    # declare different prefix lengths (each capped at its own prompt), so
    # the discount is min(own prefix, paid so far) and a longer-prefix
    # member pays the difference — shared blocks are nested per group, so
    # this is exact whatever order the prefills later run in.
    prefixes_paid: dict = {}
    if page_budget is not None and page_budget.free_pages_now is not None:
        # live accounting: the pool's free count (plus reclaimable cache
        # pages) already excludes every running task's holdings
        capacity = int(page_budget.free_pages_now())
        pages_used = 0
    elif page_budget is not None:
        # static accounting: every candidate's CURRENT holdings are
        # committed up front; admitting a task upgrades its reservation
        # from held to peak. Tasks that stay unselected thus still account
        # for the pages they physically occupy.
        capacity = page_budget.total_pages
        pages_used = sum(page_budget.held_for(t) for t in pool)
    # recurrent-state slots (StateBudget, DESIGN.md §12): same static
    # arithmetic as pages — candidates' current slots committed up front,
    # each admission upgrades held -> peak (one slot per task)
    total_states = int(getattr(page_budget, "total_states", 0) or 0)
    states_used = 0
    if total_states:
        states_used = sum(page_budget.held_states_for(t) for t in pool)
    for i, t in enumerate(pool):
        if page_budget is not None:
            if (page_budget.max_tasks is not None
                    and len(selected) >= page_budget.max_tasks):
                deferred.append(t)          # engine's compiled batch ceiling
                if reasons is not None:
                    reasons[t.task_id] = "batch"
                continue
            held = page_budget.held_for(t)
            need = page_budget.pages_for(t) - held
            key, kp = page_budget.prefix_for(t)
            if key is not None and held == 0:
                # shared pages counted once: discount what an earlier
                # admission this round already paid for this prefix
                need = max(0, need - min(kp, prefixes_paid.get(key, 0)))
            if pages_used + need > capacity:
                deferred.append(t)          # defer, keep scanning
                if reasons is not None:
                    reasons[t.task_id] = "pages"
                continue
            s_need = 0
            if total_states:
                s_need = (page_budget.states_for(t)
                          - page_budget.held_states_for(t))
                if states_used + s_need > total_states:
                    deferred.append(t)      # slot-starved: defer likewise
                    if reasons is not None:
                        reasons[t.task_id] = "states"
                    continue
        cand = rates + [quantized_rate(t.slo.tpot_ms)]
        cand.sort(reverse=True)  # sortTasksBySLORateDescending (Alg.2 line 11)
        if estimate_period_ms(cand, lat) >= budget_ms:
            if reasons is not None:
                for rest in pool[i:]:
                    reasons[rest.task_id] = "time"
            return selected, deferred + pool[i:]
        selected.append(t)
        rates = cand
        if page_budget is not None:
            pages_used += need
            states_used += s_need
            if key is not None:
                prefixes_paid[key] = max(prefixes_paid.get(key, 0), kp)
    return selected, deferred


# ------------------------------------------------------- fleet routing (§11)

@dataclasses.dataclass
class InstanceView:
    """Routing snapshot of one fleet member (DESIGN.md §11): everything the
    cross-instance comparison needs, decoupled from scheduler/executor
    internals so the router prices a SimExecutor tier and a PagedJaxExecutor
    tier with the same arithmetic.

    ``rates_desc`` are the quantized SLO rates of the tasks already routed
    to the instance and still unfinished — the live Eq. 7 load. ``free_pages``
    is the instance's page headroom right now (None = unbounded / slot
    executor). ``quality`` scales realized utility by model tier, so a
    quality-weighted request prefers the large model when both tiers are
    time-feasible. ``free_states`` is the instance's recurrent-state slot
    headroom (StateBudget engines, DESIGN.md §12; None = no state kind) —
    a slot-starved mamba2 tier must refuse routes exactly as a page-starved
    dense tier does."""
    tier: int
    lat: LatencyModel
    rates_desc: List[int]
    free_pages: Optional[int] = None
    page_budget: Optional[PageBudget] = None
    quality: float = 1.0
    free_states: Optional[int] = None


def instance_cost_ms(task: Task, view: InstanceView) -> float:
    """Predicted engine time the task would consume on an instance: its
    prefill plus its output tokens priced at the decode batch it would
    join, amortized per co-batched task. This is the denominator of the
    Eq. 7-style routing score — a slow tier or a crowded instance both
    raise it."""
    b = max(1, len(view.rates_desc) + 1)
    return (view.lat.prefill_ms(task.prompt_len)
            + task.output_len * view.lat.decode_ms(b) / b)


def route_score(task: Task, view: InstanceView,
                budget_ms: float = PERIOD_BUDGET_MS) -> Optional[float]:
    """Eq. 7-priced marginal utility per predicted cost of serving ``task``
    on one instance; None when admission there is predicted infeasible —
    the cycle-period test (Eq. 7) over the instance's live rates plus this
    task, and the page-headroom test against its pool."""
    if view.page_budget is not None and view.page_budget.infeasible(task):
        return None
    cand = sorted(view.rates_desc + [quantized_rate(task.slo.tpot_ms)],
                  reverse=True)
    if estimate_period_ms(cand, view.lat) >= budget_ms:
        return None
    if (view.free_pages is not None and view.page_budget is not None
            and view.page_budget.pages_for(task) > view.free_pages):
        return None
    if (view.free_states is not None and view.page_budget is not None
            and getattr(view.page_budget, "states_for", None) is not None
            and view.page_budget.states_for(task) > view.free_states):
        return None
    return view.quality * task.utility_rate / instance_cost_ms(task, view)


def route_request(task: Task, views: Sequence[InstanceView],
                  budget_ms: float = PERIOD_BUDGET_MS) -> Tuple[int, bool]:
    """Cross-instance comparison (DESIGN.md §11): pick the feasible
    instance of qualifying tier (>= task.min_tier) with the highest
    marginal utility per predicted cost. When every qualifying tier is
    page- or headroom-starved, fall back DOWN-tier to the best-scoring
    feasible instance — degraded service beats deferring. When every
    instance is starved, overflow to the least-loaded one (it queues).

    Returns (index into views, degraded) — degraded=True when the chosen
    tier is below the task's min_tier."""
    scored = [(route_score(task, v, budget_ms), j)
              for j, v in enumerate(views)]
    eligible = [(s, j) for s, j in scored
                if s is not None and views[j].tier >= task.min_tier]
    if eligible:
        return max(eligible, key=lambda sj: (sj[0], -sj[1]))[1], False
    feasible = [(s, j) for s, j in scored if s is not None]
    if feasible:
        j = max(feasible, key=lambda sj: (sj[0], -sj[1]))[1]
        return j, views[j].tier < task.min_tier
    j = min(range(len(views)),
            key=lambda k: (len(views[k].rates_desc), k))
    return j, views[j].tier < task.min_tier


def select_swap_victims(shortfall_pages: int, candidates: Sequence[Task],
                        budget: PageBudget,
                        protect: Sequence[Task] = ()) -> List[Task]:
    """SLICE victim policy for host-offload KV swap (DESIGN.md §7).

    Called when ``PageBudget`` cannot admit a time-feasible REALTIME
    arrival: pick resident non-realtime tasks to suspend, lowest marginal
    utility first — utility rate r_i (Eq. 6, through ``effective_utility``
    so the UtilityAdaptor's preemption policy is respected), ties broken
    toward tasks holding more pages (fewer victims per admission) — until
    their held pages cover the shortfall.

    Held pages are an upper bound on what a suspension frees (shared
    prefix pages stay resident), so a round may under-free; the scheduler
    replans after each suspension lands and picks up the difference.
    Returns [] when even suspending every eligible resident would not
    cover the shortfall: thrashing the swap link without admitting the
    arrival would be pure loss, so the arrival stays deferred."""
    protect_ids = {t.task_id for t in protect}
    resident = [t for t in candidates
                if not t.slo.realtime and not t.suspended and not t.dropped
                and not t.finished and t.task_id not in protect_ids
                and budget.held_for(t) > 0]
    resident.sort(key=lambda t: (t.utility_rate, -budget.held_for(t),
                                 t.task_id))
    victims: List[Task] = []
    freed = 0
    for v in resident:
        if freed >= shortfall_pages:
            break
        victims.append(v)
        freed += budget.held_for(v)
    return victims if freed >= shortfall_pages else []


def prefill_chunk_budget(rates_desc: Sequence[int], lat: LatencyModel,
                         budget_ms: float, chunk_len: int) -> int:
    """Eq. 7 headroom → prefill-chunk token budget for one cycle
    (DESIGN.md §5).

    The decode-mask matrix consumes ``estimate_period_ms(rates)`` of the
    cycle; the remainder is slack that interleaved prefill chunks may fill
    without pushing the *delivered* cycle past budget. Tokens are priced at
    the chunk granularity (``prefill_ms(chunk_len) / chunk_len``) so the
    per-chunk launch overhead is amortized at the size actually dispatched.
    """
    slack_ms = budget_ms - estimate_period_ms(rates_desc, lat)
    if slack_ms <= 0.0:
        return 0
    per_chunk_ms = lat.prefill_ms(chunk_len)
    if per_chunk_ms <= 0.0:
        return 10 ** 9
    return int(slack_ms * chunk_len / per_chunk_ms)


def spec_depth_budget(rates_desc: Sequence[int], lat: LatencyModel,
                      budget_ms: float, max_depth: int) -> int:
    """Eq. 7 headroom → speculative-token budget for one cycle
    (DESIGN.md §8), mirroring ``prefill_chunk_budget``.

    The decode-mask matrix consumes ``estimate_period_ms(rates)`` of the
    cycle; the remaining slack may be spent accelerating lagging requests
    with draft-verify windows. Each unit of the budget is ONE speculative
    token — a draft step plus a marginal verify query — priced at the
    batch size the cycle actually runs (``lat.spec_token_ms``), so the
    *delivered* cycle stays under budget whatever depths the scheduler
    hands out. Returns 0 when the cycle is already full: depth 0 (plain
    decode) is the tight-headroom behavior, never an overrun.
    """
    if max_depth <= 0 or not rates_desc:
        return 0
    slack_ms = budget_ms - estimate_period_ms(rates_desc, lat)
    if slack_ms <= 0.0:
        return 0
    per_tok_ms = lat.spec_token_ms(len(rates_desc))
    if per_tok_ms <= 0.0:
        return 10 ** 9
    return int(slack_ms / per_tok_ms)


def selection_feasible(selected: Sequence[Task], lat: LatencyModel,
                       budget_ms: float = PERIOD_BUDGET_MS) -> bool:
    rates = sorted((quantized_rate(t.slo.tpot_ms) for t in selected),
                   reverse=True)
    return estimate_period_ms(rates, lat) < budget_ms if rates else True


def total_utility(selected: Sequence[Task]) -> float:
    """Objective Eq. (1) assuming every admitted task meets its SLO."""
    return sum(t.effective_utility for t in selected)
