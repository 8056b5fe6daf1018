"""Fleet tier (DESIGN.md §11), the PyTorch port: a copy of
``repro.serving.fleet`` changed only in its imports, except
``engine_fleet``, which builds the port's paged engines.

The fleet tier: N (scheduler, executor) instances — e.g.
smollm_360m + edge_6b — behind ONE admission layer.

``FleetRouter`` owns the instances and routes each arriving request by
Eq. 7-style marginal utility per predicted cost (selection.route_request):
tight-TPOT realtime traffic lands on the small fast tier (the only one
whose cycle-period test passes at its rate), quality-tier requests
(``Task.min_tier``) on the large model that satisfies their tier floor.
When the preferred tier is page- or headroom-starved the router falls back
DOWN-tier (degraded service — the request flows, its tier attainment does
not) instead of deferring, and an instance that runs dry pulls queued
zero-progress requests from a loaded peer (overflow spill) through
``Scheduler.withdraw``.

``run_fleet_loop`` drives the instances as N concurrent edge devices: each
has its own ``InstanceDriver`` clock and the lowest-clock instance steps
next, so the fleet frontier delivers every arrival at its true time. With
ONE instance the event order reduces exactly to ``run_serving_loop`` —
the degenerate ``--fleet`` config is byte-identical to the single-model
path.

Accounting contract (the spill double-count rule): ADMISSION is counted
once at the fleet layer (``FleetResult.admissions``, keyed by the first
route); TOKENS are attributed to the instance that serves them
(``Task.served_by``, rewritten by a spill before any engine-side progress
exists), and each request appears in exactly one per-instance LoopResult.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import torch

from repro_torch.core.latency_model import LatencyModel
from repro_torch.core.mask_matrix import quantized_rate
from repro_torch.core.schedulers import Scheduler, SliceScheduler
from repro_torch.core.selection import (PERIOD_BUDGET_MS, InstanceView, PageBudget,
                                  route_request, route_score)
from repro_torch.core.task import Task
from repro_torch.serving.executor import Executor, PagedSimExecutor
from repro_torch.serving.loop import InstanceDriver, LoopResult, merge_results


@dataclasses.dataclass
class FleetInstance:
    """One fleet member: a scheduler+executor pair plus the routing facts
    about it — model tier (0 = smallest), latency pricing, page budget,
    and the quality weight its tier earns in the routing score."""
    name: str
    tier: int
    scheduler: Scheduler
    executor: Executor
    lat: LatencyModel
    page_budget: Optional[PageBudget] = None
    quality: float = 1.0


@dataclasses.dataclass
class FleetResult:
    """Fleet-wide outcome: ``tasks`` holds every workload request exactly
    once (whether or not an instance ever served it); ``per_instance``
    partitions the served requests by serving instance; ``admissions``
    counts fleet-layer admission once per request at its FIRST route —
    a spill moves tokens, never the admission count."""
    tasks: List[Task]
    end_ms: float
    per_instance: Dict[str, LoopResult]
    merged: LoopResult
    admissions: Dict[str, int]
    spills: int = 0
    degraded: int = 0


class FleetRouter:
    """Single admission layer over N instances (DESIGN.md §11)."""

    def __init__(self, instances: Sequence[FleetInstance],
                 budget_ms: float = PERIOD_BUDGET_MS, spill: bool = True):
        if not instances:
            raise ValueError("a fleet needs at least one instance")
        names = [i.name for i in instances]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate instance names: {names}")
        self.instances = list(instances)
        self.budget_ms = budget_ms
        self.spill = spill
        self.admissions: Dict[str, int] = {i.name: 0 for i in instances}
        self.spills = 0
        self.degraded = 0
        # observability (DESIGN.md §13): wired by run_fleet_loop; the
        # router emits route / defer(reason="tier") events — pure
        # observation, routing decisions never read it
        self.trace = None

    # -- routing snapshots --
    def view(self, inst: FleetInstance, live: Sequence[Task]) -> InstanceView:
        rates = sorted((quantized_rate(t.slo.tpot_ms) for t in live),
                       reverse=True)
        free = None
        free_states = None
        pb = inst.page_budget
        if pb is not None:
            if pb.free_pages_now is not None:
                free = int(pb.free_pages_now())
            else:
                free = pb.total_pages - sum(pb.held_for(t) for t in live)
            if getattr(pb, "total_states", 0):
                # state-kind headroom (DESIGN.md §12): one slot per task
                free_states = pb.total_states - sum(
                    pb.held_states_for(t) for t in live)
        return InstanceView(tier=inst.tier, lat=inst.lat, rates_desc=rates,
                            free_pages=free, page_budget=pb,
                            quality=inst.quality, free_states=free_states)

    def views(self, drivers: Dict[str, InstanceDriver]) -> List[InstanceView]:
        return [self.view(inst, drivers[inst.name].live_tasks())
                for inst in self.instances]

    # -- admission (counted ONCE here, never by instances) --
    def route(self, task: Task, views: Sequence[InstanceView],
              now: Optional[float] = None) -> FleetInstance:
        j, degraded = route_request(task, views, self.budget_ms)
        inst = self.instances[j]
        self.admissions[inst.name] += 1
        self.degraded += int(degraded)
        task.routed_to = inst.name
        task.served_by = inst.name
        task.served_tier = inst.tier
        if self.trace is not None:
            ts = now if now is not None else task.arrival_ms
            self.trace.emit("route", ts, task.task_id, inst.name,
                            tier=inst.tier, degraded=degraded,
                            score=route_score(task, views[j],
                                              self.budget_ms))
            if degraded:
                # the event twin of the merged LoopResult's "tier" defer
                # bucket (run_fleet_loop folds router.degraded in)
                self.trace.emit("defer", ts, task.task_id, inst.name,
                                reason="tier")
        return inst

    # -- overflow spill (pull-based: an idle instance steals queued work) --
    def try_spill(self, to_inst: FleetInstance,
                  drivers: Dict[str, InstanceDriver],
                  views: Sequence[InstanceView]) -> Optional[Task]:
        """Pull ONE queued zero-progress request from a loaded peer onto
        the idle ``to_inst``. Down-tier pulls of quality traffic happen
        only when the owning instance is itself starved for the task
        (route_score None there) — degraded-mode fallback, not theft of
        work the right tier would soon serve. Returns the moved task
        (already re-attributed), or None."""
        if not self.spill or len(self.instances) < 2:
            return None
        by_name = {inst.name: v
                   for inst, v in zip(self.instances, views)}
        to_view = by_name[to_inst.name]
        to_now = drivers[to_inst.name].now
        cands = []
        for inst in self.instances:
            if inst.name == to_inst.name:
                continue
            for t in drivers[inst.name].live_tasks():
                if (t.prefill_done_tokens > 0 or t.tokens_done > 0
                        or t.suspended):
                    continue               # engine-side state: not movable
                if t.arrival_ms > to_now:
                    continue               # not yet arrived at the puller
                s = route_score(t, to_view, self.budget_ms)
                if s is None:
                    continue               # infeasible on the idle side
                if (to_inst.tier < t.min_tier
                        and route_score(t, by_name[inst.name],
                                        self.budget_ms) is not None):
                    continue               # right tier can still serve it
                cands.append((s, -t.arrival_ms, -t.task_id, t, inst))
        cands.sort(reverse=True, key=lambda c: c[:3])
        for s, _, _, t, from_inst in cands:
            if not drivers[from_inst.name].scheduler.withdraw(t):
                continue
            drivers[from_inst.name].tracked.remove(t)
            self.spills += 1
            degraded = to_inst.tier < t.min_tier
            self.degraded += int(degraded)
            t.served_by = to_inst.name     # tokens follow the server;
            t.served_tier = to_inst.tier   # admission stays with routed_to
            if self.trace is not None:
                ts = drivers[to_inst.name].now
                self.trace.emit("route", ts, t.task_id, to_inst.name,
                                tier=to_inst.tier, degraded=degraded,
                                spill=True, score=s)
                if degraded:
                    self.trace.emit("defer", ts, t.task_id, to_inst.name,
                                    reason="tier")
            return t
        return None


def run_fleet_loop(router: FleetRouter, workload: Sequence[Task],
                   max_ms: float = 600_000.0,
                   idle_gas: int = 10_000_000,
                   idle_tick_ms: float = 100.0,
                   max_idle_ticks: int = 600,
                   trace=None) -> FleetResult:
    """Drive every fleet instance over one workload: lowest-clock instance
    steps next (N concurrent devices in one discrete-event frontier),
    arrivals are routed when the frontier reaches them, idle instances
    pull spills, and per-instance LoopResults merge at the end.

    One deliberate deviation from run_serving_loop's ending: that loop
    stops at the first idle moment after arrivals end, even with deferred
    work still pooled (SLICE's greedy selection prefix can stall behind an
    alone-infeasible realtime head task until deadline pruning drops it).
    A fleet instance instead ticks its clock forward by ``idle_tick_ms``
    and pokes ``scheduler.on_idle`` until its tracked work drains — the
    page-leak gate in benchmarks/fleet_routing.py requires every instance
    to actually finish or drop everything it holds. ``max_idle_ticks``
    consecutive fruitless ticks (a request statically unadmittable on this
    instance and immune to deadline pruning, e.g. a non-realtime SLO whose
    rate alone overruns Eq. 7) fall back to the single-model loop's
    give-up semantics instead of spinning the clock to ``max_ms``."""
    arrivals = sorted(workload, key=lambda t: (t.arrival_ms, t.task_id))
    i = 0
    if trace is not None:
        router.trace = trace
    drivers = {inst.name: InstanceDriver(inst.scheduler, inst.executor,
                                         trace=trace, name=inst.name)
               for inst in router.instances}
    order = {inst.name: k for k, inst in enumerate(router.instances)}
    by_name = {inst.name: inst for inst in router.instances}
    done: set = set()
    stall = {inst.name: 0 for inst in router.instances}
    gas = idle_gas

    def deliver_upto(upto: float) -> None:
        nonlocal i
        while i < len(arrivals) and arrivals[i].arrival_ms <= upto:
            t = arrivals[i]
            inst = router.route(t, router.views(drivers))
            drivers[inst.name].deliver(t)
            i += 1

    while len(done) < len(drivers):
        active = [n for n in drivers if n not in done]
        name = min(active, key=lambda n: (drivers[n].now, order[n]))
        d = drivers[name]
        if d.now >= max_ms:
            done.add(name)
            continue
        gas -= 1
        if gas <= 0:
            raise RuntimeError("fleet loop did not converge")
        deliver_upto(d.now)
        if d.step():
            stall[name] = 0
            continue
        pulled = router.try_spill(by_name[name], drivers,
                                  router.views(drivers))
        if pulled is not None:
            d.deliver(pulled)
            continue
        if i < len(arrivals):              # idle -> jump to next arrival
            d.now = max(d.now, arrivals[i].arrival_ms)
            continue
        if (any(not t.finished and not t.dropped for t in d.tracked)
                and stall[name] < max_idle_ticks):
            d.now += idle_tick_ms          # deferred work: tick + replan
            d.scheduler.on_idle(d.now)
            stall[name] += 1
            continue
        done.add(name)                     # drained (spills are pull-based
                                           # and peers gain no new queue
                                           # entries once arrivals end)
    for d in drivers.values():
        d.drain()
    per = {inst.name: drivers[inst.name].result(
               [t for t in arrivals if t.served_by == inst.name])
           for inst in router.instances}
    merged = merge_results(per)
    if router.degraded:
        # fleet-layer defer cause (DESIGN.md §13): degraded down-tier
        # routings, counted whether or not a recorder is attached
        merged.defers_by_reason["tier"] = (
            merged.defers_by_reason.get("tier", 0) + router.degraded)
    return FleetResult(tasks=list(arrivals), end_ms=merged.end_ms,
                       per_instance=per, merged=merged,
                       admissions=dict(router.admissions),
                       spills=router.spills, degraded=router.degraded)


# ------------------------------------------------- construction conveniences

@dataclasses.dataclass
class SimTier:
    """Spec for one simulated fleet member: its latency pricing stands in
    for the model weights. ``pages=None`` takes an equal slice of the
    shared arena."""
    name: str
    tier: int
    lat: LatencyModel
    quality: float = 1.0
    pages: Optional[int] = None


def sim_fleet(tiers: Sequence[SimTier], total_pages: int = 256,
              page_size: int = 16, budget_ms: float = PERIOD_BUDGET_MS,
              spill: bool = True, **slice_kwargs) -> FleetRouter:
    """SimExecutor fleet mode: one PagedSimExecutor + SliceScheduler per
    tier under ONE shared page arena (KVSwapArena-style single budget,
    statically partitioned across instances — the sim-side image of the
    engine fleet's shared host arena). All scheduler-level routing wins
    are measurable here without touching JAX (benchmarks/fleet_routing.py).
    """
    explicit = sum(t.pages for t in tiers if t.pages is not None)
    free_tiers = [t for t in tiers if t.pages is None]
    share = ((total_pages - explicit) // len(free_tiers)) if free_tiers else 0
    insts = []
    for spec in tiers:
        pages = spec.pages if spec.pages is not None else share
        ex = PagedSimExecutor(spec.lat, total_pages=pages,
                              page_size=page_size, name=spec.name)
        sched = SliceScheduler(spec.lat, budget_ms=budget_ms,
                               page_budget=ex.budget, **slice_kwargs)
        insts.append(FleetInstance(name=spec.name, tier=spec.tier,
                                   scheduler=sched, executor=ex,
                                   lat=spec.lat, page_budget=ex.budget,
                                   quality=spec.quality))
    return FleetRouter(insts, budget_ms=budget_ms, spill=spill)


def engine_fleet(archs: Sequence[str], n_pages: int = 64,
                 page_size: int = 16, max_seq: int = 256,
                 max_batch: int = 8, seed: int = 0,
                 qualities: Optional[Sequence[float]] = None,
                 spill: bool = True, dtype=torch.float32, device="cuda",
                 **executor_kwargs) -> FleetRouter:
    """Real-engine fleet: one reduced-config PagedTorchExecutor +
    SliceScheduler per registry arch, tier = position in ``archs`` (order
    small -> large), on ``device`` in ``dtype``. Each instance keeps its
    full subsystem stack (paging, chunking, prefix cache, swap, spec-decode,
    async dispatch — whatever ``executor_kwargs`` enables) unchanged inside
    the fleet. The counterpart of ``repro.serving.fleet.engine_fleet``."""
    from repro_torch.configs import get_config
    from repro_torch.serving.executor import PagedTorchExecutor

    insts = []
    n = len(archs)
    for tier, arch in enumerate(archs):
        cfg = get_config(arch).reduced()
        ex = PagedTorchExecutor(cfg, n_pages=n_pages, page_size=page_size,
                                max_seq=max_seq, seed=seed,
                                max_batch=max_batch, dtype=dtype,
                                device=device, **executor_kwargs)
        lat = ex.latency_model()
        budget = ex.page_budget()
        sched = SliceScheduler(lat, page_budget=budget)
        quality = (qualities[tier] if qualities is not None
                   else (tier + 1) / n)
        insts.append(FleetInstance(name=arch, tier=tier, scheduler=sched,
                                   executor=ex, lat=lat, page_budget=budget,
                                   quality=quality))
    return FleetRouter(insts, spill=spill)
