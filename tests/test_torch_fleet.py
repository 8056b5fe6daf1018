"""The port's fleet tier (``repro_torch.serving.fleet``, DESIGN.md §11)
held against the JAX package on the CPU.

- The properties of ``tests/test_fleet.py`` (the spill accounting
  contract, the degenerate one-instance fleet) run over both packages'
  simulated fleets, and the two packages' ``FleetResult`` of the same
  workload are equal field for field: every task's token times, routing
  (``routed_to``/``served_by``/``served_tier``), admissions, spills,
  degraded routings, defers by reason and the end clock.
- The simulated executors (the port's copies) return what JAX's return
  over one script of operations.
- A two-tier fleet of real engines (``smollm-360m``, ``edge-6b``,
  reduced, fp32), the port's against JAX's on the same bridged weights,
  each engine priced by its tier's one latency model (the ``Priced``
  wrapper of ``tests/test_torch_serving.py``): routing, token times,
  greedy streams and admissions identical, the pools empty.
- ``engine_fleet`` over the heterogeneous pair (``mamba2-780m``,
  ``granite-moe-3b-a800m``) against the structural gate of
  ``benchmarks/fleet_routing.py``.
- ``events_conserved`` and per-instance replay on a two-instance torch
  fleet, synchronous and async (the fleet half of
  ``tests/test_trace.py``); the async fleet gives the sync one's run.
- The CLI's ``--fleet``: a run that imports no JAX, JAX's refusals, and a
  one-arch fleet that is the single-model run.

Runs of real engines price each step (``priced_engines``) instead of
timing it, so every decision is deterministic.
"""
from __future__ import annotations

import itertools
import os
import re
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.core import latency_model as jlm  # noqa: E402
from repro.core import schedulers as jsched  # noqa: E402
from repro.core import task as jtask  # noqa: E402
from repro.data import workload as jwl  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serving import executor as jex  # noqa: E402
from repro.serving import fleet as jfleet  # noqa: E402
from repro.serving import loop as jloop  # noqa: E402
from repro.serving import trace as jtrace  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import latency_model as tlm  # noqa: E402
from repro_torch.core import schedulers as tsched  # noqa: E402
from repro_torch.core import task as ttask  # noqa: E402
from repro_torch.data import workload as twl  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.serving import executor as tex  # noqa: E402
from repro_torch.serving import fleet as tfleet  # noqa: E402
from repro_torch.serving import loop as tloop  # noqa: E402
from repro_torch.serving import trace as ttrace  # noqa: E402
from repro_torch.serving.pipeline import FakeClock  # noqa: E402
from test_torch_cuda import fleet_structural_gate  # noqa: E402
from test_torch_serving import Priced  # noqa: E402
# priced, and reads nothing per step (an async engine keeps its steps in
# flight); each stream is read at the release
from test_torch_trace import Priced as Unread  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PKGS = {
    "jax": types.SimpleNamespace(lm=jlm, sched=jsched, task=jtask, wl=jwl,
                                 ex=jex, fleet=jfleet, loop=jloop,
                                 trace=jtrace),
    "torch": types.SimpleNamespace(lm=tlm, sched=tsched, task=ttask, wl=twl,
                                   ex=tex, fleet=tfleet, loop=tloop,
                                   trace=ttrace),
}
BOTH = pytest.mark.parametrize("pkg", sorted(PKGS))


@pytest.fixture(autouse=True, scope="module")
def one_cpu_thread():
    """PyTorch's CPU ops on one intra-op thread: beside the other test
    processes its default pool (a thread per core) waits on itself at
    every op, and a reduced step slows many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fleet_fingerprint(res):
    """Every field of a FleetResult the contract holds equal."""
    return (res.end_ms, dict(res.admissions), res.spills, res.degraded,
            dict(res.merged.defers_by_reason), res.merged.decode_iterations,
            res.merged.prefills,
            {n: sorted(t.task_id for t in r.tasks)
             for n, r in res.per_instance.items()},
            [(t.task_id, t.routed_to, t.served_by, t.served_tier, t.finished,
              t.dropped, t.tokens_done, tuple(t.token_times_ms))
             for t in res.tasks])


# ------------------------------------- the simulated fleets (test_fleet.py)

def _task(p, tpot_ms=100.0, min_tier=0, **kw):
    kw.setdefault("prompt_len", 64)
    kw.setdefault("output_len", 12)
    return p.task.Task(p.task.SLOSpec(tpot_ms=tpot_ms, ttft_ms=60_000.0),
                       utility=1.0, min_tier=min_tier, **kw)


def _spill_fleet(p):
    """``tests/test_fleet.py``'s forced spill: the big tier has pages for
    one resident, a second quality request queues page-deferred, and a
    later realtime arrival keeps the small tier's clock alive until it
    pulls the queued request."""
    lat = p.lm.paper_fig1_model()
    router = p.fleet.sim_fleet(
        [p.fleet.SimTier("small", 0, lat, quality=0.5, pages=64),
         p.fleet.SimTier("big", 1, lat, quality=1.0, pages=17)],
        total_pages=81, page_size=16)
    a = _task(p, tpot_ms=500.0, min_tier=1, arrival_ms=0.0, output_len=200)
    b = _task(p, tpot_ms=500.0, min_tier=1, arrival_ms=0.0)
    c = p.task.control_task(arrival_ms=5000.0, prompt_len=32, output_len=8)
    for i, t in enumerate((a, b, c)):
        t.task_id = 50_001 + i
    return router, [a, b, c]


@BOTH
def test_router_rejects_bad_fleets(pkg):
    p = PKGS[pkg]
    lat = p.lm.paper_fig1_model()
    with pytest.raises(ValueError):
        p.fleet.FleetRouter([])
    inst = p.fleet.FleetInstance(name="a", tier=0,
                                 scheduler=p.sched.SliceScheduler(lat),
                                 executor=p.ex.SimExecutor(lat), lat=lat)
    with pytest.raises(ValueError):
        p.fleet.FleetRouter([inst, inst])


@BOTH
def test_forced_spill_attribution_and_no_double_count(pkg):
    p = PKGS[pkg]
    router, tasks = _spill_fleet(p)
    res = p.fleet.run_fleet_loop(router, tasks)
    assert all(t.finished for t in res.tasks)
    assert res.spills == 1 and res.degraded >= 1
    assert res.admissions == {"big": 2, "small": 1}
    spilled = [t for t in res.tasks if t.routed_to != t.served_by]
    assert len(spilled) == 1
    s = spilled[0]
    assert (s.routed_to, s.served_by, s.served_tier) == ("big", "small", 0)
    assert not s.tier_met() and not s.slo_met()
    ids = [t.task_id for r in res.per_instance.values() for t in r.tasks]
    assert sorted(ids) == sorted(t.task_id for t in tasks)
    assert {t.task_id for t in res.per_instance["small"].tasks} == \
        {s.task_id, tasks[2].task_id}
    assert {t.task_id for t in res.per_instance["big"].tasks} == \
        {tasks[0].task_id}
    for name, r in res.per_instance.items():
        assert r.decode_iterations >= max(
            (t.output_len - 1 for t in r.tasks), default=0), name
    for inst in router.instances:
        assert inst.executor.used_pages == 0, inst.name


@BOTH
def test_spill_disabled_leaves_queue_in_place(pkg):
    p = PKGS[pkg]
    router, tasks = _spill_fleet(p)
    router.spill = False
    res = p.fleet.run_fleet_loop(router, tasks)
    assert res.spills == 0
    assert all(t.routed_to == t.served_by for t in res.tasks)


def _mini_workload(p):
    tasks = [p.task.control_task(arrival_ms=120.0 * k, prompt_len=48,
                                 output_len=8) for k in range(3)]
    tasks += [p.task.voice_task(arrival_ms=150.0 + 400.0 * k, prompt_len=64,
                                output_len=16) for k in range(2)]
    for i, t in enumerate(tasks):
        t.task_id = 60_001 + i
    return tasks


@BOTH
def test_single_instance_fleet_matches_serving_loop(pkg):
    p = PKGS[pkg]
    lat = p.lm.paper_fig1_model()
    ref = p.loop.run_serving_loop(p.sched.SliceScheduler(lat),
                                  p.ex.SimExecutor(lat), _mini_workload(p))
    assert all(t.finished for t in ref.tasks)
    inst = p.fleet.FleetInstance(name="solo", tier=0,
                                 scheduler=p.sched.SliceScheduler(lat),
                                 executor=p.ex.SimExecutor(lat), lat=lat)
    res = p.fleet.run_fleet_loop(p.fleet.FleetRouter([inst]),
                                 _mini_workload(p))
    by_id = {t.task_id: t for t in ref.tasks}
    for t in res.tasks:
        r = by_id[t.task_id]
        assert t.token_times_ms == r.token_times_ms, t.task_id
        assert t.dropped == r.dropped
        assert (t.routed_to, t.served_by, t.served_tier) == ("solo", "solo", 0)
    assert res.merged.end_ms == ref.end_ms
    assert res.merged.decode_iterations == ref.decode_iterations
    assert res.merged.prefills == ref.prefills
    assert res.admissions == {"solo": len(ref.tasks)}
    assert res.spills == 0 and res.degraded == 0


def _two_tier(p, trace=None, **slice_kwargs):
    """``tests/test_trace.py``'s two-tier fleet: a small tier at 0.4x the
    large one's latencies, QA traffic on the large tier, 64 pages."""
    lat = p.lm.paper_fig1_model()
    small = p.lm.MeasuredLatencyModel(
        [(b, ms * 0.4) for b, ms in lat._bs],
        prefill_samples=[(n, ms * 0.4) for n, ms in lat._ps])
    router = p.fleet.sim_fleet([p.fleet.SimTier("small", 0, small,
                                                quality=0.8),
                                p.fleet.SimTier("large", 1, lat, quality=1.0)],
                               total_pages=64, **slice_kwargs)
    tasks = p.wl.poisson_workload(rate_per_s=2.0, duration_s=20.0, seed=7,
                                  realtime_frac=0.4, voice_output_len=64,
                                  qa_output_len=64)
    for i, t in enumerate(tasks):
        t.task_id = 70_000 + i
        if t.kind == "qa":
            t.min_tier = 1
    return p.fleet.run_fleet_loop(router, tasks, max_ms=3e7, trace=trace)


SCENARIOS = {
    "spill": lambda p: p.fleet.run_fleet_loop(*_spill_fleet(p)),
    "single": lambda p: p.fleet.run_fleet_loop(p.fleet.FleetRouter([
        p.fleet.FleetInstance(
            name="solo", tier=0,
            scheduler=p.sched.SliceScheduler(p.lm.paper_fig1_model()),
            executor=p.ex.SimExecutor(p.lm.paper_fig1_model()),
            lat=p.lm.paper_fig1_model())]), _mini_workload(p)),
    "two-tier": _two_tier,
    # every event source of the simulated engine armed: swap, spec
    # decode, chunked prefill
    "two-tier-swap-spec-chunk": lambda p: _two_tier(
        p, kv_swap=True, spec_decode=True, prefill_chunk=32),
}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_sim_fleet_equals_jax(scenario):
    """The port's simulated fleet gives JAX's FleetResult exactly."""
    want = SCENARIOS[scenario](PKGS["jax"])
    got = SCENARIOS[scenario](PKGS["torch"])
    assert len(got.tasks) >= 3
    assert _fleet_fingerprint(got) == _fleet_fingerprint(want)


@BOTH
def test_events_conserved_sim_fleet(pkg):
    """``tests/test_trace.py``'s fleet conservation over either package's
    two-instance simulated fleet under one recorder."""
    p = PKGS[pkg]
    tr = p.trace.TraceRecorder()
    res = _two_tier(p, trace=tr)
    assert p.trace.events_conserved(tr.events, res.merged)
    tracks = [i for i in tr.instances() if i != "fleet"]
    assert len(tracks) == 2
    merged = p.trace.replay_counters(tr.events)
    per = [p.trace.replay_counters(tr.events, instance=i)
           for i in tr.instances()]
    assert merged["finished"] == sum(q["finished"] for q in per)
    assert merged["decode_iterations"] == sum(q["decode_iterations"]
                                              for q in per)


# ------------------------------------------------- the simulated executors

def _sim_script(p):
    """Every operation of both simulated executors, in one script; returns
    what each returned and the counters after."""
    lat = p.lm.paper_fig1_model()
    out = []
    for paged in (False, True):
        ex = (p.ex.PagedSimExecutor(lat, total_pages=32, page_size=16,
                                    scheduling_overhead_ms=0.25, name="s")
              if paged else p.ex.SimExecutor(lat, 0.25, name="s"))
        a = _task(p, prompt_len=40, output_len=30, task_id=81)
        b = _task(p, prompt_len=100, output_len=20, task_id=82)
        ops = [ex.prefill(a), ex.prefill_chunk(b, 32), ex.prefill_chunk(b, 32),
               ex.prefill_chunk(b, 99)]
        for depths in (None, [0, 0], [3, 2], [4, 4], [1, 0]):
            ops.append(ex.decode([a, b], depths))
            ops.append(list(ex.last_commits))
            a.token_times_ms.append(10.0)
        ops += [ex.suspend(a), ex.trace_gauges(), ex.resume(a),
                ex.latency_model() is lat]
        with pytest.raises(RuntimeError):
            ex.resume(a)
        if paged:
            ops += [ex.used_pages, dict(ex.held), ex.budget.held_for(b)]
        ex.release(a)
        ex.release(b)
        ops += [ex.trace_gauges(), ex.decode_steps, ex.prefill_steps,
                ex.chunk_steps, ex.suspend_count, ex.resume_count,
                ex.swapped_bytes, ex.spec_steps, ex.drafted_tokens,
                ex.accepted_tokens, ex.name]
        out.append(ops)
    return out


def test_sim_executors_equal_jax():
    assert _sim_script(PKGS["torch"]) == _sim_script(PKGS["jax"])


# ------------------------------------------------ fleets of real engines

ENGINE = dict(n_pages=24, page_size=8, max_seq=64, max_batch=4)
SAMPLES = [(1, 8.0), (2, 9.0), (4, 11.0)]
PREFILL = [(8, 4.0), (64, 12.0)]
# (arch, factor of SAMPLES/PREFILL): the small tier runs at half the
# large tier's step times
TIERS = (("smollm-360m", 0.5), ("edge-6b", 1.0))


def _lat(p, f):
    return p.lm.MeasuredLatencyModel([(b, ms * f) for b, ms in SAMPLES],
                                     [(n, ms * f) for n, ms in PREFILL])


def _fleet_workload(p, seed=5):
    tasks = p.wl.poisson_workload(4.0, 3.0, realtime_frac=0.5, seed=seed,
                                  rt_output_len=6, voice_output_len=10,
                                  qa_output_len=12, rt_prompt=(4, 12),
                                  voice_prompt=(6, 20), qa_prompt=(8, 28))
    for i, t in enumerate(tasks):          # pin ids: prompts derive from them
        t.task_id = 6000 + i
        if t.kind == "qa":
            t.min_tier = 1
    return tasks


def _priced_fleet(p, engines, wrap):
    insts = []
    for tier, ((arch, f), ex) in enumerate(zip(TIERS, engines)):
        lat = _lat(p, f)
        budget = ex.page_budget()
        insts.append(p.fleet.FleetInstance(
            name=arch, tier=tier,
            scheduler=p.sched.SliceScheduler(lat, page_budget=budget),
            executor=wrap(ex, lat), lat=lat, page_budget=budget,
            quality=(tier + 1) / len(TIERS)))
    return p.fleet.FleetRouter(insts)


@pytest.fixture(scope="module")
def tier_weights():
    out = []
    for k, (arch, _) in enumerate(TIERS):
        jcfg = jax_config(arch).reduced()
        cfg = get_config(arch).reduced()
        jp = JM.init_params(jcfg, jax.random.PRNGKey(10 + k))
        tp = TM.load_params(cfg, jax.tree_util.tree_map(np.asarray, jp),
                            device="cpu")
        out.append((jcfg, cfg, jp, tp))
    return out


def test_engine_fleet_equals_jax(tier_weights):
    """Two tiers of real paged engines on the same weights, each priced by
    its tier's latency model: the port's fleet routes, admits, spills and
    times every token as JAX's does, every greedy stream is JAX's, and
    both tiers' pools end empty."""
    runs = {}
    for name, p in PKGS.items():
        if name == "jax":
            engines = [jex.PagedJaxExecutor(jcfg, params=jp, **ENGINE)
                       for jcfg, _, jp, _ in tier_weights]
        else:
            engines = [tex.PagedTorchExecutor(cfg, params=tp, device="cpu",
                                              **ENGINE)
                       for _, cfg, _, tp in tier_weights]
        router = _priced_fleet(p, engines, Priced)
        res = p.fleet.run_fleet_loop(router, _fleet_workload(p),
                                     max_ms=1e6)
        streams = {}
        for inst in router.instances:
            streams.update(inst.executor.streams)
        runs[name] = (res, streams, engines)
    (jres, jstreams, _), (tres, tstreams, tengines) = runs["jax"], \
        runs["torch"]
    assert len(tres.tasks) >= 10
    assert {t.served_by for t in tres.tasks} == {a for a, _ in TIERS}
    assert _fleet_fingerprint(tres) == _fleet_fingerprint(jres)
    finished = [t.task_id for t in tres.tasks if t.finished]
    assert finished and all(len(tstreams[i]) > 1 for i in finished)
    assert tstreams == jstreams
    for ex in tengines:
        assert ex.pool.used_pages == 0 and not ex.pool.owners()


@pytest.fixture
def priced_engines(monkeypatch):
    """PagedTorchExecutor's prefill and decode run as ever but return a
    price (the tier's SAMPLES/PREFILL by the arch's factor, 1 for an arch
    of no tier) instead of the time they took, so the probed l(b), the
    SLO scale and every decision of a run are deterministic."""
    decode, prefill = tex.PagedTorchExecutor.decode, \
        tex.PagedTorchExecutor.prefill
    factor = {f"{a}-smoke": f for a, f in TIERS}

    def lat_of(ex):
        return _lat(PKGS["torch"], factor.get(ex.cfg.name, 1.0))

    def priced_decode(self, tasks, depths=None):
        decode(self, tasks, depths)
        return lat_of(self).decode_ms(len(tasks))

    def priced_prefill(self, task):
        prefill(self, task)
        return lat_of(self).prefill_ms(task.prompt_len)

    monkeypatch.setattr(tex.PagedTorchExecutor, "decode", priced_decode)
    monkeypatch.setattr(tex.PagedTorchExecutor, "prefill", priced_prefill)


def test_hetero_engine_fleet_structural_gate(priced_engines):
    """``engine_fleet`` over mamba2-780m (SSM: the realtime tier) and
    granite-moe-3b-a800m (MoE: the quality tier), the gate of
    ``benchmarks/fleet_routing.py``: each instance keeps its cache kind,
    every request is served exactly once, no page or state slot leaks,
    and no quality request is served below its tier floor."""
    router = tfleet.engine_fleet(["mamba2-780m", "granite-moe-3b-a800m"],
                                 n_pages=48, page_size=8, max_seq=96,
                                 max_batch=4, seed=0, device="cpu")
    kinds = tuple(i.executor.store.kinds for i in router.instances)
    assert kinds == (("state",), ("kv",)), kinds
    assert [(i.name, i.tier, i.quality, i.executor.cfg.name)
            for i in router.instances] == [
        ("mamba2-780m", 0, 0.5, "mamba2-780m-smoke"),
        ("granite-moe-3b-a800m", 1, 1.0, "granite-moe-3b-a800m-smoke")]
    res = fleet_structural_gate(router, two_tier=False)
    assert all(t.served_tier >= 1 for t in res.tasks if t.min_tier >= 1)
    assert all(t.finished for t in res.tasks)


def _torch_fleet_run(tier_weights, async_dispatch, trace=None):
    engines = []
    for _, cfg, _, tp in tier_weights:
        ex = tex.PagedTorchExecutor(cfg, params=tp, device="cpu",
                                    async_dispatch=async_dispatch, **ENGINE)
        ex._queue.clock = FakeClock()      # commits priced at 0 ms
        engines.append(ex)
    router = _priced_fleet(PKGS["torch"], engines, Unread)
    res = tfleet.run_fleet_loop(router, _fleet_workload(PKGS["torch"], 9),
                                max_ms=1e6, trace=trace)
    streams = {}
    for inst in router.instances:
        streams.update(inst.executor.streams)
    return res, streams, engines


def test_events_conserved_engine_fleet(tier_weights):
    """One recorder over a two-instance fleet of the port's engines,
    synchronous and async: the stream replays the merged LoopResult, each
    instance's track replays its own part, and the async fleet's run
    (decisions, token times, streams, events) is the synchronous one's."""
    out = {}
    for async_dispatch in (False, True):
        tr = ttrace.TraceRecorder(metrics_every=4)
        res, streams, engines = _torch_fleet_run(tier_weights,
                                                 async_dispatch, tr)
        assert tr.dropped == 0
        assert ttrace.events_conserved(tr.events, res.merged)
        tracks = [i for i in tr.instances() if i != "fleet"]
        assert sorted(tracks) == sorted(a for a, _ in TIERS)
        merged = ttrace.replay_counters(tr.events)
        per = [ttrace.replay_counters(tr.events, instance=i)
               for i in tr.instances()]
        for key in ("finished", "decode_iterations", "prefills"):
            assert merged[key] == sum(q[key] for q in per), key
        for ex in engines:
            ex.drain()
            assert ex.pool.used_pages == 0 and ex.ledger.outstanding() == 0
        assert tr.snapshots
        events = [(e.ts, e.kind, e.task_id, e.instance) for e in tr.events]
        out[async_dispatch] = (_fleet_fingerprint(res), streams, events)
    assert out[True] == out[False]
    assert len(out[False][1]) >= 10


# ------------------------------------------------------------------ CLI

_SERVE = """
import sys
from repro_torch.launch import serve
serve.main(["--reduced", "--device", "cpu", "--duration", "1.5",
            "--rate", "2", "--slots", "2", "--max-seq", "64", *sys.argv[1:]])
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "repro"
             or m.startswith("repro."))
assert not bad, bad
print("CLEAN")
"""


def test_fleet_cli_imports_no_jax(tmp_path):
    """``--fleet smollm-360m,edge-6b`` on the CPU, traced, in a process
    that never imports JAX or the JAX package: both instances' l(b), the
    fleet summary line, one line per serving instance, the trace line."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-c", _SERVE, "--fleet", "smollm-360m,edge-6b",
         "--trace", str(tmp_path / "t.json"), "--metrics-every", "4"],
        env=env, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "CLEAN" in out.stdout
    assert re.search(r"fleet\[0\] smollm-360m-smoke \(paged, float32, "
                     r"cpu\): l\(1\)=", out.stdout)
    assert re.search(r"fleet\[1\] edge-6b-smoke ", out.stdout)
    assert re.search(r"fleet\(smollm-360m,edge-6b\): n=\d+ SLO=.* spills=\d+ "
                     r"degraded=\d+ defers=", out.stdout)
    assert re.search(r"^  (smollm-360m|edge-6b): served=\d+ admitted=\d+ "
                     r"SLO=", out.stdout, re.M)
    assert re.search(r"trace: \d+ events \(0 dropped\)", out.stdout)


@pytest.mark.parametrize("argv,match", [
    (["--fleet", "smollm-360m,edge-6b", "--executor", "slot"],
     "requires --executor paged"),
    (["--fleet", "smollm-360m,edge-6b", "--scheduler", "orca"],
     "Orca/FastServe fleets"),
    (["--fleet", ","], "comma-separated arch list"),
    (["--fleet", "smollm-360m,hubert-xlarge"], "encoder-only"),
    (["--fleet", "mamba2-780m,edge-6b", "--prefill-chunk", "8"],
     "pure-attention")])
def test_fleet_cli_refusals(argv, match):
    """The JAX CLI's refusals of ``--fleet``, raised before any engine
    serves."""
    with pytest.raises(SystemExit, match=match):
        tserve.run(tserve.parse_args(["--reduced", "--device", "cpu",
                                      *argv]))


def test_one_arch_fleet_is_the_single_model_run(priced_engines, monkeypatch):
    """``--fleet edge-6b`` is the single-model run of ``--arch edge-6b``:
    the same l(b), decisions, token times and greedy streams (the steps
    priced, task ids drawn from the same start)."""
    streams = {}
    release = tex.PagedTorchExecutor.release

    def recording_release(self, task):
        streams[task.task_id] = self.generated_tokens(task)
        release(self, task)

    monkeypatch.setattr(tex.PagedTorchExecutor, "release", recording_release)
    base = ["--reduced", "--device", "cpu", "--duration", "2", "--rate", "3",
            "--slots", "4", "--max-seq", "64", "--ratio", "0.5"]
    runs = {}
    for how in (["--arch", "edge-6b"], ["--fleet", "edge-6b"]):
        monkeypatch.setattr(ttask, "_ids", itertools.count(1))
        streams.clear()
        run = tserve.run(tserve.parse_args(base + how))
        res = run.result.merged if how[0] == "--fleet" else run.result
        probes = (run.probes["edge-6b"] if how[0] == "--fleet"
                  else run.probes)
        runs[how[0]] = (probes, res.decode_iterations, res.prefills,
                        res.end_ms, dict(res.defers_by_reason),
                        [(t.task_id, t.finished, t.dropped,
                          tuple(t.token_times_ms)) for t in res.tasks],
                        dict(streams))
    single, fleet = runs["--arch"], runs["--fleet"]
    assert len(single[5]) >= 4 and single[1] > 0
    assert fleet == single


def test_fleet_needs_the_card_by_default():
    """``engine_fleet`` and ``--fleet`` run on the card unless the caller
    asks for the CPU; without a card they raise, nothing falls back."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tfleet.engine_fleet(["smollm-360m"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tserve.run(tserve.parse_args(["--fleet", "smollm-360m", "--reduced"]))
