"""The port's lifecycle trace (``repro_torch.serving.trace``, DESIGN.md
§13) over the port's paged engine, synchronous and async.

The replay-ledger properties of ``tests/test_trace.py`` re-run on the
torch engine (the JAX file runs them on its simulated executor): tracing
changes no decision, token or timestamp; ``replay_counters`` over the
event stream reproduces the LoopResult exactly, atomic under KV-swap
pressure (suspend and resume fire) and chunked; ``slo_attribution``
partitions the violated requests; the Perfetto export round-trips; the
ring drops and counts; snapshots are sampled. The loop runs on a priced
clock (every op returns ms priced from one latency model, the async
queue's commits on a ``FakeClock``), so a run is deterministic: the
port's traced SLICE loop gives the JAX package's event stream (kinds,
tasks, timestamps, payloads) on the same weights, and the async engine's
stream equals the synchronous one. Plus the CLI: an async traced serve
run on the CPU that writes its trace and imports no JAX.
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.core import schedulers as jsched  # noqa: E402
from repro.core.latency_model import MeasuredLatencyModel as JLat  # noqa: E402
from repro.data.workload import poisson_workload as j_workload  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serving import trace as jtrace  # noqa: E402
from repro.serving.executor import PagedJaxExecutor  # noqa: E402
from repro.serving.loop import run_serving_loop as jax_loop  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import schedulers as tsched  # noqa: E402
from repro_torch.core.latency_model import MeasuredLatencyModel as TLat  # noqa: E402
from repro_torch.data.workload import poisson_workload as t_workload  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.serving import trace as ttrace  # noqa: E402
from repro_torch.serving.executor import PagedTorchExecutor  # noqa: E402
from repro_torch.serving.loop import run_serving_loop as torch_loop  # noqa: E402
from repro_torch.serving.metrics import (ATTRIBUTION_BUCKETS,  # noqa: E402
                                         slo_attribution)
from repro_torch.serving.pipeline import FakeClock  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# a pool of 12 pages under 40 requests/s: admission defers on pages and
# SLICE suspends residents to admit realtime arrivals
ENGINE = dict(n_pages=12, page_size=8, max_seq=64, max_batch=4)
SAMPLES = [(1, 8.0), (2, 9.0), (4, 11.0)]
PREFILL = [(8, 4.0), (64, 12.0)]
GAP_KEYS = ("schedule_ms", "dispatch_ms", "wait_ms", "swap_overlap_ms")


class Priced:
    """An engine whose ops return ms priced from the latency model (swaps
    1 ms), never measured, and which reads nothing per step: an async
    engine keeps its steps in flight. Each task's stream is read at its
    release."""

    def __init__(self, inner, lat):
        self.inner, self.lat = inner, lat
        self.streams = {}

    def prefill(self, task):
        self.inner.prefill(task)
        return self.lat.prefill_ms(task.prompt_len)

    def prefill_chunk(self, task, n_tokens):
        _, done = self.inner.prefill_chunk(task, n_tokens)
        return self.lat.prefill_ms(n_tokens), done

    def decode(self, tasks, depths=None):
        self.inner.decode(tasks, depths)
        return self.lat.decode_ms(len(tasks))

    def suspend(self, task):
        self.inner.suspend(task)
        return 1.0

    def resume(self, task):
        self.inner.resume(task)
        return 1.0

    def release(self, task):
        gen = self.inner.generated_tokens(task)
        if gen:
            self.streams[task.task_id] = gen
        self.inner.release(task)

    def __getattr__(self, name):           # page_budget, gap_stats, ...
        return getattr(self.inner, name)


@pytest.fixture(scope="module")
def weights():
    jcfg = jax_config("edge-6b").reduced()
    cfg = get_config("edge-6b").reduced()
    jp = JM.init_params(jcfg, jax.random.PRNGKey(2))
    tp = TM.load_params(cfg, jax.tree_util.tree_map(np.asarray, jp),
                        device="cpu")
    return jcfg, cfg, jp, tp


@pytest.fixture(autouse=True, scope="module")
def one_cpu_thread():
    """PyTorch's CPU ops on one intra-op thread: beside the other test
    processes its default pool (a thread per core) waits on itself at
    every op, and a reduced step slows many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _workload(make):
    tasks = make(40.0, 1.0, realtime_frac=0.4, seed=5, rt_output_len=6,
                 voice_output_len=24, qa_output_len=32, rt_prompt=(4, 12),
                 voice_prompt=(6, 20), qa_prompt=(8, 28))
    for i, t in enumerate(tasks):        # pin ids: prompts derive from them
        t.task_id = 5000 + i
    return tasks


def _torch_run(weights, trace=None, chunk=None, async_dispatch=False):
    _, cfg, _, tp = weights
    ex = PagedTorchExecutor(cfg, params=tp, device="cpu",
                            prefill_chunk_size=chunk,
                            async_dispatch=async_dispatch, **ENGINE)
    ex._queue.clock = FakeClock()      # commits priced at 0 ms
    lat = TLat(SAMPLES, PREFILL)
    sched = tsched.SliceScheduler(lat, page_budget=ex.page_budget(),
                                  prefill_chunk=chunk, kv_swap=True)
    priced = Priced(ex, lat)
    res = torch_loop(sched, priced, _workload(t_workload), max_ms=1e6,
                     trace=trace)
    return res, priced.streams, ex


def _jax_run(weights, trace=None, chunk=None):
    jcfg, _, jp, _ = weights
    ex = PagedJaxExecutor(jcfg, params=jp, prefill_chunk_size=chunk,
                          **ENGINE)
    lat = JLat(SAMPLES, PREFILL)
    sched = jsched.SliceScheduler(lat, page_budget=ex.page_budget(),
                                  prefill_chunk=chunk, kv_swap=True)
    priced = Priced(ex, lat)
    res = jax_loop(sched, priced, _workload(j_workload), max_ms=1e6,
                   trace=trace)
    return res, priced.streams


def _fingerprint(res):
    return (res.decode_iterations, res.prefills, res.prefill_chunks,
            res.suspends, res.resumes, res.spec_extra_tokens,
            res.swapped_bytes, res.end_ms, dict(res.defers_by_reason),
            [(t.task_id, t.finished, t.dropped, t.tokens_done, t.ttft_ms,
              tuple(t.token_times_ms)) for t in res.tasks])


def _stream(events):
    """Events with the GapStats deltas (host clock readings) left out."""
    return [(e.ts, e.kind, e.task_id, e.instance, e.dur,
             {k: v for k, v in e.args.items() if k not in GAP_KEYS})
            for e in events]


MODES = pytest.mark.parametrize("async_dispatch", [False, True],
                                ids=["sync", "async"])


# ------------------------------------------------------------- read-only

@MODES
def test_untraced_run_identical_to_traced(weights, async_dispatch):
    tr = ttrace.TraceRecorder()
    traced, t_streams, _ = _torch_run(weights, tr,
                                      async_dispatch=async_dispatch)
    plain, p_streams, _ = _torch_run(weights, None,
                                     async_dispatch=async_dispatch)
    assert len(tr) > 0
    assert _fingerprint(traced) == _fingerprint(plain)
    assert t_streams == p_streams and len(t_streams) >= 20


# ---------------------------------------------------------- conservation

@MODES
@pytest.mark.parametrize("chunk", [None, 8], ids=["atomic", "chunked"])
def test_events_conserved_engine_loop(weights, async_dispatch, chunk):
    tr = ttrace.TraceRecorder()
    res, _, ex = _torch_run(weights, tr, chunk=chunk,
                            async_dispatch=async_dispatch)
    assert tr.dropped == 0
    assert ttrace.events_conserved(tr.events, res)
    # the swap half of the check is not vacuous
    assert res.suspends > 0 and res.resumes > 0
    kinds = {e.kind for e in tr.events}
    assert {"arrive", "admit", "defer", "decode", "suspend", "resume",
            "finish"} <= kinds
    assert ("prefill_chunk" in kinds) == (chunk is not None)
    assert ex.pool.used_pages == 0 and ex.ledger.outstanding() == 0
    if async_dispatch:
        assert res.pipeline_stalls > 0 and res.dispatch_ms > 0


def test_attribution_partitions_violations(weights):
    tr = ttrace.TraceRecorder()
    res, _, _ = _torch_run(weights, tr, async_dispatch=True)
    att = slo_attribution(res.tasks, tr.events)
    assert att["violations"] > 0
    assert sum(att["buckets"].values()) == att["violations"]
    assert set(att["buckets"]) == set(ATTRIBUTION_BUCKETS)
    violated = {t.task_id for t in res.tasks if not t.slo_met()}
    assert set(att["by_task"]) == violated


# ------------------------------------------------------ bounded + export

def test_ring_drops_and_snapshots_sampled(weights):
    small = ttrace.TraceRecorder(capacity=64)
    _torch_run(weights, small, async_dispatch=True)
    assert len(small) == 64 and small.dropped > 0
    tr = ttrace.TraceRecorder(metrics_every=8)
    res, _, _ = _torch_run(weights, tr, async_dispatch=True)
    assert tr.snapshots
    last = tr.snapshots[-1]
    assert last.defers_by_reason == dict(res.defers_by_reason)
    assert last.suspends == res.suspends
    assert max(s.pages_in_use for s in tr.snapshots) > 0
    ts = [s.ts for s in tr.snapshots]
    assert ts == sorted(ts)


def test_perfetto_round_trip(weights, tmp_path):
    tr = ttrace.TraceRecorder()
    res, _, _ = _torch_run(weights, tr, async_dispatch=True)
    path = tmp_path / "trace.json"
    rows = tr.export_perfetto(str(path))
    doc = json.loads(path.read_text())
    evs = doc["traceEvents"]
    assert rows == len(evs)
    assert doc["otherData"]["dropped_events"] == 0
    spans = sorted((e["ts"], e["dur"]) for e in evs if e.get("ph") == "X")
    assert spans and all(e["name"] in ttrace.SPAN_KINDS
                         for e in evs if e.get("ph") == "X")
    for (t0, d0), (t1, _) in zip(spans, spans[1:]):
        assert t1 >= t0 + d0 - 1e-6
    flows = [e for e in evs if e.get("cat") == "req-flow"]
    assert sum(e["ph"] == "s" for e in flows) >= sum(
        t.finished for t in res.tasks)


# ------------------------------------------------ against JAX, sync/async

def test_priced_trace_matches_jax(weights):
    """The same SLICE loop with KV swap on the priced clock over the JAX
    engine and the port's: the same event stream, the same LoopResult
    and greedy streams."""
    jtr, ttr = jtrace.TraceRecorder(), ttrace.TraceRecorder()
    jres, jstreams = _jax_run(weights, jtr)
    tres, tstreams, _ = _torch_run(weights, ttr)
    assert jres.suspends > 0
    assert _stream(ttr.events) == _stream(jtr.events)
    assert _fingerprint(tres) == _fingerprint(jres)
    assert tstreams == jstreams


def test_async_priced_trace_equals_sync(weights):
    sync_tr, async_tr = ttrace.TraceRecorder(), ttrace.TraceRecorder()
    sres, sstreams, _ = _torch_run(weights, sync_tr, chunk=8)
    ares, astreams, ex = _torch_run(weights, async_tr, chunk=8,
                                    async_dispatch=True)
    assert _stream(async_tr.events) == _stream(sync_tr.events)
    assert _fingerprint(ares) == _fingerprint(sres)
    assert astreams == sstreams
    assert ex.gap_stats.stalls > 0 and ex.ledger.started == ares.suspends


# ------------------------------------------------------------------- CLI

_SERVE = """
import json, sys
from repro_torch.launch import serve
serve.main(["--reduced", "--device", "cpu", "--duration", "1.5",
            "--rate", "4", "--slots", "2", "--max-seq", "64",
            "--async-pipeline", "--kv-swap", "--pages", "10",
            "--trace", sys.argv[1], "--metrics-every", "4"])
with open(sys.argv[1]) as f:
    assert json.load(f)["traceEvents"]
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "repro"
             or m.startswith("repro."))
assert not bad, bad
print("CLEAN")
"""


def test_async_traced_serving_run_imports_no_jax(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    path = tmp_path / "serve_trace.json"
    out = subprocess.run([sys.executable, "-c", _SERVE, str(path)], env=env,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "CLEAN" in out.stdout
    assert re.search(r"host_gap=[\d.]+ms \(dispatch=[\d.]+ wait=[\d.]+ "
                     r"swap_overlap=[\d.]+\) stalls=\d+", out.stdout)
    assert re.search(r"trace: \d+ events \(0 dropped\) \d+ snapshots -> ",
                     out.stdout)
