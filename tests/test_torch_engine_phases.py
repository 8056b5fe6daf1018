"""The phases of the paged engine's ops (``step_graphs.PhaseTimer``), on
the reduced edge-6b engine on the CPU, synchronous.

A traced ``InstanceDriver`` attaches the trace to the engine: every
prefill, chunk and decode span then carries ``stage_ms``, ``graph_ms``,
``gaps_ms``, ``commit_ms`` (on the CPU the steps' host time), ``graphs``
and ``captures``, and the four times partition the op's host wall
within 1%. A chunk op of several pieces counts each piece's step. The
driver emits one ``engine_setup`` instant with the steps the probe and
the warm-up made. An untraced engine times nothing: no phases, no CUDA
event, no clock read and no sync beyond its own. Tracing changes no
decision, token or timestamp. The async engine reports no phases.
Imports no JAX.
"""
from __future__ import annotations

import time

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import schedulers as sched  # noqa: E402
from repro_torch.core.latency_model import MeasuredLatencyModel  # noqa: E402
from repro_torch.core.task import SLOSpec, Task  # noqa: E402
from repro_torch.data.workload import poisson_workload  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.serving import executor as tex  # noqa: E402
from repro_torch.serving.executor import PagedTorchExecutor  # noqa: E402
from repro_torch.serving.loop import InstanceDriver, run_serving_loop  # noqa: E402
from repro_torch.serving.trace import TraceRecorder  # noqa: E402

ENGINE = dict(n_pages=24, page_size=8, max_seq=64, max_batch=4)
SAMPLES = [(1, 8.0), (2, 9.0), (4, 11.0)]
PREFILL = [(8, 4.0), (64, 12.0)]
TIMES = ("stage_ms", "graph_ms", "gaps_ms", "commit_ms")
FIELDS = TIMES + ("graphs", "captures")
OPS = {"prefill": "prefill", "prefill_chunk": "chunk", "decode": "decode"}


@pytest.fixture(scope="module")
def params():
    cfg = get_config("edge-6b").reduced()
    return cfg, M.init_params(cfg, seed=3, device="cpu")


@pytest.fixture(autouse=True, scope="module")
def one_cpu_thread():
    """One intra-op thread: beside the other test processes the default
    pool waits on itself at every op."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Walled:
    """The engine with each op's host wall kept (``walls``: kind, ms from
    the call to the return) and its ms priced from the latency model, so
    that the loop's decisions and stamps do not depend on the host."""

    def __init__(self, inner, lat):
        self.inner, self.lat = inner, lat
        self.walls = []
        self.streams = {}

    def _timed(self, kind, fn):
        t0 = time.perf_counter()
        out = fn()
        self.walls.append((kind, (time.perf_counter() - t0) * 1000.0))
        return out

    def prefill(self, task):
        self._timed("prefill", lambda: self.inner.prefill(task))
        return self.lat.prefill_ms(task.prompt_len)

    def prefill_chunk(self, task, n_tokens):
        _, done = self._timed(
            "chunk", lambda: self.inner.prefill_chunk(task, n_tokens))
        return self.lat.prefill_ms(n_tokens), done

    def decode(self, tasks, depths=None):
        self._timed("decode", lambda: self.inner.decode(tasks, depths))
        return self.lat.decode_ms(len(tasks))

    def release(self, task):
        self.streams[task.task_id] = self.inner.generated_tokens(task)
        self.inner.release(task)

    def __getattr__(self, name):          # page_budget, attach_trace, ...
        return getattr(self.inner, name)


def _engine(params, **kw):
    cfg, p = params
    return PagedTorchExecutor(cfg, params=p, device="cpu", **ENGINE, **kw)


def _task(tid, prompt, out=6):
    return Task(SLOSpec(tpot_ms=100.0, ttft_ms=2000.0), 1.0,
                prompt_len=prompt, output_len=out, task_id=tid)


def _run(params, trace, chunk=None):
    ex = _engine(params, prefill_chunk_size=chunk)
    lat = MeasuredLatencyModel(SAMPLES, PREFILL)
    s = sched.SliceScheduler(lat, page_budget=ex.page_budget(),
                             prefill_chunk=chunk)
    tasks = poisson_workload(20.0, 0.6, realtime_frac=0.4, seed=11,
                             rt_output_len=4, voice_output_len=8,
                             qa_output_len=10, rt_prompt=(4, 12),
                             voice_prompt=(6, 20), qa_prompt=(8, 28))
    for i, t in enumerate(tasks):         # pin ids: prompts derive from them
        t.task_id = 7000 + i
    walled = Walled(ex, lat)
    res = run_serving_loop(s, walled, tasks, max_ms=1e6, trace=trace)
    return res, walled, ex


def _fingerprint(res):
    return (res.decode_iterations, res.prefills, res.prefill_chunks,
            res.end_ms, dict(res.defers_by_reason),
            [(t.task_id, t.finished, t.dropped, t.tokens_done,
              tuple(t.token_times_ms)) for t in res.tasks])


def _partitioned(ph, wall_ms):
    return abs(sum(ph[k] for k in TIMES) - wall_ms) <= 0.01 * wall_ms


CHUNKS = pytest.mark.parametrize("chunk", [None, 8], ids=["atomic", "chunked"])


@CHUNKS
def test_spans_carry_phases_that_partition_each_op(params, chunk):
    tr = TraceRecorder()
    res, walled, ex = _run(params, tr, chunk)
    spans = [e for e in tr.events if e.kind in OPS]
    assert [OPS[e.kind] for e in spans] == [k for k, _ in walled.walls]
    kinds = {e.kind for e in spans}
    assert kinds == ({"prefill_chunk", "decode"} if chunk
                     else {"prefill", "decode"})
    for e, (_, wall) in zip(spans, walled.walls):
        assert set(FIELDS) <= set(e.args), e
        assert e.args["graphs"] >= 1 and e.args["captures"] >= 0
        assert min(e.args[k] for k in TIMES) >= 0.0
        assert _partitioned(e.args, wall), (e.args, wall)
    # every step made after the trace was attached is in some span
    setup = [e for e in tr.events if e.kind == "engine_setup"]
    assert len(setup) == 1 and setup[0].args["captures"] == 0
    assert sum(e.args["captures"] for e in spans) == ex.graphs.captures > 0
    assert res.decode_iterations > 0


def test_chunk_op_of_several_pieces_counts_each_step(params):
    ex = _engine(params, prefill_chunk_size=8)
    ex.attach_trace()
    t = _task(1, 29)
    t0 = time.perf_counter()
    ex.prefill_chunk(t, 13)                # pieces of 8, 4 and 1
    wall = (time.perf_counter() - t0) * 1000.0
    ph = ex.last_phases
    assert ph["graphs"] == 3 and ph["captures"] == 3
    assert ph["gaps_ms"] > 0.0 and _partitioned(ph, wall)
    ex.prefill_chunk(t, 16)                # 8 and 8
    assert ex.last_phases["graphs"] == 2
    assert ex.last_phases["captures"] == 0
    ex.decode([t])
    assert ex.last_phases["graphs"] == 1
    assert ex.last_phases["gaps_ms"] == 0.0


@pytest.mark.parametrize("traced", [False, True], ids=["untraced", "traced"])
def test_untraced_engine_times_nothing(params, monkeypatch, traced):
    """Untraced, an op reads the clock only where it did before (its
    dispatch start, its clock's start and end), makes no CUDA event and
    syncs once; traced, it reads more clocks and still syncs once."""
    ex = _engine(params)
    a, b, c = _task(1, 12), _task(2, 12), _task(3, 12)
    ex.prefill(a)
    ex.prefill(b)
    ex.decode([a, b])                       # the steps below, made
    if traced:
        ex.attach_trace()
    reads, syncs = [0], [0]
    clock, sync = time.perf_counter, tex._sync

    def counted_clock():
        reads[0] += 1
        return clock()

    def counted_sync(device):
        syncs[0] += 1
        sync(device)

    def no_event(*args, **kwargs):
        raise AssertionError("a CUDA event was made")

    monkeypatch.setattr(time, "perf_counter", counted_clock)
    monkeypatch.setattr(tex, "_sync", counted_sync)
    monkeypatch.setattr(torch.cuda, "Event", no_event)
    for op in (lambda: ex.prefill(c), lambda: ex.decode([a, c])):
        reads[0] = syncs[0] = 0
        op()
        assert syncs[0] == 1
        if traced:
            assert reads[0] > 3 and ex.last_phases["graphs"] == 1
        else:
            assert reads[0] == 3
            assert ex.last_phases is None and ex.graphs.timer is None


@CHUNKS
def test_traced_run_equals_untraced(params, chunk):
    traced, t_walled, _ = _run(params, TraceRecorder(), chunk)
    plain, p_walled, ex = _run(params, None, chunk)
    assert _fingerprint(traced) == _fingerprint(plain)
    assert t_walled.streams == p_walled.streams
    assert len(p_walled.streams) >= 8
    assert ex._phases is None


def test_engine_setup_counts_the_probe_and_warm_up_steps(params):
    ex = _engine(params)
    ex.latency_model()
    probed = ex.graphs.captures
    for i, L in enumerate((9, 17, 17)):     # two prompt lengths
        t = _task(100 + i, L)
        ex.prefill(t)
        ex.decode([t])
        ex.release(t)
    assert probed > 0 and ex.graphs.captures == len(ex.graphs.steps)
    made, ms = ex.graphs.captures, ex.graphs.make_ms
    s = sched.SliceScheduler(MeasuredLatencyModel(SAMPLES, PREFILL),
                             page_budget=ex.page_budget())
    InstanceDriver(s, ex)                   # untraced: nothing attached
    assert ex._phases is None
    tr = TraceRecorder()
    InstanceDriver(s, ex, trace=tr, name="edge")
    (e,) = tr.events
    assert (e.kind, e.ts, e.task_id, e.instance) == ("engine_setup", 0.0, -1,
                                                     "edge")
    assert e.args == {"captures": made, "make_ms": ms} and ms > 0.0


def test_async_engine_reports_no_phases(params):
    ex = _engine(params, async_dispatch=True)
    tr = TraceRecorder()
    s = sched.SliceScheduler(MeasuredLatencyModel(SAMPLES, PREFILL),
                             page_budget=ex.page_budget())
    InstanceDriver(s, ex, trace=tr)
    assert [e.kind for e in tr.events] == ["engine_setup"]
    t = _task(1, 12)
    ex.prefill(t)
    ex.decode([t])
    ex.drain()
    assert ex.last_phases is None and ex.graphs.timer is None


class FakeEvent:
    """A timing event on a fake device clock (``FakeEvent.now``, ms)."""
    now = 0.0

    def __init__(self, enable_timing=False, external=False):
        self.t = None

    def record(self):
        self.t = FakeEvent.now

    def query(self):
        return self.t is not None and self.t <= FakeEvent.done

    def elapsed_time(self, other):
        return other.t - self.t


@pytest.mark.parametrize("done", [True, False], ids=["read", "overwritten"])
def test_timer_reads_a_rerun_graphs_marks_before_they_are_reused(
        monkeypatch, done):
    """The device path of ``PhaseTimer`` on fake events: an op runs
    captured step A twice, then B. A's first marks are read before its
    second replay records them anew when they have completed; otherwise
    that run falls back to the pair recorded around its replay (its
    start then holds the launch). The others' come from their marks."""
    from types import SimpleNamespace

    from repro_torch.serving.step_graphs import PhaseTimer
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    FakeEvent.done = 100.0 if done else 0.0
    tm = PhaseTimer(SimpleNamespace(capture=True, captures=5))
    class Marked:                          # a captured step's marks
        def __init__(self):
            self.marks = (FakeEvent(), FakeEvent())

    a, b = Marked(), Marked()

    def run(step, host_at, start, end):
        FakeEvent.now = host_at              # the pair's first event
        tm.start(step)
        step.marks[0].t, step.marks[1].t = start, end
        FakeEvent.now = end                  # the stream's end
        tm.stop(step)

    tm.enter()
    FakeEvent.now = 0.0
    tm.anchor()
    run(a, 0.5, 1.0, 5.0)
    run(a, 5.0, 6.0, 9.0)
    run(b, 9.0, 9.5, 12.0)
    tm.leave()
    ph = tm.last()
    first = 1.0 if done else 0.5
    assert ph["graphs"] == 3 and ph["captures"] == 0
    assert ph["graph_ms"] == pytest.approx((5 - first) + 3 + 2.5)
    assert ph["gaps_ms"] == pytest.approx(1.0 + 0.5)
    assert ph["stage_ms"] == pytest.approx(
        (tm._t_anchor - tm._entry) * 1000.0 + first)
    total = sum(ph[k] for k in TIMES)
    assert total == pytest.approx((tm._ret - tm._entry) * 1000.0)
