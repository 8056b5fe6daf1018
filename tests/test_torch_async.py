"""The port's async pipelined paged engine (DESIGN.md §10) on the CPU.

``PagedTorchExecutor(async_dispatch=True)`` against the synchronous
engine on the same weights and the same Task objects: greedy streams
equal and logits bit for bit (both run the same ops on the same inputs;
only when results are observed differs), pool and ledger consistent,
across plain decode, a bucket change, chunked prefill, prefix sharing,
suspend/resume (also while a decode is in flight), speculative depths,
the Orca serving loop, an SSM arch's state swap, release with steps in
flight, an injected commit failure, and random interleavings
(hypothesis). One case holds the port's async engine against the JAX
package's async engine on the same weights (logits within 1e-5).
These are the cases of ``tests/test_async_engine.py`` but the sharded
one, plus the port's own.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from helpers import assert_logits_close, drive_async, drive_plain  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serving.executor import PagedJaxExecutor  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.schedulers import OrcaScheduler  # noqa: E402
from repro_torch.core.task import SLOSpec, Task, qa_task  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.serving.executor import PagedTorchExecutor  # noqa: E402
from repro_torch.serving.loop import run_serving_loop  # noqa: E402

ENGINE = dict(n_pages=64, page_size=8, max_seq=128, max_batch=4)


@pytest.fixture(scope="module")
def setup():
    cfg = get_config("smollm-360m").reduced()
    return cfg, TM.init_params(cfg, seed=0, device="cpu")


@pytest.fixture(autouse=True, scope="module")
def one_cpu_thread():
    """PyTorch's CPU ops on one intra-op thread: beside the other test
    processes its default pool (a thread per core) waits on itself at
    every op, and a reduced step slows many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(cfg, params, **kw):
    """(synchronous engine, async engine) on the same weights."""
    kw = {**ENGINE, **kw}
    return (PagedTorchExecutor(cfg, params=params, device="cpu",
                               async_dispatch=False, **kw),
            PagedTorchExecutor(cfg, params=params, device="cpu",
                               async_dispatch=True, **kw))


def _equal_logits(a, b):
    np.testing.assert_array_equal(b, a)


# ------------------------------------------------------------ plain decode

def test_plain_decode_streams_and_logits_match(setup):
    exA, exB = _pair(*setup)
    tasks = [qa_task(prompt_len=ln, output_len=32) for ln in (5, 23, 17)]
    for t in tasks:
        exA.prefill(t)
        exB.prefill(t)
        _equal_logits(exA.last_prefill_logits, exB.last_prefill_logits)
    assert drive_plain(exA, tasks, 10) == drive_async(exB, tasks, 10)
    _equal_logits(exA.last_logits, exB.last_logits)
    assert exB.gap_stats.cycles > 0 and exB.gap_stats.stalls > 0
    assert len(exB._queue) == 0 and not exB._tok_dev
    exB.pool.check()


def test_async_drive_matches_per_step_observation(setup):
    """Observing every step commits each at once; the pipelined drive
    must give the same streams."""
    cfg, params = setup
    _, exB1 = _pair(cfg, params)
    _, exB2 = _pair(cfg, params)
    tasks = [qa_task(prompt_len=9, output_len=24) for _ in range(2)]
    for t in tasks:
        exB1.prefill(t)
        exB2.prefill(t)
    assert drive_plain(exB1, tasks, 8) == drive_async(exB2, tasks, 8)


def test_batch_bucket_change_mid_stream(setup):
    """3 -> 1 -> 3 tasks crosses the batch buckets 4 -> 1 -> 4 with steps
    in flight: the chained tokens are gathered across steps."""
    exA, exB = _pair(*setup)
    tasks = [qa_task(prompt_len=7, output_len=32) for _ in range(3)]
    for ex in (exA, exB):
        for t in tasks:
            ex.prefill(t)
        for _ in range(3):
            ex.decode(tasks)
        for _ in range(3):
            ex.decode(tasks[:1])
        for _ in range(2):
            ex.decode(tasks[::-1])          # and back, rows reordered
        ex.drain()
    assert [exA.generated_tokens(t) for t in tasks] == \
           [exB.generated_tokens(t) for t in tasks]
    _equal_logits(exA.last_logits, exB.last_logits)


# ------------------------------------------------------------ chunked prefill

def test_chunked_prefill_streams_match(setup):
    exA, exB = _pair(*setup, prefill_chunk_size=8)
    tasks = [qa_task(prompt_len=20, output_len=16) for _ in range(2)]
    for ex in (exA, exB):
        for t in tasks:
            done = False
            while not done:
                _, done = ex.prefill_chunk(t, 8)
    _equal_logits(exA.last_prefill_logits, exB.last_prefill_logits)
    assert drive_plain(exA, tasks, 8) == drive_async(exB, tasks, 8)
    assert exA.pool.page_table(tasks[1].task_id) == \
        exB.pool.page_table(tasks[1].task_id)


# ------------------------------------------------------------ prefix sharing

def test_prefix_sharing_streams_and_pages_match(setup):
    exA, exB = _pair(*setup, prefix_cache=True)
    psz = exA.page_size
    tasks = [qa_task(prompt_len=3 * psz + 5, output_len=16)
             for _ in range(3)]
    for t in tasks:
        t.prefix_group, t.prefix_len = 1, 2 * psz
    for t in tasks:
        exA.prefill(t)
        exB.prefill(t)
        _equal_logits(exA.last_prefill_logits, exB.last_prefill_logits)
    assert exA.pool.free_pages == exB.pool.free_pages
    assert exB.prefix_cache.hits == 2
    assert drive_plain(exA, tasks, 8) == drive_async(exB, tasks, 8)
    assert [exA.pool.page_table(t.task_id) for t in tasks] == \
        [exB.pool.page_table(t.task_id) for t in tasks]
    exB.pool.check()


# ------------------------------------------------------- suspend / resume

def test_suspend_resume_mid_stream_matches(setup):
    exA, exB = _pair(*setup)
    tasks = [qa_task(prompt_len=12, output_len=48) for _ in range(2)]
    for ex in (exA, exB):
        for t in tasks:
            ex.prefill(t)
        for _ in range(4):
            ex.decode(tasks)
        ex.suspend(tasks[0])
        for _ in range(3):
            ex.decode(tasks[1:])
        ex.resume(tasks[0])
        for _ in range(3):
            ex.decode(tasks)
        ex.drain()
    assert [exA.generated_tokens(t) for t in tasks] == \
           [exB.generated_tokens(t) for t in tasks]
    _equal_logits(exA.last_logits, exB.last_logits)
    assert exB.ledger.outstanding() == 0 and exB.ledger.started == 1
    exB.ledger.check()
    exB.arena.check()
    exB.pool.check()


def test_suspend_during_in_flight_decode_lands_after_commit(setup):
    """A suspend issued while decodes are in flight commits them first:
    the swapped pages hold every committed token."""
    _, exB = _pair(*setup)
    tasks = [qa_task(prompt_len=12, output_len=48) for _ in range(2)]
    for t in tasks:
        exB.prefill(t)
    pre_len = exB.pool.length(tasks[0].task_id)
    for _ in range(3):
        exB.decode(tasks)
    assert len(exB._queue) > 0
    exB.suspend(tasks[0])
    assert len(exB._queue) == 0
    assert len(exB.generated_tokens(tasks[0])) == 1 + 3
    exB.resume(tasks[0])
    assert exB.pool.length(tasks[0].task_id) == pre_len + 3
    exB.decode(tasks)
    exB.drain()
    assert len(exB.generated_tokens(tasks[0])) == 1 + 4


# ------------------------------------------------------- speculative decode

def test_spec_decode_depths_match(setup):
    exA, exB = _pair(*setup, spec_decode=True, max_spec_depth=4)
    tasks = [qa_task(prompt_len=10, output_len=40) for _ in range(2)]
    for ex in (exA, exB):
        for t in tasks:
            ex.prefill(t)
        for depths in ([2, 3], [0, 4], [3, 1], [4, 4], [1, 0]):
            ex.decode(tasks, depths=depths)
            ex.decode(tasks)                 # plain decode behind a verify
        ex.drain()
    assert [exA.generated_tokens(t) for t in tasks] == \
           [exB.generated_tokens(t) for t in tasks]
    assert exA.last_commits == exB.last_commits
    assert exA.accepted_tokens == exB.accepted_tokens
    assert exA.drafted_tokens == exB.drafted_tokens
    assert exA.spec_steps == exB.spec_steps == 5
    _equal_logits(exA.last_logits, exB.last_logits)
    exB.decode(tasks, depths=[2, 2])
    assert exB.last_commits is not None and exB.last_verify[0] == 3


# ------------------------------------------------------- loop-level metrics

def _loop_workload():
    return [Task(slo=SLOSpec(tpot_ms=100.0, ttft_ms=2000.0), utility=1.0,
                 prompt_len=8 + 3 * i, output_len=10, arrival_ms=float(i),
                 task_id=9000 + i, kind="qa") for i in range(4)]


def test_loop_metrics_equivalence_under_orca(setup):
    exA, exB = _pair(*setup)
    resA = run_serving_loop(OrcaScheduler(max_batch=4), exA, _loop_workload())
    resB = run_serving_loop(OrcaScheduler(max_batch=4), exB, _loop_workload())
    for field in ("decode_iterations", "prefills", "prefill_chunks",
                  "suspends", "resumes", "spec_extra_tokens",
                  "drafted_tokens", "accepted_tokens"):
        assert getattr(resA, field) == getattr(resB, field), field
    for a, b in zip(resA.tasks, resB.tasks):
        assert a.finished == b.finished
        assert a.tokens_done == b.tokens_done
        assert len(a.token_times_ms) == len(b.token_times_ms)
    assert resB.dispatch_ms > 0.0 and resA.dispatch_ms == 0.0
    assert exB.pool.used_pages == 0 and len(exB._queue) == 0


# ------------------------------------------------------- the port's own

def test_ssm_async_suspend_resume_restores_the_state_blob():
    """A reduced mamba2-780m async engine: a suspend while decodes are in
    flight swaps the state slot out as one blob, resume writes it back
    bit for bit, and the streams equal the synchronous engine's."""
    cfg = get_config("mamba2-780m").reduced()
    params = TM.init_params(cfg, seed=0, device="cpu")
    exA, exB = _pair(cfg, params, n_pages=48, page_size=16)
    tasks = [qa_task(prompt_len=n, output_len=32) for n in (5, 17, 2)]
    state = {}
    for ex in (exA, exB):
        for t in tasks:
            ex.prefill(t)
        for _ in range(2):
            ex.decode(tasks)
        ex.drain()
        slot = ex.states.slot_of(tasks[0].task_id)
        state[ex] = [ex.pages[n][:, slot].clone()
                     for n in ("ssm_state", "conv_state")]
        ex.decode(tasks[1:])                 # in flight at the suspend
        ex.suspend(tasks[0])
        assert ex.states.is_swapped(tasks[0].task_id)
        for _ in range(2):
            ex.decode(tasks[1:])
        ex.resume(tasks[0])
        slot = ex.states.slot_of(tasks[0].task_id)
        ex.drain()
        assert all(torch.equal(a, ex.pages[n][:, slot]) for a, n in zip(
            state[ex], ("ssm_state", "conv_state")))
        for _ in range(2):
            ex.decode(tasks)
        ex.drain()
    assert [exA.generated_tokens(t) for t in tasks] == \
           [exB.generated_tokens(t) for t in tasks]
    _equal_logits(exA.last_logits, exB.last_logits)
    assert exB.ledger.started == 1 and exB.ledger.outstanding() == 0
    for ex in (exA, exB):
        for t in tasks:
            ex.release(t)
        ex.store.check()
        assert not ex.store.leaked()


def test_release_with_steps_in_flight(setup):
    """Releasing a task commits through its in-flight steps first; the
    other task's stream is the synchronous engine's."""
    exA, exB = _pair(*setup)
    tasks = [qa_task(prompt_len=9, output_len=32) for _ in range(2)]
    for ex in (exA, exB):
        for t in tasks:
            ex.prefill(t)
        for _ in range(2):
            ex.decode(tasks)
    assert exB._queue.pending_for(tasks[0].task_id) == 2
    for ex in (exA, exB):
        ex.release(tasks[0])
        assert not ex.pool.holds(tasks[0].task_id)
        for _ in range(3):
            ex.decode(tasks[1:])
    assert exB._queue.pending_for(tasks[0].task_id) == 0
    assert exA.generated_tokens(tasks[1]) == exB.generated_tokens(tasks[1])
    assert exA.pool.used_pages == exB.pool.used_pages
    exB.pool.check()


def test_commit_failure_rolls_back_the_uncommitted_steps(setup, monkeypatch):
    """A commit that raises: the steps behind it are rolled back newest
    first (a fresh prefill gives its pages back, a decode its extension),
    the error propagates, and the pool is as it was before them."""
    _, ex = _pair(*setup)
    tasks = [qa_task(prompt_len=9, output_len=32) for _ in range(2)]
    late = qa_task(prompt_len=11, output_len=8)
    for t in tasks:
        ex.prefill(t)
    ex.decode(tasks)
    ex.drain()
    before = {t.task_id: ex.pool.length(t.task_id) for t in tasks}
    used = ex.pool.used_pages
    real = ex._commit_step
    poisoned = []

    def commit(step):
        if step.kind == "decode" and not poisoned:
            poisoned.append(step)
            raise RuntimeError("device fault")
        real(step)

    monkeypatch.setattr(ex, "_commit_step", commit)
    ex._queue._commit = commit
    ex.decode(tasks)                         # the poisoned step
    ex.prefill(late)                         # behind it: a fresh prefill
    assert ex.pool.holds(late.task_id) and len(ex._queue) == 2
    with pytest.raises(RuntimeError, match="device fault"):
        ex.decode(tasks)                     # the push commits the oldest
    assert len(ex._queue) == 0
    assert not ex.pool.holds(late.task_id)
    # the poisoned step's own extension stays (it was dispatched), the
    # steps behind it are undone, the one being pushed too
    assert {t.task_id: ex.pool.length(t.task_id) for t in tasks} == {
        i: n + 1 for i, n in before.items()}
    assert ex.pool.used_pages <= used + len(tasks)
    assert not ex._tok_dev and ex._pushing is None
    ex.pool.check()
    # with nothing queued behind the poisoned step, the pushed one alone
    poisoned.clear()
    _, one = _pair(*setup, max_in_flight=1)
    monkeypatch.setattr(one, "_commit_step", commit)
    one._queue._commit = commit
    one.prefill(tasks[0])
    one.drain()
    n = one.pool.length(tasks[0].task_id)
    one.decode(tasks[:1])
    with pytest.raises(RuntimeError, match="device fault"):
        one.decode(tasks[:1])
    assert one.pool.length(tasks[0].task_id) == n + 1
    one.pool.check()


def test_latency_model_probes_synchronously(setup, monkeypatch):
    """latency_model() on an async engine times whole steps: nothing is
    pushed on the queue and the probes book wait, not dispatch."""
    _, ex = _pair(*setup)

    def no_push(step):
        raise AssertionError("a latency probe was dispatched ahead")

    monkeypatch.setattr(ex, "_push", no_push)
    lat = ex.latency_model()
    assert [b for b, _ in ex.probe_samples] == [1, 2, 4]
    assert all(ms > 0 for _, ms in ex.probe_samples)
    assert lat.decode_ms(1) == ex.probe_samples[0][1]
    assert ex.gap_stats.dispatch_ms == 0.0 and ex.gap_stats.wait_ms > 0
    assert ex.pool.used_pages == 0 and ex._sync_depth == 0


def test_async_matches_the_jax_async_engine():
    """The port's async engine against ``PagedJaxExecutor(async_dispatch=
    True)`` on the same weights: plain decode and a suspend/resume, greedy
    streams equal and logits within 1e-5."""
    jcfg = jax_config("smollm-360m").reduced()
    cfg = get_config("smollm-360m").reduced()
    jp = JM.init_params(jcfg, jax.random.PRNGKey(3))
    tp = TM.load_params(cfg, jax.tree_util.tree_map(np.asarray, jp),
                        device="cpu")
    jx = PagedJaxExecutor(jcfg, params=jp, async_dispatch=True, **ENGINE)
    tx = PagedTorchExecutor(cfg, params=tp, device="cpu",
                            async_dispatch=True, **ENGINE)
    tasks = [Task(SLOSpec(tpot_ms=100.0), 1.0, prompt_len=n, output_len=40,
                  task_id=9300 + i) for i, n in enumerate((5, 17, 12))]
    for t in tasks:
        jx.prefill(t)
        tx.prefill(t)
        assert_logits_close(tx.last_prefill_logits, jx.last_prefill_logits)
    for ex in (jx, tx):
        for _ in range(3):
            ex.decode(tasks)
        ex.suspend(tasks[0])
        for _ in range(2):
            ex.decode(tasks[1:])
        ex.resume(tasks[0])
        for _ in range(3):
            ex.decode(tasks)
        ex.drain()
    assert [jx.generated_tokens(t) for t in tasks] == \
           [tx.generated_tokens(t) for t in tasks]
    assert_logits_close(tx.last_logits, jx.last_logits)


# ------------------------------------------------------- interleavings

OPS = st.lists(st.tuples(st.sampled_from(["decode", "suspend", "resume",
                                          "release"]),
                         st.integers(0, 15)), min_size=1, max_size=12)


@settings(max_examples=15, deadline=None)
@given(ops=OPS)
def test_random_interleavings_match_sync(setup, ops):
    """Random decode (over a subset), suspend, resume and release calls
    on a synchronous and an async engine: identical streams (each
    released task's read at its release), a consistent pool and an idle
    ledger after drain()."""
    cfg, params = setup
    engines = _pair(cfg, params, n_pages=40)
    tasks = [Task(SLOSpec(tpot_ms=100.0), 1.0, prompt_len=n, output_len=64,
                  task_id=9400 + i) for i, n in enumerate((6, 14, 9, 3))]
    streams = [{}, {}]
    for ex in engines:
        for t in tasks:
            ex.prefill(t)
    live = {t.task_id: "resident" for t in tasks}
    for op, arg in ops:
        resident = [t for t in tasks if live.get(t.task_id) == "resident"]
        swapped = [t for t in tasks if live.get(t.task_id) == "swapped"]
        if op == "decode":
            batch = [t for k, t in enumerate(resident) if arg >> k & 1]
            if not batch:
                continue
            for ex in engines:
                ex.decode(batch)
        elif op in ("suspend", "release") and resident:
            t = resident[arg % len(resident)]
            for e, ex in enumerate(engines):
                if op == "suspend":
                    ex.suspend(t)
                else:
                    streams[e][t.task_id] = ex.generated_tokens(t)
                    ex.release(t)
            live[t.task_id] = "swapped" if op == "suspend" else None
        elif op == "resume" and swapped:
            t = swapped[arg % len(swapped)]
            for ex in engines:
                ex.resume(t)
            live[t.task_id] = "resident"
    for e, ex in enumerate(engines):
        ex.drain()
        for t in tasks:
            if live.get(t.task_id) is not None:
                streams[e][t.task_id] = ex.generated_tokens(t)
        ex.pool.check()
        ex.arena.check()
    assert streams[0] == streams[1]
    assert engines[1].ledger.outstanding() == 0
    engines[1].ledger.check()
    assert engines[0].pool.used_pages == engines[1].pool.used_pages
