"""The port's radix prefix cache and host KV swap held against the JAX
package on the CPU.

``PagedTorchExecutor(prefix_cache=True)`` against the unshared port
engine and ``PagedJaxExecutor(prefix_cache=True)``: cache-hit prefill and
decode logits, shared page tables, chunked prefill starting at the first
uncached chunk, the page budget's prefix discount, eviction under pool
pressure and under the index's own page budget (``prefix_cache_pages``),
and priced SLICE loops with the prefix hint that end with an empty pool
(the JAX models are ``tests/test_prefix_cache.py`` and
``tests/test_kv_swap.py``). Suspend/resume: decode logits across a swap
equal the never-suspended engine's and JAX's, a shared prefix page stays
resident, and ``HostArenaFull`` rolls the swap back. Same weights (the JAX
``init_params`` through ``load_params``) and pinned task ids. Tolerances:
logits atol 1e-5 (``assert_logits_close``), identical streams and page
counts.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from helpers import assert_logits_close  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.core import schedulers as jsched  # noqa: E402
from repro.core import task as jtask  # noqa: E402
from repro.core.latency_model import MeasuredLatencyModel as JLat  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serving.executor import PagedJaxExecutor  # noqa: E402
from repro.serving.kv_swap import HostArenaFull as JFull  # noqa: E402
from repro.serving.loop import run_serving_loop as jax_loop  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import schedulers as tsched  # noqa: E402
from repro_torch.core import task as ttask  # noqa: E402
from repro_torch.core.latency_model import MeasuredLatencyModel as TLat  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.serving.executor import PagedTorchExecutor  # noqa: E402
from repro_torch.serving.kv_swap import HostArenaFull  # noqa: E402
from repro_torch.serving.loop import run_serving_loop as torch_loop  # noqa: E402

ARCH = "smollm-360m"        # reduced: 2 layers, d_model 256, GQA -> 1 head
ENGINE = dict(n_pages=16, page_size=8, max_seq=64, max_batch=4)


@pytest.fixture(scope="module")
def weights():
    jcfg = jax_config(ARCH).reduced()
    cfg = get_config(ARCH).reduced()
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, cfg, jp, jax.tree_util.tree_map(np.asarray, jp)


def _torch(weights, **kw):
    _, cfg, _, tree = weights
    return PagedTorchExecutor(cfg, params=TM.load_params(cfg, tree,
                                                         device="cpu"),
                              device="cpu", **{**ENGINE, **kw})


def _jax(weights, **kw):
    jcfg, _, jp, _ = weights
    return PagedJaxExecutor(jcfg, params=jp, **{**ENGINE, **kw})


def _grouped(mod, n, base, group=5, prompt=24, prefix=16, out=4):
    tasks = [mod.Task(mod.SLOSpec(tpot_ms=100.0), 1.0, prompt_len=prompt,
                      output_len=out, task_id=base + i) for i in range(n)]
    for t in tasks:
        t.prefix_group, t.prefix_len = group, prefix
    return tasks


def _task(mod, prompt_len, output_len, task_id):
    return mod.Task(mod.SLOSpec(tpot_ms=100.0), 1.0, prompt_len=prompt_len,
                    output_len=output_len, task_id=task_id)


def _clear(ex):
    ex.prefix_cache.clear()
    ex.pool.check()
    assert ex.pool.used_pages == 0


def test_prefix_shared_prefill_decode_match_unshared_and_jax(weights):
    """Cache-hit prefill and decode over shared pages reproduce the
    unshared engine's logits and the JAX sharing engine's, with the same
    page tables, fewer pages held, and the same page-budget view."""
    plain, shared, jx = (_torch(weights), _torch(weights, prefix_cache=True),
                         _jax(weights, prefix_cache=True))
    tt, jt = _grouped(ttask, 3, 5100), _grouped(jtask, 3, 5100)
    jb, tb = jx.page_budget(), shared.page_budget()
    for a, b in zip(jt, tt):
        assert tb.prefix_pages(b) == jb.prefix_pages(a)
        plain.prefill(b)
        shared.prefill(b)
        jx.prefill(a)
        assert_logits_close(shared.last_prefill_logits,
                            plain.last_prefill_logits)
        assert_logits_close(shared.last_prefill_logits,
                            jx.last_prefill_logits)
        assert shared.cached_prompt_tokens(b) == jx.cached_prompt_tokens(a)
        assert tb.free_pages_now() == jb.free_pages_now()
    first = shared.pool.page_table(tt[0].task_id)[:2]
    for a, b in zip(jt, tt):
        assert shared.pool.page_table(b.task_id)[:2] == first
        assert shared.pool.page_table(b.task_id) == jx.pool.page_table(
            a.task_id)
    assert shared.pool.used_pages == jx.pool.used_pages
    assert shared.pool.used_pages < plain.pool.used_pages
    assert shared.prefix_cache.hits == jx.prefix_cache.hits == 2
    for subset in ([0, 1, 2], [0], [1, 2], [2]):
        for ex, ts in ((plain, tt), (shared, tt), (jx, jt)):
            ex.decode([ts[i] for i in subset])
        assert_logits_close(shared.last_logits, plain.last_logits)
        assert_logits_close(shared.last_logits, jx.last_logits)
    assert ([shared.generated_tokens(t) for t in tt]
            == [jx.generated_tokens(t) for t in jt])
    for a, b in zip(jt, tt):
        shared.release(b)
        jx.release(a)
    _clear(shared)


def test_prefix_shared_chunked_prefill_starts_at_first_uncached_chunk(weights):
    plain = _torch(weights, n_pages=24, prefill_chunk_size=8)
    shared = _torch(weights, n_pages=24, prefill_chunk_size=8,
                    prefix_cache=True)
    jx = _jax(weights, n_pages=24, prefill_chunk_size=8, prefix_cache=True)
    (t0, t1), (j0, j1) = _grouped(ttask, 2, 5200), _grouped(jtask, 2, 5200)
    chunks = {}
    for name, ex, pair in (("plain", plain, (t0, t1)),
                           ("shared", shared, (t0, t1)), ("jax", jx, (j0, j1))):
        for t in pair:
            n, done = 0, False
            while not done:
                _, done = ex.prefill_chunk(t, 8)
                n += 1
            chunks[name] = n                  # chunks of the second task
    assert chunks["shared"] == chunks["jax"] < chunks["plain"]
    assert shared.prompt_progress(t1) == jx.prompt_progress(j1) == 24
    assert_logits_close(shared.last_prefill_logits, plain.last_prefill_logits)
    assert_logits_close(shared.last_prefill_logits, jx.last_prefill_logits)
    for ex, pair in ((plain, (t0, t1)), (shared, (t0, t1)), (jx, (j0, j1))):
        ex.decode(list(pair))
    assert_logits_close(shared.last_logits, plain.last_logits)
    assert_logits_close(shared.last_logits, jx.last_logits)
    for t in (t0, t1):
        shared.release(t)
    _clear(shared)


def test_prefix_cache_eviction_under_pool_pressure(weights):
    """A full pool evicts idle cached prefixes instead of failing: the
    cache is reclaimable headroom."""
    ex = _torch(weights, n_pages=8, prefix_cache=True)
    a = _grouped(ttask, 1, 5300, group=1)[0]
    ex.prefill(a)                            # 3 pages, all indexed or held
    ex.release(a)                            # pages now pinned by cache only
    assert ex.pool.used_pages == 3
    assert ex.page_budget().free_pages_now() == 8
    b = _task(ttask, 56, 4, 5301)            # needs 7 pages > 5 free
    ex.prefill(b)                            # evicts cached pages to fit
    assert ex.pool.holds(b.task_id)
    ex.release(b)
    _clear(ex)


class Priced:
    """Executor wrapper returning priced ms, so the loop's clock and every
    decision are deterministic; records each task's stream at release."""

    def __init__(self, inner, lat):
        self.inner, self.lat, self.streams = inner, lat, {}

    def prefill(self, task):
        self.inner.prefill(task)
        return self.lat.prefill_ms(task.prompt_len)

    def decode(self, tasks, depths=None):
        self.inner.decode(tasks)
        return self.lat.decode_ms(len(tasks))

    def release(self, task):
        self.streams[task.task_id] = self.inner.generated_tokens(task)
        self.inner.release(task)

    def __getattr__(self, name):
        return getattr(self.inner, name)


def test_priced_prefix_slice_loop_matches_jax_and_leaks_nothing(weights):
    """SLICE with the prefix hint over both sharing engines on a priced
    clock: equal decisions, token times, hits and streams; every task
    finishes and the pool is empty once the index is cleared."""
    runs = {}
    for name, ex, mod, sched, lat_cls, loop in (
            ("jax", _jax(weights, n_pages=24, prefix_cache=True), jtask,
             jsched, JLat, jax_loop),
            ("torch", _torch(weights, n_pages=24, prefix_cache=True), ttask,
             tsched, TLat, torch_loop)):
        lat = lat_cls([(1, 8.0), (2, 9.0), (4, 11.0)], [(8, 4.0), (64, 12.0)])
        tasks = _grouped(mod, 4, 5400, out=6)
        for i, t in enumerate(tasks):
            t.arrival_ms = 1.0 * i
        priced = Priced(ex, lat)
        res = loop(sched.SliceScheduler(
            lat, page_budget=ex.page_budget(),
            prefix_hint=ex.cached_prompt_tokens), priced, tasks)
        runs[name] = (res, priced.streams, ex)
    (jres, js, jx), (tres, ts, tx) = runs["jax"], runs["torch"]
    assert all(t.finished for t in tres.tasks)
    for f in ("decode_iterations", "prefills", "end_ms", "defers_by_reason"):
        assert getattr(tres, f) == getattr(jres, f), f
    for a, b in zip(jres.tasks, tres.tasks):
        assert a.token_times_ms == b.token_times_ms
    assert ts == js and all(len(s) > 1 for s in ts.values())
    assert tx.prefix_cache.hits == jx.prefix_cache.hits >= 1
    _clear(tx)


def test_prefix_cache_page_budget_evicts_and_matches_jax(weights):
    """``prefix_cache_pages=2`` (the radix index's own page budget, as
    JAX's engine takes it) under SLICE with the prefix hint on a priced
    clock, over two prefix groups (two tasks of one, two of the other,
    then one of each) whose 2-page prefixes cannot both stay indexed: the
    index evicts, never holds more than 2 pages,
    and the decisions, token times, hits and streams equal JAX's engine
    under the same budget; the pool ends empty."""
    runs = {}
    for name, ex, mod, sched, lat_cls, loop in (
            ("jax", _jax(weights, n_pages=24, prefix_cache=True,
                         prefix_cache_pages=2), jtask, jsched, JLat, jax_loop),
            ("torch", _torch(weights, n_pages=24, prefix_cache=True,
                             prefix_cache_pages=2), ttask, tsched, TLat,
             torch_loop)):
        lat = lat_cls([(1, 8.0), (2, 9.0), (4, 11.0)], [(8, 4.0), (64, 12.0)])
        a = _grouped(mod, 3, 5500, group=5, out=5)
        b = _grouped(mod, 3, 5510, group=6, out=5)
        tasks = a[:2] + b[:2] + [a[2], b[2]]
        for i, t in enumerate(tasks):
            t.arrival_ms = 6.0 * i
        cache, held, evicted = ex.prefix_cache, [], []
        evict = cache.evict

        def counted(n, protect=None, evict=evict, evicted=evicted):
            evicted.append(evict(n, protect))
            return evicted[-1]

        cache.evict = counted
        priced = Priced(ex, lat)
        prefill = priced.prefill

        def watched(task, prefill=prefill, held=held, cache=cache):
            ms = prefill(task)
            held.append(cache.pages_indexed)
            return ms

        priced.prefill = watched
        res = loop(sched.SliceScheduler(
            lat, page_budget=ex.page_budget(),
            prefix_hint=ex.cached_prompt_tokens), priced, tasks)
        runs[name] = (res, priced.streams, ex, held, sum(evicted))
    (jres, js, jx, jheld, _), (tres, ts, tx, theld, tev) = (runs["jax"],
                                                            runs["torch"])
    assert all(t.finished for t in tres.tasks)
    for f in ("decode_iterations", "prefills", "end_ms", "defers_by_reason"):
        assert getattr(tres, f) == getattr(jres, f), f
    for x, y in zip(jres.tasks, tres.tasks):
        assert x.token_times_ms == y.token_times_ms
    assert ts == js and all(len(v) > 1 for v in ts.values())
    assert tx.prefix_cache.hits == jx.prefix_cache.hits >= 1
    assert theld == jheld and max(theld) <= 2 and tev >= 1
    _clear(tx)


def test_suspend_resume_matches_logits_and_jax(weights):
    """Decode across a suspend/resume cycle reproduces the never-suspended
    engine's logits and JAX's; the restored K/V equal the suspended K/V
    bit for bit; nothing leaks; HostArenaFull rolls a suspension back with
    the task still decodable."""
    ex, ref, jx = (_torch(weights, page_size=16),
                   _torch(weights, page_size=16), _jax(weights, page_size=16))
    tt = [_task(ttask, 18, 8, 5500 + i) for i in range(2)]
    jt = [_task(jtask, 18, 8, 5500 + i) for i in range(2)]
    for a, b in zip(jt, tt):
        ex.prefill(b)
        ref.prefill(b)
        jx.prefill(a)

    def step(subset):
        ex.decode([tt[i] for i in subset])
        ref.decode([tt[i] for i in subset])
        jx.decode([jt[i] for i in subset])
        assert_logits_close(ex.last_logits, ref.last_logits)
        assert_logits_close(ex.last_logits, jx.last_logits)

    def kv(e, t):
        idx = torch.as_tensor(e.pool.page_table(t.task_id))
        return [e.pages[n][:, idx].clone() for n in ("k_pages", "v_pages")]

    step([0, 1])
    before = kv(ex, tt[0])
    ex.suspend(tt[0])
    jx.suspend(jt[0])
    assert ex.arena.bytes_held == jx.arena.bytes_held > 0
    assert ex.suspend_count == 1 and not ex.pool.holds(tt[0].task_id)
    step([1])
    ex.resume(tt[0])
    jx.resume(jt[0])
    assert ex.resume_count == 1
    assert ex.swapped_bytes == jx.swapped_bytes
    assert all(torch.equal(a, b) for a, b in zip(kv(ex, tt[0]), before))
    step([0, 1])
    step([0])
    ex.arena.capacity_bytes = jx.arena.capacity_bytes = 0
    with pytest.raises(HostArenaFull):
        ex.suspend(tt[1])
    with pytest.raises(JFull):
        jx.suspend(jt[1])
    assert ex.pool.holds(tt[1].task_id) and ex.arena.bytes_held == 0
    step([0, 1])
    for t in tt:
        ex.release(t)
    ex.pool.check()
    ex.arena.check()
    assert ex.pool.used_pages == 0
    assert ex.arena.bytes_held == 0 and ex.arena.owners_held == 0


def test_suspend_keeps_shared_prefix_pages_resident(weights):
    """A sharer's suspension swaps only its private pages: the shared
    prefix pages stay resident for the other owner and the index, and the
    resumed task decodes as the never-suspended engine does."""
    ex, ref = _torch(weights, prefix_cache=True), _torch(weights)
    tasks = _grouped(ttask, 2, 5600, prompt=28)     # 3 indexed pages + 1
    for t in tasks:
        ex.prefill(t)
        ref.prefill(t)
    shared = ex.pool.page_table(tasks[1].task_id)[:2]
    ex.suspend(tasks[1])
    assert ex.arena.pages_held(tasks[1].task_id) == 1     # the private tail
    assert all(ex.pool.ref_count(p) > 0 for p in shared)
    ex.decode(tasks[:1])
    ref.decode(tasks[:1])
    assert_logits_close(ex.last_logits, ref.last_logits)
    ex.resume(tasks[1])
    assert ex.pool.page_table(tasks[1].task_id)[:2] == shared
    ex.decode(tasks)
    ref.decode(tasks)
    assert_logits_close(ex.last_logits, ref.last_logits)
    for t in tasks:
        ex.release(t)
    _clear(ex)
