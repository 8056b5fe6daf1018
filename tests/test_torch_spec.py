"""The port's speculative decoding held against the JAX package on the CPU.

``DraftModel.propose`` against JAX's on the same weights; the spec
``PagedTorchExecutor`` against ``PagedJaxExecutor(spec_decode=True)``
across batch and depth buckets with a corrupted proposer (rejections) and
a suspend mid-stream (the JAX model is ``tests/test_spec_decode.py``);
spec streams against depth-0 streams; rejected drafts never touching
shared prefix pages; and SLICE with ``spec_decode`` on a priced clock
against the JAX loop. Same weights (the JAX ``init_params`` through
``load_params``) and pinned task ids, so both packages draw the same
prompts. Tolerances: logits atol 1e-5 (``assert_logits_close``),
identical greedy streams, commits, page tables and page counts.
"""
from __future__ import annotations

import dataclasses
import types

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
from repro.serving import spec_decode as jspec  # noqa: E402
from repro.serving.executor import PagedJaxExecutor  # noqa: E402
from repro.serving.loop import run_serving_loop as jax_loop  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import schedulers as tsched  # noqa: E402
from repro_torch.core import task as ttask  # noqa: E402
from repro_torch.core.latency_model import MeasuredLatencyModel as TLat  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.serving import spec_decode as tspec  # noqa: E402
from repro_torch.serving.executor import PagedTorchExecutor  # noqa: E402
from repro_torch.serving.loop import run_serving_loop as torch_loop  # noqa: E402

ARCH = "edge-6b"            # reduced: 2 layers, 4 q / 1 KV heads
ENGINE = dict(n_pages=32, page_size=8, max_seq=64, max_batch=4)


@pytest.fixture(scope="module")
def weights():
    jcfg = jax_config(ARCH).reduced()
    cfg = get_config(ARCH).reduced()
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, cfg, jp, jax.tree_util.tree_map(np.asarray, jp)


def _tp(cfg, tree):
    return TM.load_params(cfg, tree, device="cpu")


@pytest.fixture(scope="module")
def spec_pair(weights):
    """Self-draft spec engines (the draft is the target, so proposals are
    the target's greedy tokens and every window is accepted unless a test
    corrupts it), one per package, built once."""
    jcfg, cfg, jp, tree = weights
    jx = PagedJaxExecutor(jcfg, params=jp, spec_decode=True, draft_cfg=jcfg,
                          draft_params=jp, max_spec_depth=4, **ENGINE)
    tp = _tp(cfg, tree)
    tx = PagedTorchExecutor(cfg, params=tp, spec_decode=True, draft_cfg=cfg,
                            draft_params=tp, max_spec_depth=4, device="cpu",
                            **ENGINE)
    return jx, tx


def _task(mod, prompt_len, output_len, task_id):
    return mod.Task(mod.SLOSpec(tpot_ms=100.0), 1.0, prompt_len=prompt_len,
                    output_len=output_len, task_id=task_id)


def test_spec_helpers_match_jax(weights):
    jcfg, cfg, _, _ = weights
    for drafts, target in (([3, 4, 5], [3, 4, 9, 1]), ([], [2]),
                           ([1, 2], [0, 2, 3]), ([7, 7], [7, 7, 7])):
        assert tspec.greedy_accept(drafts, target) == jspec.greedy_accept(
            drafts, target)
    for d in range(0, 9):
        for m in (1, 2, 4, 8):
            assert tspec.depth_bucket(d, m) == jspec.depth_bucket(d, m)
    dc, jdc = tspec.default_draft_config(cfg), jspec.default_draft_config(jcfg)
    assert (dc.name, dc.n_layers, dc.vocab_size) == (jdc.name, jdc.n_layers,
                                                     jdc.vocab_size)
    rc = tspec.draft_config_from_registry("smollm-360m", cfg)
    jrc = jspec.draft_config_from_registry("smollm-360m", jcfg)
    assert (rc.name, rc.n_layers, rc.d_model, rc.vocab_size) == (
        jrc.name, jrc.n_layers, jrc.d_model, jrc.vocab_size)


def test_draft_propose_matches_jax(weights):
    """The default one-layer draft on bridged weights: catch-up from
    scratch, lockstep drafting to max(depths), a partial catch-up after
    note_commit, and a re-prefill after drop give JAX's drafts."""
    jcfg, cfg, _, _ = weights
    jdc, dc = jspec.default_draft_config(jcfg), tspec.default_draft_config(cfg)
    jdp = JM.init_params(jdc, jax.random.PRNGKey(7))
    tdp = _tp(dc, jax.tree_util.tree_map(np.asarray, jdp))
    jd = jspec.DraftModel(jdc, params=jdp, max_slots=4, max_seq=64)
    td = tspec.DraftModel(dc, params=tdp, max_slots=4, max_seq=64,
                          device="cpu")
    rng = np.random.default_rng(3)
    hist = {i: rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32)
            for i, n in ((1, 9), (2, 17), (3, 4))}

    def both(ids, depths):
        items = [(i, hist[i], int(hist[i][-1]) ^ 5) for i in ids]
        a, b = jd.propose(items, depths), td.propose(items, depths)
        assert b == a
        assert [len(x) for x in b] == list(depths)
        return b

    out = both([1, 2, 3], [3, 1, 2])
    for i, d in zip((1, 2, 3), out):          # accept part of each window
        hist[i] = np.concatenate([hist[i], np.asarray(d[:1], np.int32),
                                  np.asarray([11], np.int32)])
        jd.note_commit(i, len(hist[i]) - 1)
        td.note_commit(i, len(hist[i]) - 1)
    both([2, 1], [4, 2])
    jd.drop(1)
    td.drop(1)
    both([1, 3], [2, 2])
    assert td.drafted_tokens == jd.drafted_tokens
    assert td.slot_of == jd.slot_of and sorted(td.free) == sorted(jd.free)


def test_spec_executor_matches_jax_and_depth0(weights, spec_pair):
    """Across batch buckets (3 rows -> 2) and depth buckets (K 1, 2, 4),
    with every second proposal corrupted on both engines and a suspend
    mid-stream: per-step commits, last logits, page tables and page counts
    equal JAX's, and the streams equal a depth-0 engine's."""
    jcfg, cfg, jp, tree = weights
    jx, tx = spec_pair
    calls = {"n": 0, "rejected": 0}

    def corrupting(orig):
        def propose(items, depths):
            out = orig(items, depths)
            calls["n"] += 1
            if calls["n"] % 4 in (1, 2):          # the same calls on both
                for dr in out:
                    if len(dr) >= 2:
                        dr[1] = (dr[1] + 1) % cfg.vocab_size
                        calls["rejected"] += 1
            return out
        return propose

    jorig, torig = jx.draft.propose, tx.draft.propose
    jx.draft.propose, tx.draft.propose = corrupting(jorig), corrupting(torig)
    jt = [_task(jtask, 11, 40, 4100 + i) for i in range(3)]
    tt = [_task(ttask, 11, 40, 4100 + i) for i in range(3)]
    try:
        for a, b in zip(jt, tt):
            jx.prefill(a)
            tx.prefill(b)
            assert_logits_close(tx.last_prefill_logits,
                                jx.last_prefill_logits)
        cycle = [[4, 0, 2], [1, 3, 0], [2, 2, 2], [0, 4, 1], [3, 1, 4]]

        def step(jl, tl, depths):
            jx.decode(jl, depths)
            tx.decode(tl, depths)
            assert tx.last_commits == jx.last_commits
            assert_logits_close(tx.last_logits, jx.last_logits)
            assert tx.pool.used_pages == jx.pool.used_pages
            for a, b in zip(jl, tl):
                assert (tx.pool.page_table(b.task_id)
                        == jx.pool.page_table(a.task_id))
            tx.pool.check()

        for it in range(12):
            n = 3 if it < 7 else 2                # batch bucket 4 -> 2
            step(jt[:n], tt[:n], cycle[it % len(cycle)][:n])
            if it == 4:                           # mid-stream swap: draft
                jx.suspend(jt[0])                 # state dropped, history
                tx.suspend(tt[0])                 # survives
                assert tx.swapped_bytes == jx.swapped_bytes > 0
                step(jt[1:], tt[1:], [2, 2])
                jx.resume(jt[0])
                tx.resume(tt[0])
        assert calls["rejected"] > 0 and tx.accepted_tokens > 0
        assert tx.accepted_tokens == jx.accepted_tokens
        assert tx.spec_steps == jx.spec_steps
        assert tx.drafted_tokens == jx.drafted_tokens
        assert ([tx.generated_tokens(t) for t in tt]
                == [jx.generated_tokens(t) for t in jt])
        # the streams equal greedy depth-0 decode on a plain engine
        plain = PagedTorchExecutor(cfg, params=_tp(cfg, tree), device="cpu",
                                   **ENGINE)
        for t in tt:
            plain.prefill(t)
        need = max(len(tx.generated_tokens(t)) for t in tt)
        for _ in range(need):
            plain.decode(tt)
        for t in tt:
            a = tx.generated_tokens(t)
            assert len(a) >= 12
            assert a == plain.generated_tokens(t)[: len(a)]
    finally:
        jx.draft.propose, tx.draft.propose = jorig, torig
        for a, b in zip(jt, tt):
            jx.release(a)
            tx.release(b)
    tx.pool.check()
    assert tx.pool.used_pages == 0 and not tx.draft.slot_of


def test_spec_rollback_never_touches_shared_prefix_pages(weights):
    """Two tasks of one prefix group decode speculatively over two shared
    pages with every window partly rejected: the shared pages' K/V stay
    bit for bit, the pool and radix invariants hold, and the streams
    equal depth-0 decode."""
    _, cfg, _, tree = weights
    tp = _tp(cfg, tree)
    ex = PagedTorchExecutor(cfg, params=tp, prefix_cache=True,
                            spec_decode=True, draft_cfg=cfg, draft_params=tp,
                            max_spec_depth=2, device="cpu", **ENGINE)
    ref = PagedTorchExecutor(cfg, params=tp, device="cpu", **ENGINE)
    tasks = []
    for i in range(2):
        t = _task(ttask, 20, 16, 4200 + i)
        t.prefix_group, t.prefix_len = 9, 16      # 2 shared pages of 8
        tasks.append(t)
    for t in tasks:
        ex.prefill(t)
        ref.prefill(t)
    shared = ex.pool.page_table(tasks[0].task_id)[:2]
    assert ex.pool.page_table(tasks[1].task_id)[:2] == shared
    before = {k: v[:, shared].clone() for k, v in ex.pages.items()}
    orig = ex.draft.propose

    def rejecting(items, depths):
        out = orig(items, depths)
        for dr in out:
            dr[-1] = (dr[-1] + 1) % cfg.vocab_size
        return out

    ex.draft.propose = rejecting
    for it in range(8):
        ex.decode(tasks, [2, 1] if it % 2 else [1, 2])
        ex.pool.check()
    for k, v in ex.pages.items():
        assert torch.equal(v[:, shared], before[k]), k
    need = max(len(ex.generated_tokens(t)) for t in tasks)
    for _ in range(need):
        ref.decode(tasks)
    for t in tasks:
        a = ex.generated_tokens(t)
        assert len(a) > 9
        assert a == ref.generated_tokens(t)[: len(a)]
    for t in tasks:
        ex.release(t)
    ex.prefix_cache.clear()
    ex.pool.check()
    assert ex.pool.used_pages == 0


class PricedSpec:
    """Executor wrapper returning priced ms (``lat.decode_ms(b)``, plus
    the draft cost of a window) so the serving loop's clock and every
    decision are deterministic; records each decode column's depths and
    commits, and each task's stream at its release."""

    def __init__(self, inner, lat):
        self.inner, self.lat = inner, lat
        self.columns, self.streams = [], {}

    def prefill(self, task):
        self.inner.prefill(task)
        return self.lat.prefill_ms(task.prompt_len)

    def decode(self, tasks, depths=None):
        self.inner.decode(tasks, depths)
        self.columns.append((tuple(t.task_id for t in tasks),
                             None if depths is None else tuple(depths),
                             tuple(self.inner.last_commits)))
        ms = self.lat.decode_ms(len(tasks))
        if depths is not None:
            ms += self.lat.draft_ms(len(tasks), max(depths))
        return ms

    def release(self, task):
        self.streams[task.task_id] = self.inner.generated_tokens(task)
        self.inner.release(task)

    def __getattr__(self, name):           # page_budget, counters, ...
        return getattr(self.inner, name)


def _priced_spec_run(task_mod, sched_mod, lat_cls, loop, ex):
    """Four non-realtime tasks, each reported as lagging (as the JAX
    in-vivo test does), so SLICE grants depth out of the cycle's slack."""
    lat = lat_cls([(1, 8.0), (2, 9.0), (4, 11.0)], [(8, 4.0), (64, 12.0)])
    tasks = [_task(task_mod, n, out, 4300 + i)
             for i, (n, out) in enumerate(((9, 14), (13, 10), (6, 12),
                                           (17, 9)))]
    for i, t in enumerate(tasks):
        t.arrival_ms = 3.0 * i
    sched = sched_mod.SliceScheduler(lat, page_budget=ex.page_budget(),
                                     spec_decode=True, max_spec_depth=4)
    sched._slo_headroom_ms = types.MethodType(
        lambda self, t, now: -1.0, sched)          # force 'lagging'
    priced = PricedSpec(ex, lat)
    res = loop(sched, priced, tasks, max_ms=1e6)
    return res, priced


def test_priced_spec_slice_loop_matches_jax(spec_pair):
    """SLICE with spec_decode over both spec engines on the priced clock:
    the same depth grants, columns, commits, streams, token times and
    counters."""
    jx, tx = spec_pair
    jres, jp = _priced_spec_run(jtask, jsched, JLat, jax_loop, jx)
    tres, tp = _priced_spec_run(ttask, tsched, TLat, torch_loop, tx)
    assert any(d is not None and any(d) for _, d, _ in jp.columns)
    assert tp.columns == jp.columns
    assert tp.streams == jp.streams
    assert all(len(s) > 1 for s in tp.streams.values())
    for f in ("decode_iterations", "prefills", "end_ms", "spec_extra_tokens",
              "accepted_tokens", "drafted_tokens"):
        assert getattr(tres, f) == getattr(jres, f), f
    assert tres.spec_extra_tokens > 0
    for a, b in zip(jres.tasks, tres.tasks):
        assert (a.task_id, a.finished, a.token_times_ms) == (
            b.task_id, b.finished, b.token_times_ms)
    assert all(t.finished for t in tres.tasks)
    assert tx.pool.used_pages == 0 and jx.pool.used_pages == 0


def test_spec_engine_refusals(weights):
    _, cfg, _, tree = weights
    tp = _tp(cfg, tree)
    ex = PagedTorchExecutor(cfg, params=tp, device="cpu", **ENGINE)
    t = _task(ttask, 5, 4, 4400)
    ex.prefill(t)
    with pytest.raises(RuntimeError, match="spec_decode"):
        ex.decode([t], [2])
    with pytest.raises(ValueError, match="max_spec_depth"):
        PagedTorchExecutor(cfg, params=tp, spec_decode=True,
                           max_spec_depth=0, device="cpu", **ENGINE)
    other = dataclasses.replace(cfg, vocab_size=77)
    with pytest.raises(ValueError, match="vocab"):
        PagedTorchExecutor(cfg, params=tp, spec_decode=True, draft_cfg=other,
                           device="cpu", **ENGINE)


# ------------------------------------------- more prefilled tasks than slots

def _over_slot_tasks(mod):
    return [_task(mod, n, 24, 4500 + i) for i, n in enumerate((5, 9, 7))]


def test_jax_draft_runs_out_of_slots(weights):
    """The reference's fault: three prefilled tasks on an engine of two
    decode slots, drafted two, then one: JAX's draft holds a slot per
    drafted task until it is dropped, so the third raises."""
    jcfg, _, jp, _ = weights
    jx = PagedJaxExecutor(jcfg, params=jp, spec_decode=True,
                          max_spec_depth=2, **dict(ENGINE, max_batch=2))
    jt = _over_slot_tasks(jtask)
    for t in jt:
        jx.prefill(t)
    jx.decode(jt[:2], [2, 2])
    with pytest.raises(RuntimeError, match="draft model out of KV slots"):
        jx.decode(jt[2:], [2])


def test_draft_reclaims_a_slot_and_keeps_the_greedy_streams(weights):
    """The same run on the port, with a self-draft, over every subset of
    the three tasks: drafting a task beyond the two slots reclaims the
    slot of the task drafted least recently outside the call (its next
    propose re-prefills it), windows are still accepted, and every
    committed stream equals the target-only greedy stream."""
    _, cfg, _, tree = weights
    tp = _tp(cfg, tree)
    eng = dict(ENGINE, max_batch=2)
    tx = PagedTorchExecutor(cfg, params=tp, spec_decode=True, draft_cfg=cfg,
                            draft_params=tp, max_spec_depth=2, device="cpu",
                            **eng)
    plain = PagedTorchExecutor(cfg, params=tp, device="cpu", **eng)
    tt = _over_slot_tasks(ttask)
    for t in tt:
        tx.prefill(t)
        plain.prefill(t)
    for t in tt:                        # 4500 is drafted least recently
        tx.decode([t], [2])
    assert sorted(tx.draft.slot_of) == [4501, 4502]
    assert tx.draft.reclaimed_slots == 1
    for sel in ((0, 1), (1, 2), (0,), (2, 0), (1,)):
        tx.decode([tt[i] for i in sel], [2] * len(sel))
    assert tx.accepted_tokens > 0
    assert len(tx.draft.slot_of) == 2 and not tx.draft.free
    for _ in range(max(len(tx.generated_tokens(t)) for t in tt)):
        plain.decode(tt[:2])
        plain.decode(tt[2:])
    for t in tt:
        got = tx.generated_tokens(t)
        assert len(got) > 3 and got == plain.generated_tokens(t)[:len(got)]
