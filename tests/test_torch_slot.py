"""The port's slot engine, chunked prefill on both engines, and the decode
cycle, held against the JAX package on the CPU.

``TorchExecutor(device="cpu")`` against ``JaxExecutor`` (masked and
compacted decode, ring wrap past max_seq under the reduced config's
sliding window), chunked against monolithic prefill on each engine and
against the JAX engines' chunked prefill (``tests/test_chunked_prefill.py``
is the model), and ``core.decode_cycle`` against the JAX cycle. Same
weights (the JAX ``init_params`` through ``load_params``) and pinned task
ids, so both packages draw the same prompts. Tolerances: logits atol 1e-5
(``assert_logits_close``), identical greedy streams, exact lengths and
kv_pos.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from helpers import (assert_logits_close, make_paged_engine,  # noqa: E402
                     make_slot_engine)
from repro.configs import get_config as jax_config  # noqa: E402
from repro.core import decode_cycle as JC  # noqa: E402
from repro.core import task as jtask  # noqa: E402
from repro.core.mask_matrix import build_mask_matrix  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serving.executor import _chunk_pieces as jax_pieces  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import decode_cycle as TC  # noqa: E402
from repro_torch.core import task as ttask  # noqa: E402
from repro_torch.core.mask_matrix import \
    build_mask_matrix as t_build_mask  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.serving.executor import (PagedTorchExecutor,  # noqa: E402
                                          TorchExecutor, _chunk_pieces)
from repro_torch.serving.kv_pool import OutOfPages  # noqa: E402

ARCH = "edge-6b"          # reduced: 2 layers, 4 q / 1 KV heads, window 64


@pytest.fixture(scope="module")
def weights():
    jcfg = jax_config(ARCH).reduced()
    cfg = get_config(ARCH).reduced()
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, cfg, jp, jax.tree_util.tree_map(np.asarray, jp)


def _slot(cfg, tree, **kw):
    kw = {"max_slots": 4, "max_seq": 64, **kw}
    return TorchExecutor(cfg, params=TM.load_params(cfg, tree, device="cpu"),
                         device="cpu", **kw)


def _paged(cfg, tree, **kw):
    kw = {"n_pages": 16, "page_size": 8, "max_seq": 64, "max_batch": 4, **kw}
    return PagedTorchExecutor(cfg, params=TM.load_params(cfg, tree,
                                                         device="cpu"),
                              device="cpu", **kw)


def _task(mod, prompt_len, output_len, task_id):
    return mod.Task(mod.SLOSpec(tpot_ms=100.0), 1.0, prompt_len=prompt_len,
                    output_len=output_len, task_id=task_id)


def _pair(prompt_len, output_len=8, task_id=3000):
    return (_task(jtask, prompt_len, output_len, task_id),
            _task(ttask, prompt_len, output_len, task_id))


def _chunk_all(ex, task, n):
    done = False
    while not done:
        _, done = ex.prefill_chunk(task, n)


def test_chunk_pieces_match_jax():
    for chunk in (1, 3, 8, 64):
        for n in range(0, 3 * chunk + 5):
            assert _chunk_pieces(n, chunk) == jax_pieces(n, chunk)


def _slot_rows(tx):
    """The slot engine's cache without its spare row (the last), as numpy:
    the JAX engine's cache has no spare."""
    S = tx.max_slots
    return {k: (v[:, :S] if k in ("k", "v") else v[:S]).numpy()
            for k, v in tx.cache.items()}


@pytest.mark.parametrize("compact", [False, True], ids=["masked", "compact"])
def test_slot_executor_matches_jax(weights, compact):
    """Prefill three prompts, then decode changing subsets of them (the
    decode-mask column), masked over the whole slot array or compacted
    into pow-2 buckets padded with distinct inactive slots. Logits within
    1e-5 and identical tokens per slot. Lengths and kv_pos are exact; the
    K/V cache is held at 1e-5: compaction's gather-decode-scatter moves
    the JAX cache itself by ~2e-6 against masked decode (ROADMAP.md Queue
    C), so bitwise equality is not the contract."""
    jcfg, cfg, jp, tree = weights
    jx = make_slot_engine(jcfg, params=jp, compact_buckets=compact)
    tx = _slot(cfg, tree, compact_buckets=compact)
    pairs = [_pair(n, task_id=3100 + i) for i, n in enumerate((5, 17, 9))]
    want = {}
    for j, t in pairs:
        jx.prefill(j)
        tx.prefill(t)
        assert_logits_close(tx.last_prefill_logits, jx.last_prefill_logits)
        want[t.task_id] = [int(jx.last_prefill_logits[0].argmax())]
    for step, sel in enumerate(((0, 1, 2), (1, 2), (2,), (0, 2), (0, 1, 2))):
        jx.decode([pairs[i][0] for i in sel])
        tx.decode([pairs[i][1] for i in sel])
        assert_logits_close(tx.last_logits, jx.last_logits,
                            err_msg=f"decode {step}")
        for r, i in enumerate(sel):
            want[pairs[i][1].task_id].append(int(jx.last_logits[r].argmax()))
    assert {t.task_id: tx.generated_tokens(t) for _, t in pairs} == want
    np.testing.assert_array_equal(tx.tokens, np.asarray(jx.tokens))
    rows = _slot_rows(tx)
    for name in ("length", "kv_pos"):
        np.testing.assert_array_equal(rows[name], np.asarray(jx.cache[name]))
    for name in ("k", "v"):
        assert_logits_close(rows[name], np.asarray(jx.cache[name]))
    for _, t in pairs:
        tx.release(t)
    assert sorted(tx.free) == [0, 1, 2, 3] and not tx.slot_of
    assert (tx.cache["kv_pos"] == -1).all() and (tx.cache["length"] == 0).all()


def test_slot_chunked_matches_monolithic_and_jax(weights):
    """Chunks of 8, then 7 (pow-2 pieces 4+2+1), then 99 (clamped to the
    remainder): the port's chunked slot prefill equals its monolithic one
    and the JAX engine's chunked one, and so do the decodes after it."""
    jcfg, cfg, jp, tree = weights
    txA = _slot(cfg, tree)
    txC = _slot(cfg, tree, prefill_chunk_size=8)
    jxC = make_slot_engine(jcfg, params=jp, prefill_chunk_size=8)
    j, t = _pair(20, 6)
    txA.prefill(t)
    for n, final in ((8, False), (7, False), (99, True)):
        assert jxC.prefill_chunk(j, n)[1] is final
        assert txC.prefill_chunk(t, n)[1] is final
    assert txC._chunk_progress[t.task_id] == 20
    assert_logits_close(txC.last_prefill_logits, txA.last_prefill_logits)
    assert_logits_close(txC.last_prefill_logits, jxC.last_prefill_logits)
    with pytest.raises(RuntimeError, match="already prefilled"):
        txC.prefill_chunk(t, 4)
    for _ in range(3):
        for ex in (txA, txC):
            ex.decode([t])
        jxC.decode([j])
        assert_logits_close(txC.last_logits, txA.last_logits)
        assert_logits_close(txC.last_logits, jxC.last_logits)
    assert txC.generated_tokens(t) == txA.generated_tokens(t)


def test_slot_chunked_reused_slot_matches(weights):
    """release() resets the slot row (length, kv_pos), so chunked prefill
    into a REUSED slot over stale K/V still matches atomic prefill."""
    _, cfg, _, tree = weights
    txA = _slot(cfg, tree, max_slots=1)
    txC = _slot(cfg, tree, max_slots=1, prefill_chunk_size=8)
    t1, t2 = _pair(20, 3, 3201)[1], _pair(13, 3, 3202)[1]
    txA.prefill(t1)
    txA.release(t1)
    _chunk_all(txC, t1, 8)
    txC.release(t1)
    txA.prefill(t2)                        # both engines reuse slot 0
    _chunk_all(txC, t2, 8)
    assert txC.slot_of[t2.task_id] == 0
    assert_logits_close(txC.last_prefill_logits, txA.last_prefill_logits)


def test_paged_chunked_matches_jax(weights):
    """Chunked prefill on the paged engine: pages allocated per chunk as
    in the JAX engine (the same page tables, never above the prompt's
    peak), logits equal to JAX's chunked engine and to the port's
    monolithic slot prefill, decode after it equal, pool empty after
    release."""
    jcfg, cfg, jp, tree = weights
    jx = make_paged_engine(jcfg, params=jp, prefill_chunk_size=8)
    tx = _paged(cfg, tree, prefill_chunk_size=8)
    mono = _slot(cfg, tree)
    j, t = _pair(20, 6)
    mono.prefill(t)
    used, jused, done = [], [], False
    while not done:
        jx.prefill_chunk(j, 8)
        _, done = tx.prefill_chunk(t, 8)
        used.append(tx.pool.used_pages)
        jused.append(jx.pool.used_pages)
        assert tx.prompt_progress(t) == jx.prompt_progress(j)
    assert used == jused and used == sorted(used)
    assert used[0] < used[-1] == tx.pool.pages_for(20)
    assert tx.pool.page_table(t.task_id) == jx.pool.page_table(j.task_id)
    assert_logits_close(tx.last_prefill_logits, jx.last_prefill_logits)
    assert_logits_close(tx.last_prefill_logits, mono.last_prefill_logits)
    for _ in range(2):
        jx.decode([j])
        tx.decode([t])
        assert_logits_close(tx.last_logits, jx.last_logits)
    assert tx.generated_tokens(t) == jx.generated_tokens(j)
    with pytest.raises(RuntimeError, match="already prefilled"):
        tx.prefill(t)
    tx.release(t)
    tx.pool.check()
    assert tx.pool.used_pages == 0 and tx.prompt_progress(t) == 0


def test_paged_chunked_out_of_pages_mid_chunk_resumes(weights):
    """OutOfPages on a non-first piece leaves pool and progress
    consistent: the task resumes from its cached tokens once pages free
    up and still matches monolithic prefill."""
    _, cfg, _, tree = weights
    mono = _slot(cfg, tree, max_slots=1)
    ex = _paged(cfg, tree, n_pages=2, max_batch=2, prefill_chunk_size=16)
    ex.pool.alloc(999, 8)                  # blocker holds 1 of 2 pages
    t = _pair(12, 3)[1]
    mono.prefill(t)
    with pytest.raises(OutOfPages):
        ex.prefill_chunk(t, 12)            # pieces [8, 4]: the 4 need page 2
    assert ex.prompt_progress(t) == 8 and ex.pool.length(t.task_id) == 8
    ex.pool.free(999)
    ms, done = ex.prefill_chunk(t, 99)     # the remaining 4 tokens
    assert done and ms > 0
    assert_logits_close(ex.last_prefill_logits, mono.last_prefill_logits)


def test_ring_wrap_matches_jax(weights):
    """Decode far past max_seq on the slot engine: the ring reuses slot
    q_pos % 64 and the reduced config's 64-token window drops the
    overwritten positions. Logits and streams equal JAX's at every step,
    for a long row and a short row decoded on alternate steps."""
    jcfg, cfg, jp, tree = weights
    jx = make_slot_engine(jcfg, params=jp, max_slots=2, max_seq=64)
    tx = _slot(cfg, tree, max_slots=2, max_seq=64)
    long_, short = _pair(30, 60, 3301), _pair(6, 60, 3302)
    for j, t in (long_, short):
        jx.prefill(j)
        tx.prefill(t)
    for step in range(44):
        sel = (long_, short) if step % 2 else (long_,)
        jx.decode([p[0] for p in sel])
        tx.decode([p[1] for p in sel])
        assert_logits_close(tx.last_logits, jx.last_logits,
                            err_msg=f"decode {step}")
    assert int(tx.cache["length"][tx.slot_of[long_[1].task_id]]) == 74
    np.testing.assert_array_equal(_slot_rows(tx)["kv_pos"],
                                  np.asarray(jx.cache["kv_pos"]))
    np.testing.assert_array_equal(tx.tokens, np.asarray(jx.tokens))


# ------------------------------------------------------------- decode cycle

def _cycle_setup(weights, B=4, S=8):
    jcfg, cfg, jp, tree = weights
    tp = TM.load_params(cfg, tree, device="cpu")
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S))
    jl, jc = JM.prefill(jcfg, jp, jnp.asarray(toks), buf_len=64)
    tl, tc = TM.prefill(cfg, tp, torch.from_numpy(toks), buf_len=64)
    t0 = np.asarray(jl).argmax(-1).astype(np.int32)
    assert (tl.numpy().argmax(-1) == t0).all()
    return jcfg, cfg, jp, tp, jc, tc, t0


def test_decode_cycle_matches_jax(weights):
    """One cycle over the mask of rates [4, 3, 2, 1], with an EOS id that
    one slot emits mid-cycle (it takes no part in later columns): tokens
    out, last tokens and lengths equal JAX's cycle, the cache within
    1e-5."""
    jcfg, cfg, jp, tp, jc, tc, t0 = _cycle_setup(weights)
    rates = [4, 3, 2, 1]
    mask = build_mask_matrix(rates)
    np.testing.assert_array_equal(t_build_mask(rates), mask)
    out0, _, _ = JC.decode_cycle(jcfg, jp, jc, jnp.asarray(t0),
                                 jnp.asarray(mask))
    eos = int(np.asarray(out0)[1, 0])      # slot 0's second token
    jout, jlast, jc2 = JC.decode_cycle(jcfg, jp, jc, jnp.asarray(t0),
                                       jnp.asarray(mask), eos_id=eos)
    tout, tlast, tc2 = TC.decode_cycle(cfg, tp, tc, torch.from_numpy(t0),
                                       torch.from_numpy(np.asarray(mask)),
                                       eos_id=eos)
    assert (np.asarray(jout)[2:, 0] == -1).all()   # stopped after EOS
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    np.testing.assert_array_equal(tlast.numpy(), np.asarray(jlast))
    np.testing.assert_array_equal(tc2["length"].numpy(),
                                  np.asarray(jc2["length"]))
    np.testing.assert_array_equal(tc2["kv_pos"].numpy(),
                                  np.asarray(jc2["kv_pos"]))
    assert_logits_close(tc2["k"].numpy(), np.asarray(jc2["k"]))


def test_decode_cycle_row_quota(weights):
    """Each slot emits exactly its mask row-sum tokens per cycle."""
    _, cfg, _, tp, _, tc, t0 = _cycle_setup(weights)
    rates = [4, 3, 2, 1]
    out, _, cache = TC.decode_cycle(
        cfg, tp, tc, torch.from_numpy(t0),
        torch.from_numpy(np.asarray(t_build_mask(rates))))
    assert (out.numpy() >= 0).sum(axis=0).tolist() == rates
    assert cache["length"].tolist() == [8 + r for r in rates]


def test_cycle_throughput_estimate_matches_jax():
    mask = build_mask_matrix([6, 4, 2, 1])
    table = np.asarray([0.0] + [10.0 + 1.5 * b for b in range(1, 16)],
                       np.float32)
    got = TC.cycle_throughput_estimate(torch.from_numpy(np.asarray(mask)),
                                       torch.from_numpy(table))
    want = JC.cycle_throughput_estimate(jnp.asarray(mask), jnp.asarray(table))
    assert abs(float(got) - float(want)) < 1e-3
