"""SSM and hybrid archs on the port's slot engine, and the ring branch of
``prefill``, held against the JAX package on the CPU.

``TorchExecutor(device="cpu")`` against ``JaxExecutor`` for mamba2-780m
(SSM) and hymba-1.5b (hybrid: attention beside SSD heads, a 64-slot ring
under the reduced config's window of 64), masked and compacted decode:
prefill (one prompt shorter than the conv width), decode under a
changing active set, a slot reused after a release. The slot cache's
rows equal the JAX engine's: length and kv_pos exact, K/V, the SSD state
and the conv tail at 1e-4 of their largest magnitude. Then the
port's paged engine against its slot engine for every servable registry
arch (the JAX package's
``tests/test_registry_smoke.py`` oracle check), the ring prefill
(``buf_len`` = the window < S) against ``repro.models.model.prefill``
and the decode steps after it, the refusal of chunked prefill on SSM
archs, and a traced slot serving run. Same weights (the JAX
``init_params`` through ``load_params``) and pinned task ids; logits
atol 1e-5 (``assert_logits_close``), identical greedy streams. fp32.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from helpers import assert_logits_close, make_slot_engine  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.core import task as jtask  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serving.executor import JaxExecutor  # noqa: E402
from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.core import task as ttask  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.serving.executor import (PagedTorchExecutor,  # noqa: E402
                                          TorchExecutor)

SSM_ARCHS = ["mamba2-780m", "hymba-1.5b"]


@pytest.fixture(autouse=True, scope="module")
def one_cpu_thread():
    """PyTorch's CPU ops on one intra-op thread: beside the other test
    processes its default pool (a thread per core) waits on itself at
    every op, and a reduced step slows many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _weights(arch, seed=4, window=None):
    jcfg = jax_config(arch).reduced()
    cfg = get_config(arch).reduced()
    if window is not None:
        jcfg = dataclasses.replace(jcfg, sliding_window=window)
        cfg = dataclasses.replace(cfg, sliding_window=window)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(seed))
    tree = jax.tree_util.tree_map(np.asarray, jp)
    return jcfg, cfg, jp, TM.load_params(cfg, tree, device="cpu")


def _pair(prompt_len, task_id, output_len=16):
    return tuple(mod.Task(mod.SLOSpec(tpot_ms=100.0), 1.0,
                          prompt_len=prompt_len, output_len=output_len,
                          task_id=task_id) for mod in (jtask, ttask))


def _slot_rows(tx):
    """The slot engine's cache without its spare row (the last), as numpy:
    the JAX engine's cache has no spare."""
    S = tx.max_slots
    return {k: (v[:, :S] if k in TM.LAYER_FIELDS else v[:S]).numpy()
            for k, v in tx.cache.items()}


def _assert_state_close(got, want, what=""):
    """A cache tensor (K/V, the SSD state, the conv tail) at 1e-4 of its
    largest magnitude, at least 1e-4 (the measure ``chip_smoke.py`` holds
    SSD states to). The SSD state is an fp32 running sum that the two
    packages round in different orders, and a hybrid's later layers read
    it: hymba's K/V differ from JAX's by up to 4.4e-5 at magnitude 4.2,
    ring or not, while its logits stay within 1e-5."""
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=1e-4 * scale, rtol=0,
                               err_msg=f"{what} (scale {scale:.3g})")


def _assert_cache_equal(got, want, what=""):
    assert set(got) == set(want)
    for name, w in want.items():
        w, g = np.asarray(w), np.asarray(got[name])
        if name in ("length", "kv_pos"):
            np.testing.assert_array_equal(g, w, err_msg=f"{what} {name}")
        else:
            _assert_state_close(g, w, f"{what} {name}")


@pytest.mark.parametrize("compact", [False, True], ids=["masked", "compact"])
@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_slot_ssm_engine_matches_jax(arch, compact):
    """Prefill three prompts (one of 2 tokens, shorter than the conv
    width of 4: its conv tail is left-padded), decode six steps under a
    changing active set, release a task and prefill a new one into its
    slot (over the stale state), decode on. Logits within 1e-5 at every
    step, identical tokens per task, and the cache's rows equal the JAX
    engine's after every phase."""
    jcfg, cfg, jp, tp = _weights(arch)
    # three slots, so the task after the release reuses the freed one
    jx = make_slot_engine(jcfg, params=jp, max_slots=3,
                          compact_buckets=compact)
    tx = TorchExecutor(cfg, params=tp, max_slots=3, max_seq=64,
                       compact_buckets=compact, device="cpu")
    assert set(tx.cache) == set(jx.cache)
    pairs = [_pair(n, 4100 + i) for i, n in enumerate((2, 17, 9))]
    want = {}

    def prefill(j, t):
        jx.prefill(j)
        tx.prefill(t)
        assert_logits_close(tx.last_prefill_logits, jx.last_prefill_logits)
        want[t.task_id] = [int(jx.last_prefill_logits[0].argmax())]

    def decode(sel, step):
        jx.decode([pairs[i][0] for i in sel])
        tx.decode([pairs[i][1] for i in sel])
        assert_logits_close(tx.last_logits, jx.last_logits,
                            err_msg=f"decode {step}")
        for r, i in enumerate(sel):
            want[pairs[i][1].task_id].append(int(jx.last_logits[r].argmax()))

    for j, t in pairs:
        prefill(j, t)
    _assert_cache_equal(_slot_rows(tx), jx.cache)
    for step, sel in enumerate(((0, 1, 2), (1, 2), (2,), (0, 2), (0, 1, 2),
                                (0,))):
        decode(sel, step)
    _assert_cache_equal(_slot_rows(tx), jx.cache)
    assert {t.task_id: tx.generated_tokens(t) for _, t in pairs} == want
    # release the 2-token task; a new task takes its slot over stale state
    old_slot = tx.slot_of[pairs[0][1].task_id]
    jx.release(pairs[0][0])
    tx.release(pairs[0][1])
    del want[pairs[0][1].task_id]
    pairs[0] = _pair(5, 4200)
    prefill(*pairs[0])
    assert tx.slot_of[pairs[0][1].task_id] == old_slot
    for step, sel in enumerate(((0, 1, 2), (0, 2), (0, 1, 2)), 6):
        decode(sel, step)
    _assert_cache_equal(_slot_rows(tx), jx.cache)
    assert {t.task_id: tx.generated_tokens(t) for _, t in pairs} == want
    np.testing.assert_array_equal(tx.tokens, np.asarray(jx.tokens))
    for j, t in pairs:
        jx.release(j)
        tx.release(t)
    assert sorted(tx.free) == [0, 1, 2] and not tx.slot_of
    assert (tx.cache["length"] == 0).all()
    _assert_cache_equal(_slot_rows(tx), jx.cache)


SERVABLE = [a for a in list_archs() if get_config(a).causal]


@pytest.mark.parametrize("arch", SERVABLE)
def test_paged_engine_matches_slot_engine(arch):
    """The port's counterpart of the JAX package's registry oracle check
    (``tests/test_registry_smoke.py::test_every_servable_arch_serves``):
    every servable registry config (dense, SSM, hybrid, MoE) runs one
    paged-engine prefill and two decode steps, and the logits equal the
    port's slot engine's within 1e-5 on the same weights; nothing is left
    held."""
    cfg = get_config(arch).reduced()
    ex = PagedTorchExecutor(cfg, n_pages=16, page_size=8, max_seq=32,
                            max_batch=2, seed=0, device="cpu")
    oracle = TorchExecutor(cfg, params=ex.params, max_slots=2, max_seq=32,
                           seed=0, device="cpu")
    task = ttask.qa_task(prompt_len=9, output_len=4)
    ex.prefill(task)
    oracle.prefill(task)
    assert_logits_close(ex.last_prefill_logits, oracle.last_prefill_logits)
    for step in range(2):
        ex.decode([task])
        oracle.decode([task])
        assert_logits_close(ex.last_logits, oracle.last_logits,
                            err_msg=f"{arch} decode {step}")
    assert ex.generated_tokens(task) == oracle.generated_tokens(task)
    ex.release(task)
    oracle.release(task)
    assert ex.store.leaked() == 0 and sorted(oracle.free) == [0, 1]
    ex.store.check()


RING = 64            # the reduced configs' sliding window


@pytest.mark.parametrize("S", [65, 100, 200])
@pytest.mark.parametrize("arch", ["hymba-1.5b", "smollm-360m"])
def test_ring_prefill_matches_jax(arch, S):
    """A prompt longer than its buffer (buf_len = the window of 64 < S)
    through the ring branch of ``prefill`` on two rows: logits, the ring's
    K/V and kv_pos (the tail's positions at p % 64), and for the hybrid
    the SSD state and conv tail equal JAX's; then four decode steps on the
    ring, row 1 inactive in one, equal JAX's logits and cache."""
    jcfg, cfg, jp, tp = _weights(arch, window=RING)
    toks = np.random.default_rng(S).integers(0, cfg.vocab_size, (2, S))
    jl, jc = JM.prefill(jcfg, jp, jnp.asarray(toks, jnp.int32), buf_len=RING)
    tl, tc = TM.prefill(cfg, tp, torch.from_numpy(toks).int(), buf_len=RING)
    assert_logits_close(tl.numpy(), np.asarray(jl))

    def same_cache(what):
        _assert_cache_equal({k: v.numpy() for k, v in tc.items()}, jc, what)

    same_cache("prefill")
    want_pos = np.full(RING, -1)
    for p in range(S - RING, S):
        want_pos[p % RING] = p
    np.testing.assert_array_equal(tc["kv_pos"][0].numpy(), want_pos)
    tok = np.asarray(jl).argmax(-1).astype(np.int32)
    for step, act in enumerate(((1, 1), (1, 0), (1, 1), (1, 1))):
        active = np.asarray(act, bool)
        jl, jc = JM.decode_step(jcfg, jp, jc, jnp.asarray(tok),
                                jnp.asarray(active))
        tl, tc = TM.decode_step(cfg, tp, tc, torch.from_numpy(tok),
                                torch.from_numpy(active))
        assert_logits_close(tl.numpy()[active], np.asarray(jl)[active],
                            err_msg=f"decode {step}")
        same_cache(f"decode {step}")
        tok = np.where(active, np.asarray(jl).argmax(-1), tok).astype(
            np.int32)


def test_ring_prefill_refuses_other_buffers():
    """A windowed arch prefilled past its buffer needs buf_len == window
    (JAX asserts it)."""
    _, cfg, _, tp = _weights("smollm-360m", window=RING)
    toks = torch.zeros((1, 100), dtype=torch.int32)
    with pytest.raises(ValueError, match="sliding window 64"):
        TM.prefill(cfg, tp, toks, buf_len=32)


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_slot_chunked_prefill_refused_on_ssm(arch):
    """Chunked prefill on the slot engine needs a pure-attention arch:
    both packages raise the same ValueError at construction."""
    jcfg, cfg, jp, tp = _weights(arch)
    with pytest.raises(ValueError, match="pure-attention") as jerr:
        JaxExecutor(jcfg, params=jp, max_slots=2, max_seq=64,
                    prefill_chunk_size=8)
    with pytest.raises(ValueError, match="pure-attention") as terr:
        TorchExecutor(cfg, params=tp, max_slots=2, max_seq=64,
                      prefill_chunk_size=8, device="cpu")
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("arch", ["edge-6b", "hymba-1.5b"])
def test_traced_slot_serving_run(arch, tmp_path, monkeypatch):
    """A traced slot-engine run with metric snapshots (the JAX CLI's
    ``--executor slot --trace --metrics-every``): the slot engine reports
    no gauges, as the JAX slot engine, instead of failing the snapshot;
    every task finishes and every slot is free at the end. The engine's
    steps run as ever but return a price (8 ms + 1 ms a row, 4 ms a
    prefill) instead of their time, so the probed l(b), the SLO scale and
    every decision are the same on a loaded machine."""
    decode, prefill = TorchExecutor.decode, TorchExecutor.prefill
    monkeypatch.setattr(TorchExecutor, "decode",
                        lambda self, tasks, depths=None:
                        decode(self, tasks, depths) * 0 + 8.0 + len(tasks))
    monkeypatch.setattr(TorchExecutor, "prefill",
                        lambda self, task: prefill(self, task) * 0 + 4.0)
    path = tmp_path / "trace.json"
    run = tserve.run(tserve.parse_args([
        "--reduced", "--device", "cpu", "--executor", "slot", "--arch", arch,
        "--slots", "8", "--max-seq", "64", "--duration", "1.5", "--rate", "2",
        "--ratio", "0", "--trace", str(path), "--metrics-every", "4"]))
    assert isinstance(run.executor, TorchExecutor)
    assert run.executor.trace_gauges() == {}
    assert run.trace.snapshots and path.exists()
    assert all(t.finished for t in run.result.tasks)
    assert sorted(run.executor.free) == list(range(8))
