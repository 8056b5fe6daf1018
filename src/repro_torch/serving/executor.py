"""Executors: the data plane behind the schedulers (PyTorch port).

PagedTorchExecutor — the counterpart of ``repro.serving.executor.
                     PagedJaxExecutor`` on one device: the model over a
                     paged KV arena (kv_pool.KVPagePool +
                     model.decode_step_paged), admission bounded by the
                     page pool, page_budget() for SLICE's memory-aware
                     selection, measured l(b) for its Eq. 7 feasibility
                     test. Attention runs in the hand-written CUDA kernels
                     on the card and in their plain versions on the CPU.

The engine is synchronous, dense and single-device. Chunked prefill, the
prefix cache, KV swap, speculative decoding, tensor parallelism, async
dispatch and SSM state are still to port (ROADMAP.md); asking for one
raises NotImplementedError.

Every timed operation ends in a device synchronise before its clock read,
as the JAX engine's ``block_until_ready``: without it l(b) would time only
the enqueue and every Eq. 7 feasibility check would be wrong.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.latency_model import LatencyModel, MeasuredLatencyModel
from repro_torch.core.selection import PageBudget
from repro_torch.core.task import Task, qa_task
from repro_torch.models import model as M
from repro_torch.serving.kv_pool import KVPagePool

_PREFILL_PRIOR = [(64, 10.0), (512, 40.0)]   # prefill ms prior until measured


def _pow2_buckets(limit: int):
    """1, 2, 4, ... capped at limit — the decode batch shapes of the paged
    executor."""
    b = 1
    while b < limit:
        yield b
        b *= 2
    yield limit


def _prompt_tokens(seed: int, task: Task, vocab: int, length: int):
    """Deterministic per-task prompt tokens, shared by the atomic and chunked
    prefill paths (and across executors at equal seed) so chunked-vs-
    monolithic logit equivalence is well-defined.

    Tasks carrying shared-prefix metadata (task.prefix_group, DESIGN.md §6)
    open with tokens drawn from a per-GROUP stream instead of the per-task
    stream, so two tasks of one group really do share their first
    prefix_len prompt tokens — the content contract the radix prefix cache
    deduplicates on."""
    rng = np.random.default_rng((seed + 1) * 100_003 + task.task_id)
    toks = rng.integers(0, vocab, (1, length))
    k = min(getattr(task, "prefix_len", 0) or 0, length)
    if k > 0 and getattr(task, "prefix_group", None) is not None:
        grng = np.random.default_rng(
            (seed + 1) * 7_919 + 1_000_003 * (task.prefix_group + 1))
        toks[0, :k] = grng.integers(0, vocab, (k,))
    return toks


def _probe_latency_curve(executor: "Executor", warm_tasks, probes):
    """Warm min-of-3 decode timings at each probe batch size over tasks the
    caller has already admitted to the engine."""
    samples = []
    for b in probes:
        sub = warm_tasks[:b]
        executor.decode(sub)  # warm compile/caches
        ms = min(executor.decode(sub) for _ in range(3))
        samples.append((b, ms))
    return MeasuredLatencyModel(samples, _PREFILL_PRIOR)


class Executor:
    """Returns elapsed milliseconds for each operation."""

    def prefill(self, task: Task) -> float:
        raise NotImplementedError

    def prefill_chunk(self, task: Task, n_tokens: int) -> Tuple[float, bool]:
        """Process the next ``n_tokens`` of a task's prompt (DESIGN.md §5).
        Returns (elapsed ms, done)."""
        raise NotImplementedError(
            f"{type(self).__name__} has no chunked prefill (ROADMAP.md)")

    def decode(self, tasks: Sequence[Task],
               depths: Optional[Sequence[int]] = None) -> float:
        """One decode iteration: every task produces exactly one token."""
        raise NotImplementedError

    def suspend(self, task: Task) -> float:
        raise NotImplementedError(f"{type(self).__name__} has no KV swap")

    def resume(self, task: Task) -> float:
        raise NotImplementedError(f"{type(self).__name__} has no KV swap")

    def release(self, task: Task) -> None:
        pass

    def latency_model(self) -> LatencyModel:
        raise NotImplementedError


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class PagedTorchExecutor(Executor):
    """Real PyTorch engine over a paged KV arena with continuous batching.

    Every task is backed by ``ceil(tokens / page_size)`` pages from a shared
    pool; concurrency is whatever fits in the pool. A decode step pads the
    batch to the next power of two (pad rows inactive), like the JAX
    engine's compiled buckets, and runs model.decode_step_paged. A prefill
    runs the prompt at its exact length L through model.prefill and writes
    its K/V into the task's pages.

    Sequences are hard-capped at max_seq (the paged cache is append-only)
    and prompts at max_seq // 2, as in the JAX engine.
    """

    def __init__(self, cfg, params=None, n_pages: int = 64,
                 page_size: int = 16, max_seq: int = 512, seed: int = 0,
                 max_batch: int = 16, dtype=torch.float32, device="cuda",
                 prefill_chunk_size: Optional[int] = None,
                 prefix_cache: bool = False,
                 host_arena_bytes: Optional[int] = None,
                 spec_decode: bool = False, mesh=None,
                 async_dispatch: bool = False):
        unported = [name for name, on in (
            ("prefill_chunk_size", prefill_chunk_size is not None),
            ("prefix_cache", prefix_cache),
            ("host_arena_bytes (KV swap)", host_arena_bytes is not None),
            ("spec_decode", spec_decode),
            ("mesh", mesh is not None),
            ("async_dispatch", async_dispatch)) if on]
        if unported:
            raise NotImplementedError(
                f"PagedTorchExecutor: {', '.join(unported)} still to port "
                "(ROADMAP.md)")
        self.device = M.resolve_device(device)
        self.cfg = cfg
        self.params = params if params is not None else M.init_params(
            cfg, seed=seed, dtype=dtype, device=self.device)
        self.page_size = page_size
        self.n_pages = n_pages
        self.max_seq = max_seq
        self.max_batch = max_batch
        self.seed = seed
        self.pool = KVPagePool(n_pages, page_size)
        self.max_pages_per_seq = -(-max_seq // page_size)
        self.pages = M.init_paged_cache(cfg, n_pages, page_size, dtype=dtype,
                                        device=self.device)
        self._last_tok: Dict[int, int] = {}
        self._gen: Dict[int, List[int]] = {}     # generated tokens per task
        self._toks_memo: Dict[int, np.ndarray] = {}
        self.last_logits: Optional[np.ndarray] = None
        self.last_prefill_logits: Optional[np.ndarray] = None
        # (batch, ms) samples of the last latency_model() probe
        self.probe_samples: List[Tuple[int, float]] = []

    # -- observation surfaces --
    @property
    def last_tok(self) -> Dict[int, int]:
        return self._last_tok

    def generated_tokens(self, task: Task) -> List[int]:
        """Generated token ids so far, the first (from prefill) included."""
        return list(self._gen.get(task.task_id, []))

    def _effective_prompt(self, task: Task) -> int:
        return min(task.prompt_len, self.max_seq // 2)

    def _task_tokens(self, task: Task) -> np.ndarray:
        toks = self._toks_memo.get(task.task_id)
        if toks is None:
            toks = _prompt_tokens(self.seed, task, self.cfg.vocab_size,
                                  self._effective_prompt(task))
            self._toks_memo[task.task_id] = toks
        return toks

    def _tensor(self, a: np.ndarray, dtype=torch.int32) -> torch.Tensor:
        return torch.as_tensor(a, dtype=dtype).to(self.device)

    def page_budget(self) -> PageBudget:
        """Admission-side view of the pool for SliceScheduler: peak pages per
        task (capped prompt + full output) against the pool, counting pages
        held by running tasks; seq_cap/max_tasks mirror the engine's hard
        limits."""
        return PageBudget(
            total_pages=self.n_pages, page_size=self.page_size,
            prompt_cap=self.max_seq // 2, seq_cap=self.max_seq,
            max_tasks=self.max_batch,
            held_pages=lambda t: self.pool.resident_page_count(t.task_id))

    # -- ops --
    def prefill(self, task: Task) -> float:
        tid = task.task_id
        L = self._effective_prompt(task)
        if self.pool.holds(tid):
            raise RuntimeError(f"task {tid} already prefilled")
        toks = self._tensor(self._task_tokens(task), torch.long)
        phys = self.pool.alloc(tid, L)                # OutOfPages -> caller
        _sync(self.device)
        t0 = time.perf_counter()
        last, cache1 = M.prefill(self.cfg, self.params, toks,
                                 buf_len=self.max_seq)
        _sync(self.device)
        ms = (time.perf_counter() - t0) * 1000.0
        # write the single-row cache [L,1,Hkv,max_seq,hd] into the task's
        # pages [L,n_alloc,Hkv,psz,hd] (untimed, as in the JAX engine)
        n_alloc, psz = len(phys), self.page_size
        idx = torch.as_tensor(phys, dtype=torch.long, device=self.device)
        for name, src in (("k_pages", cache1["k"]), ("v_pages", cache1["v"])):
            view = (src[:, 0, :, :n_alloc * psz, :]
                    .reshape(src.shape[0], src.shape[2], n_alloc, psz, -1)
                    .transpose(1, 2))
            self.pages[name][:, idx] = view
        self.last_prefill_logits = last.float().cpu().numpy()
        tok = int(self.last_prefill_logits[0].argmax())
        self._last_tok[tid] = tok
        self._gen[tid] = [tok]
        return ms

    def decode(self, tasks: Sequence[Task],
               depths: Optional[Sequence[int]] = None) -> float:
        if depths is not None and any(depths):
            raise NotImplementedError("speculative decoding is still to "
                                      "port (ROADMAP.md)")
        if len(tasks) > self.max_batch:
            raise RuntimeError(f"decode batch {len(tasks)} > max_batch "
                               f"{self.max_batch}")
        ids = [t.task_id for t in tasks]
        lengths = [self.pool.length(i) for i in ids]
        for i, ln in zip(ids, lengths):
            if ln + 1 > self.max_seq:
                raise RuntimeError(f"task {i} exceeds max_seq {self.max_seq}")
            self.pool.extend(i, ln + 1)
        b = next(x for x in _pow2_buckets(self.max_batch) if x >= len(tasks))
        pt = np.full((b, self.max_pages_per_seq), -1, np.int32)
        for r, i in enumerate(ids):
            row = self.pool.page_table(i)
            pt[r, : len(row)] = row
        ln = np.zeros((b,), np.int32)
        ln[: len(ids)] = lengths
        av = np.zeros((b,), bool)
        av[: len(ids)] = True
        tk = np.zeros((b,), np.int32)
        tk[: len(ids)] = [self._last_tok[i] for i in ids]
        args = (self._tensor(pt), self._tensor(ln), self._tensor(tk),
                self._tensor(av, torch.bool))
        _sync(self.device)
        t0 = time.perf_counter()
        logits, self.pages = M.decode_step_paged(
            self.cfg, self.params, self.pages, *args)
        new_toks = logits.argmax(-1).cpu().numpy()     # synchronises
        ms = (time.perf_counter() - t0) * 1000.0
        self.last_logits = logits[: len(ids)].float().cpu().numpy()
        for i, tok in zip(ids, new_toks[: len(ids)]):
            self._last_tok[i] = int(tok)
            # setdefault: latency-model probes decode without a prefill
            self._gen.setdefault(i, []).append(int(tok))
        return ms

    def release(self, task: Task) -> None:
        tid = task.task_id
        self.pool.free(tid)
        self._last_tok.pop(tid, None)
        self._toks_memo.pop(tid, None)
        self._gen.pop(tid, None)

    def latency_model(self) -> LatencyModel:
        """Measure l(b) on the live engine (warm) — MeasuredLatencyModel."""
        # each warm task may grow ~32 tokens across the probe decodes;
        # reserve that many pages so probing never exhausts the pool
        nmax = min(self.max_batch,
                   max(1, self.n_pages // max(1, self.pool.pages_for(32))))
        probes = sorted({b for b in (1, 2, 4, 8, nmax) if b <= nmax})
        warm = [qa_task() for _ in range(nmax)]
        for t in warm:
            self.pool.alloc(t.task_id, 1)
            self._last_tok[t.task_id] = 0
        lat = _probe_latency_curve(self, warm, probes)
        for t in warm:
            self.release(t)
        self.probe_samples = [(b, lat.decode_ms(b)) for b in probes]
        return lat
