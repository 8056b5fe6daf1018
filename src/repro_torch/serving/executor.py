"""Executors: the data plane behind the schedulers (PyTorch port).

TorchExecutor      — the counterpart of ``repro.serving.executor.
                     JaxExecutor``: the model over a fixed slot array
                     (model.init_cache + model.decode_step), decode masked
                     over the whole array by the decode-mask column, or,
                     with ``compact_buckets``, gathered into the smallest
                     power-of-two bucket first (DESIGN.md §3 adaptation #1).
PagedTorchExecutor — the counterpart of ``PagedJaxExecutor`` on one
                     device: the model over a paged KV arena
                     (kv_pool.KVPagePool + model.decode_step_paged),
                     admission bounded by the page pool, page_budget() for
                     SLICE's memory-aware selection.

Both measure l(b) for SLICE's Eq. 7 feasibility test, and both take
``prefill_chunk_size`` for chunked prefill (``prefill_chunk``, DESIGN.md
§5), cutting a request into the same pieces as the JAX engines
(``_chunk_pieces``). Attention runs in the hand-written CUDA kernels on
the card and in their plain versions on the CPU.

The engines are synchronous, dense and single-device. The prefix cache,
KV swap, speculative decoding, tensor parallelism, async dispatch and SSM
state are still to port (ROADMAP.md); asking for one raises
NotImplementedError.

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


def _chunk_pieces(n: int, chunk: int):
    """Decompose an n-token prefill request into compiled chunk buckets:
    full ``chunk``-size pieces plus a power-of-two decomposition of the
    remainder — so the AOT bucket set {chunk} ∪ {2^k < chunk} covers every
    request size, mirroring the pow-2 decode buckets."""
    pieces = []
    while n > 0:
        if n >= chunk:
            pieces.append(chunk)
            n -= chunk
        else:
            p = 1
            while p * 2 <= n:
                p *= 2
            pieces.append(p)
            n -= p
    return pieces


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


class TorchExecutor(Executor):
    """Real PyTorch engine over a fixed slot array.

    Every task holds one slot of a ``max_seq``-position ring cache
    (model.init_cache). Decode runs the whole slot array with a per-slot
    active mask, the image of the decode-mask-matrix column. With
    ``compact_buckets`` the active slots' state is gathered into the
    smallest power-of-two bucket first, padded with distinct inactive
    slots, decoded, and scattered back, so step cost falls with column
    sparsity (DESIGN.md §3 adaptation #1). With ``prefill_chunk_size``,
    ``prefill_chunk`` appends the next pieces of a prompt to its slot
    through model.prefill_chunk on a view of that slot's rows.

    Prompts are capped at max_seq // 2; decode wraps the ring past
    max_seq, as in the JAX engine.
    """

    def __init__(self, cfg, params=None, max_slots: int = 16,
                 max_seq: int = 512, seed: int = 0,
                 compact_buckets: bool = False,
                 prefill_chunk_size: Optional[int] = None,
                 dtype=torch.float32, device="cuda"):
        self.device = M.resolve_device(device)
        self.cfg = cfg
        self.params = params if params is not None else M.init_params(
            cfg, seed=seed, dtype=dtype, device=self.device)
        self.max_slots = max_slots
        self.max_seq = max_seq
        self.seed = seed
        self.compact_buckets = compact_buckets
        self.prefill_chunk_size = prefill_chunk_size
        self.cache = M.init_cache(cfg, max_slots, max_seq,
                                  dtype=self.params["embed"].dtype,
                                  device=self.device)
        self.slot_of: Dict[int, int] = {}
        self.free = list(range(max_slots))
        self.tokens = np.zeros((max_slots,), np.int32)  # last token per slot
        self._chunk_progress: Dict[int, int] = {}
        self._gen: Dict[int, List[int]] = {}     # generated tokens per task
        self.last_logits: Optional[np.ndarray] = None
        self.last_prefill_logits: Optional[np.ndarray] = None
        # (batch, ms) samples of the last latency_model() probe
        self.probe_samples: List[Tuple[int, float]] = []

    # -- observation surfaces --
    @property
    def last_tok(self) -> Dict[int, int]:
        return {tid: g[-1] for tid, g in self._gen.items()}

    def generated_tokens(self, task: Task) -> List[int]:
        """Generated token ids so far, the first (from prefill) included."""
        return list(self._gen.get(task.task_id, []))

    def _effective_prompt(self, task: Task) -> int:
        return min(task.prompt_len, self.max_seq // 2)

    def _set_first_token(self, tid: int, s: int, logits: torch.Tensor) -> None:
        self.last_prefill_logits = logits.float().cpu().numpy()
        tok = int(self.last_prefill_logits[0].argmax())
        self.tokens[s] = tok
        self._gen[tid] = [tok]

    # -- slots --
    def _assign_slot(self, task: Task) -> int:
        if task.task_id in self.slot_of:
            return self.slot_of[task.task_id]
        if not self.free:
            raise RuntimeError("out of KV slots; release finished tasks first")
        s = self.free.pop(0)
        self.slot_of[task.task_id] = s
        return s

    def release(self, task: Task) -> None:
        self._chunk_progress.pop(task.task_id, None)
        self._gen.pop(task.task_id, None)
        s = self.slot_of.pop(task.task_id, None)
        if s is not None:
            self.free.append(s)
            self.cache["length"][s] = 0
            self.cache["kv_pos"][s] = -1

    # -- ops --
    def prefill(self, task: Task) -> float:
        s = self._assign_slot(task)
        L = self._effective_prompt(task)
        toks = torch.as_tensor(_prompt_tokens(self.seed, task,
                                              self.cfg.vocab_size, L),
                               dtype=torch.long).to(self.device)
        _sync(self.device)
        t0 = time.perf_counter()
        last, cache1 = M.prefill(self.cfg, self.params, toks,
                                 buf_len=self.max_seq)
        _sync(self.device)
        ms = (time.perf_counter() - t0) * 1000.0
        # splice the single-row cache into slot s (untimed, as in JAX)
        for k in ("k", "v"):
            self.cache[k][:, s] = cache1[k][:, 0]
        self.cache["kv_pos"][s] = cache1["kv_pos"][0]
        self.cache["length"][s] = cache1["length"][0]
        self._set_first_token(task.task_id, s, last)
        return ms

    def prefill_chunk(self, task: Task, n_tokens: int) -> Tuple[float, bool]:
        """Append the next ``n_tokens`` of the task's prompt to its slot,
        piece by piece (``_chunk_pieces``), on a view of the slot's rows of
        the cache: nothing of the cache is copied."""
        if self.prefill_chunk_size is None:
            raise RuntimeError("executor built without prefill_chunk_size")
        s = self._assign_slot(task)
        L = self._effective_prompt(task)
        done = self._chunk_progress.get(task.task_id, 0)
        if done >= L:     # progress kept until release: appending again
            raise RuntimeError(f"task {task.task_id} already prefilled")
        n = min(n_tokens, L - done)
        toks_full = _prompt_tokens(self.seed, task, self.cfg.vocab_size, L)
        row = {k: self.cache[k][:, s:s + 1] for k in ("k", "v")}
        row["length"] = self.cache["length"][s:s + 1]
        row["kv_pos"] = self.cache["kv_pos"][s:s + 1]
        ms = 0.0
        logits = None
        for c in _chunk_pieces(n, self.prefill_chunk_size):
            piece = torch.as_tensor(toks_full[:, done:done + c],
                                    dtype=torch.long).to(self.device)
            _sync(self.device)
            t0 = time.perf_counter()
            logits, _ = M.prefill_chunk(self.cfg, self.params, row, piece)
            _sync(self.device)
            ms += (time.perf_counter() - t0) * 1000.0
            done += c
        self._chunk_progress[task.task_id] = done
        if done >= L:
            self._set_first_token(task.task_id, s, logits)
            return ms, True
        return ms, False

    def decode(self, tasks: Sequence[Task],
               depths: Optional[Sequence[int]] = None) -> float:
        if depths is not None and any(depths):
            raise RuntimeError("slot executor has no speculative decoding")
        slots = [self._assign_slot(t) for t in tasks]
        if self.compact_buckets:
            b = next(x for x in _pow2_buckets(self.max_slots)
                     if x >= len(slots))
            # pad with slots NOT in the active set, so the scatter-back
            # writes each slot once (pads write back their own state)
            taken = set(slots)
            pads = [s for s in range(self.max_slots) if s not in taken]
            idx = np.asarray(slots + pads[: b - len(slots)], np.int64)
        else:
            idx = np.arange(self.max_slots)
        valid = np.isin(idx, slots)
        idx_t = torch.as_tensor(idx).to(self.device)
        args = (torch.as_tensor(self.tokens[idx]).to(self.device),
                torch.as_tensor(valid).to(self.device))
        _sync(self.device)
        t0 = time.perf_counter()
        if self.compact_buckets:
            sub = {k: v[:, idx_t] if k in ("k", "v") else v[idx_t]
                   for k, v in self.cache.items()}
            logits, sub = M.decode_step(self.cfg, self.params, sub, *args)
            for k, v in sub.items():
                if k in ("k", "v"):
                    self.cache[k][:, idx_t] = v
                else:
                    self.cache[k][idx_t] = v
        else:
            logits, self.cache = M.decode_step(self.cfg, self.params,
                                               self.cache, *args)
        new_toks = logits.argmax(-1).cpu().numpy()     # synchronises
        ms = (time.perf_counter() - t0) * 1000.0
        row_of = {int(s): r for r, s in enumerate(idx)}
        rows = [row_of[s] for s in slots]
        self.last_logits = logits[rows].float().cpu().numpy()
        for t, s, r in zip(tasks, slots, rows):
            self.tokens[s] = new_toks[r]
            # setdefault: latency-model probes decode without a prefill
            self._gen.setdefault(t.task_id, []).append(int(new_toks[r]))
        return ms

    def latency_model(self) -> LatencyModel:
        """Measure l(b) on the live engine (warm) — MeasuredLatencyModel."""
        probes = sorted({b for b in (1, 2, 4, 8, self.max_slots)
                         if b <= self.max_slots})
        warm = [qa_task() for _ in range(self.max_slots)]
        for t in warm:
            self._assign_slot(t)
        lat = _probe_latency_curve(self, warm, probes)
        for t in warm:
            self.release(t)
        self.probe_samples = [(b, lat.decode_ms(b)) for b in probes]
        return lat


class PagedTorchExecutor(Executor):
    """Real PyTorch engine over a paged KV arena with continuous batching.

    Every task is backed by ``ceil(tokens / page_size)`` pages from a shared
    pool; concurrency is whatever fits in the pool. A decode step pads the
    batch to the next power of two (pad rows inactive), like the JAX
    engine's compiled buckets, and runs model.decode_step_paged. A prefill
    runs the prompt at its exact length L through model.prefill and writes
    its K/V into the task's pages.

    With ``prefill_chunk_size`` set, ``prefill_chunk`` runs the next
    piece of a prompt through model.prefill_chunk_paged, allocating its
    pages as each piece arrives (never the prompt's peak up front).

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
        self.prefill_chunk_size = prefill_chunk_size
        self._chunk_progress: Dict[int, int] = {}
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

    def _set_first_token(self, tid: int, logits: torch.Tensor) -> None:
        """Record a completed prefill's logits and first output token."""
        self.last_prefill_logits = logits.float().cpu().numpy()
        tok = int(self.last_prefill_logits[0].argmax())
        self._last_tok[tid] = tok
        self._gen[tid] = [tok]

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
        self._set_first_token(tid, last)
        return ms

    def prompt_progress(self, task: Task) -> int:
        """Prompt tokens cached so far by chunked prefill."""
        return self._chunk_progress.get(task.task_id, 0)

    def prefill_chunk(self, task: Task, n_tokens: int) -> Tuple[float, bool]:
        """Run the next ``n_tokens`` of the task's prompt, piece by piece
        (``_chunk_pieces``). Each piece's pages are allocated just before
        it runs and progress advances per piece, so an OutOfPages from the
        pool propagates with pool and progress consistent and the task
        resumes from its cached tokens."""
        if self.prefill_chunk_size is None:
            raise RuntimeError("executor built without prefill_chunk_size")
        tid = task.task_id
        L = self._effective_prompt(task)
        done = self._chunk_progress.get(tid, 0)
        if done >= L or (done == 0 and self.pool.holds(tid)):
            raise RuntimeError(f"task {tid} already prefilled")
        toks_full = self._task_tokens(task)
        n = min(n_tokens, L - done)
        ms = 0.0
        logits = None
        for c in _chunk_pieces(n, self.prefill_chunk_size):
            if self.pool.holds(tid):
                self.pool.extend(tid, done + c)       # OutOfPages -> caller
            else:
                self.pool.alloc(tid, c)
            row = self.pool.page_table(tid)
            pt = np.full((1, self.max_pages_per_seq), -1, np.int32)
            pt[0, : len(row)] = row
            args = (self._tensor(pt), self._tensor(np.asarray([done])),
                    self._tensor(toks_full[:, done:done + c], torch.long))
            _sync(self.device)
            t0 = time.perf_counter()
            logits, self.pages = M.prefill_chunk_paged(
                self.cfg, self.params, self.pages, *args)
            _sync(self.device)
            ms += (time.perf_counter() - t0) * 1000.0
            done += c
            self._chunk_progress[tid] = done
        if done >= L:
            self._set_first_token(tid, logits)
            return ms, True
        return ms, False

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
        self._chunk_progress.pop(tid, None)
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
