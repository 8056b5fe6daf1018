"""Executors: the data plane behind the schedulers (PyTorch port).

SimExecutor        — copies of ``repro.serving.executor``'s discrete-
PagedSimExecutor     event executors: step costs from a LatencyModel, no
                     model (the simulated fleet's members,
                     ``serving.fleet.sim_fleet``).
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
                     SLICE's memory-aware selection; the radix prefix
                     cache, synchronous host KV swap and speculative
                     decoding (model.verify_step_paged); SSM and hybrid
                     archs with a recurrent-state arena beside the pages
                     (serving.state_store, DESIGN.md §12), MoE archs
                     through the model's grouped dispatch.

The two torch engines measure l(b) for SLICE's Eq. 7 feasibility test,
and both take
``prefill_chunk_size`` for chunked prefill (``prefill_chunk``, DESIGN.md
§5), cutting a request into the same pieces as the JAX engines
(``_chunk_pieces``). Attention, the SSD scan and step and the MoE expert
FFN run in the hand-written CUDA kernels on the card and in their plain
versions on the CPU.

The paged engine runs synchronously by default and, with
``async_dispatch=True``, as the JAX engine's async pipeline (DESIGN.md
§10): each op dispatches its step on the compute stream and returns, and
the step is observed at its commit, in dispatch order, through
``serving.pipeline.DispatchQueue`` (at most ``max_in_flight`` steps in
flight). With ``mesh=`` (a ``launch.mesh.ServingMesh``) it is one rank of
a tensor-parallel engine (DESIGN.md §9), run SPMD over
``torch.distributed``; the slot engine has no mesh, as in JAX.

Every step runs through ``serving.step_graphs``: on the card each step
kind and static shape is captured once as a CUDA graph and replayed, as
the JAX engines AOT-compile them (``cuda_graphs=False`` runs the same
staged step eagerly). Decode-type steps: paged decode and verify, the
slot engine's masked and compacted decode, the draft model's masked
decode. Prefill-type steps: the whole prompt per exact length (with its
splice into the task's pages, state slot or cache row inside the step),
chunks per piece size on both engines (the paged engine's prefix-hit
suffixes too) and the draft's catch-up pieces. The argmax is fused into
each step and only it is read to the host; the logits stay on the
device until ``last_logits`` or ``last_prefill_logits`` is read. A
step's graph is captured when the step is first asked for, before the
engine's clock starts.

Every timed operation of a synchronous engine ends in a wait on the
device before its clock read, as the JAX engine's ``block_until_ready``:
without it l(b) would time only the enqueue and every Eq. 7 feasibility
check would be wrong. An async engine's ops return the host's dispatch
time and the serving loop adds the commit waits to its clock
(``GapStats``); its ``latency_model()`` probes synchronously.
"""
from __future__ import annotations

import contextlib
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.latency_model import LatencyModel, MeasuredLatencyModel
from repro_torch.core.selection import PageBudget, StateBudget
from repro_torch.core.task import Task, qa_task
from repro_torch.launch import sharding as S
from repro_torch.launch.mesh import digest
from repro_torch.models import model as M
from repro_torch.models.partitioning import activation_partitioning
from repro_torch.serving.kv_pool import KVPagePool, OutOfPages
from repro_torch.serving.kv_swap import HostArenaFull, KVSwapArena
from repro_torch.serving.pipeline import (DispatchQueue, GapStats,
                                          PendingStep, TransferLedger)
from repro_torch.serving.prefix_cache import RadixPrefixCache
from repro_torch.serving.spec_decode import (DraftModel, default_draft_config,
                                             depth_bucket, greedy_accept,
                                             pow2_pieces)
from repro_torch.serving.state_store import (CacheStore, OutOfStates,
                                             SSMStateStore)
from repro_torch.serving.step_graphs import (LazyLogits, Snapshot,
                                             StepGraphs, chunk_step,
                                             masked_step, slot_cache,
                                             wait_event, with_argmax)

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


def monotone_samples(samples: Sequence[Tuple[int, float]]
                     ) -> List[Tuple[int, float]]:
    """The (batch, ms) samples of l(b) made non-decreasing in b: each
    sample is the least of its own and every larger batch's. A smaller
    batch on the same engine never costs more than a larger one, so a
    sample above a larger batch's is a slow reading (a host shared with
    other processes, a mesh's slowest rank); where the samples already
    rise nothing changes."""
    out: List[Tuple[int, float]] = []
    low = float("inf")
    for b, ms in sorted(samples, reverse=True):
        low = min(low, ms)
        out.append((b, low))
    return out[::-1]


def _probe_latency_curve(executor: "Executor", warm_tasks, probes
                         ) -> Tuple[MeasuredLatencyModel,
                                    List[Tuple[int, float]]]:
    """Warm min-of-3 decode timings at each probe batch size over tasks the
    caller has already admitted to the engine: (the model over them made
    non-decreasing in the batch (``monotone_samples``; JAX's probe keeps
    them as read), the (batch, ms) samples as read)."""
    samples = []
    for b in probes:
        sub = warm_tasks[:b]
        executor.decode(sub)  # warm compile/caches
        ms = min(executor.decode(sub) for _ in range(3))
        samples.append((b, ms))
    return (MeasuredLatencyModel(monotone_samples(samples), _PREFILL_PRIOR),
            samples)


class Executor:
    """Returns elapsed milliseconds for each operation."""

    _last_logits: Optional[LazyLogits] = None
    _last_prefill: Optional[LazyLogits] = None

    @property
    def last_logits(self) -> Optional[np.ndarray]:
        """Logits [tasks, V] (fp32) of the tasks the last decode-type step
        served, read from the device at the first access."""
        return None if self._last_logits is None else self._last_logits.numpy()

    @property
    def last_prefill_logits(self) -> Optional[np.ndarray]:
        """Last-position logits [1, V] (fp32) of the last completed
        prefill, read from the device at the first access."""
        return (None if self._last_prefill is None
                else self._last_prefill.numpy())

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

    def trace_gauges(self) -> Dict[str, int]:
        """Observability gauge surface (DESIGN.md §13): point-in-time
        resource occupancy for MetricsSnapshot sampling. Read-only —
        never mutates executor state. Executors without a paged arena
        report nothing."""
        return {}


class SimExecutor(Executor):
    def __init__(self, lat: LatencyModel, scheduling_overhead_ms: float = 0.0,
                 name: Optional[str] = None):
        self.lat = lat
        self.name = name               # fleet-instance identity (DESIGN.md §11)
        self.overhead = scheduling_overhead_ms
        self.decode_steps = 0
        self.prefill_steps = 0
        self.chunk_steps = 0
        self._chunk_progress: Dict[int, int] = {}
        # KV swap accounting (DESIGN.md §7): transfers are priced by the
        # latency model's swap_bw_gbps term; resident KV is the task's
        # prompt plus every token decoded so far.
        self.suspend_count = 0
        self.resume_count = 0
        self.swapped_bytes = 0.0
        self._swapped_tokens: Dict[int, int] = {}
        # Speculative decoding (DESIGN.md §8): draft+verify cost comes from
        # the latency model's spec terms; acceptance is sampled per task
        # from a persistent stream at the model's spec_accept_rate, so a
        # run is deterministic at equal seed/call order.
        self.spec_steps = 0
        self.drafted_tokens = 0
        self.accepted_tokens = 0
        self.last_commits: Optional[List[int]] = None
        self._accept_rng: Dict[int, Any] = {}

    def prefill(self, task: Task) -> float:
        self.prefill_steps += 1
        return self.lat.prefill_ms(task.prompt_len) + self.overhead

    def prefill_chunk(self, task: Task, n_tokens: int) -> Tuple[float, bool]:
        done = self._chunk_progress.get(task.task_id, 0)
        n = min(n_tokens, task.prompt_len - done)
        self.chunk_steps += 1
        done += n
        if done >= task.prompt_len:
            self._chunk_progress.pop(task.task_id, None)
            self.prefill_steps += 1
            return self.lat.prefill_ms(n) + self.overhead, True
        self._chunk_progress[task.task_id] = done
        return self.lat.prefill_ms(n) + self.overhead, False

    def decode(self, tasks: Sequence[Task],
               depths: Optional[Sequence[int]] = None) -> float:
        self.decode_steps += 1
        if depths is None or not any(depths):
            self.last_commits = [1] * len(tasks)
            return self.lat.decode_ms(len(tasks)) + self.overhead
        k = max(depths)
        b = len(tasks)
        commits: List[int] = []
        for t, d in zip(tasks, depths):
            d = max(0, min(int(d), t.output_len - t.tokens_done - 1))
            rng = self._accept_rng.get(t.task_id)
            if rng is None:
                rng = np.random.default_rng(9_176 + 613 * t.task_id)
                self._accept_rng[t.task_id] = rng
            n_acc = 0
            while n_acc < d and rng.random() < self.lat.spec_accept_rate:
                n_acc += 1
            self.drafted_tokens += d
            self.accepted_tokens += n_acc
            commits.append(n_acc + 1)
        self.spec_steps += 1
        self.last_commits = commits
        return (self.lat.verify_ms(b, k) + self.lat.draft_ms(b, k)
                + self.overhead)

    def suspend(self, task: Task) -> float:
        tid = task.task_id
        if tid in self._swapped_tokens:
            raise RuntimeError(f"task {tid} already suspended")
        n = task.prompt_len + task.tokens_done
        self._swapped_tokens[tid] = n
        self.suspend_count += 1
        self.swapped_bytes += n * self.lat.kv_bytes_per_token
        return self.lat.swap_ms(n) + self.overhead

    def resume(self, task: Task) -> float:
        tid = task.task_id
        if tid not in self._swapped_tokens:
            raise RuntimeError(f"task {tid} is not suspended")
        n = self._swapped_tokens.pop(tid)
        self.resume_count += 1
        self.swapped_bytes += n * self.lat.kv_bytes_per_token
        return self.lat.swap_ms(n) + self.overhead

    def release(self, task: Task) -> None:
        self._chunk_progress.pop(task.task_id, None)
        self._swapped_tokens.pop(task.task_id, None)
        self._accept_rng.pop(task.task_id, None)

    def latency_model(self) -> LatencyModel:
        return self.lat


class PagedSimExecutor(SimExecutor):
    """SimExecutor + the held-page reporting a paged engine provides
    (used by benchmarks/kv_swap.py and tests/test_kv_swap.py): prefill
    pins the task's peak pages — deterministic and conservative, a real
    engine grows into them — suspend releases them (sim has no sharing,
    so every page is private), resume re-pins, release frees. ``budget``
    is the PageBudget to hand the scheduler."""

    def __init__(self, lat: LatencyModel, total_pages: int, page_size: int,
                 scheduling_overhead_ms: float = 0.0,
                 name: Optional[str] = None):
        super().__init__(lat, scheduling_overhead_ms, name=name)
        self.held: Dict[int, int] = {}
        self.budget = PageBudget(
            total_pages=total_pages, page_size=page_size,
            held_pages=lambda t: self.held.get(t.task_id, 0))

    @property
    def used_pages(self) -> int:
        """Pages currently pinned — the sim-side analogue of
        PagePool.used_pages, so fleet leak checks read uniformly."""
        return sum(self.held.values())

    def trace_gauges(self) -> Dict[str, int]:
        return {"pages_in_use": self.used_pages,
                "pages_total": self.budget.total_pages}

    def prefill(self, task: Task) -> float:
        self.held[task.task_id] = self.budget.pages_for(task)
        return super().prefill(task)

    def suspend(self, task: Task) -> float:
        self.held[task.task_id] = 0
        return super().suspend(task)

    def resume(self, task: Task) -> float:
        self.held[task.task_id] = self.budget.pages_for(task)
        return super().resume(task)

    def release(self, task: Task) -> None:
        self.held.pop(task.task_id, None)
        super().release(task)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _RankStats(GapStats):
    """GapStats of a rank of a tensor-parallel engine: every wait booked
    into ``wait_ms`` grows it by the slowest rank's wait (``agree``), so
    the serving loop, which folds these waits into its clock under async
    dispatch, keeps one clock on every rank."""

    def __init__(self, agree):
        self.__dict__["_agree"] = agree
        super().__init__()

    def __setattr__(self, name, value):
        if name == "wait_ms" and "wait_ms" in self.__dict__:
            value = self.wait_ms + self._agree(value - self.wait_ms)
        super().__setattr__(name, value)


def _check_mesh(cfg, mesh, cuda_graphs: bool, device) -> None:
    """The mesh refusal that is the port's own: captured steps over gloo
    (its collectives cannot be captured). SSM and hybrid archs refuse a
    mesh as in JAX, before this."""
    if tuple(mesh.axis_names) != ("data", "model"):
        raise ValueError("serving mesh needs ('data', 'model') axes, as "
                         "JAX's engine does (a 'pod' axis serves a training "
                         "step) — see launch.mesh.make_serving_mesh")
    if (cuda_graphs and getattr(mesh, "backend", None) == "gloo"
            and torch.device(device).type == "cuda"):
        raise ValueError("cuda_graphs=True over a gloo process group: gloo "
                         "collectives cannot be captured in a CUDA graph; "
                         "pass cuda_graphs=False, or give each rank a card "
                         "of its own (NCCL)")


class TorchExecutor(Executor):
    """Real PyTorch engine over a fixed slot array.

    Every task holds one slot of a ``max_seq``-position ring cache
    (model.init_cache): K/V for attention layers, the SSD state and conv
    tail for SSM layers, both for hybrid archs. Decode runs the whole slot array with a per-slot
    active mask, the image of the decode-mask-matrix column. With
    ``compact_buckets`` the active slots' state is gathered into the
    smallest power-of-two bucket first, padded with distinct inactive
    slots, decoded, and scattered back, so step cost falls with column
    sparsity (DESIGN.md §3 adaptation #1). With ``prefill_chunk_size``,
    ``prefill_chunk`` appends the next pieces of a prompt to its slot
    through model.prefill_chunk, one staged step per piece size that
    gathers the slot's row, chunks it and scatters it back (JAX's
    ``_build_chunk_steps``; attention-only archs: SSM and hybrid archs
    raise, as JAX's engine does). A whole prompt runs in one staged step per
    prompt length that splices the prompt's cache into its slot. The
    cache holds one spare row past the slots (``step_graphs.slot_cache``),
    which the steps' pad inputs write.

    Prompts are capped at max_seq // 2; decode wraps the ring past
    max_seq, as in the JAX engine.
    """

    def __init__(self, cfg, params=None, max_slots: int = 16,
                 max_seq: int = 512, seed: int = 0,
                 compact_buckets: bool = False,
                 prefill_chunk_size: Optional[int] = None,
                 dtype=torch.float32, device="cuda",
                 cuda_graphs: bool = True):
        if prefill_chunk_size is not None and (not cfg.has_attention
                                               or cfg.has_ssm):
            raise ValueError("chunked prefill needs a pure-attention arch "
                             "(SSM chunk-state carry is not implemented); "
                             "use atomic prefill")
        self.device = M.resolve_device(device)
        self.cfg = cfg
        # detached: a model fresh from training serves without autograd
        self.params = M.detached(params) if params is not None else \
            M.init_params(cfg, seed=seed, dtype=dtype, device=self.device)
        self.max_slots = max_slots
        self.max_seq = max_seq
        self.seed = seed
        self.compact_buckets = compact_buckets
        self.prefill_chunk_size = prefill_chunk_size
        self.cache = slot_cache(cfg, max_slots, max_seq,
                                self.params["embed"].dtype, self.device)
        self.slot_of: Dict[int, int] = {}
        self.free = list(range(max_slots))
        self.tokens = np.zeros((max_slots,), np.int32)  # last token per slot
        self._chunk_progress: Dict[int, int] = {}
        self._gen: Dict[int, List[int]] = {}     # generated tokens per task
        # (batch, ms) samples of the last latency_model() probe: the curve
        # the model uses, and the samples as read
        self.probe_samples: List[Tuple[int, float]] = []
        self.probe_read: List[Tuple[int, float]] = []
        # the masked step, the compacted buckets' steps (DESIGN.md §3),
        # the chunk steps and the whole-prompt steps
        self.graphs = StepGraphs(self.device, cuda_graphs)

    # -- observation surfaces --
    @property
    def last_tok(self) -> Dict[int, int]:
        return {tid: g[-1] for tid, g in self._gen.items()}

    def generated_tokens(self, task: Task) -> List[int]:
        """Generated token ids so far, the first (from prefill) included."""
        return list(self._gen.get(task.task_id, []))

    def _effective_prompt(self, task: Task) -> int:
        return min(task.prompt_len, self.max_seq // 2)

    def _set_first_token(self, tid: int, s: int, logits: torch.Tensor,
                         tok: int) -> None:
        self._last_prefill = LazyLogits(logits)
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
            if "kv_pos" in self.cache:
                self.cache["kv_pos"][s] = -1

    # -- ops --
    def _prefill_step(self, L: int):
        """The whole-prompt step of length L (JAX's ``_prefill_jit[(L,)]``):
        model.prefill, then the prompt's cache (K/V and kv_pos, the SSD
        state and conv tail, the length) spliced into the slot ``idx``.
        Inputs idx [1] and tokens [1, L]; the pad is the spare row.
        Returns (logits [1,V], argmax [1] int32)."""
        cfg, params = self.cfg, self.params
        spec = {"idx": ((1,), torch.int64, self.max_slots),
                "tokens": ((1, L), torch.int32, 0)}

        def prefill(x):
            last, cache1 = M.prefill(cfg, params, x["tokens"],
                                     buf_len=self.max_seq)
            idx = x["idx"]
            for k, v in cache1.items():
                if k in M.LAYER_FIELDS:
                    self.cache[k][:, idx] = v
                else:
                    self.cache[k][idx] = v
            return with_argmax(last)

        return self.graphs.step(("prefill", L), spec, prefill, self._arenas)

    def prefill(self, task: Task) -> float:
        L = self._effective_prompt(task)
        # made (on the card: captured) before the clock starts and before
        # the task takes a slot, so a refused capture leaves it without one
        step = self._prefill_step(L)
        s = self._assign_slot(task)
        toks = _prompt_tokens(self.seed, task, self.cfg.vocab_size, L)
        _sync(self.device)
        t0 = time.perf_counter()
        logits, argmax = step.run({"idx": np.asarray([s]), "tokens": toks})
        tok = int(argmax.cpu()[0])                     # synchronises
        ms = (time.perf_counter() - t0) * 1000.0
        self._set_first_token(task.task_id, s, logits, tok)
        return ms

    def prefill_chunk(self, task: Task, n_tokens: int) -> Tuple[float, bool]:
        """Append the next ``n_tokens`` of the task's prompt to its slot,
        piece by piece (``_chunk_pieces``), each through the staged chunk
        step of its size (``step_graphs.chunk_step``)."""
        if self.prefill_chunk_size is None:
            raise RuntimeError("executor built without prefill_chunk_size")
        L = self._effective_prompt(task)
        done = self._chunk_progress.get(task.task_id, 0)
        if done >= L:     # progress kept until release: appending again
            raise RuntimeError(f"task {task.task_id} already prefilled")
        pieces = _chunk_pieces(min(n_tokens, L - done),
                               self.prefill_chunk_size)
        steps = [chunk_step(self, c) for c in pieces]  # before the clock
        s = self._assign_slot(task)
        toks_full = _prompt_tokens(self.seed, task, self.cfg.vocab_size, L)
        _sync(self.device)
        t0 = time.perf_counter()
        for c, step in zip(pieces, steps):
            logits, argmax = step.run({
                "idx": np.asarray([s]), "length": np.asarray([done]),
                "tokens": toks_full[:, done:done + c]})
            done += c
        self._chunk_progress[task.task_id] = done
        if done >= L:
            self._set_first_token(task.task_id, s, logits,
                                  int(argmax.cpu()[0]))  # synchronises
        else:
            _sync(self.device)
        return (time.perf_counter() - t0) * 1000.0, done >= L

    def _arenas(self) -> List[torch.Tensor]:
        return list(self.cache.values())

    def _decode_step(self, b: Optional[int]):
        """The masked step over every slot (``b`` None,
        ``step_graphs.masked_step``), or the compacted step of bucket b:
        gather the bucket's slots ``idx`` from the cache, step them,
        scatter them back, as JAX's ``_build_bucket_steps``. Inputs:
        tokens and valid (the decode-mask column) per row, and the
        bucket's slots; pads: inactive rows over distinct slots."""
        cfg, params = self.cfg, self.params
        if b is None:
            return masked_step(self)
        spec = {"idx": ((b,), torch.int64, np.arange(b)),
                "tokens": ((b,), torch.int32, 0),
                "valid": ((b,), torch.bool, False)}

        def compacted(x):
            idx = x["idx"]
            sub = {k: v[:, idx] if k in M.LAYER_FIELDS else v[idx]
                   for k, v in self.cache.items()}
            logits, sub = M.decode_step(cfg, params, sub, x["tokens"],
                                        x["valid"])
            for k, v in sub.items():
                if k in M.LAYER_FIELDS:
                    self.cache[k][:, idx] = v
                else:
                    self.cache[k][idx] = v
            return with_argmax(logits)

        return self.graphs.step(("compact", b), spec, compacted, self._arenas)

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
            step = self._decode_step(b)
            host = {"idx": idx}
        else:
            idx = np.arange(self.max_slots)
            step = self._decode_step(None)
            host = {}
        host.update(tokens=self.tokens[idx], valid=np.isin(idx, slots))
        _sync(self.device)
        t0 = time.perf_counter()
        logits, argmax = step.run(host)
        row_of = {int(s): r for r, s in enumerate(idx)}
        rows = [row_of[s] for s in slots]
        self._last_logits = LazyLogits(logits, rows=rows)
        new_toks = argmax.cpu().numpy()                # synchronises
        ms = (time.perf_counter() - t0) * 1000.0
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
        lat, self.probe_read = _probe_latency_curve(self, warm, probes)
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
    pages as each piece arrives (never the prompt's peak up front). A
    whole prompt runs in one staged step per prompt length that splices
    the prompt's K/V into the task's pages (and its final recurrent state
    into its state slot) inside the step; chunk pieces and prefix-hit
    suffix pieces share one staged chunk step per piece size.

    With ``prefix_cache=True`` a radix index over page-aligned prompt
    blocks (serving.prefix_cache, DESIGN.md §6) dedups shared prompt
    prefixes: prefill acquires the cached pages (pool.share) and computes
    only the uncached suffix in power-of-two prefill_chunk_paged pieces;
    chunked prefill starts at the first uncached chunk; admission
    (page_budget) counts shared pages once and treats idle cached pages as
    reclaimable headroom, evicted under pressure (``_reserve``).
    ``prefix_cache_pages`` bounds the index's own pages (default
    ``n_pages``): an insert past it evicts the least recently used leaves.

    ``suspend``/``resume`` swap a task's private pages to the host arena
    (serving.kv_swap, DESIGN.md §7) and back; with ``host_arena_bytes``
    the arena is bounded and a suspension past it is rolled back.

    With ``spec_decode=True``, ``decode(tasks, depths)`` runs a draft-verify
    iteration (DESIGN.md §8): the draft model (serving.spec_decode)
    proposes per-task windows, model.verify_step_paged checks them in one
    step over a power-of-two (batch, depth) bucket, the greedy-accepted
    prefix plus a bonus token is committed and pages of rejected drafts are
    rolled back. The committed stream equals depth-0 greedy decode.

    SSM and hybrid archs (DESIGN.md §12) hold, beside their (for pure SSM
    zero-width) pages, one constant-size slot of a recurrent-state arena
    (``n_state_slots``, default 2*max_batch, allocated by SSMStateStore):
    prefill writes the prompt's final SSD state and conv tail into it,
    decode steps it in place through a per-row slot vector, suspend/resume
    swap it with the pages as one blob, and admission (page_budget) is a
    StateBudget. Speculative decoding, the prefix cache and executor-level
    chunked prefill need per-token state and raise for these archs, as in
    the JAX engine.

    With ``mesh=`` (a ``launch.mesh.ServingMesh`` over an initialised
    process group; DESIGN.md §9) the engine is one rank of a
    tensor-parallel engine, run SPMD: every rank runs this same control
    plane in lockstep on its own host state (pool, radix cache, swap
    arena, draft model), holds its slab of the weights
    (``launch.sharding.local_params``: whole heads, d_ff columns,
    vocabulary rows and, for MoE, whole experts or each expert's d_ff
    columns) and of the KV arena (its KV heads), and runs every step with
    ``models.partitioning``'s collectives installed, so the paged kernels
    and the grouped-expert FFN run on the rank's slab and every rank sees
    the whole logits. Over 'data' the weights and the arena are
    replicated (JAX's ``param_specs(train=False)`` and ``page_specs``): a
    decode or verify step of bucket b is cut into ``data`` row blocks when
    b divides (JAX's ``batch_spec``), each data group computing its block
    on its model group, and every rank then gathers the other groups'
    logits and new K/V into its own arena, once a step; any other step
    runs whole on every group. The loop's clock must be one clock: every
    ms an op returns, and every commit wait, is the slowest rank's of the
    whole mesh (``_agree``). Each op compares a digest of its host inputs
    across every rank and raises ``RuntimeError("ranks diverged ...")``
    on a mismatch; ``digest`` chains them over the run. Suspend/resume
    swap each rank's own slab (the same on every data replica); the host
    arena counts whole pages (``KVSwapArena.byte_scale``), so admission
    decides as the single-device engine does. The draft of speculative
    decoding stays whole on every rank. SSM and hybrid archs raise
    ValueError, as in JAX; ``cuda_graphs`` on the card needs NCCL (gloo
    collectives cannot be captured).

    With ``async_dispatch=True`` the engine pipelines as the JAX engine
    does (DESIGN.md §10), on one compute stream. Every op makes its host
    reservations and dispatches its step at once, then returns the host's
    dispatch ms; what the step computed is observed at its commit, in
    dispatch order (``DispatchQueue``: a push past ``max_in_flight``
    steps commits the oldest first, a stall). A commit waits on the event
    recorded after that step's argmax copy only (``step_graphs.Snapshot``),
    never on later steps. The next decode's tokens are chained on the
    device from the argmax of steps not yet committed. ``suspend`` commits
    first, gathers the task's pages (and state slot) into a device copy on
    the compute stream, before any later step can reuse them, and copies
    that to pinned host memory on a side stream; a worker thread retires
    the copy in the ``TransferLedger``, and ``resume`` and ``release``
    wait for it. A speculative iteration commits what is pending before
    it drafts (the draft runs synchronously); its verify step is
    committed lazily like a decode. Reading an observation surface
    (``last_tok``, ``last_logits``, ``last_prefill_logits``,
    ``last_commits``, ``generated_tokens``, ``accepted_tokens``,
    ``drafted_tokens``) commits what is pending, so callers see exactly
    the synchronous engine's values; ``drain()`` commits everything and
    waits out the transfers. A commit that raises rolls the uncommitted
    steps' reservations back, newest first, and the error propagates;
    nothing falls back to the synchronous engine. The synchronous engine
    runs the same code and commits each step as it is dispatched.

    Sequences are hard-capped at max_seq (the paged cache is append-only)
    and prompts at max_seq // 2, as in the JAX engine.
    """

    def __init__(self, cfg, params=None, n_pages: int = 64,
                 page_size: int = 16, max_seq: int = 512, seed: int = 0,
                 max_batch: int = 16, dtype=torch.float32, device="cuda",
                 prefill_chunk_size: Optional[int] = None,
                 prefix_cache: bool = False,
                 prefix_cache_pages: Optional[int] = None,
                 host_arena_bytes: Optional[int] = None,
                 spec_decode: bool = False, draft_cfg=None,
                 draft_params=None, max_spec_depth: int = 4, mesh=None,
                 async_dispatch: bool = False, max_in_flight: int = 2,
                 n_state_slots: Optional[int] = None,
                 cuda_graphs: bool = True):
        if not (cfg.has_attention or cfg.has_ssm):
            raise ValueError("PagedTorchExecutor needs an attention and/or "
                             "SSM mixer")
        if cfg.has_ssm:
            gated = [name for name, on in (
                ("spec_decode", spec_decode),
                ("prefix_cache", prefix_cache),
                ("prefill_chunk_size", prefill_chunk_size is not None),
                ("mesh", mesh is not None)) if on]
            if gated:
                raise ValueError(
                    f"{'/'.join(gated)} unsupported for SSM/hybrid archs: "
                    "recurrent state is a running summary, not a per-token "
                    "log — it cannot be rewound, prefix-shared, chunk-"
                    "restarted at the executor level, or sharded "
                    "(DESIGN.md §12)")
        if mesh is not None:
            _check_mesh(cfg, mesh, cuda_graphs, device)
        self.device = M.resolve_device(device)
        self.cfg = cfg
        # tensor parallelism (DESIGN.md §9): this rank's slab of the
        # weights and of the KV heads
        self.mesh = mesh
        ways = mesh.shape["model"] if mesh is not None else 1
        rank = mesh.coords["model"] if mesh is not None else 0
        self.heads = S.head_slab(cfg, ways, rank)   # (Hq, Hkv, first KV)
        cut = S.cutter(cfg, mesh) if mesh is not None else None
        # detached: a model fresh from training serves without autograd
        if params is not None:
            self.params = M.detached(params)
            if mesh is not None:
                self.params = S.local_params(cfg, self.params, mesh)
        else:
            self.params = M.init_params(cfg, seed=seed, dtype=dtype,
                                        device=self.device, cut=cut)
        self.digest = 0               # chained digest of the ops' inputs
        self.page_size = page_size
        self.n_pages = n_pages
        self.max_seq = max_seq
        self.max_batch = max_batch
        self.seed = seed
        self.prefill_chunk_size = prefill_chunk_size
        self._chunk_progress: Dict[int, int] = {}
        self.pool = KVPagePool(n_pages, page_size)
        # host-offload KV swap (DESIGN.md §7): suspended tasks' private
        # page contents live here until resume; host_arena_bytes bounds it
        self.arena = KVSwapArena(
            page_size, capacity_bytes=host_arena_bytes,
            byte_scale=cfg.n_kv_heads // self.heads[1]
            if cfg.has_attention else 1)
        self.prefix_cache = None
        if prefix_cache:
            self.prefix_cache = RadixPrefixCache(
                self.pool, max_pages=prefix_cache_pages or n_pages)
        self.max_pages_per_seq = -(-max_seq // page_size)
        self.pages = M.init_paged_cache(cfg, n_pages, page_size,
                                        dtype=self.params["embed"].dtype,
                                        device=self.device,
                                        kv_heads=self.heads[1])
        # recurrent-state kind (DESIGN.md §12): one constant-size slot of
        # the state arena per SSM/hybrid task, allocated as pages are;
        # CacheStore is the cross-kind audit facade
        self.states: Optional[SSMStateStore] = None
        self.n_state_slots = 0
        if cfg.has_ssm:
            self.n_state_slots = (n_state_slots if n_state_slots is not None
                                  else 2 * max_batch)
            self.states = SSMStateStore(self.n_state_slots)
            self.pages.update(M.init_state_arena(
                cfg, self.n_state_slots, dtype=self.params["embed"].dtype,
                device=self.device))
        self.store = CacheStore(cfg, self.pool, self.states)
        self._last_tok: Dict[int, int] = {}
        self._gen: Dict[int, List[int]] = {}     # generated tokens per task
        self._toks_memo: Dict[int, np.ndarray] = {}
        self._gtoks: Dict[int, np.ndarray] = {}  # group -> prefix tokens
        # async pipelining (DESIGN.md §10): the queue, ledger and stats
        # exist in both modes (a synchronous op commits its step at once
        # and books its time as wait), so the loop reads one surface
        self.async_dispatch = async_dispatch
        self._sync_depth = 0          # _sync_mode() nesting
        self.gap_stats = GapStats() if mesh is None else _RankStats(
            mesh.agree)
        self.ledger = TransferLedger()
        self._queue = DispatchQueue(self._commit_step,
                                    max_in_flight=max_in_flight,
                                    rollback=self._rollback_step,
                                    stats=self.gap_stats)
        # chain links: task -> (snapshot of an uncommitted step's argmax,
        # row), the source of that task's next decode token on the device
        self._tok_dev: Dict[int, Tuple[Snapshot, int]] = {}
        self._verify_queued = False   # a verify step awaits its commit
        self._pushing: Optional[PendingStep] = None   # during _push
        self._swap_stream = None                      # side stream, lazy
        self._swap_worker: Optional[ThreadPoolExecutor] = None
        self._landing: Dict[int, List[Future]] = {}  # task -> transfers
        # the decode steps per batch bucket, the verify steps per (batch,
        # depth) bucket, the chunk steps per piece size and the prefill
        # steps per prompt length; staging and snapshot rings one deeper
        # than the steps in flight; no capture while a transfer is
        # outstanding (the worker waits on a CUDA event)
        self.graphs = StepGraphs(
            self.device, cuda_graphs,
            ring=max_in_flight + 1 if async_dispatch else 1,
            quiesce=self.ledger.wait)
        # (batch, ms) samples of the last latency_model() probe: the curve
        # the model uses, and the samples as read
        self.probe_samples: List[Tuple[int, float]] = []
        self.probe_read: List[Tuple[int, float]] = []
        # speculative decoding (DESIGN.md §8)
        self.draft = None
        self.spec_depth = 0
        self.spec_steps = 0
        self._accepted_tokens = 0
        self._last_commits: Optional[List[int]] = None
        # (window C, the rows' cached lengths, ms from the verify step's
        # dispatch to its commit) of the last committed verify step
        self.last_verify: Optional[Tuple[int, List[int], float]] = None
        if spec_decode:
            if max_spec_depth < 1:
                raise ValueError("max_spec_depth must be >= 1")
            self.spec_depth = max_spec_depth
            self.draft = DraftModel(
                draft_cfg if draft_cfg is not None
                else default_draft_config(cfg),
                params=draft_params, max_slots=max_batch, max_seq=max_seq,
                seed=seed, dtype=self.params["embed"].dtype,
                device=self.device, cuda_graphs=cuda_graphs)
            self.draft.graphs.quiesce = self.ledger.wait
            if self.draft.cfg.vocab_size != cfg.vocab_size:
                raise ValueError(
                    f"draft vocab {self.draft.cfg.vocab_size} != target "
                    f"vocab {cfg.vocab_size}: proposals would not be "
                    "valid target token ids")

    # -- observation surfaces: each commits what is pending first, so an
    # async engine answers exactly as the synchronous one --
    @property
    def last_tok(self) -> Dict[int, int]:
        self._commit_pending()
        return self._last_tok

    @property
    def last_logits(self) -> Optional[np.ndarray]:
        self._commit_pending()
        return super().last_logits

    @property
    def last_prefill_logits(self) -> Optional[np.ndarray]:
        self._commit_pending()
        return super().last_prefill_logits

    @property
    def last_commits(self) -> Optional[List[int]]:
        self._commit_pending()
        return self._last_commits

    @property
    def accepted_tokens(self) -> int:
        self._commit_pending()
        return self._accepted_tokens

    def generated_tokens(self, task: Task) -> List[int]:
        """Committed generated token ids so far, the first (from prefill)
        included."""
        self._commit_pending()
        return list(self._gen.get(task.task_id, []))

    @property
    def drafted_tokens(self) -> int:
        self._commit_pending()
        return self.draft.drafted_tokens if self.draft is not None else 0

    @property
    def suspend_count(self) -> int:
        return self.arena.swap_outs

    @property
    def resume_count(self) -> int:
        return self.arena.swap_ins

    @property
    def swapped_bytes(self) -> float:
        return float(self.arena.bytes_out + self.arena.bytes_in)

    def _effective_prompt(self, task: Task) -> int:
        return min(task.prompt_len, self.max_seq // 2)

    def _task_tokens(self, task: Task) -> np.ndarray:
        """Memoised per-task prompt tokens (``cached_prompt_tokens`` sits on
        the scheduler's pruning path); purged on release."""
        toks = self._toks_memo.get(task.task_id)
        if toks is None:
            toks = _prompt_tokens(self.seed, task, self.cfg.vocab_size,
                                  self._effective_prompt(task))
            self._toks_memo[task.task_id] = toks
        return toks

    def _committed_tokens(self, task: Task) -> np.ndarray:
        """Token ids at the committed cached positions 0..pool.length-1:
        the effective prompt, then generated tokens. The last committed
        token (``last_tok``, K/V not yet written) is not included: it is
        the first token the next decode or verify window feeds."""
        tid = task.task_id
        L = self.pool.length(tid)
        prompt = self._task_tokens(task)[0]
        if L <= prompt.shape[0]:
            return prompt[:L]
        gen = self._gen.get(tid, [])
        return np.concatenate(
            [prompt, np.asarray(gen, dtype=prompt.dtype)])[:L]

    def _table_np(self, ids: Sequence[int], b: int) -> np.ndarray:
        """Page tables of ``ids`` padded to b rows and max_pages_per_seq
        columns with -1."""
        pt = np.full((b, self.max_pages_per_seq), -1, np.int32)
        for r, i in enumerate(ids):
            row = self.pool.page_table(i)
            pt[r, : len(row)] = row
        return pt

    def _arenas(self) -> List[torch.Tensor]:
        return list(self.pages.values())

    def _step(self, key, spec, fn):
        """The staged step ``key`` (``StepGraphs.step``); under a mesh its
        function runs with the model's collectives installed."""
        if self.mesh is not None:
            inner = fn
            cut = S.cut_leaves(self.cfg, self.mesh.shape["model"])

            def fn(x):
                with activation_partitioning(self.mesh, cut):
                    return inner(x)
        return self.graphs.step(key, spec, fn, self._arenas)

    # -- tensor parallelism (DESIGN.md §9) --
    def _agree(self, ms: float) -> float:
        """An op's ms as the loop books it: under a mesh the slowest
        rank's, so every rank's loop keeps one clock."""
        return ms if self.mesh is None else self.mesh.agree(ms)

    def _guard(self, kind: str, ids: Sequence[int],
               host: Optional[Dict[str, np.ndarray]] = None, *extra) -> None:
        """Under a mesh: raise unless every rank gives this op the same
        host inputs (kind, task ids, the step's arrays: page table,
        lengths, token ids, ...), and chain their digest into
        ``digest``."""
        if self.mesh is None:
            return
        arrays = [x for k in sorted(host or {})
                  for x in (k, np.asarray(host[k]))]
        d = digest(self.digest, kind, [int(i) for i in ids], *arrays, *extra)
        self.mesh.check_same(d, f"{kind} of tasks {list(ids)}")
        self.digest = d

    def _decode_step(self, b: int):
        """The decode step of batch bucket b (JAX's ``_build_steps``):
        inputs page table, lengths, tokens, active and, for SSM/hybrid
        archs, state slots; pad rows are inactive and untabled, slot -1.
        Returns (logits [b,V], argmax [b] int32)."""
        maxp, cfg, params = self.max_pages_per_seq, self.cfg, self.params
        spec = {"page_table": ((b, maxp), torch.int32, -1),
                "lengths": ((b,), torch.int32, 0),
                "tokens": ((b,), torch.int32, 0),
                "active": ((b,), torch.bool, False)}
        if self.states is not None:
            spec["state_slots"] = ((b,), torch.int32, -1)

        def fn(x):
            kw = ({"state_slots": x["state_slots"]} if "state_slots" in x
                  else {})
            logits, _ = M.decode_step_paged(
                cfg, params, self.pages, x["page_table"], x["lengths"],
                x["tokens"], x["active"], **kw)
            return with_argmax(logits)

        return self._step(("decode", b), spec, fn)

    def _verify_step(self, b: int, K: int):
        """The verify step of batch bucket b and depth bucket K (JAX's
        ``_build_verify_steps``): inputs page table, lengths and tokens
        [b, K+1]; pad rows untabled. Returns (logits [b,K+1,V], argmax
        [b,K+1] int32)."""
        maxp, cfg, params = self.max_pages_per_seq, self.cfg, self.params
        spec = {"page_table": ((b, maxp), torch.int32, -1),
                "lengths": ((b,), torch.int32, 0),
                "tokens": ((b, K + 1), torch.int32, 0)}

        def fn(x):
            logits, _ = M.verify_step_paged(cfg, params, self.pages,
                                            x["page_table"], x["lengths"],
                                            x["tokens"])
            return with_argmax(logits)

        return self._step(("verify", b, K), spec, fn)

    def _chunk_step(self, c: int):
        """The chunk step of c tokens on one row (JAX's
        ``_build_chunk_steps`` and ``_suffix_step``): inputs page table
        [1, maxp], length [1] and tokens [1, c]; the pad row is untabled
        and writes only the spare page. Returns (logits [1,V], argmax [1]
        int32)."""
        maxp, cfg, params = self.max_pages_per_seq, self.cfg, self.params
        spec = {"page_table": ((1, maxp), torch.int32, -1),
                "lengths": ((1,), torch.int32, 0),
                "tokens": ((1, c), torch.int32, 0)}

        def fn(x):
            logits, _ = M.prefill_chunk_paged(cfg, params, self.pages,
                                              x["page_table"], x["lengths"],
                                              x["tokens"])
            return with_argmax(logits)

        return self._step(("chunk", c), spec, fn)

    def _prefill_step(self, L: int):
        """The whole-prompt step of length L (JAX's ``_prefill_jit[(L,)]``):
        model.prefill, then the prompt's K/V spliced into its
        ceil(L / page_size) pages and, for SSM/hybrid archs, its final
        recurrent state into its state slot, all inside the step, so only
        the logits and their argmax outlive it. Inputs tokens [1, L],
        page_ids [ceil(L / page_size)] (attention archs) and state_slot
        [1] (SSM archs); the pads are the spare page and slot. Returns
        (logits [1,V], argmax [1] int32)."""
        cfg, params, psz = self.cfg, self.params, self.page_size
        n = -(-L // psz)
        spec = {"tokens": ((1, L), torch.int32, 0)}
        if cfg.has_attention:
            spec["page_ids"] = ((n,), torch.int64, M.spare_page(self.pages))
        if self.states is not None:
            spec["state_slot"] = ((1,), torch.int64,
                                  M.spare_slot(self.pages))

        def fn(x):
            last, cache1 = M.prefill(cfg, params, x["tokens"],
                                     buf_len=n * psz, kv_slab=True)
            if cfg.has_attention:
                # [L,1,Hkv,n*psz,hd] -> the pages' [L,n,Hkv,psz,hd]
                for name, key in (("k_pages", "k"), ("v_pages", "v")):
                    src = cache1[key][:, 0]
                    self.pages[name][:, x["page_ids"]] = src.reshape(
                        src.shape[0], src.shape[1], n, psz, -1).transpose(1, 2)
            if self.states is not None:
                # the whole per-task state is one fixed-size "page"
                for name, key in (("ssm_state", "ssm"),
                                  ("conv_state", "conv")):
                    self.pages[name][:, x["state_slot"]] = cache1[key].to(
                        self.pages[name].dtype)
            return with_argmax(last)

        return self._step(("prefill", L), spec, fn)

    def _set_first_token(self, tid: int, logits: LazyLogits,
                         tok: int) -> None:
        """Record a completed prefill's logits and first output token."""
        self._last_prefill = logits
        self._last_tok[tid] = tok
        self._gen[tid] = [tok]

    # -- prefix sharing (DESIGN.md §6) --
    def _group_tokens(self, group: int, k: int) -> np.ndarray:
        """First k tokens of a prefix group's stream (bulk rng draws are
        prefix-consistent, so the memo only ever grows)."""
        cur = self._gtoks.get(group)
        if cur is None or cur.shape[0] < k:
            grng = np.random.default_rng(
                (self.seed + 1) * 7_919 + 1_000_003 * (group + 1))
            cur = grng.integers(0, self.cfg.vocab_size, (max(k, 1),))
            self._gtoks[group] = cur
        return cur[:k]

    def _reserve(self, fn):
        """Run a pool reservation, evicting LRU prefix-cache pages until it
        fits before giving up: cached-but-idle prefix K/V is reclaimable
        headroom. OutOfPages still propagates when live sequences fill the
        pool."""
        while True:
            try:
                return fn()
            except OutOfPages:
                cache = self.prefix_cache
                if cache is None:
                    raise
                # escalate the eviction batch (1, 2, 4, ...): owner-shared
                # leaves free nothing, so fixed-size nibbles could rescan
                # the trie once per indexed node before finding a free page
                before = self.pool.free_pages
                batch = 1
                while (cache.pages_indexed > 0
                       and self.pool.free_pages == before):
                    if cache.evict(batch) == 0:
                        break
                    batch *= 2
                if self.pool.free_pages == before:
                    raise

    def _ensure_range_writable(self, tid: int, start: int, end: int) -> None:
        """Copy-on-write defence: every page receiving tokens [start, end)
        must be private to ``tid``. With page-aligned prefix matching a
        shared page is an immutable full block, so this fires only on
        boundary cases; pool.fork copies the bookkeeping and the device
        page is copied here, in place."""
        if end <= start:
            return
        psz = self.page_size
        for idx in range(start // psz, (end - 1) // psz + 1):
            forked = self._reserve(lambda i=idx: self.pool.fork(tid, i))
            if forked is not None:
                old, new = forked
                for name in ("k_pages", "v_pages"):
                    self.pages[name][:, new] = self.pages[name][:, old]

    def _acquire_prefix(self, task: Task, toks_np: np.ndarray) -> int:
        """Register this task over the cached page-aligned prefix of its
        prompt (pool.share, no copy), capped at L-1 tokens so at least one
        suffix token is computed: its logits give the first output token.
        Returns the tokens skipped (0 on a miss or without the cache)."""
        if self.prefix_cache is None:
            return 0
        hit, _ = self.prefix_cache.acquire(task.task_id, toks_np[0],
                                           max_tokens=toks_np.shape[1] - 1)
        return hit

    def _insert_prefix(self, task: Task, toks_np: np.ndarray,
                       upto: Optional[int] = None) -> None:
        """Index the full-page prefix of a (possibly partial) prefill so
        later tasks with the same opening tokens share its pages. Chunked
        prefill inserts after every piece: full pages of a prompt still
        being prefilled are already immutable."""
        if self.prefix_cache is None:
            return
        n = toks_np.shape[1] if upto is None else min(upto, toks_np.shape[1])
        n_full = n // self.page_size
        if n_full:
            self.prefix_cache.insert(
                toks_np[0, : n_full * self.page_size],
                self.pool.page_table(task.task_id)[:n_full])

    def cached_prompt_tokens(self, task: Task) -> int:
        """Prompt tokens already resident for this task: its own prefill
        progress, or the radix cache's matched prefix. The scheduler takes
        it as TTFT credit."""
        L = self._effective_prompt(task)
        if self.pool.holds(task.task_id):
            return min(self.pool.length(task.task_id), L)
        if self.prefix_cache is None:
            return 0
        matched, _ = self.prefix_cache.match(self._task_tokens(task)[0],
                                             touch=False)
        cap = ((L - 1) // self.page_size) * self.page_size
        return min(matched, max(cap, 0))

    def page_budget(self) -> PageBudget:
        """Admission-side view of the pool for SliceScheduler: peak pages per
        task (capped prompt + full output) against the pool, counting pages
        held by running tasks; seq_cap/max_tasks mirror the engine's hard
        limits. With the prefix cache, admission sees the live free count
        plus reclaimable cached pages and counts each shared prompt prefix
        once (DESIGN.md §6)."""
        free_pages_now = None
        prefix_pages = None
        if self.prefix_cache is not None:
            cache, psz = self.prefix_cache, self.page_size

            def free_pages_now():
                return self.pool.free_pages + cache.reclaimable_pages()

            def prefix_pages(t):
                if getattr(t, "prefix_group", None) is None:
                    return None, 0
                L = self._effective_prompt(t)
                k = min(t.prefix_len or 0, max(L - 1, 0))
                kp = k // psz
                if self.prefill_chunk_size is not None and kp:
                    # chunked prefills interleave: discount only the pages
                    # resident right now (per-piece insertion lets
                    # admission catch up at the next reschedule)
                    matched, _ = cache.match(self._group_tokens(
                        t.prefix_group, kp * psz), touch=False)
                    kp = min(kp, matched // psz)
                return ("prefix", t.prefix_group), kp
        kw = dict(
            total_pages=self.n_pages, page_size=self.page_size,
            prompt_cap=self.max_seq // 2, seq_cap=self.max_seq,
            max_tasks=self.max_batch,
            held_pages=lambda t: self.pool.resident_page_count(t.task_id),
            free_pages_now=free_pages_now, prefix_pages=prefix_pages)
        if self.states is None:
            return PageBudget(**kw)
        # SSM/hybrid archs: admission also reserves one constant-size
        # recurrent-state slot per task, under the same headroom arithmetic
        # as pages (DESIGN.md §12)
        return StateBudget(
            total_states=self.n_state_slots,
            state_bytes=self.store.state_bytes,
            page_bytes=self.store.page_bytes,
            held_states=lambda t: self.states.resident_slot_count(t.task_id),
            **kw)

    def trace_gauges(self) -> Dict[str, int]:
        """Pool (and state-slot) occupancy for a trace's metrics
        snapshots."""
        g = {"pages_in_use": self.pool.used_pages,
             "pages_total": self.n_pages}
        if self.states is not None:
            g["states_in_use"] = self.states.used_slots
            g["states_total"] = self.n_state_slots
        return g

    # -- async pipelining (DESIGN.md §10) --
    def _async_on(self) -> bool:
        return self.async_dispatch and self._sync_depth == 0

    @contextlib.contextmanager
    def _sync_mode(self):
        """Synchronous semantics for a block: latency probes must time
        whole steps, not their dispatch."""
        self._commit_pending()
        self._sync_depth += 1
        try:
            yield
        finally:
            self._sync_depth -= 1

    def _commit_pending(self) -> None:
        if len(self._queue):
            self._queue.commit_all()

    def _push(self, step: PendingStep) -> float:
        """Enqueue a dispatched step; returns the ms the push spent
        committing older steps (a stall). The queue books that time as
        wait, so the dispatch clock subtracts it. When a stall's commit
        raises, the step being pushed is the newest uncommitted one: it
        is rolled back first (``_rollback_step``), then the queue's."""
        w0 = self.gap_stats.wait_ms
        self._pushing = step
        try:
            self._queue.push(step)
        except BaseException:
            self._undo_pushing()
            raise
        finally:
            self._pushing = None
        return self.gap_stats.wait_ms - w0

    def _undo_pushing(self) -> None:
        if self._pushing is not None:
            step, self._pushing = self._pushing, None
            self._undo_step(step)

    def drain(self) -> None:
        """Commit every in-flight step and wait out the host transfers:
        the end-of-run barrier of the serving loop."""
        self._commit_pending()
        self.ledger.wait()
        for tid in list(self._landing):
            self._landed(tid)

    def _clock(self, async_on: bool, t_disp: float) -> float:
        """Start of an op's clock: its dispatch start under async
        dispatch, else now, once the device has finished earlier work."""
        if async_on:
            return t_disp
        _sync(self.device)
        return time.perf_counter()

    def _finish(self, step: PendingStep, t0: float, async_on: bool) -> float:
        """End of an op that dispatched a step: under async dispatch push
        it and book the dispatch time; else commit it now (the commit
        waits on the step) and book the whole time as wait."""
        if async_on:
            waited = self._push(step)
            ms = self._agree(max(0.0, (time.perf_counter() - t0) * 1000.0
                                 - waited))
            self.gap_stats.dispatch_ms += ms
            return ms
        self._commit_step(step)
        ms = self._agree((time.perf_counter() - t0) * 1000.0)
        self.gap_stats.wait_ms += ms
        self.gap_stats.cycles += 1
        return ms

    def _book(self, t0: float, async_on: bool) -> float:
        """End of an op with nothing to commit (a prompt's non-final
        chunks, a swap): synchronously after the device finishes."""
        if not async_on:
            _sync(self.device)
        ms = self._agree((time.perf_counter() - t0) * 1000.0)
        if async_on:
            self.gap_stats.dispatch_ms += ms
        else:
            self.gap_stats.wait_ms += ms
        return ms

    def _commit_step(self, step: PendingStep) -> None:
        """Observe one dispatched step (waiting on its argmax copy only)
        and apply its host-side updates. Runs in dispatch order."""
        p = step.payload
        if step.kind == "prefill":
            tid = p["tid"]
            self._set_first_token(tid, p["logits"], int(p["snap"].read()[0]))
            self._pop_tok_dev(tid, p["tok_dev"].get(tid))
        elif step.kind == "decode":
            ids = step.task_ids
            toks = p["snap"].read()[: len(ids)]
            self._last_logits = p["logits"]
            for i, tok in zip(ids, toks):
                self._last_tok[i] = int(tok)
                self._pop_tok_dev(i, p["tok_dev"].get(i))
                # setdefault: latency-model probes decode without a prefill
                self._gen.setdefault(i, []).append(int(tok))
            self._last_commits = [1] * len(ids)
        else:                                    # verify
            target = p["snap"].read()[: len(step.task_ids)]
            self.last_verify = (target.shape[1], p["lengths"],
                                (time.perf_counter() - p["t0"]) * 1000.0)
            accepted = self._apply_verify(p["tasks"], p["lengths"],
                                          p["capped"], p["drafts"], target)
            p["logits"].pick = accepted
            self._last_logits = p["logits"]
            self._verify_queued = False

    def _pop_tok_dev(self, tid: int, entry) -> None:
        """Drop the chain link a step registered, unless a later step has
        replaced it."""
        if entry is not None and self._tok_dev.get(tid) is entry:
            del self._tok_dev[tid]

    def _rollback_step(self, step: PendingStep) -> None:
        """The queue's rollback, called newest first for every queued step
        behind a commit that raised."""
        self._undo_pushing()
        self._undo_step(step)

    def _undo_step(self, step: PendingStep) -> None:
        """Undo an uncommitted step's reservations: a prefill that took the
        task's pages and state slot gives them back, a chunked prefill's
        last call is cut back to where it started, a decode or verify
        step's pages are cut back to the lengths before it. What the
        device computed is dropped with the step."""
        p = step.payload
        if step.kind == "prefill":
            tid = p["tid"]
            if p.get("fresh"):
                if self.pool.holds(tid):
                    self.pool.free(tid)
                if self.states is not None:
                    self.states.free(tid)
                self._chunk_progress.pop(tid, None)
            elif "pre_len" in p and self.pool.holds(tid):
                self.pool.truncate(tid, p["pre_len"])
                self._chunk_progress[tid] = p["pre_progress"]
            self._pop_tok_dev(tid, p["tok_dev"].get(tid))
            return
        for i, ln in p["pre_lengths"].items():
            if self.pool.holds(i):
                self.pool.truncate(i, ln)
            self._pop_tok_dev(i, p["tok_dev"].get(i))
            if step.kind == "verify" and self.draft is not None:
                self.draft.drop(i)
        if step.kind == "verify":
            self._verify_queued = False

    def _chain_tokens(self, ids: Sequence[int], b: int):
        """A decode step's token input: the host array (committed tokens,
        0 in chained rows and pad rows) and, for the rows whose last token
        an uncommitted step computed, that step's argmax rows on the
        device, grouped by step (``Step.stage``'s ``dev``). Rows 0..n-1
        chained from rows 0..n-1 of one step are one slice copy."""
        tk = np.zeros((b,), np.int32)
        groups: Dict[int, Tuple[Snapshot, List[int], List[int]]] = {}
        for r, i in enumerate(ids):
            link = self._tok_dev.get(i)
            if link is None:
                tk[r] = self._last_tok[i]
            else:
                snap, row = link
                g = groups.setdefault(id(snap), (snap, [], []))
                g[1].append(r)
                g[2].append(row)
        if not groups:
            return tk, None
        return tk, {"tokens": [(snap.dev.reshape(-1), np.asarray(d),
                                np.asarray(s))
                               for snap, d, s in groups.values()]}

    def _upload(self, a, dtype=torch.long) -> torch.Tensor:
        """A small host array on the device without a host wait: through
        pinned memory and a non-blocking copy on the card (a pageable copy
        would synchronise the stream)."""
        t = torch.as_tensor(np.asarray(a)).to(dtype)
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _h2d(self, t: torch.Tensor) -> torch.Tensor:
        if self.device.type != "cuda":
            return t
        if not t.is_pinned():
            t = t.pin_memory()
        return t.to(self.device, non_blocking=True)

    # -- ops --
    def prefill(self, task: Task) -> float:
        tid = task.task_id
        L = self._effective_prompt(task)
        if self.pool.holds(tid):
            raise RuntimeError(f"task {tid} already prefilled")
        toks_np = self._task_tokens(task)
        hit = self._acquire_prefix(task, toks_np)     # pool.share on a hit
        if hit > 0:
            try:
                ms = self._prefill_suffix(task, toks_np, hit, L)
            except OutOfPages:
                # undo the share: OutOfPages leaves the task unprefilled
                self.pool.free(tid)
                raise
            self._insert_prefix(task, toks_np)
            return ms
        async_on = self._async_on()
        # made (on the card: captured) before the clock starts and before
        # the pages are taken, so a refused capture leaves the pool as it was
        step = self._prefill_step(L)
        t_disp = time.perf_counter()
        phys = self._reserve(lambda: self.pool.alloc(tid, L))
        slot = -1
        if self.states is not None:
            try:
                slot = self.states.alloc(tid)
            except OutOfStates:
                # OutOfStates leaves the store unchanged; undo the page
                # reservation so the deferred task re-enters prefill cleanly
                self.pool.free(tid)
                raise
        host = {"tokens": toks_np}
        if self.cfg.has_attention:
            host["page_ids"] = np.asarray(phys)
        if self.states is not None:
            host["state_slot"] = np.asarray([slot])
        self._guard("prefill", [tid], host)
        # the splice into the pages and state slot is inside the step and
        # its clock (the JAX engine splices after its clock)
        t0 = self._clock(async_on, t_disp)
        logits, argmax = step.run(host)
        ms = self._finish(self._prefill_pending(tid, logits, argmax,
                                                fresh=True), t0, async_on)
        self._insert_prefix(task, toks_np)
        return ms

    def _prefill_pending(self, tid: int, logits: torch.Tensor,
                         argmax: torch.Tensor, **undo) -> PendingStep:
        """The pending step of a prefill's last piece: its argmax
        snapshot, which the task's first decode chains from, and its
        logits."""
        snap = self.graphs.snapshot(argmax)
        link = self._tok_dev[tid] = (snap, 0)
        return PendingStep("prefill", [tid], {
            "tid": tid, "logits": LazyLogits(logits), "snap": snap,
            "tok_dev": {tid: link}, **undo})

    def _prefill_suffix(self, task: Task, toks_np: np.ndarray, start: int,
                        L: int) -> float:
        """Cache-hit prefill: only the uncached suffix runs, its queries
        attending over the shared prefix pages, in power-of-two
        prefill_chunk_paged pieces, largest first."""
        tid = task.task_id
        async_on = self._async_on()
        pieces = pow2_pieces(L - start)
        steps = [self._chunk_step(c) for c in pieces]  # before the clock
        t_disp = time.perf_counter()
        self._reserve(lambda: self.pool.extend(tid, L))
        self._ensure_range_writable(tid, start, L)
        pt = self._table_np([tid], 1)
        self._guard("suffix", [tid], {"page_table": pt,
                                      "tokens": toks_np[:, start:L]}, start)
        t0 = self._clock(async_on, t_disp)
        done = start
        for c, step in zip(pieces, steps):
            logits, argmax = step.run({"page_table": pt,
                                       "lengths": np.asarray([done]),
                                       "tokens": toks_np[:, done:done + c]})
            done += c
        return self._finish(self._prefill_pending(tid, logits, argmax,
                                                  fresh=True), t0, async_on)

    def prompt_progress(self, task: Task) -> int:
        """Prompt tokens cached so far by chunked prefill, prefix-cache
        credit included."""
        return self._chunk_progress.get(task.task_id, 0)

    def prefill_chunk(self, task: Task, n_tokens: int) -> Tuple[float, bool]:
        """Run the next ``n_tokens`` of the task's prompt, piece by piece
        (``_chunk_pieces``), starting at the first uncached chunk when the
        prefix cache holds the opening pages. Each piece's pages are
        allocated just before it runs and progress advances per piece, so
        an OutOfPages from the pool propagates with pool and progress
        consistent and the task resumes from its cached tokens."""
        if self.prefill_chunk_size is None:
            raise RuntimeError("executor built without prefill_chunk_size")
        tid = task.task_id
        L = self._effective_prompt(task)
        done = self._chunk_progress.get(tid, 0)
        if done >= L or (done == 0 and self.pool.holds(tid)):
            raise RuntimeError(f"task {tid} already prefilled")
        async_on = self._async_on()
        toks_full = self._task_tokens(task)
        if done == 0:
            done = self._acquire_prefix(task, toks_full)
            if done:
                self._chunk_progress[tid] = done
        fresh = not self.pool.holds(tid)
        undo = {"fresh": fresh, "pre_len": 0 if fresh else
                self.pool.length(tid), "pre_progress": done}
        pieces = _chunk_pieces(min(n_tokens, L - done),
                               self.prefill_chunk_size)
        steps = [self._chunk_step(c) for c in pieces]  # before the clock
        t0 = self._clock(async_on, time.perf_counter())
        for c, step in zip(pieces, steps):
            if self.pool.holds(tid):
                self._reserve(lambda e=done + c: self.pool.extend(tid, e))
            else:
                self._reserve(lambda e=c: self.pool.alloc(tid, e))
            self._ensure_range_writable(tid, done, done + c)
            host = {"page_table": self._table_np([tid], 1),
                    "lengths": np.asarray([done]),
                    "tokens": toks_full[:, done:done + c]}
            self._guard("chunk", [tid], host)
            logits, argmax = step.run(host)
            done += c
            self._chunk_progress[tid] = done
            self._insert_prefix(task, toks_full, upto=done)
        if done < L:
            return self._book(t0, async_on), False
        return self._finish(self._prefill_pending(tid, logits, argmax,
                                                  **undo), t0, async_on), True

    def decode(self, tasks: Sequence[Task],
               depths: Optional[Sequence[int]] = None) -> float:
        if len(tasks) > self.max_batch:
            raise RuntimeError(f"decode batch {len(tasks)} > max_batch "
                               f"{self.max_batch}")
        if depths is not None and any(depths):
            if self.draft is None:
                raise RuntimeError("executor built without spec_decode=True")
            return self._decode_spec(tasks, [int(d) for d in depths])
        ids = [t.task_id for t in tasks]
        if self._verify_queued:
            # a verify step's acceptance sets the lengths and last tokens
            self._commit_pending()
        async_on = self._async_on()
        b = next(x for x in _pow2_buckets(self.max_batch) if x >= len(tasks))
        step = self._decode_step(b)                     # before the clock
        t_disp = time.perf_counter()
        lengths = [self.pool.length(i) for i in ids]
        for i, ln in zip(ids, lengths):
            if ln + 1 > self.max_seq:
                raise RuntimeError(f"task {i} exceeds max_seq {self.max_seq}")
            self._reserve(lambda i=i, ln=ln: self.pool.extend(i, ln + 1))
            self._ensure_range_writable(i, ln, ln + 1)
        ln = np.zeros((b,), np.int32)
        ln[: len(ids)] = lengths
        av = np.zeros((b,), bool)
        av[: len(ids)] = True
        tk, dev = self._chain_tokens(ids, b)
        host = {"page_table": self._table_np(ids, b), "lengths": ln,
                "tokens": tk, "active": av}
        if self.states is not None:
            # per-row recurrent-state slots; pad rows carry -1 and write
            # only the spare slot
            sl = np.full((b,), -1, np.int32)
            sl[: len(ids)] = [self.states.slot_of(i) for i in ids]
            host["state_slots"] = sl
        self._guard("decode", ids, host)
        t0 = self._clock(async_on, t_disp)
        logits, argmax = step.run(host, dev)
        snap = self.graphs.snapshot(argmax)
        links = {}
        for r, i in enumerate(ids):
            links[i] = self._tok_dev[i] = (snap, r)
        return self._finish(PendingStep("decode", ids, {
            "logits": LazyLogits(logits[: len(ids)]), "snap": snap,
            "tok_dev": links, "pre_lengths": dict(zip(ids, lengths))}),
            t0, async_on)

    # -- speculative decoding (DESIGN.md §8) --
    def _decode_spec(self, tasks: Sequence[Task], depths: List[int]) -> float:
        """Draft-verify iteration: per-task windows drafted by the draft
        model, verified in ONE bucketed ``verify_step_paged`` call, the
        accepted prefix committed and rejected-draft pages rolled back.
        The engine clock spans drafting, verify and acceptance; every
        (batch, depth) bucket's verify step is made before the first
        iteration's clock starts, as JAX compiles them up front. Drafting
        replays committed history, so the iteration first commits what is
        pending (a pipeline barrier); under async dispatch its verify step
        is then pushed like a decode and accepted at its commit."""
        self._commit_pending()
        async_on = self._async_on()
        ids = [t.task_id for t in tasks]
        lengths = [self.pool.length(i) for i in ids]
        for b in _pow2_buckets(self.max_batch):
            for K in _pow2_buckets(self.spec_depth):
                self._verify_step(b, K)
        self.draft.make_steps()
        t0 = self._clock(async_on, time.perf_counter())
        # clamp each row's depth to the sequence cap, its remaining output
        # (a window past the last needed token is wasted) and the buckets
        capped = []
        for t, ln, d in zip(tasks, lengths, depths):
            if ln + 1 > self.max_seq:
                raise RuntimeError(f"task {t.task_id} exceeds max_seq "
                                   f"{self.max_seq}")
            capped.append(max(0, min(d, self.spec_depth,
                                     self.max_seq - ln - 1,
                                     t.output_len - t.tokens_done - 1)))
        drafts: List[List[int]] = [[] for _ in tasks]
        d_items, d_depths, d_rows = [], [], []
        for r, (t, d) in enumerate(zip(tasks, capped)):
            if d > 0:
                d_items.append((t.task_id, self._committed_tokens(t),
                                self._last_tok[t.task_id]))
                d_depths.append(d)
                d_rows.append(r)
        if d_items:
            for r, dr in zip(d_rows, self.draft.propose(d_items, d_depths)):
                drafts[r] = dr
        # reserve each window's pages, falling back to depth 0 under
        # pressure (plain decode must stay possible), then copy-on-write
        for r, (i, ln) in enumerate(zip(ids, lengths)):
            try:
                self._reserve(
                    lambda i=i, e=ln + 1 + capped[r]: self.pool.extend(i, e))
            except OutOfPages:
                if capped[r] == 0:
                    raise
                capped[r] = 0
                drafts[r] = []
                self._reserve(lambda i=i, e=ln + 1: self.pool.extend(i, e))
            self._ensure_range_writable(i, ln, ln + 1 + capped[r])
        b = depth_bucket(len(tasks), self.max_batch)
        K = depth_bucket(max(max(capped), 1), self.spec_depth)
        ln_arr = np.zeros((b,), np.int32)
        ln_arr[: len(ids)] = lengths
        toks = np.zeros((b, K + 1), np.int32)
        for r, i in enumerate(ids):
            toks[r, 0] = self._last_tok[i]
            toks[r, 1: 1 + len(drafts[r])] = drafts[r]
        step = self._verify_step(b, K)
        host = {"page_table": self._table_np(ids, b), "lengths": ln_arr,
                "tokens": toks}
        self._guard("verify", ids, host)
        if not async_on:
            _sync(self.device)
        t_verify = time.perf_counter()
        logits, argmax = step.run(host)
        self._verify_queued = True     # at most one: the barrier above
        return self._finish(PendingStep("verify", ids, {
            "logits": LazyLogits(logits[: len(ids)]),
            "snap": self.graphs.snapshot(argmax), "tasks": list(tasks),
            "lengths": lengths, "capped": capped, "drafts": drafts,
            "tok_dev": {}, "pre_lengths": dict(zip(ids, lengths)),
            "t0": t_verify}), t0, async_on)

    def _apply_verify(self, tasks, lengths, capped, drafts,
                      target: np.ndarray) -> List[int]:
        """Host side of a verify window: greedy acceptance against the
        target's argmax ``target`` [rows, K+1], page rollback,
        committed-history updates. Returns each row's accepted drafts."""
        commits: List[int] = []
        accepted: List[int] = []
        for r, (t, ln) in enumerate(zip(tasks, lengths)):
            i = t.task_id
            d = capped[r]
            target_ids = target[r, : d + 1]
            n_acc = greedy_accept(drafts[r][:d], target_ids)
            bonus = int(target_ids[n_acc])
            new_len = ln + n_acc + 1
            if new_len < ln + d + 1:     # roll back rejected-draft pages
                self.pool.truncate(i, new_len)
            self._last_tok[i] = bonus
            self._gen[i].extend(drafts[r][:n_acc] + [bonus])
            self.draft.note_commit(i, new_len)
            self._accepted_tokens += n_acc
            commits.append(n_acc + 1)
            accepted.append(n_acc)
        self.spec_steps += 1
        self._last_commits = commits
        return accepted

    # -- host-offload KV swap (DESIGN.md §7) --
    def _restore_pages(self, positions, entries) -> None:
        """Write host page blobs back into freshly allocated device pages.
        positions: [(logical_idx, phys)] from pool.swap_in; entries: the
        arena's [(logical_idx, {"k","v"})], both ascending by logical."""
        if not positions:
            return
        assert [li for li, _ in positions] == [li for li, _ in entries], (
            positions, [li for li, _ in entries])
        idx = self._upload([p for _, p in positions])
        for name, key in (("k_pages", "k"), ("v_pages", "v")):
            host = torch.stack([blob[key] for _, blob in entries], dim=1)
            self.pages[name][:, idx] = self._h2d(host)

    def _snapshot_swapped(self, tid: int, released):
        """Device copies of what a suspension releases, taken on the
        compute stream right after the release, so no later step can
        have reused a page or slot first: {"k","v"} [L, n, ...] of the
        released pages, {"ssm","conv"} of the state slot."""
        snaps: Dict[str, torch.Tensor] = {}
        if released:
            idx = self._upload([p for _, p in released])
            snaps["k"] = self.pages["k_pages"][:, idx]
            snaps["v"] = self.pages["v_pages"][:, idx]
        if (self.states is not None and self.states.holds(tid)
                and not self.states.is_swapped(tid)):
            slot = self.states.slot_of(tid)
            snaps["ssm"] = self.pages["ssm_state"][:, slot].clone()
            snaps["conv"] = self.pages["conv_state"][:, slot].clone()
            self.states.swap_out(tid)
        return snaps

    def _copy_out(self, snaps: Dict[str, torch.Tensor]):
        """Host tensors for the snapshots and the event after their copy:
        on the card pinned buffers, filled by non-blocking copies on the
        side stream once the compute stream has taken the snapshots; on
        the CPU the snapshots themselves (no event)."""
        if self.device.type != "cuda":
            return dict(snaps), None
        hosts = {k: torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                 for k, v in snaps.items()}
        if self._swap_stream is None:
            self._swap_stream = torch.cuda.Stream(self.device)
        taken = torch.cuda.Event()
        taken.record()
        with torch.cuda.stream(self._swap_stream):
            self._swap_stream.wait_event(taken)
            for k, v in snaps.items():
                hosts[k].copy_(v, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self._swap_stream)
        return hosts, done

    def suspend(self, task: Task) -> float:
        """Swap the task's private pages, and for SSM/hybrid archs its
        recurrent state, to the host arena: snapshot their device
        contents on the compute stream, release them to the pool's free
        list and the state store, and copy the snapshot to host memory on
        a side stream; shared prefix pages stay resident. The state swaps
        as ONE blob {"ssm","conv"} at logical index -1, below every page
        index, as in the JAX engine. Steps in flight are committed first
        (the swapped contents hold every committed token). A synchronous
        engine waits for the copy; an async one returns and a worker
        retires the copy in the ledger. On HostArenaFull the swap is
        rolled back (the snapshot written into re-allocated pages and
        slot) and the error propagates with the task still resident."""
        tid = task.task_id
        self._commit_pending()
        async_on = self._async_on()
        t0 = self._clock(async_on, time.perf_counter())
        released = self.pool.swap_out(tid)
        self._guard("suspend", [tid], None, released)
        snaps = self._snapshot_swapped(tid, released)
        hosts, done = self._copy_out(snaps) if snaps else ({}, None)
        entries = [(li, {"k": hosts["k"][:, n], "v": hosts["v"][:, n]})
                   for n, (li, _) in enumerate(released)]
        stashed = entries
        if "ssm" in hosts:
            stashed = [(-1, {"ssm": hosts["ssm"], "conv": hosts["conv"]})
                       ] + entries
        try:
            self.arena.put(tid, stashed)
        except HostArenaFull:
            # the released pages and slot are still free (nothing allocated
            # since), so swap_in cannot fail here
            if "ssm" in snaps:
                slot = self.states.swap_in(tid)
                self.pages["ssm_state"][:, slot] = snaps["ssm"]
                self.pages["conv_state"][:, slot] = snaps["conv"]
            back = self.pool.swap_in(tid)
            if back:
                idx = self._upload([p for _, p in back])
                self.pages["k_pages"][:, idx] = snaps["k"]
                self.pages["v_pages"][:, idx] = snaps["v"]
            raise
        if self.draft is not None:
            # the draft state is dropped: the committed history survives in
            # _gen, and the first propose after resume re-prefills it
            self.draft.drop(tid)
        if async_on and stashed:
            handle = self.ledger.begin(tid, [p for _, p in released])
            if self._swap_worker is None:
                self._swap_worker = ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix="kv-swap")
            self._landing.setdefault(tid, []).append(self._swap_worker.submit(
                self._land, handle, done, snaps))
        elif done is not None:
            wait_event(done, self.graphs, "commit_waits")
        return self._book(t0, async_on)

    def _land(self, handle: int, done, snaps) -> None:
        """The worker's half of an async suspension: wait for the copy to
        host, then retire it in the ledger. ``snaps`` keeps the device
        snapshot alive until the copy has read it."""
        t0 = time.perf_counter()
        try:
            if done is not None:
                done.synchronize()
        finally:
            self.gap_stats.add_swap_overlap(
                (time.perf_counter() - t0) * 1000.0)
            self.ledger.complete(handle)

    def _landed(self, tid: int) -> None:
        """Wait for the task's transfers and raise what one raised."""
        self.ledger.wait(tid)
        for f in self._landing.pop(tid, ()):
            f.result()

    def _restore_state(self, slot: int, blob) -> None:
        """Write a host state blob {"ssm","conv"} into a state slot."""
        for name, key in (("ssm_state", "ssm"), ("conv_state", "conv")):
            self.pages[name][:, slot] = self._h2d(blob[key])

    def resume(self, task: Task) -> float:
        """Re-allocate the task's state slot (SSM/hybrid archs) and device
        pages for the swapped-out positions (evicting idle prefix-cache
        pages under pressure) and restore the host contents, once the
        task's copy to host has landed. OutOfStates or OutOfPages
        propagates with pool, store and arena unchanged: the task stays
        suspended."""
        tid = task.task_id
        self._landed(tid)
        async_on = self._async_on()
        t0 = self._clock(async_on, time.perf_counter())
        slot = -1
        if self.states is not None and self.states.is_swapped(tid):
            slot = self.states.swap_in(tid)   # OutOfStates: nothing changed
        try:
            restored = self._reserve(lambda: self.pool.swap_in(tid))
        except OutOfPages:
            if slot >= 0:
                self.states.swap_out(tid)     # give the fresh slot back
            raise
        self._guard("resume", [tid], None, restored)
        entries = self.arena.take(tid)
        state = [blob for li, blob in entries if li < 0]
        self._restore_pages(restored, [e for e in entries if e[0] >= 0])
        if state:
            self._restore_state(slot, state[0])
        return self._book(t0, async_on)

    def release(self, task: Task) -> None:
        tid = task.task_id
        # a finished task can still have steps in flight (the loop knows
        # "finished" from host-side token counts): commit through them
        while self._queue.pending_for(tid):
            self._queue.commit_oldest()
        self._landed(tid)
        self.pool.free(tid)
        if self.states is not None:
            self.states.free(tid)
        self.arena.drop(tid)
        self._chunk_progress.pop(tid, None)
        self._last_tok.pop(tid, None)
        self._tok_dev.pop(tid, None)
        self._toks_memo.pop(tid, None)
        self._gen.pop(tid, None)
        if self.draft is not None:
            self.draft.drop(tid)

    def latency_model(self) -> LatencyModel:
        """Measure l(b) on the live engine (warm) — MeasuredLatencyModel.
        The probes run synchronously (``_sync_mode``): dispatch-only
        timings would price every step near 0 ms in Eq. 7."""
        # each warm task may grow ~32 tokens across the probe decodes;
        # reserve that many pages so probing never exhausts the pool
        nmax = min(self.max_batch,
                   max(1, self.n_pages // max(1, self.pool.pages_for(32))))
        if self.states is not None:
            nmax = min(nmax, max(1, self.states.free_slots))
        probes = sorted({b for b in (1, 2, 4, 8, nmax) if b <= nmax})
        warm = [qa_task() for _ in range(nmax)]
        with self._sync_mode():
            for t in warm:
                self.pool.alloc(t.task_id, 1)
                if self.states is not None:
                    self.states.alloc(t.task_id)
                self._last_tok[t.task_id] = 0
            lat, self.probe_read = _probe_latency_curve(self, warm, probes)
            for t in warm:
                self.release(t)
        self.probe_samples = [(b, lat.decode_ms(b)) for b in probes]
        return lat
