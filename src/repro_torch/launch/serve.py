"""Serving launcher of the PyTorch port: SLICE over the paged or the slot
engine.

Serves the FULL-width config by default (``--reduced`` opts in to the
small one), on the CUDA card by default (``--device cpu`` runs the plain
kernel versions on the CPU), over the paged engine by default
(``--executor slot`` serves the slot engine, the JAX CLI's default):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch edge-6b \\
      --dtype bfloat16 --scheduler slice --rate 2 --duration 4

  # slot engine with chunked prefill (SLICE only)
  PYTHONPATH=src python -m repro_torch.launch.serve --arch edge-6b \\
      --dtype bfloat16 --executor slot --prefill-chunk 64 --slots 16

  # speculative decoding (SLICE only), the radix prefix cache and host
  # KV swap on the paged engine
  PYTHONPATH=src python -m repro_torch.launch.serve --arch edge-6b \\
      --dtype bfloat16 --spec-decode --spec-depth 4 --prefix-cache \\
      --shared-prefix-frac 0.7 --kv-swap

  # SSM, MoE and hybrid archs on the paged engine (DESIGN.md §12)
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-780m \\
      --dtype bfloat16 --max-seq 1024 --ratio 0
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch granite-moe-3b-a800m --dtype bfloat16 --max-seq 1024

  # async pipelined engine (DESIGN.md §10), traced (DESIGN.md §13): a
  # Perfetto/Chrome-trace timeline and a metrics snapshot every 16 cycles
  PYTHONPATH=src python -m repro_torch.launch.serve --arch edge-6b \\
      --dtype bfloat16 --async-pipeline --trace out.json --metrics-every 16

  # SSM and hybrid archs on the slot engine
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-780m \\
      --dtype bfloat16 --executor slot --slots 16 --max-seq 1024

  # fleet routing (DESIGN.md §11): one paged SLICE engine per arch, small
  # -> large, behind one admission layer
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --fleet smollm-360m,edge-6b --dtype bfloat16 --ratio 0.5

  # tensor-parallel paged serving (DESIGN.md §9): weights and the KV
  # arena cut over the model axis of a (data, model) mesh, one process a
  # rank; NCCL when each rank has a card of its own, else gloo (the CPU,
  # or ranks sharing one card, with eager steps)
  PYTHONPATH=src python -m repro_torch.launch.serve --arch edge-6b \\
      --dtype bfloat16 --mesh-shape 1,2
  # the same ranks under torchrun (it starts them, not the CLI)
  PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.serve \\
      --arch edge-6b --dtype bfloat16 --mesh-shape 1,2
  # an MoE arch (expert-parallel: 20 of granite's 40 experts a rank) with
  # the decode batch split over two data groups: 4 ranks
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch granite-moe-3b-a800m --dtype bfloat16 --mesh-shape 2,2

  # tiny CPU run
  PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu \\
      --duration 3 --slots 4 --max-seq 128

Prints the measured l(b) curve and a one-line SLO summary, as the JAX
launcher does (``repro.launch.serve``); with ``--fleet``, each instance's
l(b), the fleet's summary line and one line per serving instance. With
``--mesh-shape`` the first line names the mesh and its backend, rank 0
prints the summary, and a last line gives the mesh, the backend and every
rank's digest of its ops' inputs (equal when the ranks ran in lockstep);
a rank that fails fails the command.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import os
import sys
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.core.schedulers import (FastServeScheduler, OrcaScheduler,
                                         SliceScheduler)
from repro_torch.data.workload import poisson_workload
from repro_torch.kernels import ops
from repro_torch.launch.mesh import (backend_for, make_serving_mesh,
                                     rank_device, spawn_ranks)
from repro_torch.serving.executor import (Executor, PagedTorchExecutor,
                                          TorchExecutor)
from repro_torch.serving.fleet import (FleetInstance, FleetResult,
                                       FleetRouter, run_fleet_loop)
from repro_torch.serving.loop import LoopResult, run_serving_loop
from repro_torch.serving.metrics import per_tier, slo_attribution, summarize
from repro_torch.serving.spec_decode import draft_config_from_registry
from repro_torch.serving.trace import TraceRecorder

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# seconds the ranks of --mesh-shape may run before they are ended and the
# command fails (a hung collective never returns)
MESH_TIMEOUT_S = 1800.0


@dataclasses.dataclass
class ServeRun:
    executor: Executor           # PagedTorchExecutor or TorchExecutor
    lat: object                  # MeasuredLatencyModel
    probes: List[tuple]          # measured (batch, ms) samples of l(b)
    result: LoopResult
    trace: Optional[TraceRecorder] = None    # with --trace


@dataclasses.dataclass
class MeshRun:
    mesh_shape: Tuple[int, int]      # (data, model)
    backend: str                     # "nccl" or "gloo"
    ranks: List[dict]                # each rank's summary (``_serve_rank``)


@dataclasses.dataclass
class FleetRun:
    router: FleetRouter          # its instances hold the engines
    probes: Dict[str, List[tuple]]   # instance -> measured (batch, ms)
    result: FleetResult
    trace: Optional[TraceRecorder] = None    # with --trace


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="edge-6b")
    ap.add_argument("--scheduler", default="slice",
                    choices=["slice", "orca", "fastserve"])
    ap.add_argument("--executor", default="paged", choices=["slot", "paged"],
                    help="paged KV arena (default) or fixed slot array")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="chunked prefill: prompt tokens per chunk (SLICE "
                         "only)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="paged executor: radix prefix cache — tasks with a "
                         "common page-aligned prompt prefix share physical "
                         "KV pages (DESIGN.md §6)")
    ap.add_argument("--shared-prefix-frac", type=float, default=0.0,
                    help="fraction of workload tasks opening with a shared "
                         "system prompt from a per-seed prefix pool")
    ap.add_argument("--kv-swap", action="store_true",
                    help="paged executor: host-offload KV swap (DESIGN.md "
                         "§7) — SLICE suspends low-utility residents (and "
                         "FastServe its demoted queues) to host memory to "
                         "admit arrivals under page pressure")
    ap.add_argument("--swap-bw-gbps", type=float, default=8.0,
                    help="device<->host link bandwidth pricing swap "
                         "transfers in the scheduler's resume headroom")
    ap.add_argument("--spec-decode", action="store_true",
                    help="paged executor + SLICE: speculative decoding "
                         "(DESIGN.md §8) — a draft model proposes per-"
                         "request token windows, the target verifies them "
                         "in one step")
    ap.add_argument("--spec-depth", type=int, default=4,
                    help="max speculation depth (draft tokens per verify "
                         "window)")
    ap.add_argument("--draft-config", default=None,
                    help="registry arch for the draft model (reduced, "
                         "reshaped to the target vocab); default: the "
                         "target architecture cut to one layer")
    ap.add_argument("--async-pipeline", action="store_true",
                    help="paged executor: dispatch-ahead pipelining "
                         "(DESIGN.md §10) — decode cycles are enqueued "
                         "without blocking on device results; sampling "
                         "and bookkeeping land at commit time, KV-swap "
                         "transfers overlap decode on a background "
                         "worker. Streams and metrics stay byte-"
                         "identical to the synchronous engine")
    ap.add_argument("--fleet", default=None,
                    help="comma-separated registry archs ordered small -> "
                         "large: run one paged SLICE instance per arch "
                         "behind a single routing/admission layer "
                         "(DESIGN.md §11). A single-arch fleet is byte-"
                         "identical to the plain single-model path")
    ap.add_argument("--mesh-shape", default=None,
                    help="paged executor: 'data,model' serving mesh, e.g. "
                         "2,2 — cuts weights + the KV page arena over the "
                         "model axis and decode batches over the data axis "
                         "(DESIGN.md §9), one process a rank, started here "
                         "(or by torchrun)")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="record the per-request lifecycle stream "
                         "(DESIGN.md §13) and write a Perfetto/Chrome-"
                         "trace JSON timeline here — open in "
                         "ui.perfetto.dev or chrome://tracing. Composes "
                         "with every mode incl. --fleet and "
                         "--async-pipeline (commit-time spans)")
    ap.add_argument("--metrics-every", type=int, default=0, metavar="N",
                    help="with --trace: also sample a counters/gauges "
                         "MetricsSnapshot (pages in use, resident tasks, "
                         "defers, spec accept rate) every N loop cycles "
                         "(default 0 = off)")
    ap.add_argument("--rate", type=float, default=1.0)
    ap.add_argument("--duration", type=float, default=20.0)
    ap.add_argument("--ratio", type=float, default=0.5)
    ap.add_argument("--slots", type=int, default=8,
                    help="max decode batch of the paged engine; slot "
                         "count of the slot engine")
    ap.add_argument("--max-seq", type=int, default=256)
    ap.add_argument("--pages", type=int, default=None,
                    help="KV pool size in pages (default: "
                         "slots*max_seq/page_size)")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--dtype", default="float32", choices=sorted(DTYPES))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true",
                    help="serve the reduced (CPU-feasible) config instead "
                         "of the full-width one")
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


def shape_workload(tasks, lats, slots: int, max_seq: int) -> None:
    """Scale the paper's workload SLOs to the measured speed of the slowest
    engine in ``lats`` (one latency model a serving engine) and cap every
    task inside the engines' per-task limits, as ``repro.launch.serve``
    does."""
    scale = max(max(lat.decode_ms(max(2, slots // 2)) for lat in lats)
                / 50.0, 0.02)
    for t in tasks:
        t.slo.tpot_ms *= scale
        t.slo.ttft_ms *= max(scale, 1.0)
        if t.slo.deadline_ms:
            t.slo.deadline_ms *= max(scale, 1.0)
        t.prompt_len = min(t.prompt_len, max_seq // 4)
        t.prefix_len = min(t.prefix_len, t.prompt_len)
        t.output_len = min(t.output_len, max_seq // 2)


def _workload(args):
    return poisson_workload(args.rate, args.duration,
                            realtime_frac=args.ratio, seed=args.seed,
                            rt_output_len=8, voice_output_len=24,
                            qa_output_len=32,
                            shared_prefix_frac=args.shared_prefix_frac,
                            prefix_len_range=(args.max_seq // 8,
                                              args.max_seq // 4))


def _paged_engine(cfg, args, mesh=None) -> PagedTorchExecutor:
    """The paged engine the flags ask for; under a mesh this rank's, on
    the rank's device, its steps captured only over NCCL."""
    n_pages = args.pages or (args.slots * args.max_seq) // args.page_size
    draft_cfg = None
    if args.spec_decode and args.draft_config is not None:
        draft_cfg = draft_config_from_registry(args.draft_config, cfg)
    mesh_kw = {} if mesh is None else dict(
        mesh=mesh, cuda_graphs=mesh.backend == "nccl")
    return PagedTorchExecutor(cfg, n_pages=n_pages, page_size=args.page_size,
                              max_seq=args.max_seq, seed=args.seed,
                              max_batch=args.slots, dtype=DTYPES[args.dtype],
                              device=args.device if mesh is None
                              else mesh.device,
                              prefill_chunk_size=args.prefill_chunk,
                              prefix_cache=args.prefix_cache,
                              spec_decode=args.spec_decode,
                              draft_cfg=draft_cfg,
                              max_spec_depth=args.spec_depth,
                              async_dispatch=args.async_pipeline, **mesh_kw)


def _slice_scheduler(lat, args, page_budget=None,
                     prefix_hint=None) -> SliceScheduler:
    return SliceScheduler(lat, page_budget=page_budget,
                          prefill_chunk=args.prefill_chunk,
                          prefix_hint=prefix_hint, kv_swap=args.kv_swap,
                          spec_decode=args.spec_decode,
                          max_spec_depth=args.spec_depth)


def _curve(ex) -> str:
    """The probed l(b) curve, with the samples as read where they fell
    (``serving.executor.monotone_samples``)."""
    def line(samples):
        return " ".join(f"l({b})={ms:.3f}ms" for b, ms in samples)
    out = line(ex.probe_samples)
    if ex.probe_read != ex.probe_samples:
        out += f" (read: {line(ex.probe_read)})"
    return out


def _make_trace(args) -> Optional[TraceRecorder]:
    """TraceRecorder for --trace, or None (the zero-overhead default)."""
    if args.trace is None:
        return None
    return TraceRecorder(capacity=1 << 20, metrics_every=args.metrics_every)


def _export_trace(tr, args, tasks, events) -> None:
    """Write the Perfetto JSON + print the observability summary line
    (events, snapshots, SLO-violation attribution buckets)."""
    if tr is None:
        return
    rows = tr.export_perfetto(args.trace)
    att = slo_attribution(tasks, events)
    buckets = {k: v for k, v in att["buckets"].items() if v}
    print(f"trace: {len(tr)} events ({tr.dropped} dropped) "
          f"{len(tr.snapshots)} snapshots -> {args.trace} ({rows} rows); "
          f"violations={att['violations']} attribution={buckets or '{}'}")


def _mesh_shape(args) -> Optional[Tuple[int, int]]:
    """--mesh-shape parsed and checked against the other flags, as the JAX
    launcher does."""
    if args.mesh_shape is None:
        return None
    try:
        shape = tuple(int(x) for x in args.mesh_shape.split(","))
        assert len(shape) == 2 and min(shape) >= 1
    except (ValueError, AssertionError):
        raise SystemExit("--mesh-shape wants 'data,model', e.g. 1,4")
    if args.executor != "paged":
        raise SystemExit("--mesh-shape requires --executor paged "
                         "(the slot engine has no sharded arena)")
    if args.fleet is not None:
        raise SystemExit("--fleet with --mesh-shape is not supported "
                         "(one process group per run)")
    return shape


def run(args: argparse.Namespace) -> Union[ServeRun, FleetRun, MeshRun]:
    """Build the engine, measure l(b), serve a Poisson workload under the
    chosen scheduler, print the l(b) curve and the SLO summary line. With
    ``--fleet``, ``run_fleet``; with ``--mesh-shape``, one rank of the mesh
    serves in each process (``run_mesh``), or, in a rank, this rank."""
    mesh_shape = _mesh_shape(args)
    if args.fleet is not None:
        if args.executor != "paged":
            raise SystemExit("--fleet requires --executor paged (every "
                             "instance is a paged SLICE engine)")
        if args.scheduler != "slice":
            raise SystemExit("--fleet routes onto per-instance SLICE "
                             "schedulers; Orca/FastServe fleets are not "
                             "a thing here")
        return run_fleet(args)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if cfg.is_encoder_only:
        raise SystemExit(f"{args.arch} is encoder-only: no decode serving "
                         "(DESIGN.md §4)")
    if args.prefill_chunk is not None and args.scheduler != "slice":
        raise SystemExit("--prefill-chunk requires --scheduler slice "
                         "(Orca/FastServe are atomic-prefill baselines)")
    if args.prefill_chunk is not None and (not cfg.has_attention or cfg.has_ssm):
        raise SystemExit(f"{args.arch}: executor-level chunked prefill needs "
                         "a pure-attention arch — SSM/hybrid archs serve "
                         "with atomic prefill (DESIGN.md §12)")
    if cfg.has_ssm and args.executor == "paged" and (
            args.spec_decode or args.prefix_cache or mesh_shape is not None):
        raise SystemExit(f"{args.arch}: spec-decode/prefix-cache/mesh need "
                         "rewindable/sharable per-token KV; the recurrent "
                         "state kind has none (DESIGN.md §12)")
    if args.prefix_cache and args.executor != "paged":
        raise SystemExit("--prefix-cache requires --executor paged "
                         "(sharing rides on the refcounted page pool)")
    if args.kv_swap and args.executor != "paged":
        raise SystemExit("--kv-swap requires --executor paged "
                         "(the slot arena has no page pool to swap from)")
    if args.kv_swap and args.scheduler == "orca":
        raise SystemExit("--kv-swap requires --scheduler slice or fastserve "
                         "(Orca has no preemption policy)")
    if args.spec_decode and args.executor != "paged":
        raise SystemExit("--spec-decode requires --executor paged "
                         "(the verify window rides the paged KV arena)")
    if args.spec_decode and args.scheduler != "slice":
        raise SystemExit("--spec-decode requires --scheduler slice "
                         "(depth grants come from the Eq. 7 headroom)")
    if args.async_pipeline and args.executor != "paged":
        raise SystemExit("--async-pipeline requires --executor paged "
                         "(the dispatch queue rides the paged engine)")
    if mesh_shape is None:
        return _serve(args, cfg)
    if dist.is_initialized():
        raise SystemExit("--mesh-shape starts its own process group")
    return run_mesh(args, cfg, mesh_shape)


def _serve(args: argparse.Namespace, cfg, mesh=None) -> ServeRun:
    """One engine (under a mesh: this rank's) serving the workload."""
    n_pages = args.pages or (args.slots * args.max_seq) // args.page_size
    page_budget = None
    prefix_hint = None
    if args.executor == "paged":
        ex = _paged_engine(cfg, args, mesh)
        page_budget = ex.page_budget()
        if args.prefix_cache:
            prefix_hint = ex.cached_prompt_tokens
    else:
        ex = TorchExecutor(cfg, max_slots=args.slots, max_seq=args.max_seq,
                           seed=args.seed,
                           prefill_chunk_size=args.prefill_chunk,
                           dtype=DTYPES[args.dtype], device=args.device)
    lat = ex.latency_model()
    lat.swap_bw_gbps = args.swap_bw_gbps
    probes = list(ex.probe_samples)
    print(f"engine {cfg.name} ({args.executor}, {args.dtype}, {ex.device}): "
          f"{_curve(ex)}")
    tasks = _workload(args)
    shape_workload(tasks, [lat], args.slots, args.max_seq)
    # Orca/FastServe have no memory model: cap their batch so worst-case
    # residency (prompt cap + output cap per task) fits the pool; the slot
    # engine holds one slot per task, so its cap is the slot count. With
    # --kv-swap FastServe gets the page budget and manages the pressure
    baseline_batch = args.slots
    if args.executor == "paged" and not (args.kv_swap
                                         and args.scheduler == "fastserve"):
        peak = args.max_seq // 4 + args.max_seq // 2
        baseline_batch = max(1, min(args.slots,
                                    (n_pages * args.page_size) // peak))
    sched = {"slice": lambda: _slice_scheduler(lat, args, page_budget,
                                               prefix_hint),
             "orca": lambda: OrcaScheduler(max_batch=baseline_batch),
             "fastserve": lambda: FastServeScheduler(
                 max_batch=baseline_batch,
                 page_budget=page_budget if args.kv_swap else None,
                 kv_swap=args.kv_swap)}[args.scheduler]()
    tr = _make_trace(args)
    res = run_serving_loop(sched, ex, tasks, max_ms=3e7, trace=tr)
    s = summarize(res.tasks)
    swap_note = (f" suspends={res.suspends} resumes={res.resumes} "
                 f"swapped={res.swapped_bytes / 1e6:.1f}MB"
                 if args.kv_swap else "")
    spec_note = (f" spec_extra={res.spec_extra_tokens} "
                 f"accepted={res.accepted_tokens}/{res.drafted_tokens}"
                 if args.spec_decode else "")
    pipe_note = (f" host_gap={res.dispatch_ms + res.wait_ms:.1f}ms "
                 f"(dispatch={res.dispatch_ms:.1f} wait={res.wait_ms:.1f} "
                 f"swap_overlap={res.swap_overlap_ms:.1f}) "
                 f"stalls={res.pipeline_stalls}"
                 if args.async_pipeline else "")
    print(f"{args.scheduler}: n={s['all'].n} SLO={s['all'].slo:.1%} "
          f"RT={s['realtime'].slo:.1%} nRT={s['non_realtime'].slo:.1%} "
          f"decode_iters={res.decode_iterations} prefills={res.prefills} "
          f"prefill_chunks={res.prefill_chunks} defers={dict(res.defers_by_reason)}"
          f"{swap_note}{spec_note}{pipe_note}")
    if mesh is None or mesh.rank == 0:        # one rank writes the trace
        _export_trace(tr, args, res.tasks,
                      tr.events if tr is not None else [])
    return ServeRun(executor=ex, lat=lat, probes=probes, result=res, trace=tr)


def run_mesh(args: argparse.Namespace, cfg,
             mesh_shape: Tuple[int, int]) -> MeshRun:
    """Serve on a (data, model) mesh, one process a rank: the ranks are
    spawned here and rendezvous through a FileStore in a temporary
    directory, or, under torchrun (RANK and WORLD_SIZE set), this process
    is its rank. Returns the ranks' summaries (under torchrun, this
    rank's)."""
    ways = mesh_shape[0] * mesh_shape[1]
    backend = backend_for(args.device, ways)
    torchrun = "RANK" in os.environ and "WORLD_SIZE" in os.environ
    if not torchrun or os.environ["RANK"] == "0":
        where = ("each on its own card" if backend == "nccl"
                 else f"sharing {rank_device(args.device, backend, 0)}")
        print(f"mesh data={mesh_shape[0]} model={mesh_shape[1]}: {ways} "
              f"ranks over {backend}, {where}", flush=True)
    if torchrun:
        rank = int(os.environ["RANK"])
        dist.init_process_group(backend)
        try:
            return MeshRun(mesh_shape, backend,
                           [_serve_rank(rank, args, cfg, mesh_shape, backend)])
        finally:
            dist.destroy_process_group()
    return MeshRun(mesh_shape, backend, spawn_ranks(
        _serve_rank, ways, (args, cfg, mesh_shape, backend),
        backend=backend, timeout=MESH_TIMEOUT_S))


def _serve_rank(rank: int, args: argparse.Namespace, cfg,
                mesh_shape: Tuple[int, int], backend: str) -> dict:
    """One rank of ``run_mesh``: serve on this rank's slab (only rank 0
    prints), then gather the ranks' digests; rank 0 prints them. Returns
    the rank's summary: its heads (query, KV, first KV head), the experts
    it holds (MoE), digest, kernel launches, loop clock, the tasks'
    (prompt, output) lengths, tasks left unfinished, pages held and any
    module of JAX or the JAX package it imported."""
    device = rank_device(args.device, backend, rank)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    else:       # ranks on one host's CPU: threads of their own, not shared
        torch.set_num_threads(max(1, (os.cpu_count() or 1)
                                  // (mesh_shape[0] * mesh_shape[1])))
    mesh = make_serving_mesh(data=mesh_shape[0], model=mesh_shape[1],
                             device=device)
    quiet = (contextlib.nullcontext() if rank == 0
             else contextlib.redirect_stdout(io.StringIO()))
    with quiet:
        run = _serve(args, cfg, mesh)
    ex, res = run.executor, run.result
    if ex.prefix_cache is not None:
        ex.prefix_cache.clear()
    digests = mesh.gather(ex.digest)
    if rank == 0:
        print(f"mesh data={mesh_shape[0]} model={mesh_shape[1]} "
              f"backend={backend} heads/rank q={ex.heads[0]} "
              f"kv={ex.heads[1]} digests=[{', '.join(f'{d:#x}' for d in digests)}]"
              f" {'equal' if len(set(digests)) == 1 else 'DIFFER'}",
              flush=True)
    moe = ex.params["blocks"].get("moe")
    return {"rank": rank, "device": str(device), "heads": ex.heads,
            "experts": 0 if moe is None else moe["wg"].shape[1],
            "digest": ex.digest, "digests": digests,
            "launches": dict(ops.LAUNCHES), "probes": list(run.probes),
            "probe_read": list(ex.probe_read),
            "end_ms": res.end_ms, "n_tasks": len(res.tasks),
            "tasks": [(t.prompt_len, t.output_len) for t in res.tasks],
            "unfinished": [t.task_id for t in res.tasks
                           if t.dropped or not t.finished],
            "used_pages": ex.pool.used_pages, "leaked": ex.store.leaked(),
            "decode_iters": res.decode_iterations, "prefills": res.prefills,
            "jax_modules": sorted(m for m in sys.modules if m == "jax"
                                  or m.startswith(("jax.", "repro.")))}


def run_fleet(args: argparse.Namespace) -> FleetRun:
    """The --fleet path, after the JAX launcher's ``_run_fleet``: one paged
    engine and SliceScheduler per arch (tier = position, small -> large,
    quality = (tier + 1) / n) under one FleetRouter. Each instance is built
    and probed in turn, with the flags of a single paged run. The SLOs are
    scaled to the slowest instance, and QA tasks want the top tier
    (``min_tier``). With one arch this is the single-model run: the same
    engine, scaling and event order."""
    archs = [a.strip() for a in args.fleet.split(",") if a.strip()]
    if not archs:
        raise SystemExit("--fleet wants a comma-separated arch list ordered "
                         "small -> large, e.g. smollm-360m,edge-6b")
    insts = []
    for tier, arch in enumerate(archs):
        cfg = get_config(arch)
        if args.reduced:
            cfg = cfg.reduced()
        if cfg.is_encoder_only:
            raise SystemExit(f"{arch} is encoder-only: no decode serving "
                             "(DESIGN.md §4)")
        if args.prefill_chunk is not None and (not cfg.has_attention
                                               or cfg.has_ssm):
            raise SystemExit(f"{arch}: executor-level chunked prefill needs "
                             "a pure-attention arch — SSM/hybrid archs serve "
                             "with atomic prefill (DESIGN.md §12)")
        ex = _paged_engine(cfg, args)
        budget = ex.page_budget()
        lat = ex.latency_model()
        lat.swap_bw_gbps = args.swap_bw_gbps
        prefix_hint = ex.cached_prompt_tokens if args.prefix_cache else None
        sched = _slice_scheduler(lat, args, budget, prefix_hint)
        print(f"fleet[{tier}] {cfg.name} (paged, {args.dtype}, "
              f"{ex.device}): {_curve(ex)}")
        insts.append(FleetInstance(name=arch, tier=tier, scheduler=sched,
                                   executor=ex, lat=lat, page_budget=budget,
                                   quality=(tier + 1) / len(archs)))
    router = FleetRouter(insts)
    tasks = _workload(args)
    shape_workload(tasks, [i.lat for i in insts], args.slots, args.max_seq)
    top = len(archs) - 1
    for t in tasks:
        if top > 0 and t.kind == "qa":
            t.min_tier = top           # quality tier: wants the big model
    tr = _make_trace(args)
    res = run_fleet_loop(router, tasks, max_ms=3e7, trace=tr)
    s = summarize(res.tasks)
    print(f"fleet({','.join(archs)}): n={s['all'].n} SLO={s['all'].slo:.1%} "
          f"RT={s['realtime'].slo:.1%} nRT={s['non_realtime'].slo:.1%} "
          f"spills={res.spills} degraded={res.degraded} "
          f"defers={dict(res.merged.defers_by_reason)}")
    for name, a in per_tier(res.tasks).items():
        print(f"  {name}: served={a.n} "
              f"admitted={res.admissions.get(name, 0)} SLO={a.slo:.1%}")
    _export_trace(tr, args, res.tasks, tr.events if tr is not None else [])
    return FleetRun(router=router,
                    probes={i.name: list(i.executor.probe_samples)
                            for i in insts},
                    result=res, trace=tr)


def main(argv: Optional[Sequence[str]] = None) -> None:
    run(parse_args(argv))


if __name__ == "__main__":
    main()
