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

  # tiny CPU run
  PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu \\
      --duration 3 --slots 4 --max-seq 128

Prints the measured l(b) curve and a one-line SLO summary, as the JAX
launcher does (``repro.launch.serve``).
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import List, Optional, Sequence

import torch

from repro_torch.configs import get_config
from repro_torch.core.schedulers import (FastServeScheduler, OrcaScheduler,
                                         SliceScheduler)
from repro_torch.data.workload import poisson_workload
from repro_torch.serving.executor import (Executor, PagedTorchExecutor,
                                          TorchExecutor)
from repro_torch.serving.loop import LoopResult, run_serving_loop
from repro_torch.serving.metrics import summarize
from repro_torch.serving.spec_decode import draft_config_from_registry

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass
class ServeRun:
    executor: Executor           # PagedTorchExecutor or TorchExecutor
    lat: object                  # MeasuredLatencyModel
    probes: List[tuple]          # measured (batch, ms) samples of l(b)
    result: LoopResult


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


def shape_workload(tasks, lat, slots: int, max_seq: int) -> None:
    """Scale the paper's workload SLOs to this engine's measured speed and
    cap every task inside the engine's per-task limits, as
    ``repro.launch.serve`` does."""
    scale = max(lat.decode_ms(max(2, slots // 2)) / 50.0, 0.02)
    for t in tasks:
        t.slo.tpot_ms *= scale
        t.slo.ttft_ms *= max(scale, 1.0)
        if t.slo.deadline_ms:
            t.slo.deadline_ms *= max(scale, 1.0)
        t.prompt_len = min(t.prompt_len, max_seq // 4)
        t.prefix_len = min(t.prefix_len, t.prompt_len)
        t.output_len = min(t.output_len, max_seq // 2)


def run(args: argparse.Namespace) -> ServeRun:
    """Build the engine, measure l(b), serve a Poisson workload under the
    chosen scheduler, print the l(b) curve and the SLO summary line."""
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
            args.spec_decode or args.prefix_cache):
        raise SystemExit(f"{args.arch}: spec-decode/prefix-cache/mesh need "
                         "rewindable/sharable per-token KV; the recurrent "
                         "state kind has none (DESIGN.md §12)")
    if cfg.has_ssm and args.executor == "slot":
        raise SystemExit(f"{args.arch}: the port's slot engine serves "
                         "attention-only archs; SSM/hybrid archs serve with "
                         "--executor paged (ROADMAP.md)")
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
    n_pages = args.pages or (args.slots * args.max_seq) // args.page_size
    page_budget = None
    prefix_hint = None
    if args.executor == "paged":
        draft_cfg = None
        if args.spec_decode and args.draft_config is not None:
            draft_cfg = draft_config_from_registry(args.draft_config, cfg)
        ex = PagedTorchExecutor(cfg, n_pages=n_pages,
                                page_size=args.page_size,
                                max_seq=args.max_seq, seed=args.seed,
                                max_batch=args.slots,
                                dtype=DTYPES[args.dtype], device=args.device,
                                prefill_chunk_size=args.prefill_chunk,
                                prefix_cache=args.prefix_cache,
                                spec_decode=args.spec_decode,
                                draft_cfg=draft_cfg,
                                max_spec_depth=args.spec_depth)
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
    curve = " ".join(f"l({b})={ms:.3f}ms" for b, ms in probes)
    print(f"engine {cfg.name} ({args.executor}, {args.dtype}, {ex.device}): "
          f"{curve}")
    tasks = poisson_workload(args.rate, args.duration,
                             realtime_frac=args.ratio, seed=args.seed,
                             rt_output_len=8, voice_output_len=24,
                             qa_output_len=32,
                             shared_prefix_frac=args.shared_prefix_frac,
                             prefix_len_range=(args.max_seq // 8,
                                               args.max_seq // 4))
    shape_workload(tasks, lat, args.slots, args.max_seq)
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
    sched = {"slice": lambda: SliceScheduler(
                 lat, page_budget=page_budget,
                 prefill_chunk=args.prefill_chunk, prefix_hint=prefix_hint,
                 kv_swap=args.kv_swap, spec_decode=args.spec_decode,
                 max_spec_depth=args.spec_depth),
             "orca": lambda: OrcaScheduler(max_batch=baseline_batch),
             "fastserve": lambda: FastServeScheduler(
                 max_batch=baseline_batch,
                 page_budget=page_budget if args.kv_swap else None,
                 kv_swap=args.kv_swap)}[args.scheduler]()
    res = run_serving_loop(sched, ex, tasks, max_ms=3e7)
    s = summarize(res.tasks)
    swap_note = (f" suspends={res.suspends} resumes={res.resumes} "
                 f"swapped={res.swapped_bytes / 1e6:.1f}MB"
                 if args.kv_swap else "")
    spec_note = (f" spec_extra={res.spec_extra_tokens} "
                 f"accepted={res.accepted_tokens}/{res.drafted_tokens}"
                 if args.spec_decode else "")
    print(f"{args.scheduler}: n={s['all'].n} SLO={s['all'].slo:.1%} "
          f"RT={s['realtime'].slo:.1%} nRT={s['non_realtime'].slo:.1%} "
          f"decode_iters={res.decode_iterations} prefills={res.prefills} "
          f"prefill_chunks={res.prefill_chunks} defers={dict(res.defers_by_reason)}"
          f"{swap_note}{spec_note}")
    return ServeRun(executor=ex, lat=lat, probes=probes, result=res)


def main(argv: Optional[Sequence[str]] = None) -> None:
    run(parse_args(argv))


if __name__ == "__main__":
    main()
