"""Where the port's serving step time goes on the card.

Builds the paged engine (``--executor slot``: the slot engine, whose
decode step runs the ring-cache attention kernel over all of its slots)
at full width by default and times one kind of step (``--step``) two
ways: the engine's own clock (host time around a step that ends in a
device synchronise, what l(b) and the prefill prior read) and
torch.profiler (device time per kernel; a replayed CUDA graph's kernels
show as the eager step's do). Prints per-step host ms, device busy ms,
the device's idle share, and the kernels ranked by device time.

- ``decode`` (default): decode steps over a batch of ``--batch``
  prefilled prompts of ``--context`` tokens, then one prefill the same
  way.
- ``prefill``: whole prompts of ``--context`` tokens, each a new task,
  released after its prefill.
- ``chunk``: the same prompts through ``prefill_chunk`` in pieces of
  ``--chunk`` tokens (one call a prompt).

The steps are captured as CUDA graphs, as the engines run them (a step
is captured at its first use, which is not timed); ``--eager`` runs them
eagerly.

  PYTHONPATH=src python -m repro_torch.launch.profile_decode \\
      --arch edge-6b --dtype bfloat16 --batch 8 --context 128
  PYTHONPATH=src python -m repro_torch.launch.profile_decode \
      --executor slot --batch 16 --context 128 --eager
  PYTHONPATH=src python -m repro_torch.launch.profile_decode \
      --step chunk --context 256 --chunk 64
"""
from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_config
from repro_torch.core.task import qa_task
from repro_torch.launch.serve import DTYPES
from repro_torch.serving.executor import (PagedTorchExecutor,
                                          TorchExecutor)


def _device_us(evt) -> float:
    t = getattr(evt, "self_device_time_total", None)
    return float(t if t is not None else getattr(evt, "self_cuda_time_total", 0))


def report(prof, wall_ms: float, n: int, top: int, label: str) -> None:
    """Per-op device time from the profile over ``n`` operations that took
    ``wall_ms`` host time in all."""
    rows = [(e.key, e.count, _device_us(e)) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(us for _, _, us in rows) / 1e3
    if busy_ms == 0:
        print(f"{label}: device time not measured (profiler saw no kernels)")
        return
    print(f"{label}: host {wall_ms / n:.3f} ms/op, device busy "
          f"{busy_ms / n:.3f} ms/op, device idle share "
          f"{1 - busy_ms / wall_ms:.3f} ({n} ops profiled)")
    for key, count, us in sorted(rows, key=lambda r: -r[2])[:top]:
        print(f"  {us / 1e3 / n:9.4f} ms/op  {count / n:7.1f} calls/op  "
              f"{100 * us / 1e3 / busy_ms:5.1f}%  {key[:100]}")


def profile_prefill(ex, args, mode: str) -> None:
    """``--step prefill|chunk``: the engine clock of prompts of
    ``--context`` tokens, whole or in chunks, each a new task released
    after it, over ``--steps`` prompts after 3 untimed ones (the first
    captures the steps), then ``--steps`` more under the profiler."""
    def one() -> float:
        t = qa_task(prompt_len=args.context, output_len=1)
        ms = (ex.prefill(t) if args.step == "prefill"
              else ex.prefill_chunk(t, args.context)[0])
        ex.release(t)
        return ms

    for _ in range(3):                         # warm
        one()
    clock = [one() for _ in range(args.steps)]
    how = ("whole" if args.step == "prefill"
           else f"in chunks of {args.chunk}")
    print(f"{ex.cfg.name} {args.dtype} {args.executor} engine, {mode} "
          f"steps, prefill of {args.context} tokens {how}: engine clock "
          f"{min(clock):.3f} ms min, {sum(clock) / len(clock):.3f} ms mean "
          f"over {len(clock)} prompts")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            one()
        wall = (time.perf_counter() - t0) * 1e3
    report(prof, wall, args.steps, args.top, f"prefill {how} (profiled)")


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="edge-6b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--dtype", default="bfloat16", choices=sorted(DTYPES))
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--context", type=int, default=128,
                    help="prompt tokens per sequence")
    ap.add_argument("--max-seq", type=int, default=1024)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--executor", default="paged", choices=("paged", "slot"),
                    help="slot: B slots of --max-seq, every one decoding")
    ap.add_argument("--eager", action="store_true",
                    help="run the steps eagerly, not as CUDA graphs")
    ap.add_argument("--step", default="decode",
                    choices=("decode", "prefill", "chunk"),
                    help="the step timed and profiled")
    ap.add_argument("--chunk", type=int, default=64,
                    help="--step chunk: prompt tokens a piece")
    args = ap.parse_args(argv)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    B = args.batch
    chunk = args.chunk if args.step == "chunk" else None
    if args.executor == "slot":
        ex = TorchExecutor(cfg, max_slots=B, max_seq=args.max_seq,
                           dtype=DTYPES[args.dtype], device=args.device,
                           prefill_chunk_size=chunk,
                           cuda_graphs=not args.eager)
    else:
        ex = PagedTorchExecutor(
            cfg, n_pages=(B + 1) * args.max_seq // args.page_size,
            page_size=args.page_size, max_seq=args.max_seq, max_batch=B,
            dtype=DTYPES[args.dtype], device=args.device,
            prefill_chunk_size=chunk, cuda_graphs=not args.eager)
    mode = "eager" if args.eager or ex.device.type != "cuda" else "captured"
    if args.step != "decode":
        profile_prefill(ex, args, mode)
        return
    tasks = [qa_task(prompt_len=args.context, output_len=args.max_seq // 2)
             for _ in range(B + 1)]
    batch, spare = tasks[:B], tasks[B]     # spare: the profiled prefill
    for t in batch:
        ex.prefill(t)
    for _ in range(3):                         # warm
        ex.decode(batch)
    steps = [ex.decode(batch) for _ in range(args.steps)]
    print(f"{cfg.name} {args.dtype} {args.executor} engine, {mode} decode "
          f"steps, decode batch {B} context "
          f"~{args.context}: engine clock {min(steps):.3f} ms min, "
          f"{sum(steps) / len(steps):.3f} ms mean over {len(steps)} steps")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            ex.decode(batch)
        wall = (time.perf_counter() - t0) * 1e3
    report(prof, wall, args.steps, args.top, "decode step (profiled)")
    if args.executor == "slot":
        ex.release(batch[-1])          # its slot takes the profiled prefill
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ms = ex.prefill(spare)
        wall = (time.perf_counter() - t0) * 1e3
    print(f"prefill of {args.context} tokens: engine clock {ms:.3f} ms")
    report(prof, wall, 1, args.top, "prefill (profiled)")


if __name__ == "__main__":
    main()
