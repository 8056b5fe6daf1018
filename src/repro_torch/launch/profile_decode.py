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

A decode run ends with the device time of the decode step's graph
replayed alone on an idle stream (CUDA events): the floor an engine
clock per step can reach without fusing kernels.

``--async`` (``--step decode``, paged engine): the async pipelined engine
(DESIGN.md §10). It dispatches ``--steps`` decode steps without
observing them, drains, and prints the engine clock per step (the whole
drive's host time over the steps), the host's dispatch ms per step, the
host waits per step (``StepGraphs``' stage waits, which must be 0, and
commit waits, at most one a stall: the commits the queue's depth
forces) and the stalls; then the device busy and idle
share over as many more steps under the profiler.

Every profiled report also counts the device operations per op (kernels
and copies) and splits the device time between cuBLAS's matrix products
and everything else.

  PYTHONPATH=src python -m repro_torch.launch.profile_decode \\
      --arch edge-6b --dtype bfloat16 --batch 8 --context 128
  PYTHONPATH=src python -m repro_torch.launch.profile_decode \
      --executor slot --batch 16 --context 128 --eager
  PYTHONPATH=src python -m repro_torch.launch.profile_decode \
      --step chunk --context 256 --chunk 64
  PYTHONPATH=src python -m repro_torch.launch.profile_decode \
      --batch 8 --steps 32 --async
"""
from __future__ import annotations

import argparse
import re
import time
from typing import Optional, Sequence

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_config
from repro_torch.core.task import qa_task
from repro_torch.launch.serve import DTYPES
from repro_torch.serving.executor import (PagedTorchExecutor,
                                          TorchExecutor)


# cuBLAS's matrix-product kernels by name (nvjet on Hopper, the older
# gemm/gemv/xmma families), told apart from everything else in a step
GEMM = re.compile(r"nvjet|gemm|gemv|xmma|cutlass", re.IGNORECASE)


def _device_us(evt) -> float:
    t = getattr(evt, "self_device_time_total", None)
    return float(t if t is not None else getattr(evt, "self_cuda_time_total", 0))


def device_gaps(prof, short_us: float = 10.0):
    """The device's idle time between the profiled device operations:
    (ms in gaps up to ``short_us``, how many such gaps, ms in longer
    gaps). A captured step's kernels run back to back, a launch gap of a
    microsecond or less between each; a longer gap is the device waiting
    on the host. None when the profile holds no device events."""
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    if not spans:
        return None
    short = long = 0.0
    n_short = 0
    end = spans[0][1]
    for start, stop in spans[1:]:
        if start > end:
            gap = start - end
            if gap <= short_us:
                short += gap
                n_short += 1
            else:
                long += gap
        end = max(end, stop)
    return short / 1e3, n_short, long / 1e3


def report(prof, wall_ms: float, n: int, top: int, label: str) -> None:
    """Per-op device time from the profile over ``n`` operations that took
    ``wall_ms`` host time in all, and the device's idle time between
    operations, split into launch gaps and waits on the host."""
    rows = [(e.key, e.count, _device_us(e)) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(us for _, _, us in rows) / 1e3
    if busy_ms == 0:
        print(f"{label}: device time not measured (profiler saw no kernels)")
        return
    print(f"{label}: host {wall_ms / n:.3f} ms/op, device busy "
          f"{busy_ms / n:.3f} ms/op, device idle share "
          f"{1 - busy_ms / wall_ms:.3f} ({n} ops profiled)")
    gaps = device_gaps(prof)
    if gaps is not None:
        short, n_short, long = gaps
        print(f"{label}: device idle between its operations "
              f"{short / n:.3f} ms/op in {n_short / n:.0f} gaps/op up to "
              f"10 us (mean {1e3 * short / max(n_short, 1):.3f} us: launch "
              f"gaps between back-to-back kernels), {long / n:.3f} ms/op in "
              "longer gaps (waiting on the host)")
    n_ops = sum(c for _, c, _ in rows)
    n_gemm = sum(c for key, c, _ in rows if GEMM.search(key))
    gemm_ms = sum(us for key, _, us in rows if GEMM.search(key)) / 1e3
    print(f"{label}: {n_ops / n:.0f} device operations/op; matrix products "
          f"{gemm_ms / n:.3f} ms/op in {n_gemm / n:.0f}/op, everything else "
          f"{(busy_ms - gemm_ms) / n:.3f} ms/op in {(n_ops - n_gemm) / n:.0f}"
          "/op")
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


def graph_alone(ex, reps: int = 10) -> None:
    """The device time of one replay of the engine's most-run captured
    step on an idle stream (CUDA events around the replay, median of
    ``reps``): its kernels and the launch gaps between them, no host in
    the way. A replay rewrites what the step's last run wrote from the
    same inputs (a recurrent state steps once more), so it runs last."""
    steps = [st for st in ex.graphs.steps.values() if st.graph is not None]
    if not steps:                              # the CPU, or --eager
        return
    st = max(steps, key=lambda x: x.runs)
    ms = []
    for _ in range(reps):
        torch.cuda.synchronize()
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        st.graph.replay()
        e1.record()
        e1.synchronize()
        ms.append(e0.elapsed_time(e1))
    print(f"the most-run step's graph replayed alone: "
          f"{sorted(ms)[reps // 2]:.3f} ms on the device (CUDA events "
          f"around one replay on an idle stream, median of {reps}: its "
          "kernels and the launch gaps between them)")


def profile_async_decode(ex, batch, args) -> None:
    """``--async``: ``--steps`` decode steps dispatched ahead and drained
    once, timed on the host clock; then as many more under the
    profiler."""
    def drive():
        g = ex.graphs
        w0 = (g.stage_waits, g.commit_waits, ex.gap_stats.stalls)
        t0 = time.perf_counter()
        disp = sum(ex.decode(batch) for _ in range(args.steps))
        ex.drain()
        wall = (time.perf_counter() - t0) * 1e3
        return (wall, disp, g.stage_waits - w0[0], g.commit_waits - w0[1],
                ex.gap_stats.stalls - w0[2])

    for _ in range(3):                         # warm
        ex.decode(batch)
    ex.drain()
    n = args.steps
    for rep in (1, 2):                         # the second: nothing new
        wall, disp, stage_w, commit_w, stalls = drive()
        print(f"{ex.cfg.name} {args.dtype} paged engine, async dispatch "
              f"(max_in_flight {ex._queue.max_in_flight}), decode batch "
              f"{len(batch)} context ~{args.context}, drive {rep}: engine "
              f"clock {wall / n:.3f} ms/step over {n} steps dispatched "
              f"ahead and drained; dispatch {disp / n:.3f} ms/step; host "
              f"waits {(stage_w + commit_w) / n:.2f}/step (staging "
              f"{stage_w}, commits {commit_w}); stalls {stalls}")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall, *_ = drive()
    report(prof, wall, n, args.top, "async decode step (profiled)")
    graph_alone(ex)


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
    ap.add_argument("--async", dest="async_dispatch", action="store_true",
                    help="--step decode on the paged engine: the async "
                         "pipelined engine, steps dispatched ahead")
    args = ap.parse_args(argv)
    if args.async_dispatch and (args.step != "decode"
                                or args.executor != "paged"):
        raise SystemExit("--async profiles --step decode on the paged "
                         "engine")
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
            prefill_chunk_size=chunk, cuda_graphs=not args.eager,
            async_dispatch=args.async_dispatch)
    mode = "eager" if args.eager or ex.device.type != "cuda" else "captured"
    if args.step != "decode":
        profile_prefill(ex, args, mode)
        return
    tasks = [qa_task(prompt_len=args.context, output_len=args.max_seq // 2)
             for _ in range(B + 1)]
    batch, spare = tasks[:B], tasks[B]     # spare: the profiled prefill
    for t in batch:
        ex.prefill(t)
    if args.async_dispatch:
        profile_async_decode(ex, batch, args)
        return
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
    graph_alone(ex)


if __name__ == "__main__":
    main()
