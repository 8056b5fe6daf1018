"""One run of one cell: set-up, the measured window, the output check,
the result line.

  python3 servebench/run.py --workload <cell> --seed <n> --seconds <s> \\
      --trace <0|1>

Earlier lines on standard output name the card, its power limit, the
measured l(b), the cell's rate and what happened to the requests; the
last line is the result object. The compared numbers, each beside its
limit, are the last lines on standard error and the last key of the
result. A run exits non-zero and prints no result without a CUDA card
(or with fewer than the cell asks for), or when JAX or the JAX package
is loaded in this process once the window has closed.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import time
from typing import Dict, List, Optional

import torch

from servebench.harness import (check, engine, openloop, profiling,
                                registry, traffic, weights, window)

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
PROFILE_SLICE_S = 2.0


def process_start() -> float:
    """time.time() at this process's start (its age from /proc), so that
    set-up counts the interpreter's own start and the imports."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - start_ticks / os.sysconf("SC_CLK_TCK")
        return time.time() - max(0.0, age)
    except (OSError, ValueError, IndexError):
        return time.time()


def card_lines() -> List[str]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        out = "nvidia-smi not available"
    return [f"card: {line}" for line in out.splitlines() or ["(none)"]]


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def run_cell(cell: Dict, bench: Dict, seed: int, seconds: float,
             trace: bool, device: str = "cuda", started: float = None,
             model: Optional[Dict] = None, mix: Optional[Dict] = None,
             cell_spec: Optional[Dict] = None, control: bool = False,
             log=print) -> Dict:
    """Run ``cell`` once and return its result object. ``model``, ``mix``
    and ``cell_spec`` replace the cell's files (the CPU tests run a small
    model through the same path); ``control`` adds every reading of the
    check, the float8 control's among them (``tools/calibrate.py``)."""
    started = time.time() if started is None else started
    cfg_file = registry.config(cell["cfg"])
    model = cfg_file["port"] if model is None else model
    mix = registry.traffic(cell["traffic"]) if mix is None else mix
    spec = registry.cell_file(cell["name"]) if cell_spec is None else cell_spec
    rate = spec["rate_per_s"]
    dtype = DTYPES[cfg_file["served_dtype"]]
    eng = mix["engine"]
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    reqs = traffic.generate(mix, seed, seconds, rate)
    engine.check_fits(reqs, eng)

    params = weights.make(model, seed, dev, dtype)
    ex = engine.executor(model, params, eng, seed, dev, dtype)
    lat = ex.latency_model()
    log("l(b): " + " ".join(f"l({b})={ms:.4f}ms" for b, ms in ex.probe_samples))
    warmed = engine.warm(ex, reqs, eng)
    sched = engine.scheduler(mix["scheduler"], ex, lat, eng)
    tr = prof = None
    if trace:
        from repro_torch.serving.trace import TraceRecorder
        tr = TraceRecorder(capacity=1 << 21)
        if cuda:
            profiling.SliceProfiler.warm(
                lambda: torch.ones(1, device=dev).add_(1))
        w_s = seconds
        prof = profiling.SliceProfiler(
            1000.0 * (w_s - min(PROFILE_SLICE_S, w_s / 4)), 1000.0 * w_s)
    from repro_torch.serving.loop import InstanceDriver
    clock = openloop.Clock()
    timed = openloop.TimedExecutor(ex, clock, ranged=trace)
    drv = InstanceDriver(sched, timed, trace=tr)
    timed.drv = drv
    if trace:
        plan = sched.next_action

        def ranged_plan(now):
            with torch.profiler.record_function("sb.schedule"):
                return plan(now)
        sched.next_action = ranged_plan
    tasks = {r.rid: engine.task(r) for r in reqs}
    gc.collect()
    setup_s = time.time() - started
    log(f"rate {rate} req/s over {seconds} s: {len(reqs)} "
        f"requests due; warmed {warmed}; set-up {setup_s:.3f} s")

    tick = None
    if prof is not None:
        tick = (lambda now: prof.tick(now, timed)) if cuda else None
    stats = openloop.serve(drv, timed, reqs, tasks, clock,
                           seconds * 1000.0, mix["drain_s"] * 1000.0,
                           tick=tick, ranged=trace)
    mem_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0

    win = window.Window(model, torch.tensor([], dtype=dtype).element_size(),
                        seconds, reqs, timed.stamps, stats, timed.ops)
    n_failed = len(stats.failed_at)
    dropped = sum(1 for r in reqs if tasks[r.rid].dropped)
    log(f"requests: sent {len(reqs)} finished {len(reqs) - n_failed} "
        f"dropped {dropped} unfinished {n_failed - dropped}; loop ended at "
        f"{stats.end_ms:.1f} ms (window {seconds * 1000.0:.0f} ms, drain "
        f"limit {mix['drain_s'] * 1000.0:.0f} ms)")
    log("summary: " + json.dumps(window.summary(win)))

    breakdown = None
    device_info = {"platform": "gpu" if cuda else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
                   "count": 1, "memory_peak_bytes": int(mem_peak)}
    if trace:
        win.trace_events = list(tr.events)
        if prof is not None and prof.done:
            dev_ops, host = prof.events()
            win.kernels_by_op = profiling.by_op(dev_ops, host)
            busy = profiling.busy_intervals(dev_ops)
            win.busy_s = sum(e - s for s, e in busy) / 1e9
            win.window_s = prof.window_s
            breakdown = {"device_ops": profiling.top_device_ops(dev_ops),
                         "idle_gaps": profiling.idle_gaps(dev_ops, host)}
            device_info["busy_s"] = win.busy_s
            device_info["window_s"] = win.window_s
            log("device ops by executor op: " + json.dumps(
                profiling.by_kind(win.kernels_by_op, win.ops)))
            log("host ms an op, profiled / not: " + json.dumps(
                profiling.op_ms(win.ops, seconds * 1000.0)))
        metrics = {}
        for m in registry.metrics_of(bench, "per_layer", cell["name"]):
            v = registry.layer_metric(m["name"]).read(win)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        e2e = window.end_to_end(win, setup_s)
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in registry.metrics_of(bench, "end_to_end",
                                                cell["name"])}
    log("metrics: " + json.dumps(metrics))

    served = timed.served
    ref_name = cfg_file["reference"]
    del drv, timed, sched, ex, lat, params, tasks, tr, prof
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t0 = time.time()
    picked = check.sample(reqs, served, stats.failed_at, seed,
                          mix["check"]["requests"])
    readings = check.gaps(model, ref_name, seed, picked, served, eng, dev,
                          dtype, control=control)
    ok, checks = check.verdict(readings, spec)
    if control:                      # calibration: every reading, shown
        for k, v in readings.items():
            checks.setdefault(k, {"value": v, "limit": None})
    log(f"check: {len(picked)} requests, {readings['tokens_compared']} "
        f"served tokens against the reference in "
        f"{time.time() - t0:.3f} s")
    out = {"correct": bool(ok), "attempted": len(reqs), "failed": n_failed,
           "metrics": metrics, "device": device_info}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return out


def main(argv: Optional[List[str]] = None, started: float = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--base-seed", type=int, default=None,
                    help="draw the arrival times, classes and lengths from "
                    "this seed in place of the traffic file's base_seed "
                    "(its holdout_base_seed checks a claim on a trace that "
                    "no change was tuned on)")
    args = ap.parse_args(argv)
    bench = registry.benchmark()
    cell = registry.cell(bench, args.workload)
    mix = None
    if args.base_seed is not None:
        mix = {**registry.traffic(cell["traffic"]),
               "base_seed": args.base_seed}
    if not torch.cuda.is_available():
        print("no CUDA card: this benchmark measures the port on one",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"{cell['name']} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    for line in card_lines():
        print(line, flush=True)
    print(f"cards used: {cell['chips']} of {torch.cuda.device_count()}; "
          f"peaks (data sheet, at 700 W): 989 TFLOP/s bf16, 3.35 TB/s",
          flush=True)
    out = run_cell(cell, bench, args.seed, args.seconds, bool(args.trace),
                   started=started, mix=mix,
                   log=lambda s: print(s, flush=True))
    bad = forbidden_modules()
    if bad:
        print(f"import guard: {', '.join(bad)} loaded in this process",
              file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
