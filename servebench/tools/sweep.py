"""Find a cell's highest sustained rate: one engine, a window at each
offered rate in turn.

  python3 servebench/tools/sweep.py --workload edge-6b.paper-mix \\
      --seed 5 --seconds 20 --rates 8,10,12,14,16

A rate is sustained when ``slo_attainment`` is at least 90% and the
backlog (requests delivered and unfinished) at the window's end is no
larger than at its middle. The engine is built and probed once, with
every prompt shape of every rate's traffic warmed; each window gets a
fresh scheduler over the idle engine, and the seed's weights serve them
all. Prints one line per rate and, last, the highest sustained rate; the
cell's file takes 0.8 of it.
"""
import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None):
    import torch

    from servebench.harness import (cli, engine, openloop, registry,
                                    traffic, weights, window)
    from repro_torch.serving.loop import InstanceDriver

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", required=True)
    args = ap.parse_args(argv)
    bench = registry.benchmark()
    cell = registry.cell(bench, args.workload)
    cfg = registry.config(cell["cfg"])
    model, mix = cfg["port"], registry.traffic(cell["traffic"])
    eng, dev = mix["engine"], torch.device("cuda")
    dtype = cli.DTYPES[cfg["served_dtype"]]
    rates = [float(r) for r in args.rates.split(",")]
    work = {r: traffic.generate(mix, args.seed + i, args.seconds, r)
            for i, r in enumerate(rates)}
    for reqs in work.values():
        engine.check_fits(reqs, eng)
    for line in cli.card_lines():
        print(line, flush=True)
    ex = engine.executor(model, weights.make(model, args.seed, dev, dtype),
                         eng, args.seed, dev, dtype)
    lat = ex.latency_model()
    print("l(b): " + " ".join(f"l({b})={ms:.4f}ms"
                              for b, ms in ex.probe_samples), flush=True)
    print("warmed", engine.warm(ex, [r for rs in work.values() for r in rs],
                                eng), flush=True)
    best = None
    for rate, reqs in work.items():
        clock = openloop.Clock()
        timed = openloop.TimedExecutor(ex, clock)
        drv = InstanceDriver(engine.scheduler(mix["scheduler"], ex, lat, eng),
                             timed)
        timed.drv = drv
        tasks = {r.rid: engine.task(r) for r in reqs}
        stats = openloop.serve(drv, timed, reqs, tasks, clock,
                               args.seconds * 1000.0,
                               mix["drain_s"] * 1000.0)
        w = window.Window(model, 2, args.seconds, reqs, timed.stamps, stats,
                          timed.ops)
        row = {"rate": rate, "requests": len(reqs),
               "failed": len(stats.failed_at),
               **window.end_to_end(w, 0.0), **window.summary(w)}
        del row["setup_s"]
        ok = (row["slo_attainment"] >= 90.0
              and row["backlog_end"] <= row["backlog_mid"])
        row["sustained"] = ok
        if ok:
            best = rate if best is None else max(best, rate)
        print(json.dumps(row), flush=True)
    print(json.dumps({"workload": args.workload,
                      "highest_sustained_rate": best}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
