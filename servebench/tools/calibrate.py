"""Readings that set a cell's output-check limit, and the check that the
float8 control fails it: for each seed, one run of the cell (a short
window at the cell's own rate, the same path and sample as the
benchmark's runs) read against the float32 reference, and the float8
control's reading on the same prompts and served tokens.

  python3 servebench/tools/calibrate.py --workload edge-6b.paper-mix \\
      --seconds 6 --seeds 1,2,3

Prints a line per seed with every reading (``harness/check.py``), then
the verdict of ``check.verdict`` on the engine's readings and on the
control's, each number beside the cell's limit (``cells/<cell>.json``),
and, last, for each reading the largest engine reading (the lower end of
a limit's range) and the smallest control reading (its upper end). Exits
1 if the engine is not correct on some seed, or the control is on one.
"""
import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def judged(who, seed, ok, checks):
    nums = "; ".join(f"{k} {c['value']!r} limit {c['limit']!r}"
                     for k, c in checks.items())
    return f"{who} seed {seed}: correct {ok}; {nums}"


def main(argv=None):
    from servebench.harness import check, cli, registry

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    bench = registry.benchmark()
    cell = registry.cell(bench, args.workload)
    spec = registry.cell_file(args.workload)
    for line in cli.card_lines():
        print(line, flush=True)
    rows, wrong = [], 0
    for seed in (int(s) for s in args.seeds.split(",")):
        out = cli.run_cell(cell, bench, seed, args.seconds, False,
                           control=True, log=lambda s: None)
        row = {k: c["value"] for k, c in out["checks"].items()}
        row.update(seed=seed, failed=out["failed"],
                   attainment=out["metrics"]["slo_attainment"]["value"])
        rows.append(row)
        print(json.dumps(row), flush=True)
        ok, checks = check.verdict(row, spec)
        print(judged("engine", seed, ok, checks), flush=True)
        ctl_ok, ctl_checks = check.verdict(check.control_readings(row), spec)
        print(judged("control", seed, ctl_ok, ctl_checks), flush=True)
        wrong += (not ok) + ctl_ok
    summary = {"workload": args.workload, "seeds": len(rows)}
    for k in ("max_logit_gap", "mean_logit_gap", "mismatch_share"):
        summary["engine_" + k] = max(r[k] for r in rows)
        summary["control_" + k] = min(r["control_" + k] for r in rows)
    print(json.dumps(summary), flush=True)
    return 1 if wrong else 0


if __name__ == "__main__":
    sys.exit(main())
