"""Spreads of a cell's metrics over sets of runs, to set the bounds.

  python3 servebench/tools/spread.py runs.jsonl

Each line of the file is ``{"set": <name>, "seed": <n>, "result": <a
run's result object>}``. For every end-to-end metric and set it prints
the median and the spread: the distance between the first and the third
quartile (``statistics.quantiles(values, n=4)``) as a share of the
median; then, per metric, the wider of the sets' spreads.
"""
import collections
import json
import statistics
import sys


def spreads(rows):
    by = collections.defaultdict(lambda: collections.defaultdict(list))
    for r in rows:
        for name, m in r["result"]["metrics"].items():
            by[name][r["set"]].append(m["value"])
    out = {}
    for name, sets in by.items():
        per = {}
        for s, vals in sets.items():
            med = statistics.median(vals)
            q1, _, q3 = statistics.quantiles(vals, n=4)
            per[s] = {"n": len(vals), "median": med,
                      "spread": (q3 - q1) / abs(med) if med else None}
        widest = max((p["spread"] for p in per.values()
                      if p["spread"] is not None), default=None)
        out[name] = {"sets": per, "widest": widest}
    return out


def main(path):
    with open(path) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    print(json.dumps(spreads(rows), indent=1))


if __name__ == "__main__":
    main(sys.argv[1])
