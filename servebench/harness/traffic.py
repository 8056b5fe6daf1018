"""The one traffic generator: reads a mix's parameters from its file.

Adapted from the port's ``data/workload.py`` ``poisson_workload`` (the
paper's control / voice / QA mix, its length ranges and output
distributions) with two changes a benchmark needs:

- the SLO classes are fixed numbers in the traffic file, never scaled
  to the engine under test;
- every seed serves the same work at the same times. ``base_seed`` in
  the file draws the arrival times (exponential gaps), the class of the
  request due at each time, and each class's multiset of prompt and
  output lengths; the run's seed only deals each class's lengths to that
  class's arrivals in another order (and draws the weights and prompt
  tokens). Queueing tails at these loads swing by half their value with
  the arrival order (PERF.md), so the order of arrivals and classes is
  not the seed's; the amount of work and the warm-up set of prompt
  lengths are the same for every seed. So every run serves one arrival
  trace; the file's ``holdout_base_seed`` names a second, which
  ``run.py --base-seed`` serves, on which a claimed gain has to hold too.

The offered rate is the cell's (``cells/<cell>.json``), found by a
sweep. The count is ``round(rate * seconds)``; the gaps are scaled so
that the last request is due inside the window (a Poisson process
conditioned on its count is uniform order statistics; exponential gaps
normalised to the window are exactly that).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class SLO:
    realtime: bool
    ttft_ms: float
    tpot_ms: float
    deadline_ms: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class Request:
    rid: int                  # task id handed to the engine
    due_ms: float             # ms after the window opens
    kind: str
    prompt_len: int
    output_len: int           # tokens to generate, the first included
    slo: SLO
    utility: float


def slo_of(spec: Dict, output_len: int) -> SLO:
    """A class's SLO. A realtime class states only a deadline; as in the
    port's ``SLOSpec.realtime_deadline`` (the paper's translation) a
    quarter of it is the TTFT budget and the rest is spread over the
    remaining tokens."""
    if spec["realtime"]:
        deadline = float(spec["deadline_ms"])
        ttft = deadline * float(spec["ttft_frac"])
        return SLO(True, ttft, (deadline - ttft) / max(output_len - 1, 1),
                   deadline)
    return SLO(False, float(spec["ttft_ms"]), float(spec["tpot_ms"]))


def _lengths(rng: np.random.Generator, spec: Dict, n: int) -> np.ndarray:
    dist = spec["dist"]
    if dist == "uniform":            # lo..hi inclusive
        return rng.integers(spec["lo"], spec["hi"] + 1, n)
    if dist == "normal":             # floored, at least min
        x = rng.normal(spec["mean"], spec["sd"], n).astype(np.int64)
        return np.maximum(x, spec["min"])
    if dist == "lognormal":          # median * exp(sigma z), clipped
        x = spec["median"] * np.exp(spec["sigma"] * rng.standard_normal(n))
        return np.clip(x.astype(np.int64), spec["lo"], spec["hi"])
    raise ValueError(f"unknown length distribution {dist!r}")


def counts(shares: List[float], n: int) -> List[int]:
    """``n`` split by ``shares`` with the largest remainders rounded up."""
    raw = np.asarray(shares, float) / sum(shares) * n
    out = np.floor(raw).astype(int)
    for i in np.argsort(-(raw - out), kind="stable")[: n - out.sum()]:
        out[i] += 1
    return [int(c) for c in out]


def generate(mix: Dict, seed: int, seconds: float, rate_per_s: float,
             first_id: int = 1_000_000) -> List[Request]:
    """The requests of one window at ``rate_per_s`` (the cell's), sorted
    by due time."""
    n = max(1, int(round(rate_per_s * seconds)))
    base = np.random.default_rng(int(mix["base_seed"]))
    classes = mix["classes"]
    per = counts([c["share"] for c in classes], n)
    lengths = [(_lengths(base, c["prompt"], k), _lengths(base, c["output"], k))
               for c, k in zip(classes, per)]
    kinds = base.permutation(np.repeat(np.arange(len(classes)), per))
    gaps = base.exponential(1.0, n + 1)
    due = np.cumsum(gaps)[:n] * (seconds * 1000.0 / gaps.sum())
    run = np.random.default_rng(seed)
    order = [run.permutation(k) for k in per]
    taken = [0] * len(classes)
    out = []
    for i, ci in enumerate(kinds):
        c, j = classes[ci], order[ci][taken[ci]]
        taken[ci] += 1
        p, o = int(lengths[ci][0][j]), int(lengths[ci][1][j])
        out.append(Request(first_id + i, float(due[i]), c["kind"], p, o,
                           slo_of(c["slo"], o), float(c["utility"])))
    return out
