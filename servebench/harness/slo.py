"""SLO and tail arithmetic on the benchmark's own wall-clock stamps.

Copied from the port: ``core/task.py`` (``Task.tpot_measured_ms``,
``Task.slo_met``) and ``serving/metrics.py`` (``percentile``), applied
to the stamps the open loop took itself (ms after the window opened,
one per output token) and to each request's due time, never to the
program's clock.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from servebench.harness.traffic import Request


def percentile(xs: Sequence[float], q: float) -> Optional[float]:
    """np.percentile (linear interpolation) over ``xs``; None if empty."""
    return float(np.percentile(list(xs), q)) if len(xs) else None


def tpot_ms(stamps: Sequence[float]) -> Optional[float]:
    """The paper's steady TPOT: the mean gap between output tokens,
    leaving out the gap from the prefill's first token to the first
    decoded one (queueing, not decode rate)."""
    if len(stamps) < 2:
        return None
    if len(stamps) == 2:
        return stamps[1] - stamps[0]
    return (stamps[-1] - stamps[1]) / (len(stamps) - 2)


def finished(req: Request, stamps: Sequence[float]) -> bool:
    return len(stamps) >= req.output_len


def slo_met(req: Request, stamps: Sequence[float], failed: bool) -> bool:
    """Realtime: finished within the deadline of its due time. Others:
    TTFT and steady TPOT both within their limits. A failed request
    (dropped, or unfinished when the run gave up) misses."""
    if failed or not finished(req, stamps):
        return False
    if req.slo.realtime:
        return stamps[-1] - req.due_ms <= req.slo.deadline_ms
    tp = tpot_ms(stamps)
    return (stamps[0] - req.due_ms <= req.slo.ttft_ms
            and (tp is None or tp <= req.slo.tpot_ms))


def latency_samples(req: Request, stamps: Sequence[float], failed: bool,
                    gave_up_ms: float):
    """(TTFT, TPOT) of one request in ms. A request that never got a
    token counts its TTFT at the time the run gave up on it; a failed
    request counts its TPOT the same way (give-up time after its due
    time), so every miss lands in the tail."""
    ttft = (stamps[0] if stamps else gave_up_ms) - req.due_ms
    if failed:
        return ttft, gave_up_ms - req.due_ms
    tp = tpot_ms(stamps)
    return ttft, (tp if tp is not None else ttft)
