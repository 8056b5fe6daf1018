"""The port's phase spans joined to the benchmark's ops, for the readers
of the engine's phases (``layer_metrics/decode_stage_ms.py`` and the
others that import this).

In a ``--trace 1`` run the port's ``InstanceDriver`` emits one span per
executed action, and the synchronous paged engine adds its op's phases
to the span's args: ``stage_ms`` (entry to its first graph's start),
``graph_ms`` (its graphs' device time, by timing events inside the
graphs), ``gaps_ms``,
``commit_ms`` (last graph's end to return), ``graphs`` and
``captures``. The spans and the benchmark's ``Op``s list the same ops,
the window's and the drain's, in call order, so the n-th span of a kind
is the n-th op of that kind. A program without phases gives spans
without them, and every reader then gives None.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

SPAN_OF = {"prefill": "prefill", "chunk": "prefill_chunk",
           "decode": "decode"}


def joined(w, *kinds: str) -> Optional[List[Tuple[object, dict]]]:
    """(op, its span's args) of every op of ``kinds`` (prefill, chunk,
    decode), in call order, kind by kind; None where a kind's spans and
    ops differ in number, or where no span carries phases."""
    out = []
    for kind in kinds:
        ops = [o for o in w.ops if o.kind == kind]
        spans = [e.args for e in w.trace_events if e.kind == SPAN_OF[kind]]
        if len(ops) != len(spans):
            return None
        out.extend(zip(ops, spans))
    if not any("graph_ms" in args for _, args in out):
        return None
    return out


def decode_mean(w, field: str) -> Optional[float]:
    """The mean ``field`` of the window's decode ops that the profiler
    did not watch."""
    pairs = joined(w, "decode")
    if pairs is None:
        return None
    vals = [args[field] for o, args in pairs
            if o.t0 < w.window_ms and not o.profiled and field in args]
    return sum(vals) / len(vals) if vals else None
