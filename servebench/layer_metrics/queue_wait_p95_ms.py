"""Scheduler: 95th percentile over the window's requests of the time
from arrival (delivery) to the start of the request's first prefill span
in the port's ``TraceRecorder``, both on the driver's clock, which the
benchmark keeps on the wall clock."""
from servebench.harness import slo


def read(w):
    arrive, first = {}, {}
    for e in w.trace_events:
        if e.kind == "arrive":
            arrive.setdefault(e.task_id, e.ts)
        elif e.kind in ("prefill", "prefill_chunk"):
            first.setdefault(e.task_id, e.ts)
    waits = [first[t] - a for t, a in arrive.items() if t in first]
    return slo.percentile(waits, 95)
