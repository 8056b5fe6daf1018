"""Open loop: 95th percentile over the window's requests of the time
from a request's due time to its delivery to the scheduler (the step in
progress when it fell due)."""
from servebench.harness import slo


def read(w):
    return slo.percentile(list(w.loop.lag_ms.values()), 95)
