"""Device: the share of the window up to the profiled slice's first op
(its end, where nothing was profiled) in which no engine graph ran on
the card, in %: 1 - the summed ``graph_ms`` of every prefill, chunk and
decode op that ended in it / its wall ms. ``graph_ms`` runs from each
graph's first kernel to its last node on the device: a launch up to the
first kernel counts as unfed, waits inside the graph on a launch still
under way count as fed. Read on the unwatched part of the window, beside
``device_idle_share`` of the profiled slice."""
from servebench.harness.phases import joined


def read(w):
    pairs = joined(w, "prefill", "chunk", "decode")
    if pairs is None:
        return None
    watched = [o.t0 for o in w.ops if o.profiled]
    end = min(watched) if watched else w.window_ms
    if end <= 0:
        return None
    busy = sum(args.get("graph_ms", 0.0) for o, args in pairs if o.t1 <= end)
    return 100.0 * (1.0 - busy / end)
