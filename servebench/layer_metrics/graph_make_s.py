"""Engine: host seconds the engine spent making its steps before the
window (the latency probe's and the warm-up's: buffers, the eager
warm-up run and the CUDA graph capture of each), from the port's
``engine_setup`` trace instant."""


def read(w):
    for e in w.trace_events:
        if e.kind == "engine_setup":
            return e.args["make_ms"] / 1000.0
    return None
