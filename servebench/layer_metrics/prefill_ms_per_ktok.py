"""Engine: the window's whole-prompt and chunk ops' ms on the port's own
clock, per 1,000 prompt tokens they processed."""


def read(w):
    ops = w.ops_in_window("prefill", "chunk")
    toks = sum(o.shape[0] if o.kind == "prefill" else o.shape[1] for o in ops)
    return 1000.0 * sum(o.ms for o in ops) / toks if toks else None
