"""Engine: mean ms of the window's decode ops on the port's own clock
(host time around a step that ends in its argmax read)."""


def read(w):
    ops = w.ops_in_window("decode")
    return sum(o.ms for o in ops) / len(ops) if ops else None
