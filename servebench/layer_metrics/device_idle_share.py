"""Device: the share of the profiled slice's wall time in which no device
operation ran (1 - the union of their intervals / the slice), in %."""


def read(w):
    if not w.window_s or w.busy_s is None:
        return None
    return 100.0 * (1.0 - w.busy_s / w.window_s)
