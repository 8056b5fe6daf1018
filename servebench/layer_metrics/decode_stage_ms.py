"""Engine: mean ms of the unprofiled window decode ops from their entry
to their graph's first kernel on the device (``stage_ms`` of the port's
phase spans: step lookup, pool and page-table work, the sync, staging
and the launch up to that kernel)."""
from servebench.harness.phases import decode_mean


def read(w):
    return decode_mean(w, "stage_ms")
