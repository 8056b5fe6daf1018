"""Engine: mean ms of the unprofiled window decode ops from their
graph's end on the device to their return (``commit_ms`` of the port's
phase spans: the snapshot and logits copies, the wake, the argmax read
and the host's bookkeeping)."""
from servebench.harness.phases import decode_mean


def read(w):
    return decode_mean(w, "commit_ms")
