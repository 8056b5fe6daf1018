"""Engine: mean device ms of the unprofiled window decode ops' captured
graphs (``graph_ms`` of the port's phase spans: timing events captured
in each graph, from its first kernel to its last node). The launch up
to the first kernel is in ``decode_stage_ms``; where the kernels wait
inside the graph on a launch still under way (a profiler attached makes
a launch slow), that wait is in this metric."""
from servebench.harness.phases import decode_mean


def read(w):
    return decode_mean(w, "graph_ms")
