"""The serving benchmark of the PyTorch and CUDA port (``src/repro_torch``).

Everything a cell needs is found by name: ``BENCHMARK.json`` names the
configuration and traffic files, ``layer_metrics/<metric>.py`` reads
each per-layer metric, ``rooflines/<kernel or step>.py`` counts the
work, ``cells/<cell>.json`` holds the cell's rate and the limits of its
output check, and ``reference/<name>.py`` is the plain model a
configuration names.
``harness/`` is the frozen core: traffic, the open loop on the wall
clock, the SLO arithmetic, tracing, the output check and the report.
"""
