"""The serving benchmark of the PyTorch and CUDA port (``src/repro_torch``).

Everything a cell needs is found by name: ``BENCHMARK.json`` names the
configuration and traffic files, ``layer_metrics/<metric>.py`` reads
each per-layer metric, ``rooflines/<kernel or step>.py`` counts the
work, ``cells/<cell>.json`` holds the cell's rate and the limits of its
output check, ``reference/<name>.py`` is the plain model a configuration
names, and ``layouts/<name>.py`` is the weight layout (leaves, scales,
the work a token needs) of the block kinds it lists.
``harness/`` is the frozen core: traffic, the open loop on the wall
clock, the SLO arithmetic, tracing, the output check and the report.
"""
