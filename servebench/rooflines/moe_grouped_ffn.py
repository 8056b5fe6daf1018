"""The grouped-expert FFN (``csrc/moe_grouped_ffn.cu``: its gate-up and
down kernels). Only its time is read for now: its work depends on the
experts each step routes to, which the program does not report yet."""
from __future__ import annotations

import re

KERNEL = re.compile(r"::(tc|cc)::(gate_up|down)[<(]")
