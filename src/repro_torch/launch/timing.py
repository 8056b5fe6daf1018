"""Device time of a kernel call on the card, for chip_smoke.py and the
launch scripts that time kernels."""
from __future__ import annotations

from typing import Callable

import torch

SPIN_CYCLES = 200_000_000            # ~0.1 s at the H100's clock


def time_ms(fn: Callable[[], object], iters: int = 30, warmup: int = 3,
            queued: bool = True) -> float:
    """Device time of one call: CUDA events around ``iters`` calls after
    ``warmup`` ones. ``queued``: a spin kernel (``torch.cuda._sleep``,
    ~0.1 s) goes first, so the host has enqueued the calls before the
    device reaches them and the events time them back to back; without
    it a call shorter than its wrapper's host path (checks and the ctypes
    call take tens of microseconds) is timed at the host's pace."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters
