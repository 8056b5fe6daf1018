"""Device time of a kernel call on the card, and of each pass of a
multi-pass kernel, for chip_smoke.py and the launch scripts that time
kernels."""
from __future__ import annotations

from typing import Callable, Dict, Tuple

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


# kernels of each pass of the multi-pass kernels, by name
ATTENTION_PASSES = {"split": ("split_tc_kernel", "split_cc_kernel"),
                    "combine": ("combine_kernel",)}
SSD_PASSES = {"chunk states": ("state_tc_kernel", "state_cc_kernel"),
              "state passing": ("state_pass_kernel",),
              "chunk outputs": ("out_tc_kernel", "out_cc_kernel")}


def passes_us(fn: Callable[[], object], passes: Dict[str, Tuple[str, ...]],
              iters: int = 20) -> Dict[str, float]:
    """Device microseconds a call of ``fn`` spends in each pass, from
    torch.profiler over ``iters`` calls: a kernel counts towards a pass
    when its name contains one of the pass's names. A profile that saw
    none of the passes' kernels (it happens now and then on a first
    profile) is taken once more."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = {k: 0.0 for k in passes}
        for e in prof.key_averages():
            t = getattr(e, "self_device_time_total", None)
            t = float(t if t is not None
                      else getattr(e, "self_cuda_time_total", 0))
            for k, names in passes.items():
                if any(n in e.key for n in names):
                    us[k] += t / iters
        if any(us.values()):
            break
    return us
