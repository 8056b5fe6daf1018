"""Workload generation (paper §VI-A): Poisson arrivals of a mix of real-time
(machine control / navigation) and non-real-time (voice chat, text Q&A)
tasks, arrival rates 0.1-7.0 tasks/s, configurable RT:non-RT ratio."""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core.task import Task, control_task, qa_task, voice_task


def poisson_workload(rate_per_s: float, duration_s: float,
                     realtime_frac: float = 0.7, seed: int = 0,
                     rt_utility: float = 50.0, nrt_utility: float = 1.0,
                     rt_output_len: int = 12,
                     voice_output_len: int = 256,
                     qa_output_len: int = 288,
                     rt_prompt: Tuple[int, int] = (32, 96),
                     voice_prompt: Tuple[int, int] = (64, 192),
                     qa_prompt: Tuple[int, int] = (128, 384),
                     shared_prefix_frac: float = 0.0,
                     prefix_pool: int = 4,
                     prefix_len_range: Tuple[int, int] = (64, 192)) -> List[Task]:
    """RT tasks are short control bursts; non-RT voice/QA run longer
    (the paper: 'real-time tasks typically consist of short-duration
    operations ... non-real-time tasks feature longer execution cycles').

    The prompt-length ranges are overridable so sweeps can shape the mix
    (e.g. the long-prompt regime of benchmarks/prefill_interference.py).

    shared_prefix_frac (DESIGN.md §6): that fraction of tasks opens with a
    shared system prompt drawn from a deterministic per-seed pool of
    ``prefix_pool`` prefixes (each with a fixed length from
    ``prefix_len_range``, capped at the task's own prompt). The draws come
    from a SEPARATE rng stream, so sweeping the knob changes prefix reuse
    without perturbing the arrival process or the task attribute stream —
    runs at different fracs stay comparable task for task.
    """
    rng = np.random.default_rng(seed)
    prng = np.random.default_rng((seed + 1) * 1_000_003 + 17)
    pool_lens = [int(prng.integers(*prefix_len_range))
                 for _ in range(max(prefix_pool, 1))]
    t_ms = 0.0
    tasks: List[Task] = []
    # Non-RT splits voice:qa 50:50. Kind comes from ONE categorical draw and
    # every branch consumes the same number of rng draws, so the arrival
    # process and per-task attribute streams are identical across
    # realtime_frac values at a fixed seed (comparable sweeps).
    voice_cut = realtime_frac + (1.0 - realtime_frac) / 2.0
    while True:
        t_ms += rng.exponential(1000.0 / rate_per_s)
        if t_ms > duration_s * 1000.0:
            break
        r = rng.random()
        if r < realtime_frac:
            tasks.append(control_task(
                arrival_ms=t_ms,
                prompt_len=int(rng.integers(*rt_prompt)),
                output_len=max(6, int(rng.normal(rt_output_len, 2))),
                utility=rt_utility))
        elif r < voice_cut:
            tasks.append(voice_task(
                arrival_ms=t_ms,
                prompt_len=int(rng.integers(*voice_prompt)),
                output_len=max(16, int(rng.normal(voice_output_len, 16))),
                utility=nrt_utility))
        else:
            tasks.append(qa_task(
                arrival_ms=t_ms,
                prompt_len=int(rng.integers(*qa_prompt)),
                output_len=max(16, int(rng.normal(qa_output_len, 32))),
                utility=nrt_utility))
        # prefix draws always consume the same prng stream, whatever the
        # frac, so the assignment (not just the arrivals) is sweep-stable
        u, g = prng.random(), int(prng.integers(len(pool_lens)))
        if u < shared_prefix_frac:
            t = tasks[-1]
            t.prefix_group = g
            t.prefix_len = min(t.prompt_len, pool_lens[g])
    return tasks


def static_table2_workload(rt_like: bool = False) -> List[Task]:
    """Paper Table II: 9 simultaneous tasks — 3x A (TPOT 100 ms),
    4x B (120 ms), 2x C (250 ms), all arriving at t=0."""
    from repro_torch.core.task import SLOSpec
    tasks = []
    specs = [("A", 100.0, 3), ("B", 120.0, 4), ("C", 250.0, 2)]
    for kind, tpot, n in specs:
        for _ in range(n):
            tasks.append(Task(SLOSpec(tpot_ms=tpot, ttft_ms=5000.0),
                              utility=1.0, prompt_len=64, output_len=60,
                              arrival_ms=0.0, kind=kind))
    return tasks
