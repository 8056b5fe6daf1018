"""The port's l(b) probe (``serving.executor._probe_latency_curve``) made
non-decreasing in the batch (``monotone_samples``), a departure from
JAX's probe, which keeps its samples as read.

Four gloo ranks probing on one shared host once read l(1) = 538.3 ms
against l(4) = 372.6 ms (the slowest rank's sample each); scaled by that
curve, SLICE found every task Eq. 7-infeasible and served none. A fake
engine whose clock reads those numbers (l(2) between them, l(8) as
l(4)), serving the workload of that run (``chip_smoke.py``'s
``paged-mesh-moe``: 8 slots, max-seq 1024, 2 requests/s for 4 s, no
realtime tasks) on a simulated engine priced by the curve, shows the
fault with the samples as read and every task admitted and finished with
the repaired curve. Where the samples rise the repair changes nothing,
so the port's engines stay equal to JAX's on the priced clocks of the
equivalence tests.
"""
from __future__ import annotations

import pytest

pytest.importorskip("torch")

from repro_torch.core.latency_model import MeasuredLatencyModel  # noqa: E402
from repro_torch.core.schedulers import SliceScheduler  # noqa: E402
from repro_torch.core.task import qa_task  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.serving.executor import (Executor, SimExecutor,  # noqa: E402
                                          _probe_latency_curve,
                                          monotone_samples)
from repro_torch.serving.loop import run_serving_loop  # noqa: E402

# the slowest rank's probe of one chip run: l(1) above l(4); l(2) between
SLOW_FIRST = {1: 538.3, 2: 455.45, 4: 372.6, 8: 372.6}


class FakeClock(Executor):
    """An engine whose decode step of b tasks reads ``ms[b]``."""

    def __init__(self, ms):
        self.ms = ms
        self.batches = []

    def decode(self, tasks, depths=None):
        self.batches.append(len(tasks))
        return self.ms[len(tasks)]


def _serve(lat):
    """The chip run's workload scaled to ``lat`` and served by SLICE on a
    simulated engine priced by ``lat``."""
    args = serve.parse_args(["--duration", "4", "--rate", "2", "--slots",
                             "8", "--max-seq", "1024", "--ratio", "0"])
    tasks = serve._workload(args)
    serve.shape_workload(tasks, [lat], args.slots, args.max_seq)
    return run_serving_loop(SliceScheduler(lat), SimExecutor(lat), tasks,
                            max_ms=3e7)


def test_slow_first_sample_no_longer_defers_every_task():
    clock = FakeClock(SLOW_FIRST)
    lat, read = _probe_latency_curve(clock, [qa_task() for _ in range(8)],
                                     [1, 2, 4, 8])
    assert clock.batches == [b for b in (1, 2, 4, 8) for _ in range(4)]
    assert read == sorted(SLOW_FIRST.items())           # kept as read
    assert [lat.decode_ms(b) for b in (1, 2, 4, 8)] == [372.6] * 4
    raw = _serve(MeasuredLatencyModel(sorted(SLOW_FIRST.items())))
    assert raw.decode_iterations == 0                       # the fault
    assert not any(t.finished for t in raw.tasks)
    res = _serve(lat)
    assert res.decode_iterations > 0
    assert all(t.finished and not t.dropped for t in res.tasks)


@pytest.mark.parametrize("samples", [
    [(1, 10.0), (2, 10.5), (4, 12.25), (8, 20.0)],
    [(1, 3.0), (2, 3.0), (4, 3.0)],
    [(1, 7.5)]])
def test_rising_samples_are_unchanged(samples):
    assert monotone_samples(samples) == samples
    clock = FakeClock(dict(samples))
    lat, read = _probe_latency_curve(clock, [qa_task() for _ in range(8)],
                                     [b for b, _ in samples])
    assert [(b, lat.decode_ms(b)) for b, _ in samples] == samples == read


def test_each_sample_is_the_least_at_or_above_its_batch():
    assert monotone_samples([(1, 9.0), (2, 4.0), (4, 6.0), (8, 5.0)]) == [
        (1, 4.0), (2, 4.0), (4, 5.0), (8, 5.0)]
