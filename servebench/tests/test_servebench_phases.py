"""The readers of the port's phase spans (``harness/phases.py``) on a
synthetic window whose values are worked out by hand: each reader gives
its value; every one gives None where a kind's spans and ops differ in
number, and where the spans carry no phases, as a program without them
gives (the last also without the ``engine_setup`` instant)."""
import pytest

from repro_torch.serving.trace import TraceEvent
from servebench.harness import registry
from servebench.harness.openloop import LoopStats, Op
from servebench.harness.window import Window

READERS = ["decode_stage_ms", "decode_graph_ms", "decode_commit_ms",
           "device_unfed_share", "graph_make_s"]
# (kind, t0, t1, profiled, span args): the window is 1 s; the first
# profiled op starts at 500 ms; the last decode is the drain's
OPS = [("prefill", 0, 20, False, dict(stage_ms=2, graph_ms=15, commit_ms=3)),
       ("decode", 20, 30, False, dict(stage_ms=1, graph_ms=8, commit_ms=1)),
       ("decode", 30, 42, False, dict(stage_ms=3, graph_ms=8, commit_ms=1)),
       ("chunk", 50, 70, False, dict(stage_ms=1, graph_ms=14, commit_ms=2)),
       ("decode", 500, 512, True, dict(stage_ms=2, graph_ms=9, commit_ms=1)),
       ("decode", 600, 610, True, dict(stage_ms=2, graph_ms=7, commit_ms=1)),
       ("decode", 1005, 1015, False, dict(stage_ms=5, graph_ms=9,
                                          commit_ms=1))]
SPAN = {"prefill": "prefill", "chunk": "prefill_chunk", "decode": "decode"}
EXPECTED = {
    "decode_stage_ms": (1 + 3) / 2,
    "decode_graph_ms": (8 + 8) / 2,
    "decode_commit_ms": 1.0,
    # ops ended by 500 ms ran graphs for 15 + 8 + 8 + 14 ms
    "device_unfed_share": 100.0 * (1 - 45 / 500),
    "graph_make_s": 2.5,
}


def _window(drop_decode=False, phases=True, setup=True):
    ops, events = [], []
    if setup:
        events.append(TraceEvent(0.0, "engine_setup", -1, "engine", 0.0,
                                 {"captures": 40, "make_ms": 2500.0}))
    for serial, (kind, t0, t1, prof, ph) in enumerate(OPS):
        ops.append(Op(kind, serial, t0, t1, t1 - t0, [serial], [8], prof))
        args = {"n": 1, "wait_ms": t1 - t0}
        if phases:
            args.update(ph, gaps_ms=0.0, graphs=1, captures=0)
        events.append(TraceEvent(float(t0), "arrive", serial))
        events.append(TraceEvent(float(t0), SPAN[kind], serial, "engine",
                                 float(t1 - t0), args))
    if drop_decode:                        # one decode span fewer than ops
        events.remove(next(e for e in events if e.kind == "decode"))
    loop = LoopStats({}, {}, 1015.0, 0, 0, len(OPS), 0.0)
    return Window({}, 2, 1.0, [], {}, loop, ops, events, {})


@pytest.mark.parametrize("name", READERS)
def test_reader_gives_its_hand_computed_value(name):
    got = registry.layer_metric(name).read(_window())
    assert got == pytest.approx(EXPECTED[name], rel=1e-12)


@pytest.mark.parametrize("name", READERS[:4])
def test_reader_gives_none_where_spans_and_ops_differ(name):
    assert registry.layer_metric(name).read(_window(drop_decode=True)) is None


@pytest.mark.parametrize("name", READERS)
def test_reader_gives_none_without_phases(name):
    w = _window(phases=False, setup=False)
    assert registry.layer_metric(name).read(w) is None
