import pytest

from servebench.harness import slo, window
from servebench.harness.openloop import LoopStats
from servebench.harness.traffic import SLO, Request


def req(rid, due, out, realtime=False, ttft=2000.0, tpot=100.0, dl=None):
    return Request(rid, due, "x", 10, out, SLO(realtime, ttft, tpot, dl), 1.0)


def test_tpot_leaves_out_the_first_gap():
    assert slo.tpot_ms([0.0, 500.0, 510.0, 530.0]) == pytest.approx(15.0)
    assert slo.tpot_ms([0.0, 7.0]) == 7.0
    assert slo.tpot_ms([3.0]) is None


def test_slo_met_by_class():
    rt = req(1, 100.0, 3, realtime=True, ttft=375, tpot=562.5, dl=1500.0)
    assert slo.slo_met(rt, [200.0, 900.0, 1600.0], False)
    assert not slo.slo_met(rt, [200.0, 900.0, 1601.0], False)
    qa = req(2, 0.0, 4)
    assert slo.slo_met(qa, [2000.0, 2100.0, 2200.0, 2300.0], False)
    assert not slo.slo_met(qa, [2001.0, 2100.0, 2200.0, 2300.0], False)
    assert not slo.slo_met(qa, [10.0, 20.0, 200.0, 401.0], False)
    assert not slo.slo_met(qa, [10.0, 20.0, 30.0], False)       # unfinished
    assert not slo.slo_met(qa, [10.0, 20.0, 30.0, 40.0], True)  # failed


def test_failed_requests_count_at_give_up_in_both_tails():
    r = req(1, 1000.0, 5)
    assert slo.latency_samples(r, [], True, 9000.0) == (8000.0, 8000.0)
    assert slo.latency_samples(r, [1010.0], True, 9000.0) == (10.0, 8000.0)
    assert slo.latency_samples(r, [1010.0, 1020.0, 1030.0, 1050.0, 1070.0],
                               False, 0.0) == (10.0, 50.0 / 3)


def test_end_to_end_on_hand_made_stamps():
    reqs = [req(i, 100.0 * i, 3) for i in range(20)]
    stamps = {r.rid: [r.due_ms + 10 + i, r.due_ms + 50 + i,
                      r.due_ms + 60 + 2 * i] for i, r in enumerate(reqs)}
    stamps[19] = [1950.0]                       # unfinished at give-up
    loop = LoopStats({}, {19: 2500.0}, 2500.0, 0, 0, 1, 0.0)
    w = window.Window({}, 2, 2.0, reqs, stamps, loop, [])
    m = window.end_to_end(w, 12.5)
    assert m["slo_attainment"] == pytest.approx(100.0 * 19 / 20)
    ttfts = [10.0 + i for i in range(19)] + [1950.0 - 1900.0]
    assert m["ttft_p95_ms"] == pytest.approx(slo.percentile(ttfts, 95))
    tpots = [10.0 + i for i in range(19)] + [2500.0 - 1900.0]
    assert m["tpot_p95_ms"] == pytest.approx(slo.percentile(tpots, 95))
    # tokens stamped before 2,000 ms, over the window's 2 s
    n = sum(t < 2000.0 for st in stamps.values() for t in st)
    assert m["output_tokens_per_s"] == pytest.approx(n / 2.0)
    assert m["setup_s"] == 12.5
