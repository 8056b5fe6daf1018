import copy
from collections import Counter

import pytest

from servebench.harness import registry, traffic


def _documents():
    """The paper mix with QA prompts drawn lognormal, as a document mix
    would state them."""
    mix = copy.deepcopy(registry.traffic("paper-mix"))
    mix["classes"][2]["prompt"] = {"dist": "lognormal", "median": 1536,
                                   "sigma": 0.4, "lo": 512, "hi": 3584}
    return mix


@pytest.mark.parametrize("make", [lambda: registry.traffic("paper-mix"),
                                  _documents], ids=["paper-mix", "lognormal"])
def test_traffic_repeats_per_seed_and_serves_the_same_work(make):
    mix = make()
    a = traffic.generate(mix, 2**31 + 99, 20.0, 12.0)
    b = traffic.generate(mix, 2**31 + 99, 20.0, 12.0)
    c = traffic.generate(mix, 5, 20.0, 12.0)
    assert a == b
    assert a != c
    assert len(a) == len(c) == 240
    work = lambda rs: Counter((r.kind, r.prompt_len, r.output_len) for r in rs)
    assert work(a) == work(c)
    # the same arrival times and classes; only the lengths dealt anew
    assert [(r.due_ms, r.kind) for r in a] == [(r.due_ms, r.kind) for r in c]
    assert all(0 < r.due_ms < 20_000 for r in a)
    assert [r.due_ms for r in a] == sorted(r.due_ms for r in a)
    shares = Counter(r.kind for r in a)
    for cls in mix["classes"]:
        assert abs(shares[cls["kind"]] - cls["share"] * 240) <= 1
        lo, hi = cls["prompt"]["lo"], cls["prompt"]["hi"]
        assert all(lo <= r.prompt_len <= hi for r in a
                   if r.kind == cls["kind"])


def test_traffic_slos_are_the_papers_fixed_classes():
    mix = registry.traffic("paper-mix")
    for r in traffic.generate(mix, 3, 10.0, 10.0):
        if r.kind == "control":
            assert r.slo.realtime and r.slo.deadline_ms == 1500
            assert r.slo.ttft_ms == 375
            assert r.slo.tpot_ms == pytest.approx(1125 / (r.output_len - 1))
            assert 32 <= r.prompt_len <= 95 and r.output_len >= 6
        else:
            assert not r.slo.realtime and r.slo.ttft_ms == 2000
            assert r.slo.tpot_ms == {"voice": 125, "qa": 100}[r.kind]


def test_counts_split_by_largest_remainder():
    assert traffic.counts([0.7, 0.15, 0.15], 10) == [7, 2, 1]
    assert sum(traffic.counts([0.3, 0.7], 77)) == 77


def test_holdout_base_seed_is_another_trace_of_the_same_mix():
    mix = registry.traffic("paper-mix")
    held = {**mix, "base_seed": mix["holdout_base_seed"]}
    a = traffic.generate(mix, 11, 20.0, 12.0)
    b = traffic.generate(held, 11, 20.0, 12.0)
    assert [r.due_ms for r in a] != [r.due_ms for r in b]
    assert Counter(r.kind for r in a) == Counter(r.kind for r in b)
    assert len(b) == 240 and all(0 < r.due_ms < 20_000 for r in b)
