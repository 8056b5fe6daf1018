"""The whole run of a cell on the CPU at a small size, through the
harness's own path, compared by the numbers the cell's file names: sound,
it is correct; with a token altered where the engine produces it, it is
not; and the float8 control, judged by the same comparison and limits,
is not correct either, reading at least three times what the engine
does. Prompts go in whole, as the cells send them, and in chunks of 32,
which the harness and the reference support for cells that chunk."""
import pytest

from helpers_servebench import TINY_DENSE, TINY_MOE, tiny_mix
from servebench.harness import check, cli, registry

BENCH = registry.benchmark()
CASES = [("edge-6b.paper-mix", TINY_DENSE, None),
         ("edge-6b.paper-mix", TINY_DENSE, 32),
         ("granite-moe-3b-a800m.paper-mix", TINY_MOE, None)]
IDS = ["edge-6b", "edge-6b-chunked", "granite"]
SEED = 2**31 + 17
CONTROL_SEEDS = [2**31 + 23, 2**31 + 29, 2**31 + 31]


def _spec(cell_name):
    """The cell's own file, at a CPU run's rate and sample size."""
    spec = dict(registry.cell_file(cell_name))
    spec.update(rate_per_s=3.0, min_tokens_compared=20)
    return spec


def _run(cell_name, model, chunk, seed, control=False):
    cell = registry.cell(BENCH, cell_name)
    return cli.run_cell(cell, BENCH, seed, 3.0, False, device="cpu",
                        model=model, mix=tiny_mix(cell["traffic"], chunk),
                        cell_spec=_spec(cell_name), control=control,
                        log=lambda s: None)


@pytest.mark.parametrize("cell_name,model,chunk", CASES, ids=IDS)
def test_sound_run_is_correct(cell_name, model, chunk):
    out = _run(cell_name, model, chunk, SEED)
    assert out["correct"], out["checks"]
    # a loaded CPU may stall the wall-clock loop past a realtime deadline,
    # and SLICE drops such a task; the check needs only finished ones
    assert out["failed"] < out["attempted"] == 9
    assert list(out)[-1] == "checks"
    assert set(out["checks"]) == set(_spec(cell_name)["limits"]) | {
        "tokens_compared"}
    assert set(out["metrics"]) == {
        m["name"] for m in registry.metrics_of(BENCH, "end_to_end",
                                               cell_name)}


@pytest.mark.parametrize("cell_name,model,chunk", CASES, ids=IDS)
def test_a_token_altered_where_it_is_produced_is_caught(cell_name, model,
                                                        chunk, monkeypatch):
    from repro_torch.serving import executor
    produce = executor.with_argmax

    def altered(logits):
        lg, arg = produce(logits)
        return lg, (arg + 1) % logits.shape[-1]
    monkeypatch.setattr(executor, "with_argmax", altered)
    out = _run(cell_name, model, chunk, SEED)
    assert not out["correct"]
    assert any(c["value"] > c["limit"] for k, c in out["checks"].items()
               if k != "tokens_compared")


@pytest.mark.parametrize("seed", CONTROL_SEEDS)
@pytest.mark.parametrize("cell_name,model,chunk", CASES, ids=IDS)
def test_float8_control_reads_far_above_the_engine(cell_name, model, chunk,
                                                   seed):
    out = _run(cell_name, model, chunk, seed, control=True)
    readings = {k: c["value"] for k, c in out["checks"].items()}
    spec = _spec(cell_name)
    assert check.verdict(readings, spec)[0] and out["correct"]
    ctl_ok, ctl_checks = check.verdict(check.control_readings(readings),
                                       spec)
    assert not ctl_ok, ctl_checks
    for name in spec["limits"]:
        gap, ctl = readings[name], readings["control_" + name]
        assert ctl >= 3 * gap, (name, gap, ctl)


@pytest.mark.parametrize("cell_name,model,chunk", CASES, ids=IDS)
def test_traced_run_reads_the_cells_per_layer_metrics(cell_name, model,
                                                      chunk):
    """On the CPU there is no device profile: the readers of the device
    trace return nothing, the others read the run's counters and spans."""
    cell = registry.cell(BENCH, cell_name)
    out = cli.run_cell(cell, BENCH, SEED, 3.0, True, device="cpu",
                       model=model, mix=tiny_mix(cell["traffic"], chunk),
                       cell_spec=_spec(cell_name), log=lambda s: None)
    listed = {m["name"]: m for m in registry.metrics_of(BENCH, "per_layer",
                                                        cell_name)}
    assert set(out["metrics"]) <= set(listed)
    host = {n for n, m in listed.items() if m["source"] != "device_trace"}
    assert host <= set(out["metrics"])
    assert all(v["value"] >= 0 for v in out["metrics"].values())
    assert "breakdown" not in out and out["correct"]
