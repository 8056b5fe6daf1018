"""Every name in BENCHMARK.json finds its file, within the contract's
limits on names and sizes."""
import json
import re

import pytest

from servebench.harness import registry, weights

BENCH = registry.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("cell_name", CELLS)
def test_each_cell_finds_its_files(cell_name):
    cell = registry.cell(BENCH, cell_name)
    cfg = registry.config(cell["cfg"])
    assert cfg["name"] == cell["config"]
    assert cfg["source"] == cell["cfg"]["source"]
    assert cfg["reduced"] == cell["cfg"]["reduced"] == []
    assert hasattr(registry.reference(cfg["reference"]), "forward")
    mix = registry.traffic(cell["traffic"])
    assert mix["scheduler"] == "slice"
    spec = registry.cell_file(cell_name)
    assert spec["rate_per_s"] > 0 and spec["limits"]
    assert all(v > 0 for v in spec["limits"].values())
    assert cell["chips"] == 1
    for m in registry.metrics_of(BENCH, "per_layer", cell_name):
        assert callable(registry.layer_metric(m["name"]).read)
        moved = registry.metrics_of(BENCH, "end_to_end", cell_name)
        assert m["moves"] in {e["name"] for e in moved}


def test_names_and_sizes_keep_to_the_contract():
    assert len(json.dumps(BENCH)) < 64 * 1024
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert {e["name"] for e in BENCH["end_to_end"]} >= {"setup_s"}
    for e in BENCH["end_to_end"]:
        assert 0.01 <= e["bound"] <= 0.25
        assert e["source"] in ("host_clock", "device_trace")
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert layers == {"open loop", "scheduler", "engine", "model step",
                      "kernels", "device"}
    for m in BENCH["per_layer"]:
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_config_files_state_the_published_widths():
    edge = registry.load_json(registry.BENCH_DIR / "configs/edge-6b.json")
    p = edge["port"]
    assert (p["n_layers"], p["d_model"], p["n_heads"], p["n_kv_heads"],
            p["head_dim"], p["d_ff"], p["vocab_size"]) == (
        edge["num_layers"], edge["hidden_size"], edge["num_attention_heads"],
        edge["multi_query_group_num"], edge["kv_channels"],
        edge["ffn_hidden_size"], edge["padded_vocab_size"])
    assert 6.2e9 < weights.n_params(p) < 6.3e9
    g = registry.load_json(
        registry.BENCH_DIR / "configs/granite-moe-3b-a800m.json")
    p = g["port"]
    assert (p["n_layers"], p["d_model"], p["n_heads"], p["n_kv_heads"],
            p["d_ff"], p["n_experts"], p["top_k"], p["vocab_size"]) == (
        g["num_hidden_layers"], g["hidden_size"], g["num_attention_heads"],
        g["num_key_value_heads"], g["intermediate_size"],
        g["num_local_experts"], g["num_experts_per_tok"], g["vocab_size"])
    assert p["head_dim"] * p["n_heads"] == p["d_model"]
    assert 3.2e9 < weights.n_params(p) < 3.5e9
