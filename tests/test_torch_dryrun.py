"""The port's dry-run end to end through its CLI (``python -m
repro_torch.launch.dryrun`` in a subprocess), the counterparts of
``tests/test_dryrun.py``: a cell is rank 0 of a stand-in production mesh,
its step run on meta tensors. The subprocess reports the modules it
imported: neither ``jax`` nor the JAX package may be among them."""
import json
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# runs the CLI's main, then prints the JAX modules the process imported
_CLI = ("import runpy, sys\n"
        "sys.argv = ['dryrun'] + sys.argv[1:]\n"
        "runpy.run_module('repro_torch.launch.dryrun', run_name='__main__')\n"
        "print('LEAKED', sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'repro.'))))\n")
COLLECTIVE_KEYS = {"all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                   "collective-permute", "n_all-gather", "n_all-reduce",
                   "n_reduce-scatter", "n_all-to-all",
                   "n_collective-permute", "total"}


def _run_cell(arch, shape, mesh, tmpdir):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    cp = subprocess.run(
        [sys.executable, "-c", _CLI, "--arch", arch, "--shape", shape,
         "--mesh", mesh, "--out", str(tmpdir)],
        env=env, capture_output=True, text=True, timeout=300, cwd=REPO)
    assert cp.returncode == 0, cp.stderr[-2000:]
    assert "LEAKED []" in cp.stdout, cp.stdout[-2000:]
    with open(os.path.join(str(tmpdir), f"{arch}__{shape}__{mesh}.json")) as f:
        return json.load(f)


def test_torch_dryrun_decode_cell_pod(tmp_path):
    rec = _run_cell("smollm-360m", "decode_32k", "pod", tmp_path)
    assert rec["status"] == "ok", rec.get("error")
    assert rec["mesh_shape"] == {"data": 16, "model": 16}
    assert rec["flops_per_device"] > 0
    # a Python loop over alike layers: the extrapolation is the count
    assert rec["flops_per_device_extrap"] == rec["flops_per_device"]
    assert rec["bytes_per_device_extrap"] == rec["bytes_per_device"]
    assert set(rec["collectives"]) == COLLECTIVE_KEYS
    # per layer the d_ff-cut MLP's sum and the sequence-parallel
    # attention's two (the rows' log-sum-exp MAX, the weighted outputs'
    # SUM), 96, and the vocabulary-cut embedding's one; the logits'
    # gathers over 'model' (vocabulary) and over 'data' (the batch rows)
    assert rec["collectives"]["n_all-reduce"] == 97
    assert rec["collectives"]["n_all-gather"] == 2
    assert set(rec["collectives_by_axis"]) == {"model", "data"}
    assert 0 < rec["bytes_floor_per_device"] <= rec["bytes_per_device"]
    # under JAX's specs a device holds 722 MB (the compiled JAX record's
    # argument_size_in_bytes, tests/test_torch_dryrun_vs_jax.py) ...
    assert rec["argument_size_in_bytes_spec"] == 722_397_120
    # ... the port's rank 0 holds its 8 rows and 2048 slots of the cache
    # and its 8 tokens, as the specs do, and every query head (15 do not
    # divide 16): the attention weights are its only departures
    named = sorted(d.split(":")[0] for d in rec["departures"])
    assert named == ["params.blocks.wk", "params.blocks.wo",
                     "params.blocks.wq", "params.blocks.wv"]
    assert rec["argument_size_in_bytes_spec"] < \
        rec["argument_size_in_bytes"] < 1.0e9


def test_torch_dryrun_ssm_heads_over_model(tmp_path):
    """mamba2-780m's decode cell on the pod mesh: its 48 SSM heads over 16
    ranks, 3 a rank. The rank's SSD state is the spec's per-device shape,
    norm_w and out_proj are the spec's blocks; only in_proj, conv_w/conv_b
    and the conv tail depart (the rank's heads with B and C whole, where
    the spec cuts contiguous blocks). Per layer the norm's sums of squares
    and out_proj's partial sum are all-reduced over 'model'."""
    rec = _run_cell("mamba2-780m", "decode_32k", "pod", tmp_path)
    assert rec["status"] == "ok", rec.get("error")
    from repro_torch.configs import get_config, get_shape
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_production_mesh
    with make_production_mesh() as mesh:
        cell = D.build_cell(get_config("mamba2-780m"),
                            get_shape("decode_32k"), mesh)
        spec = D.spec_shape(cell.whole["cache"]["ssm"].shape,
                            cell.specs["cache"]["ssm"], mesh)
    assert tuple(cell.tree["cache"]["ssm"].shape) == spec == (
        48, 8, 3, 64, 128)
    named = sorted(d.split(":")[0] for d in rec["departures"])
    assert named == ["cache.conv", "params.blocks.ssm.conv_b",
                     "params.blocks.ssm.conv_w", "params.blocks.ssm.in_proj"]
    # 2,027,315,776 bytes a rank with the SSM whole; JAX's specs hold
    # 136,077,376
    assert rec["argument_size_in_bytes_spec"] == 136_077_376
    assert rec["argument_size_in_bytes_spec"] < \
        rec["argument_size_in_bytes"] < 0.25e9
    # two a layer, and the vocabulary-cut embedding's one
    assert rec["collectives"]["n_all-reduce"] == 2 * 48 + 1
    assert rec["collectives"]["n_all-gather"] == 2


def test_torch_dryrun_multipod(tmp_path):
    rec = _run_cell("smollm-360m", "decode_32k", "multipod", tmp_path)
    assert rec["status"] == "ok", rec.get("error")
    assert rec["mesh_shape"] == {"pod": 2, "data": 16, "model": 16}
    assert rec["flops_per_device"] > 0
    assert set(rec["collectives"]) == COLLECTIVE_KEYS
    # the batch of 128 splits over the 32 data groups of ('pod', 'data')
    # on the port as in the specs: rank 0 holds 4 rows of the cache and
    # tokens, so neither is a departure
    assert not any(d.startswith(("cache.", "tokens"))
                   for d in rec["departures"])
    assert rec["collectives_by_axis"]["data"] > 0
    assert "flops_per_device_extrap" not in rec     # pod cells only
    from repro_torch.configs import get_config, get_shape
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_production_mesh
    with make_production_mesh(multi_pod=True) as mesh:
        cell = D.build_cell(get_config("smollm-360m"),
                            get_shape("decode_32k"), mesh)
        assert cell.tree["cache"]["length"].shape == (4,)
        assert cell.tree["tokens"].shape == (4,)
        assert cell.tree["cache"]["k"].shape[1::2] == (4, 2048)


TRAIN_DEPARTURES = {
    # 15 query heads over 16 (and here over 2): the port keeps whole heads
    "smollm-360m": {"blocks.wq", "blocks.wk", "blocks.wv", "blocks.wo"},
    # the rank's SSM heads with B and C whole, where the spec cuts blocks
    "mamba2-780m": {"blocks.ssm.in_proj", "blocks.ssm.conv_w",
                    "blocks.ssm.conv_b"},
    "granite-moe-3b-a800m": set(),
    "hubert-xlarge": set(),
}


@pytest.mark.parametrize("arch", sorted(TRAIN_DEPARTURES))
def test_torch_dryrun_train_rank_holds_its_shards(arch):
    """A train_4k cell's rank on a (2, 2) stand-in mesh: the params, mu
    and nu are its shards in ``param_specs(train=True)``'s and
    ``opt_state_specs``' layout and the batch its 128 of 256 rows, so
    every leaf but the named departures holds exactly its spec's bytes;
    the departures are the whole-head leaves, in the params and in both
    moments alike."""
    import math

    from repro_torch.configs import get_config, get_shape
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_stand_in_mesh
    with make_stand_in_mesh({"data": 2, "model": 2}) as mesh:
        cell = D.build_cell(get_config(arch), get_shape("train_4k"), mesh)
        spec = D.spec_leaf_bytes(cell, mesh)
        departed = {d.split(":")[0] for d in D.departures(cell, mesh)}
    mine = dict(D._leaves(cell.tree))
    want = {f"{tree}.{leaf}" for tree in ("params", "opt.mu", "opt.nu")
            for leaf in TRAIN_DEPARTURES[arch]}
    assert departed == want
    for path, n in spec.items():
        t = mine[path]
        if path not in departed:
            assert math.prod(t.shape) * t.element_size() == n, path
    assert mine["labels"].shape == (128, 4096)
    held = sum(math.prod(t.shape) * t.element_size() for t in mine.values())
    assert held >= sum(spec.values())
    assert held == sum(spec.values()) or departed


def test_torch_dryrun_encoder_skip(tmp_path):
    rec = _run_cell("hubert-xlarge", "decode_32k", "pod", tmp_path)
    assert rec["status"] == "skip"
    assert "encoder-only" in rec["reason"]


def test_torch_dryrun_long_context_skip():
    # every registry arch with attention has a window; without one JAX's
    # decode_buf_len asserts (an error record), the port names a skip
    import dataclasses

    from repro_torch.configs import get_config, get_shape
    from repro_torch.launch import specs as SP
    cfg = dataclasses.replace(get_config("smollm-360m"), sliding_window=None)
    reason = SP.skip_reason(cfg, get_shape("long_500k"))
    assert "DESIGN.md §4" in reason and "long_500k" in reason
    with pytest.raises(ValueError, match="sub-quadratic"):
        SP.decode_buf_len(cfg, get_shape("long_500k"))
    assert SP.skip_reason(get_config("smollm-360m"),
                          get_shape("long_500k")) is None
    assert SP.decode_buf_len(get_config("smollm-360m"),
                             get_shape("long_500k")) == 8192


def test_torch_roofline_analyzer_on_record():
    from repro_torch.launch.roofline import analyze_record, link_bw
    rec = {"status": "ok", "arch": "yi-6b", "shape": "decode_32k",
           "mesh_shape": {"data": 16, "model": 16},
           "flops_per_device": 4.7e10, "bytes_per_device": 2.4e11,
           "bytes_floor_per_device": 5e10,
           "collectives": {"total": 2e6},
           "collectives_by_axis": {"model": 2e6}}
    row = analyze_record(rec)
    assert row["dominant"] == "memory"   # decode is HBM-bound
    assert row["memory_s"] > row["compute_s"]
    assert row["memory_unfused_s"] > row["memory_s"]
    assert row["chips"] == 256
    assert 0 < row["useful_ratio"] < 5
    # a 16-way axis spans two nodes of 8: InfiniBand; 8 GPUs: NVLink
    assert row["collective_s"] == 2e6 / 50e9
    assert link_bw({"data": 2, "model": 4}, "data") == 450e9
    assert link_bw({"data": 4, "model": 4}, "data") == 50e9
