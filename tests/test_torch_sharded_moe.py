"""MoE archs and a 'data' axis on the port's tensor-parallel paged engine
(DESIGN.md §9) on the CPU: the layouts ``tests/test_torch_sharded.py``
leaves out.

- granite-moe reduced (4 experts, top-2) over (1, 2) and (1, 4):
  expert-parallel, 2 experts and 1 a rank;
- the same with 3 experts over (1, 2): tensor-parallel inside each
  expert (256 of the 512 d_ff columns a rank);
- smollm reduced (4 KV heads) and granite-moe reduced over (2, 1) and
  (2, 2): the decode and verify batches of buckets 2 and 4 split over the
  two data groups, bucket 1 and every prefill computed whole by both.

Every rank runs each op sequence of ``test_torch_sharded`` (atomic and
chunked prefill, decode across a bucket change, spec verify,
suspend/resume, prefix sharing, greedy streams) on its slab, and JAX's
single-device ``PagedJaxExecutor`` runs the same sequence on the same
weights (JAX's ``init_params`` through ``load_params``) with the same
engine settings here: logits within 1e-5 (``helpers.ATOL``, fp32), streams
byte-identical, the same pool and swap bookkeeping. The (2, 2) prefill
and decode are also held to JAX's own (2, 2) mesh engine. On (2, 2): every
rank's loop clock and digest equal across both data groups, the
divergence guard fires when one data group's host inputs differ. The
CLI's ``--mesh-shape 2,2`` on granite-moe. No rank
imports JAX or the JAX package.

One 2-rank and one 4-rank group (``ranks2``, ``ranks4``), each spawned
once, run every case of their layouts on every rank.
"""
from __future__ import annotations

import dataclasses
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_sharded import (ENGINE, SPEC, TIMEOUT, _close,  # noqa: E402
                                _engine, _jmk, _mk, _rank_clock,
                                seq_chunked, seq_prefill_decode, seq_prefix,
                                seq_spec, seq_streams, seq_swap)

MOE = "granite-moe-3b-a800m"

# name -> (engine settings beside ENGINE, the op sequence)
SEQS = {
    "prefill_decode": ({}, seq_prefill_decode),
    "chunked": ({"prefill_chunk_size": 8},
                lambda ex, mk: seq_chunked(ex, mk, True)),
    "spec": ({"draft": True, **SPEC}, seq_spec),
    "swap": ({}, lambda ex, mk: seq_swap(ex, mk, True)),
    "prefix": ({"n_pages": 32, "max_seq": 96, "prefix_cache": True},
               seq_prefix),
    "streams": ({}, seq_streams),
}
# layout -> (ranks, (data, model), weights, op sequences)
LAYOUTS = {
    "ep2": (2, (1, 2), "moe", list(SEQS)),
    "tp2": (2, (1, 2), "moe3", ["prefill_decode", "chunked", "spec"]),
    "data2_dense": (2, (2, 1), "mha", list(SEQS)),
    "data2_moe": (2, (2, 1), "moe", list(SEQS)),
    "ep4": (4, (1, 4), "moe", list(SEQS)),
    "data2x2_dense": (4, (2, 2), "mha", list(SEQS)),
    "data2x2_moe": (4, (2, 2), "moe", list(SEQS)),
}
CASES = [(layout, seq) for layout, (*_, seqs) in LAYOUTS.items()
         for seq in seqs]


# ---------------------------------------------------------- the ranks

def _port_cfg(weights):
    from repro_torch.configs import get_config
    if weights == "mha":
        return dataclasses.replace(get_config("smollm-360m").reduced(),
                                   n_kv_heads=4)
    cfg = get_config(MOE).reduced()
    return cfg if weights == "moe" else dataclasses.replace(cfg,
                                                            n_experts=3)


def _run_seq(ctx, seq):
    kw, fn = SEQS[seq]
    return fn(_engine(ctx, **kw), _mk)


def _rank_guard(ctx):
    """Data group 1's ranks feed another token: every rank, of both data
    groups, raises 'ranks diverged'."""
    ex = _engine(ctx)
    tasks = _mk([(301, 9, 8), (302, 6, 8)])
    for t in tasks:
        ex.prefill(t)
    ex.decode(tasks)
    if ctx.mesh.coords["data"] == 1:
        ex._last_tok[tasks[0].task_id] += 1
    try:
        ex.decode(tasks)
    except RuntimeError as e:
        return str(e)
    return None


def _rank_slab(ctx):
    """The shapes of the rank's MoE leaves."""
    return {k: tuple(v.shape)
            for k, v in _engine(ctx).params["blocks"]["moe"].items()}


EXTRA = {"ep2": {"slab": _rank_slab}, "tp2": {"slab": _rank_slab},
         "ep4": {"slab": _rank_slab},
         "data2x2_dense": {"clock": _rank_clock, "guard": _rank_guard},
         "data2x2_moe": {"clock": _rank_clock}}


def _rank_main(rank, world, trees):
    """A spawned rank: every layout of ``world`` ranks on its mesh (each
    mesh made once, in the same order on every rank), each case on this
    rank's slab; returns {(layout, case): what the rank saw} and the JAX
    modules it imported (none)."""
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import make_serving_mesh
    meshes, out = {}, {}
    for layout, (ranks, shape, weights, seqs) in LAYOUTS.items():
        if ranks != world:
            continue
        if shape not in meshes:
            meshes[shape] = make_serving_mesh(data=shape[0], model=shape[1])
        ctx = types.SimpleNamespace(rank=rank, mesh=meshes[shape],
                                    tree=trees[weights],
                                    cfg=_port_cfg(weights))
        for seq in seqs:
            out[layout, seq] = _run_seq(ctx, seq)
        for name, fn in EXTRA.get(layout, {}).items():
            out[layout, name] = fn(ctx)
    out["leaked"] = sorted(m for m in sys.modules if m == "jax"
                           or m.startswith(("jax.", "repro.")))
    return out


# ---------------------------------------------------- fixtures (JAX side)

@pytest.fixture(scope="module")
def weights():
    """weights name -> (JAX cfg, JAX params, numpy tree)."""
    import jax
    from repro.models import model as JM

    from helpers import reduced_cfg, sharded_test_cfg
    moe = reduced_cfg(MOE)
    out = {}
    for name, cfg in (("mha", sharded_test_cfg(ways=4)), ("moe", moe),
                      ("moe3", dataclasses.replace(moe, n_experts=3))):
        params = JM.init_params(cfg, jax.random.PRNGKey(0))
        out[name] = (cfg, params, _numpy(params))
    return out


def _numpy(node):
    """A JAX params tree as numpy arrays in plain dicts (a NamedTuple such
    as ``MoEParams`` would import the JAX package into the rank that
    unpickles it)."""
    if hasattr(node, "_asdict"):
        node = node._asdict()
    if isinstance(node, dict):
        return {k: _numpy(v) for k, v in node.items()}
    return np.asarray(node)


def _spawn(weights, tmp_path_factory, world):
    from repro_torch.launch.mesh import spawn_ranks
    trees = {k: v[2] for k, v in weights.items()}
    return spawn_ranks(_rank_main, world, (world, trees), timeout=TIMEOUT,
                       store_dir=str(tmp_path_factory.mktemp(f"moe{world}")))


@pytest.fixture(scope="module")
def ranks2(weights, tmp_path_factory):
    return _spawn(weights, tmp_path_factory, 2)


@pytest.fixture(scope="module")
def ranks4(weights, tmp_path_factory):
    return _spawn(weights, tmp_path_factory, 4)


@pytest.fixture(scope="module")
def jax_seen(weights):
    """(weights, sequence) -> what JAX's single-device engine saw, each
    computed once."""
    from helpers import make_paged_engine
    memo = {}

    def seen(name, seq, mesh=None):
        key = (name, seq, mesh is not None)
        if key not in memo:
            cfg, params, _ = weights[name]
            kw = {**ENGINE, **SEQS[seq][0]}
            kw.pop("seed")
            if kw.pop("draft", False):
                kw.update(spec_decode=True, draft_cfg=cfg,
                          draft_params=params)
            if mesh is not None:
                kw["mesh"] = mesh
            memo[key] = SEQS[seq][1](
                make_paged_engine(cfg, params=params, **kw), _jmk)
        return memo[key]

    return seen


def _ranks(request, layout):
    return request.getfixturevalue(f"ranks{LAYOUTS[layout][0]}")


def _check(got, want, what):
    if "streams" in want and "accepted" in want:       # spec: exact
        assert got == want, what
        assert want["accepted"] > 0
    else:
        _close(got, want, what)
    if "used" in want:
        assert want["used"] == 0


# -------------------------------------------------------------- layouts

@pytest.mark.parametrize("layout,seq", CASES,
                         ids=[f"{a}-{b}" for a, b in CASES])
def test_layout_matches_jax_single_device(request, jax_seen, layout, seq):
    """Every rank of the layout, on the op sequence, against JAX's
    single-device engine on the same weights: logits within 1e-5, streams
    and the pool and swap bookkeeping equal."""
    want = jax_seen(LAYOUTS[layout][2], seq)
    for r, res in enumerate(_ranks(request, layout)):
        _check(res[layout, seq], want, f"{layout} {seq} rank {r}")


@pytest.mark.parametrize("layout", ["data2x2_dense", "data2x2_moe"])
def test_data2x2_matches_jax_mesh_engine(request, jax_seen, layout):
    """Prefill and decode across a split (3 tasks: bucket 4) and a
    replicated (bucket 1) batch on JAX's own (2, 2) mesh engine over the
    forced host devices: the ranks' logits within 1e-5 of it too."""
    import jax

    from repro.launch.mesh import make_serving_mesh
    if jax.device_count() < 4:
        pytest.skip("needs 4 devices "
                    "(XLA_FLAGS=--xla_force_host_platform_device_count=4)")
    want = jax_seen(LAYOUTS[layout][2], "prefill_decode",
                    mesh=make_serving_mesh(model=2, data=2))
    for r, res in enumerate(_ranks(request, layout)):
        _close(res[layout, "prefill_decode"], want, f"{layout} rank {r}")


def test_expert_slabs(ranks2, ranks4):
    """The rank's MoE leaves [L, E, D, F] / [L, E, F, D]: expert-parallel,
    E / ways whole experts; inside each expert (3 experts over 2), every
    expert's d_ff / 2 columns of wg and wu and rows of wd; the router
    whole. No rank imports JAX or the JAX package."""
    L, D, F = 2, 256, 512
    want = {"ep2": (2, F), "tp2": (3, F // 2), "ep4": (1, F)}
    for layout, (e, f) in want.items():
        E = 3 if layout == "tp2" else 4
        for r, res in enumerate(_ranks_of(ranks2, ranks4, layout)):
            assert res[layout, "slab"] == {
                "router": (L, D, E), "wg": (L, e, D, f), "wu": (L, e, D, f),
                "wd": (L, e, f, D)}, (layout, r)
    for world, ranks in ((2, ranks2), (4, ranks4)):
        for r, res in enumerate(ranks):
            assert res["leaked"] == [], (world, r, res["leaked"][:5])


def _ranks_of(ranks2, ranks4, layout):
    return ranks2 if LAYOUTS[layout][0] == 2 else ranks4


@pytest.mark.parametrize("layout", ["data2x2_dense", "data2x2_moe"])
@pytest.mark.parametrize("mode", ["sync", "async"])
def test_data_groups_keep_one_clock(ranks4, layout, mode):
    """A SLICE loop on the real clock on the (2, 2) mesh: the four ranks,
    of both data groups, probe the same l(b), end at the same loop clock,
    stamp every token at the same time and end with equal digests."""
    runs = [res[layout, "clock"][{"sync": 0, "async": 1}[mode]]
            for res in ranks4]
    assert any(runs[0]["finished"])
    for r, run in enumerate(runs[1:], 1):
        for key in ("probes", "end_ms", "times", "finished", "dropped",
                    "wait_ms", "digest"):
            assert run[key] == runs[0][key], (r, key)


def test_guard_fires_across_data_groups(ranks4):
    """One data group fed another token: the digests differ between the
    data groups, and every rank of both raises 'ranks diverged'."""
    for r, res in enumerate(ranks4):
        err = res["data2x2_dense", "guard"]
        assert err is not None and "ranks diverged" in err, r


def test_serve_cli_mesh_shape_2x2_moe(capfd):
    """``--mesh-shape 2,2 --arch granite-moe-3b-a800m --reduced``: 4 ranks
    over gloo, every task finishes on every rank, the pools end empty,
    the four digests are equal, each rank holds 2 of the 4 experts and
    no rank imported JAX. Four ranks probing on a shared host can read a
    smaller batch slower than a larger one, and a curve that fell made
    SLICE defer every task as infeasible: each rank's model is its
    samples as read made non-decreasing (``serving.executor.
    monotone_samples``, ``tests/test_torch_probe.py``), and the engine
    ran decode steps whatever the host's pace."""
    from repro_torch.launch import serve
    from repro_torch.serving.executor import monotone_samples
    run = serve.run(serve.parse_args([
        "--reduced", "--device", "cpu", "--arch", MOE, "--duration", "2",
        "--rate", "3", "--slots", "4", "--max-seq", "128", "--ratio", "0",
        "--mesh-shape", "2,2"]))
    out = capfd.readouterr().out.splitlines()
    assert out[0].startswith("mesh data=2 model=2: 4 ranks over gloo")
    assert isinstance(run, serve.MeshRun) and len(run.ranks) == 4
    for r, res in enumerate(run.ranks):
        assert res["rank"] == r and res["n_tasks"] > 0
        assert res["unfinished"] == [] and res["used_pages"] == 0
        assert res["digests"] == [run.ranks[0]["digest"]] * 4
        assert res["experts"] == 2
        assert res["jax_modules"] == []
        assert res["probes"] == monotone_samples(res["probe_read"]), res
        assert res["decode_iters"] > 0, res["probe_read"]
    assert any(line.startswith("mesh data=2 model=2 backend=gloo") and
               line.endswith("equal") for line in out)
