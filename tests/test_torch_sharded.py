"""The port's tensor-parallel paged engine (DESIGN.md §9) on the CPU: the
counterpart of ``tests/test_sharded.py``, plus the port's own cases.

``PagedTorchExecutor(mesh=...)`` runs SPMD, one process a rank: every
group here is 2 or 4 gloo ranks spawned by ``launch.mesh.spawn_ranks``
(a FileStore under ``tmp_path``, a time limit of its own that ends its
ranks: a hung collective fails its test and never stalls the suite). The
ranks import neither JAX nor the JAX package; the JAX engines run here,
in the test process, on the same op sequences. Weights are JAX's
``init_params`` through ``load_params``, so both packages compute on the
same weights, and tasks carry the same ids, so the same prompts.

Held to the repo-wide engine contract: every rank's logits within 1e-5
(``helpers.ATOL``, fp32) of JAX's single-device ``PagedJaxExecutor`` on
the same ops, greedy streams byte-identical, the same pool bookkeeping,
across atomic and chunked prefill, decode across a bucket change, spec
verify, prefix sharing, suspend/resume, the GQA fallback (reduced_cfg:
one KV head, shared by the 4 ranks), a 2-way mesh and depth-0 identity;
prefill and decode also against JAX's own sharded engine (``mesh4``).
The port's own: the arena's head slabs, the swap arena's accounting and
a blob's round trip, async dispatch against sync on the mesh, the
divergence guard, the agreed loop clock, the mesh's groups, the
refusals, ``spawn_ranks``'s failure and time limit, and the CLI's
``--mesh-shape 1,2``. MoE archs and a 'data' axis are
``tests/test_torch_sharded_moe.py``'s.

All 4-rank cases share one spawned group (``ranks4``), which runs every
case on every rank and returns what each rank saw.
"""
from __future__ import annotations

import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from helpers import ATOL, assert_logits_close, drive_async, drive_plain  # noqa: E402

ARCH = "smollm-360m"
ENGINE = dict(n_pages=16, page_size=8, max_seq=64, max_batch=4, seed=0)
SPEC = dict(n_pages=32, max_seq=96, max_spec_depth=4)
TIMEOUT = 240.0


# ------------------------------------------------------- op sequences
# Each runs on a JAX engine here and on a port engine in every rank, through
# the executors' common API; ``mk`` makes tasks of the engine's package.

def make_tasks(mod, specs):
    """Tasks (task_id, prompt_len, output_len[, prefix_group, prefix_len])
    of package ``mod`` (``repro.core.task`` or ``repro_torch.core.task``)."""
    out = []
    for tid, prompt, output, *prefix in specs:
        t = mod.Task(mod.SLOSpec(tpot_ms=100.0), 1.0, prompt_len=prompt,
                     output_len=output, task_id=tid)
        if prefix:
            t.prefix_group, t.prefix_len = prefix
        out.append(t)
    return out


def seq_prefill_decode(ex, mk):
    """Atomic prefill of 3 prompts, decode across a bucket change (3 -> 1),
    release: logits and the pool."""
    tasks = mk([(101, 5, 16), (102, 23, 16), (103, 17, 16)])
    obs = {"prefill": [], "decode": []}
    for t in tasks:
        ex.prefill(t)
        obs["prefill"].append(np.asarray(ex.last_prefill_logits))
    for step in range(4):
        ex.decode(tasks if step < 2 else tasks[:1])
        obs["decode"].append(np.asarray(ex.last_logits))
    for t in tasks:
        ex.release(t)
    ex.pool.check()
    obs["used"] = ex.pool.used_pages
    return obs


def seq_chunked(ex, mk, chunked):
    """A 21-token prompt in chunks of 8 (or whole), then a decode."""
    (t,) = mk([(111, 21, 8)])
    if chunked:
        done = False
        while not done:
            _, done = ex.prefill_chunk(t, 8)
    else:
        ex.prefill(t)
    obs = {"prefill": np.asarray(ex.last_prefill_logits)}
    ex.decode([t])
    obs["decode"] = np.asarray(ex.last_logits)
    return obs


def seq_spec(ex, mk):
    """Speculative decode over a cycle of ragged depths: the streams."""
    tasks = mk([(121, 11, 32), (122, 11, 32), (123, 11, 32)])
    for t in tasks:
        ex.prefill(t)
    cycle = [[4, 0, 2], [1, 3, 0], [2, 2, 2]]
    for it in range(6):
        ex.decode(tasks, depths=cycle[it % len(cycle)])
        ex.pool.check()
    return {"streams": [ex.generated_tokens(t) for t in tasks],
            "accepted": ex.accepted_tokens}


def seq_swap(ex, mk, suspend):
    """Decode across a suspend/resume of task 0 (or none): logits, and the
    swap arena's accounting after the suspension and at the end."""
    tasks = mk([(131, 18, 8), (132, 18, 8)])
    for t in tasks:
        ex.prefill(t)
    obs = {"decode": []}

    def step(subset):
        ex.decode([tasks[i] for i in subset])
        obs["decode"].append(np.asarray(ex.last_logits))

    step([0, 1])
    if suspend:
        ex.suspend(tasks[0])
        obs["held"] = ex.arena.bytes_held
    step([1])
    if suspend:
        ex.resume(tasks[0])
    step([0, 1])
    for t in tasks:
        ex.release(t)
    ex.pool.check()
    obs.update(used=ex.pool.used_pages, end_held=ex.arena.bytes_held,
               suspends=ex.suspend_count, swapped=ex.swapped_bytes)
    return obs


def seq_prefix(ex, mk):
    """Two tasks sharing a 16-token prefix: prefill logits, shared pages,
    decode logits, an empty pool at the end."""
    tasks = mk([(141, 20, 8, 9, 16), (142, 20, 8, 9, 16)])
    obs = {"prefill": [], "decode": []}
    for t in tasks:
        ex.prefill(t)
        obs["prefill"].append(np.asarray(ex.last_prefill_logits))
    obs["shared_used"] = ex.pool.used_pages
    for _ in range(3):
        ex.decode(tasks)
        obs["decode"].append(np.asarray(ex.last_logits))
    for t in tasks:
        ex.release(t)
    ex.prefix_cache.clear()
    ex.pool.check()
    obs["used"] = ex.pool.used_pages
    return obs


def seq_streams(ex, mk):
    tasks = mk([(151, 7, 10), (152, 15, 10)])
    for t in tasks:
        ex.prefill(t)
    return {k: list(map(int, v)) for k, v in drive_plain(ex, tasks, 8).items()}


def seq_short(ex, mk, prompt, steps, tid):
    """One prompt and ``steps`` decodes: the prefill and decode logits."""
    (t,) = mk([(tid, prompt, 8)])
    ex.prefill(t)
    obs = {"prefill": np.asarray(ex.last_prefill_logits), "decode": []}
    for _ in range(steps):
        ex.decode([t])
        obs["decode"].append(np.asarray(ex.last_logits))
    return obs


# ---------------------------------------------------------- the ranks

def _port_cfg(kv_heads):
    from repro_torch.configs import get_config
    cfg = get_config(ARCH).reduced()
    return cfg if kv_heads is None else dataclasses.replace(
        cfg, n_kv_heads=kv_heads)


def _engine(ctx, **kw):
    from repro_torch.models import model as TM
    from repro_torch.serving.executor import PagedTorchExecutor
    params = TM.load_params(ctx.cfg, ctx.tree, device="cpu")
    if kw.pop("draft", False):
        kw.update(spec_decode=True, draft_cfg=ctx.cfg,
                  draft_params=TM.load_params(ctx.cfg, ctx.tree, device="cpu"))
    return PagedTorchExecutor(ctx.cfg, params=params, device="cpu",
                              mesh=ctx.mesh, **{**ENGINE, **kw})


def _mk(specs):
    from repro_torch.core import task
    return make_tasks(task, specs)


def _rank_layout(ctx):
    """The rank's arena slab after a prefill, and its engine's heads."""
    ex = _engine(ctx)
    (t,) = _mk([(161, 13, 8)])
    ex.prefill(t)
    return {"heads": ex.heads, "k_pages": ex.pages["k_pages"].numpy().copy(),
            "table": ex.pool.page_table(t.task_id)}


def _rank_swap_roundtrip(ctx):
    """Suspend then resume with nothing between: the task's pages, read in
    logical order, equal before and after, bit for bit."""
    ex = _engine(ctx)
    (t,) = _mk([(171, 30, 8)])
    ex.prefill(t)
    ex.decode([t])

    def pages():
        idx = torch.as_tensor(ex.pool.page_table(t.task_id), dtype=torch.long)
        return torch.cat([ex.pages["k_pages"][:, idx],
                          ex.pages["v_pages"][:, idx]])

    before = pages().clone()
    ex.suspend(t)
    ex.resume(t)
    return bool(torch.equal(before, pages()))


def _rank_depth0(ctx):
    """depths=[0, 0] on a spec engine and depths=None on a plain one: the
    same logits bit for bit, one commit a task."""
    ex0 = _engine(ctx, draft=True, **SPEC)
    ex1 = _engine(ctx, n_pages=32, max_seq=96)
    tasks0 = _mk([(181, 11, 16), (182, 11, 16)])
    tasks1 = _mk([(181, 11, 16), (182, 11, 16)])
    for a, b in zip(tasks0, tasks1):
        ex0.prefill(a)
        ex1.prefill(b)
    same = [np.array_equal(ex0.last_prefill_logits, ex1.last_prefill_logits)]
    for _ in range(3):
        ex0.decode(tasks0, depths=[0, 0])
        ex1.decode(tasks1, depths=None)
        same.append(np.array_equal(ex0.last_logits, ex1.last_logits)
                    and ex0.last_commits == [1, 1])
    return same


def _rank_async(ctx):
    """The async engine against the sync one on the mesh, both driven
    pipelined (``drive_async``): streams equal and the last logits bit for
    bit."""
    out = []
    for async_dispatch in (False, True):
        ex = _engine(ctx, async_dispatch=async_dispatch, n_pages=32)
        tasks = _mk([(191, 9, 12), (192, 14, 12), (193, 5, 12)])
        for t in tasks:
            ex.prefill(t)
        streams = drive_async(ex, tasks[:2], 3)
        streams.update(drive_async(ex, tasks, 5))     # a bucket change
        out.append((streams, np.asarray(ex.last_logits)))
        for t in tasks:
            ex.release(t)
        ex.drain()
    (s0, l0), (s1, l1) = out
    return {"streams": s0 == s1, "logits": bool(np.array_equal(l0, l1))}


def _rank_guard(ctx):
    """Rank 1 feeds another token: every rank raises 'ranks diverged'."""
    ex = _engine(ctx)
    (t,) = _mk([(201, 9, 8)])
    ex.prefill(t)
    ex.decode([t])
    if ctx.rank == 1:
        ex._last_tok[t.task_id] += 1
    try:
        ex.decode([t])
    except RuntimeError as e:
        return str(e)
    return None


def _rank_clock(ctx):
    """A SLICE serving loop on the real clock, sync and async: each rank's
    l(b) probe, loop clock and every token time (compared across ranks)."""
    from repro_torch.core.schedulers import SliceScheduler
    from repro_torch.data.workload import poisson_workload
    from repro_torch.launch.serve import shape_workload
    from repro_torch.serving.loop import run_serving_loop
    out = []
    for async_dispatch in (False, True):
        ex = _engine(ctx, async_dispatch=async_dispatch, n_pages=32)
        lat = ex.latency_model()
        tasks = poisson_workload(8.0, 1.0, realtime_frac=0.5, seed=0,
                                 rt_output_len=8, voice_output_len=12,
                                 qa_output_len=12)
        shape_workload(tasks, [lat], ex.max_batch, ex.max_seq)
        res = run_serving_loop(SliceScheduler(lat,
                                              page_budget=ex.page_budget()),
                               ex, tasks, max_ms=3e7)
        out.append({"probes": list(ex.probe_samples), "end_ms": res.end_ms,
                    "times": [list(t.token_times_ms) for t in res.tasks],
                    "finished": [t.finished for t in res.tasks],
                    "dropped": [t.dropped for t in res.tasks],
                    "wait_ms": ex.gap_stats.wait_ms, "digest": ex.digest})
    return out


def _rank_mesh22(ctx):
    """A (2, 2) mesh over the same 4 ranks: each rank's coordinates; a sum
    over its model group, its data group and the data group's gloo twin;
    the mesh's gather and agree."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_serving_mesh
    mesh = make_serving_mesh(model=2, data=2)
    sums = []
    for group in (mesh.model_group, mesh.data_group, mesh.data_cpu_group):
        t = torch.tensor([float(ctx.rank)])
        dist.all_reduce(t, group=group)
        sums.append(float(t[0]))
    return {"coords": mesh.coords, "sums": sums,
            "gathered": mesh.gather(ctx.rank), "agreed": mesh.agree(ctx.rank)}


CASES4 = {
    "prefill_decode": lambda c: seq_prefill_decode(_engine(c), _mk),
    "chunked": lambda c: seq_chunked(_engine(c, prefill_chunk_size=8), _mk,
                                     True),
    "spec": lambda c: seq_spec(_engine(c, draft=True, **SPEC), _mk),
    "swap": lambda c: seq_swap(_engine(c), _mk, True),
    "swap_roundtrip": _rank_swap_roundtrip,
    "prefix": lambda c: seq_prefix(
        _engine(c, n_pages=32, max_seq=96, prefix_cache=True), _mk),
    "streams": lambda c: seq_streams(_engine(c), _mk),
    "layout": _rank_layout,
    "depth0": _rank_depth0,
    "async": _rank_async,
    "guard": _rank_guard,
    "clock": _rank_clock,
    "mesh22": _rank_mesh22,
}
CASES_GQA = {"gqa": lambda c: seq_short(_engine(c), _mk, 13, 3, 211)}
CASES2 = {"two_way": lambda c: seq_short(_engine(c), _mk, 9, 1, 221)}


def _rank_main(rank, ways, groups):
    """A spawned rank: run each (cfg's KV heads, weights, cases) group on
    this rank's slab; returns {case: what the rank saw}."""
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import make_serving_mesh
    mesh = make_serving_mesh(model=ways)
    out = {}
    for kv_heads, tree, cases in groups:
        ctx = types.SimpleNamespace(rank=rank, mesh=mesh, tree=tree,
                                    cfg=_port_cfg(kv_heads))
        for name in cases:
            out[name] = {**CASES4, **CASES_GQA, **CASES2}[name](ctx)
    return out


# ---------------------------------------------------- fixtures (JAX side)

def _numpy(tree):
    import jax
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def weights():
    """(JAX cfg, JAX params, numpy tree) of the MHA test config (4 KV
    heads: the arena splits over 4 ranks) and of the GQA reduced config."""
    import jax
    from repro.models import model as JM

    from helpers import reduced_cfg, sharded_test_cfg
    out = {}
    for name, cfg in (("mha", sharded_test_cfg(ways=4)), ("gqa", reduced_cfg())):
        params = JM.init_params(cfg, jax.random.PRNGKey(0))
        out[name] = (cfg, params, _numpy(params))
    return out


@pytest.fixture(scope="module")
def ranks4(weights, tmp_path_factory):
    from repro_torch.launch.mesh import spawn_ranks
    groups = [(4, weights["mha"][2], list(CASES4)),
              (None, weights["gqa"][2], list(CASES_GQA))]
    return spawn_ranks(_rank_main, 4, (4, groups), timeout=TIMEOUT,
                       store_dir=str(tmp_path_factory.mktemp("store4")))


@pytest.fixture(scope="module")
def ranks2(weights, tmp_path_factory):
    from repro_torch.launch.mesh import spawn_ranks
    groups = [(4, weights["mha"][2], list(CASES2))]
    return spawn_ranks(_rank_main, 2, (2, groups), timeout=TIMEOUT,
                       store_dir=str(tmp_path_factory.mktemp("store2")))


def _jax_engine(weights, name="mha", **kw):
    from helpers import make_paged_engine
    cfg, params, _ = weights[name]
    if kw.pop("draft", False):
        kw.update(spec_decode=True, draft_cfg=cfg, draft_params=params)
    kw = {**ENGINE, **kw}
    kw.pop("seed")
    return make_paged_engine(cfg, params=params, **kw)


def _jmk(specs):
    from repro.core import task
    return make_tasks(task, specs)


def _close(got, want, what):
    """Every array of ``got`` within ATOL of ``want`` (nested alike)."""
    if isinstance(want, dict):
        for k in want:
            _close(got[k], want[k], f"{what}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, f"{what}[{i}]")
    elif isinstance(want, np.ndarray):
        assert_logits_close(got, want, err_msg=what)
    else:
        assert got == want, (what, got, want)


# ------------------------------------------------------------ layout

def test_page_arena_sharded_over_kv_heads(weights, ranks4):
    """Each rank holds Hkv/4 = 1 KV head of every page, rank r head r: the
    ranks' slabs side by side are the single-device JAX arena after the
    same prefill (the pool's pages and the spare page past them)."""
    cfg = weights["mha"][0]
    exA = _jax_engine(weights)
    (t,) = _jmk([(161, 13, 8)])
    exA.prefill(t)
    want = np.asarray(exA.pages["k_pages"])             # [L, P, Hkv, psz, hd]
    for r, res in enumerate(ranks4):
        got = res["layout"]
        assert got["heads"] == (1, 1, r)
        assert got["k_pages"].shape == (cfg.n_layers, ENGINE["n_pages"] + 1,
                                        1, ENGINE["page_size"], cfg.head_dim)
        assert got["table"] == exA.pool.page_table(t.task_id)
        np.testing.assert_allclose(got["k_pages"][:, :ENGINE["n_pages"], 0],
                                   want[:, :, r], atol=ATOL, rtol=0)


def test_mesh_refusals():
    """The counterpart of JAX's mesh refusal of its Pallas kernel: SSM and
    hybrid archs raise ValueError (as JAX's), captured steps over gloo on
    a card ValueError, all before any process group is touched. MoE archs
    and a data axis above 1 pass the checks: an engine is built on a
    stand-in mesh (no collective runs while one is built), an MoE rank
    holding its slab of the experts."""
    from repro_torch.configs import get_config
    from repro_torch.serving.executor import PagedTorchExecutor

    def mesh(data=1, model=2, backend="gloo"):
        return types.SimpleNamespace(shape={"data": data, "model": model},
                                     axis_names=("data", "model"),
                                     coords={"data": 0, "model": 1},
                                     backend=backend, agree=float)

    kw = dict(device="cpu", n_pages=8, page_size=8, max_seq=32, max_batch=2)
    for arch in ("mamba2-780m", "hymba-1.5b"):
        with pytest.raises(ValueError, match="mesh"):
            PagedTorchExecutor(get_config(arch).reduced(), mesh=mesh(), **kw)
    moe = get_config("granite-moe-3b-a800m").reduced()
    for shape in ((1, 2), (2, 2)):
        ex = PagedTorchExecutor(moe, mesh=mesh(*shape), **kw)
        assert ex.params["blocks"]["moe"]["wg"].shape[1] == 2, shape
    cfg = _port_cfg(4)
    ex = PagedTorchExecutor(cfg, mesh=mesh(data=2), **kw)
    assert ex.heads == (2, 2, 2)
    with pytest.raises(ValueError, match="gloo"):
        PagedTorchExecutor(cfg, mesh=mesh(), **{**kw, "device": "cuda"})


# ------------------------------------------------- op-level equivalence

def test_sharded_prefill_and_decode_match(weights, ranks4):
    """Atomic prefill logits and decode across a bucket change (3 tasks ->
    1) on every rank match the single-device JAX engine, the pool ends
    empty."""
    want = seq_prefill_decode(_jax_engine(weights), _jmk)
    for r, res in enumerate(ranks4):
        _close(res["prefill_decode"], want, f"rank {r}")
    assert want["used"] == 0


def test_sharded_matches_jax_sharded_engine(weights, ranks4, mesh4):
    """The same ops on JAX's own 4-way sharded engine: the ranks' logits
    within 1e-5 of it too."""
    want = seq_prefill_decode(_jax_engine(weights, mesh=mesh4), _jmk)
    for r, res in enumerate(ranks4):
        _close(res["prefill_decode"], want, f"rank {r}")


def test_sharded_chunked_prefill_matches(weights, ranks4):
    """prefill_chunk on the mesh == monolithic single-device prefill."""
    want = seq_chunked(_jax_engine(weights), _jmk, False)
    for r, res in enumerate(ranks4):
        _close(res["chunked"], want, f"rank {r}")


def test_sharded_spec_verify_stream_matches(weights, ranks4):
    """Speculative decode on the mesh (the draft whole on every rank):
    greedy streams across ragged depths == the single-device engine's."""
    want = seq_spec(_jax_engine(weights, draft=True, **SPEC), _jmk)
    for r, res in enumerate(ranks4):
        assert res["spec"]["streams"] == want["streams"], r
        assert res["spec"]["accepted"] == want["accepted"] > 0


def test_sharded_suspend_resume_roundtrip_matches(weights, ranks4):
    """Each rank swaps its own slab: decode across the round trip matches
    the never-suspended single-device engine; the host arena's accounting
    (bytes held, suspends, swapped bytes) is the single-device suspending
    engine's on every rank; no leak either side; a blob restores bit for
    bit."""
    never = seq_swap(_jax_engine(weights), _jmk, False)
    swapped = seq_swap(_jax_engine(weights), _jmk, True)
    for r, res in enumerate(ranks4):
        got = res["swap"]
        _close(got["decode"], never["decode"], f"rank {r}")
        assert got["held"] == swapped["held"] > 0
        assert (got["used"], got["end_held"]) == (0, 0)
        assert (got["suspends"], got["swapped"]) == (swapped["suspends"],
                                                     swapped["swapped"])
        assert res["swap_roundtrip"], r


def test_sharded_prefix_sharing_composes(weights, ranks4):
    """A prefix-cache hit on the mesh: the suffix prefill rides host page
    tables over the slabs and matches; pages are shared alike."""
    want = seq_prefix(_jax_engine(weights, n_pages=32, max_seq=96,
                                  prefix_cache=True), _jmk)
    for r, res in enumerate(ranks4):
        _close(res["prefix"], want, f"rank {r}")
    assert want["used"] == 0


def test_gqa_fallback_replicated_pages_still_match(weights, ranks4):
    """reduced_cfg (4 query heads, 1 KV head) over 4 ranks: each rank
    computes one query head and holds the one KV head, which JAX
    replicates. The fallback keeps whole heads and still matches."""
    want = seq_short(_jax_engine(weights, "gqa"), _jmk, 13, 3, 211)
    for r, res in enumerate(ranks4):
        _close(res["gqa"], want, f"rank {r}")


def test_two_way_mesh_matches(weights, ranks2):
    """A (1, 2) mesh: 2 KV heads a rank; prefill and decode match."""
    want = seq_short(_jax_engine(weights), _jmk, 9, 1, 221)
    for r, res in enumerate(ranks2):
        _close(res["two_way"], want, f"rank {r}")


def test_sharded_depth0_byte_identical_to_plain_decode(ranks4):
    """depths=[0, ...] and depths=None take the same decode path on the
    mesh: byte-identical logits, one commit a task."""
    for r, res in enumerate(ranks4):
        assert all(res["depth0"]), (r, res["depth0"])


def test_sharded_greedy_streams_byte_identical(weights, ranks4):
    """Greedy streams through 8 decode steps equal JAX's single-device
    engine's, on every rank."""
    want = seq_streams(_jax_engine(weights), _jmk)
    for r, res in enumerate(ranks4):
        assert res["streams"] == want, r


# ------------------------------------------------------ the port's own

def test_sharded_async_matches_sync(ranks4):
    """The async pipelined engine on the mesh against the sync one: the
    same streams, the last logits bit for bit, on every rank."""
    for r, res in enumerate(ranks4):
        assert res["async"] == {"streams": True, "logits": True}, r


def test_divergence_guard_raises_on_every_rank(ranks4):
    """A rank fed another token: the op's digests differ and every rank
    raises RuntimeError('ranks diverged ...') instead of carrying on."""
    for r, res in enumerate(ranks4):
        assert res["guard"] is not None and "ranks diverged" in res["guard"], r


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_agreed_clock_equal_on_every_rank(ranks4, mode):
    """A SLICE loop on the real clock: every rank probes the same l(b),
    ends at the same loop clock and stamps every token at the same time
    (every op's ms and, async, every commit wait is the slowest rank's),
    finishes and drops the same tasks (a late realtime task is dropped on
    every rank or on none) and ends with equal digests."""
    i = {"sync": 0, "async": 1}[mode]
    runs = [res["clock"][i] for res in ranks4]
    assert any(runs[0]["finished"])
    for r, run in enumerate(runs[1:], 1):
        for key in ("probes", "end_ms", "times", "finished", "dropped",
                    "wait_ms", "digest"):
            assert run[key] == runs[0][key], (r, key)


def test_data_by_model_mesh_groups(ranks4):
    """make_serving_mesh(model=2, data=2) over 4 ranks: rank r sits at
    (r // 2, r % 2); its model group is its data index's two ranks, its
    data group (and that group's gloo twin) its model index's two ranks.
    The control plane's gather and agree span all four ranks, both data
    groups: one loop clock and one digest for the mesh."""
    for r, res in enumerate(ranks4):
        d, m = r // 2, r % 2
        assert res["mesh22"] == {"coords": {"data": d, "model": m},
                                 "sums": [float(4 * d + 1), float(2 + 2 * m),
                                          float(2 + 2 * m)],
                                 "gathered": [0, 1, 2, 3],
                                 "agreed": 3.0}, r


def _fails(rank):
    if rank == 1:
        raise ValueError("rank one fails")
    return rank


def _hangs(rank):
    import torch.distributed as dist
    if rank == 0:
        dist.barrier()                   # rank 1 never joins
    else:
        import time
        time.sleep(60)
    return rank


def test_spawn_ranks_fails_and_times_out(tmp_path):
    """A rank that raises fails the group with its traceback; a group that
    outlives its time limit is ended and raises, its ranks gone."""
    from repro_torch.launch.mesh import spawn_ranks
    with pytest.raises(RuntimeError, match="rank one fails"):
        spawn_ranks(_fails, 2, store_dir=str(tmp_path))
    with pytest.raises(TimeoutError):
        spawn_ranks(_hangs, 2, timeout=5.0, store_dir=str(tmp_path))


def test_serve_cli_mesh_shape(capfd):
    """``--mesh-shape 1,2`` on the reduced config: the first line names the
    mesh and gloo, every task finishes on both ranks, the pools end empty,
    the ranks' digests are equal, each rank holds its slab's heads
    (edge-6b reduced: 4 query heads, 1 KV head -> 2 and the 1 a rank,
    which both ranks' queries read).
    A data axis passes the flag checks; an SSM arch is refused."""
    from repro_torch.launch import serve
    run = serve.run(serve.parse_args([
        "--reduced", "--device", "cpu", "--duration", "2", "--rate", "3",
        "--slots", "4", "--max-seq", "128", "--ratio", "0",
        "--mesh-shape", "1,2"]))
    out = capfd.readouterr().out.splitlines()
    assert out[0].startswith("mesh data=1 model=2: 2 ranks over gloo")
    assert isinstance(run, serve.MeshRun) and run.backend == "gloo"
    assert len(run.ranks) == 2
    for r, res in enumerate(run.ranks):
        assert res["rank"] == r and res["n_tasks"] > 0
        assert res["unfinished"] == [] and res["used_pages"] == 0
        assert res["heads"] == (2, 1, 0)
        assert res["digests"] == [run.ranks[0]["digest"]] * 2
    assert any(line.startswith("mesh data=1 model=2 backend=gloo") and
               line.endswith("equal") for line in out)
    assert serve._mesh_shape(serve.parse_args(
        ["--reduced", "--device", "cpu", "--mesh-shape", "2,1"])) == (2, 1)
    with pytest.raises(SystemExit, match="mesh"):
        serve.run(serve.parse_args(["--reduced", "--device", "cpu",
                                    "--arch", "mamba2-780m",
                                    "--mesh-shape", "1,2"]))
