"""Heterogeneous serving in the port (DESIGN.md §12) held against the JAX
package: the weight bridge of the SSM and MoE parameter groups, then
``PagedTorchExecutor`` against ``PagedJaxExecutor`` for mamba2-780m,
hymba-1.5b and granite-moe-3b-a800m (reduced, same weights): prefill and
decode logits at atol 1e-5 (``tests/helpers.py``), identical
greedy streams, suspend/resume restoring the recurrent state and K/V bit
for bit, no leaked page or state slot, the same ``StateBudget``, the SSM
feature gates, and a priced-clock SLICE loop over an SSM arch making the
JAX engine's decisions. fp32 on the CPU.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from helpers import assert_logits_close  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.core import schedulers as jsched  # noqa: E402
from repro.core import task as jtask  # noqa: E402
from repro.core.latency_model import MeasuredLatencyModel as JLat  # noqa: E402
from repro.data.workload import poisson_workload as j_workload  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serving.executor import JaxExecutor, PagedJaxExecutor  # noqa: E402
from repro.serving.loop import run_serving_loop as jax_loop  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import schedulers as tsched  # noqa: E402
from repro_torch.core import task as ttask  # noqa: E402
from repro_torch.core.latency_model import MeasuredLatencyModel as TLat  # noqa: E402
from repro_torch.core.selection import StateBudget  # noqa: E402
from repro_torch.data.workload import poisson_workload as t_workload  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.serving.executor import (PagedTorchExecutor,  # noqa: E402
                                          TorchExecutor)
from repro_torch.serving.loop import run_serving_loop as torch_loop  # noqa: E402
from repro_torch.serving.state_store import OutOfStates  # noqa: E402
from test_torch_serving import Priced, _assert_same_run  # noqa: E402

HETERO = ["mamba2-780m", "hymba-1.5b", "granite-moe-3b-a800m"]
ENGINE = dict(n_pages=24, page_size=8, max_seq=64, max_batch=4)


def _pair(arch, seed=3):
    jcfg = jax_config(arch).reduced()
    cfg = get_config(arch).reduced()
    jp = JM.init_params(jcfg, jax.random.PRNGKey(seed))
    tree = jax.tree_util.tree_map(np.asarray, jp)
    return jcfg, cfg, jp, tree, TM.load_params(cfg, tree, device="cpu")


@pytest.mark.parametrize("arch", HETERO)
def test_load_params_bridge_and_init(arch):
    """The bridge copies JAX's SSMParams/MoEParams exactly, keeps lm_head
    absent for tied archs, and init_params draws the JAX init's shapes."""
    _, cfg, _, tree, tp = _pair(arch)
    assert ("lm_head" in tp) == (not cfg.tied_embeddings)
    for group in ("ssm", "moe"):
        if group in tree["blocks"]:
            for k, v in tree["blocks"][group]._asdict().items():
                np.testing.assert_array_equal(tp["blocks"][group][k].numpy(),
                                              v)
    init = TM.init_params(cfg, seed=1, device="cpu")

    def shapes(node):
        node = node._asdict() if hasattr(node, "_asdict") else node
        if isinstance(node, dict):
            return {k: shapes(v) for k, v in node.items()}
        return tuple(node.shape)
    assert shapes(init) == shapes(tree)
    if cfg.has_ssm:
        ssm = init["blocks"]["ssm"]
        np.testing.assert_allclose(
            ssm["a_log"][0].numpy(),
            np.log(np.linspace(1.0, 16.0, cfg.ssm_heads)), rtol=1e-6)
        assert torch.all(ssm["d_skip"] == 1) and torch.all(ssm["norm_w"] == 0)
    if cfg.block_kind == "moe":
        wd = init["blocks"]["moe"]["wd"]
        assert abs(wd.std().item() * cfg.d_ff ** 0.5 - 1) < 0.05


def _engines(arch, **kw):
    jcfg, cfg, jp, tree, _ = _pair(arch, seed=0)
    return (PagedJaxExecutor(jcfg, params=jp, **ENGINE, **kw),
            PagedTorchExecutor(cfg, params=TM.load_params(cfg, tree,
                                                          device="cpu"),
                               device="cpu", **ENGINE, **kw))


def _tasks(mod, lens, base, out=16):
    return [mod.Task(mod.SLOSpec(tpot_ms=100.0), 1.0, prompt_len=n,
                     output_len=out, task_id=base + i)
            for i, n in enumerate(lens)]


def _snapshot(ex, task):
    """The task's device-resident state: its K/V pages and state slot."""
    snap = {}
    tid = task.task_id
    if ex.cfg.has_attention:
        idx = torch.as_tensor(ex.pool.page_table(tid))
        snap.update({n: ex.pages[n][:, idx].clone()
                     for n in ("k_pages", "v_pages")})
    if ex.states is not None:
        slot = ex.states.slot_of(tid)
        snap.update({n: ex.pages[n][:, slot].clone()
                     for n in ("ssm_state", "conv_state")})
    return snap


@pytest.mark.parametrize("arch", HETERO)
def test_paged_executor_matches_jax(arch):
    """Prefill (a 2-token prompt leaves the conv tail left-padded), decode
    over changing batches, a suspend/resume of one task between steps:
    logits and streams equal JAX's, the resumed task's state and pages
    come back bit for bit, and release leaves no page or slot held."""
    jx, tx = _engines(arch)
    jt, tt = _tasks(jtask, (5, 17, 2), 900), _tasks(ttask, (5, 17, 2), 900)
    for a, b in zip(jt, tt):
        jx.prefill(a)
        tx.prefill(b)
        assert_logits_close(tx.last_prefill_logits, jx.last_prefill_logits)
    for step in range(5):
        if step == 2:
            before = _snapshot(tx, tt[0])
            for ex, t in ((jx, jt[0]), (tx, tt[0])):
                ex.suspend(t)
            assert tx.arena.holds(900) and tx.store.resident_bytes(900) == 0
        if step == 3:
            for ex, t in ((jx, jt[0]), (tx, tt[0])):
                ex.resume(t)
            after = _snapshot(tx, tt[0])
            assert all(torch.equal(before[n], after[n]) for n in before)
        batch = slice(1, 3) if step == 2 else (slice(0, 3), slice(1, 3))[
            step % 2]
        jx.decode(jt[batch])
        tx.decode(tt[batch])
        assert_logits_close(tx.last_logits, jx.last_logits,
                            err_msg=f"decode {step}")
    assert ([tx.generated_tokens(t) for t in tt]
            == [jx.generated_tokens(t) for t in jt])
    assert tx.suspend_count == tx.resume_count == 1
    for a, b in zip(jt, tt):
        jx.release(a)
        tx.release(b)
    assert tx.store.leaked() == 0 == jx.store.leaked()
    tx.store.check()
    assert tx.arena.bytes_held == 0
    tx.arena.check()


@pytest.mark.parametrize("compact", [False, True])
def test_slot_executor_serves_moe(compact):
    """The slot engine takes MoE archs through the shared ``_ffn``: the
    grouped dispatch in prefill, the lossless grouped decode over the
    masked or compacted slot array; logits and streams equal JAX's."""
    jcfg, cfg, jp, tree, _ = _pair("granite-moe-3b-a800m", seed=0)
    kw = dict(max_slots=4, max_seq=64, compact_buckets=compact)
    jx = JaxExecutor(jcfg, params=jp, **kw)
    tx = TorchExecutor(cfg, params=TM.load_params(cfg, tree, device="cpu"),
                       device="cpu", **kw)
    jt, tt = _tasks(jtask, (5, 17), 960), _tasks(ttask, (5, 17), 960)
    for a, b in zip(jt, tt):
        jx.prefill(a)
        tx.prefill(b)
        assert_logits_close(tx.last_prefill_logits, jx.last_prefill_logits)
    streams = {t.task_id: [] for t in jt}
    for step in range(3):
        batch = slice(0, 2) if step != 1 else slice(1, 2)
        jx.decode(jt[batch])
        tx.decode(tt[batch])
        assert_logits_close(tx.last_logits, jx.last_logits,
                            err_msg=f"decode {step}")
        for t, row in zip(jt[batch], jx.last_logits):
            streams[t.task_id].append(int(row.argmax()))
    assert {t.task_id: tx.generated_tokens(t)[1:] for t in tt} == streams


@pytest.mark.parametrize("arch", HETERO)
def test_page_budget_mirrors_jax(arch):
    jx, tx = _engines(arch, n_state_slots=3)
    jb, tb = jx.page_budget(), tx.page_budget()
    assert type(tb).__name__ == type(jb).__name__
    fields = ["total_pages", "page_size", "prompt_cap", "seq_cap",
              "max_tasks"]
    if isinstance(tb, StateBudget):
        fields += ["total_states", "state_bytes", "page_bytes"]
        assert tb.total_states == 3
    for f in fields:
        assert getattr(tb, f) == getattr(jb, f), f
    assert tx.trace_gauges() == jx.trace_gauges()
    assert tx.store.kinds == jx.store.kinds


def test_out_of_states_rolls_back():
    """A prefill with no free state slot raises OutOfStates (an
    OutOfPages) with pool and store unchanged; the task prefills once a
    slot is free."""
    _, tx = _engines("mamba2-780m", n_state_slots=1)
    a, b = _tasks(ttask, (5, 9), 950)
    tx.prefill(a)
    with pytest.raises(OutOfStates):
        tx.prefill(b)
    assert not tx.pool.holds(b.task_id) and not tx.states.holds(b.task_id)
    tx.release(a)
    tx.prefill(b)
    tx.release(b)
    assert tx.store.leaked() == 0


@pytest.mark.parametrize("arch", ["mamba2-780m", "hymba-1.5b"])
def test_ssm_feature_gates_raise(arch):
    cfg = get_config(arch).reduced()
    for kw in ({"spec_decode": True}, {"prefix_cache": True},
               {"prefill_chunk_size": 8}):
        with pytest.raises(ValueError, match="unsupported for SSM/hybrid"):
            PagedTorchExecutor(cfg, device="cpu", **ENGINE, **kw)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TorchExecutor(cfg, device="cpu")
    for argv, match in ((["--spec-decode"], "recurrent"),
                        (["--prefix-cache"], "recurrent"),
                        (["--prefill-chunk", "8"], "pure-attention"),
                        (["--executor", "slot"], "attention-only")):
        with pytest.raises(SystemExit, match=match):
            tserve.run(tserve.parse_args(["--arch", arch, "--reduced",
                                          "--device", "cpu", *argv]))
    with pytest.raises(SystemExit, match="encoder-only"):
        tserve.run(tserve.parse_args(["--arch", "hubert-xlarge", "--reduced",
                                      "--device", "cpu"]))


SAMPLES = [(1, 8.0), (2, 9.0), (4, 11.0)]
PREFILL = [(8, 4.0), (64, 12.0)]


def _priced_ssm_run(workload, sched_mod, lat_cls, loop, ex):
    lat = lat_cls(SAMPLES, PREFILL)
    tasks = workload(4.0, 3.0, realtime_frac=0.5, seed=5, rt_output_len=6,
                     voice_output_len=10, qa_output_len=12,
                     rt_prompt=(4, 12), voice_prompt=(6, 20),
                     qa_prompt=(8, 28))
    for i, t in enumerate(tasks):              # pin ids: prompts derive from them
        t.task_id = 5000 + i
    sched = sched_mod.SliceScheduler(lat, page_budget=ex.page_budget())
    priced = Priced(ex, lat)
    res = loop(sched, priced, tasks, max_ms=1e6)
    return res, priced.streams


def test_priced_slice_loop_ssm_matches_jax():
    """SLICE over mamba2 with 3 state slots (fewer than the 4-row batch,
    so admission binds on slots): every decision, token time and stream
    equals the JAX engine's, and nothing is left held."""
    jx, tx = _engines("mamba2-780m", n_state_slots=3)
    jres, jstreams = _priced_ssm_run(j_workload, jsched, JLat, jax_loop, jx)
    tres, tstreams = _priced_ssm_run(t_workload, tsched, TLat, torch_loop, tx)
    _assert_same_run(jres, jstreams, tres, tstreams)
    assert tx.store.leaked() == 0
    tx.store.check()
