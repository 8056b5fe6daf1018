"""The port's async pipelined paged engine (DESIGN.md §10) on the SSM,
hybrid and MoE archs (DESIGN.md §12), held against the JAX package.

``PagedTorchExecutor(async_dispatch=True)`` against
``PagedJaxExecutor(async_dispatch=True)`` for reduced mamba2-780m,
hymba-1.5b and granite-moe-3b-a800m on the same weights
(``load_params``): prefill (a 2-token prompt among them, shorter than the
conv width), decode over changing batches, a suspend issued while a
decode is in flight, resume, drain and release. Logits at atol 1e-5
(``tests/helpers.py``), greedy streams equal, the resumed task's state
blob written back bit for bit, and the store, ledger and host arena
clean at the end. Then a SLICE loop over hymba-1.5b on the paged engine
with fewer state slots than the batch, on the priced clock of
``tests/test_torch_serving.py``, making the JAX engine's decisions; and
the serve CLI with ``--arch hymba-1.5b --executor paged`` and with
``--async-pipeline`` on mamba2-780m and granite-moe-3b-a800m, in a
process that never imports JAX or the JAX package. fp32 on the CPU.
"""
from __future__ import annotations

import os
import re
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from helpers import assert_logits_close  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.core import schedulers as jsched  # noqa: E402
from repro.core.latency_model import MeasuredLatencyModel as JLat  # noqa: E402
from repro.data.workload import poisson_workload as j_workload  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serving.executor import PagedJaxExecutor  # noqa: E402
from repro.serving.loop import run_serving_loop as jax_loop  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import schedulers as tsched  # noqa: E402
from repro_torch.core.latency_model import MeasuredLatencyModel as TLat  # noqa: E402
from repro_torch.core.task import SLOSpec, Task  # noqa: E402
from repro_torch.data.workload import poisson_workload as t_workload  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.serving.executor import PagedTorchExecutor  # noqa: E402
from repro_torch.serving.loop import run_serving_loop as torch_loop  # noqa: E402
from test_torch_hetero import HETERO, _priced_ssm_run  # noqa: E402
from test_torch_serving import ROOT, _assert_same_run  # noqa: E402

ENGINE = dict(n_pages=48, page_size=8, max_seq=64, max_batch=4)


@pytest.fixture(autouse=True, scope="module")
def one_cpu_thread():
    """PyTorch's CPU ops on one intra-op thread: beside the other test
    processes its default pool (a thread per core) waits on itself at
    every op, and a reduced step slows many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=HETERO)
def async_pair(request):
    """(arch, the JAX async engine, the port's async engine) on the same
    weights."""
    arch = request.param
    jcfg, cfg = jax_config(arch).reduced(), get_config(arch).reduced()
    jp = JM.init_params(jcfg, jax.random.PRNGKey(3))
    tp = TM.load_params(cfg, jax.tree_util.tree_map(np.asarray, jp),
                        device="cpu")
    return (arch,
            PagedJaxExecutor(jcfg, params=jp, async_dispatch=True, **ENGINE),
            PagedTorchExecutor(cfg, params=tp, device="cpu",
                               async_dispatch=True, **ENGINE))


def test_async_engine_matches_the_jax_async_engine(async_pair):
    """Prefill, decode over the batch buckets 4 -> 1 -> 4 with steps in
    flight, a suspend behind an in-flight decode, two steps without the
    suspended task, resume, drain: every observed logits within 1e-5 of
    JAX's async engine, streams equal, the state blob written back bit
    for bit, and nothing held after release."""
    arch, jx, tx = async_pair
    tasks = [Task(SLOSpec(tpot_ms=100.0), 1.0, prompt_len=n, output_len=40,
                  task_id=9600 + i) for i, n in enumerate((5, 17, 2))]
    for t in tasks:
        jx.prefill(t)
        tx.prefill(t)
        assert_logits_close(tx.last_prefill_logits, jx.last_prefill_logits,
                            err_msg=f"{arch} prefill {t.prompt_len}")
    for ex in (jx, tx):
        for n in (3, 3, 1, 1, 3):
            ex.decode(tasks[:n])
    assert len(tx._queue) > 0
    assert_logits_close(tx.last_logits, jx.last_logits,
                        err_msg=f"{arch} bucket change")
    tid = tasks[0].task_id
    for ex in (jx, tx):
        ex.decode(tasks)
        assert ex is jx or len(ex._queue) > 0
        ex.suspend(tasks[0])                     # behind the in-flight decode
        for _ in range(2):
            ex.decode(tasks[1:])
    tx.ledger.wait(tid)
    blob = {li: {k: v.clone() for k, v in b.items()}
            for li, b in tx.arena._entries[tid]}
    assert (-1 in blob) == tx.cfg.has_ssm
    for ex in (jx, tx):
        ex.resume(tasks[0])
    if tx.cfg.has_ssm:
        slot = tx.states.slot_of(tid)
        assert all(torch.equal(tx.pages[n][:, slot], blob[-1][k])
                   for n, k in (("ssm_state", "ssm"), ("conv_state", "conv")))
    for ex in (jx, tx):
        for _ in range(3):
            ex.decode(tasks)
        ex.drain()
    assert_logits_close(tx.last_logits, jx.last_logits,
                        err_msg=f"{arch} after resume")
    assert [tx.generated_tokens(t) for t in tasks] == \
        [jx.generated_tokens(t) for t in tasks]
    assert tx.suspend_count == tx.resume_count == 1
    assert tx.ledger.started == 1 and tx.ledger.outstanding() == 0
    assert tx.gap_stats.stalls > 0 and not tx._tok_dev
    for ex in (jx, tx):
        for t in tasks:
            ex.release(t)
    assert tx.store.leaked() == 0 == jx.store.leaked()
    tx.store.check()
    tx.ledger.check()
    tx.arena.check()
    assert tx.arena.bytes_held == 0 and len(tx._queue) == 0


def test_priced_slice_loop_hybrid_matches_jax():
    """SLICE over hymba-1.5b on the paged engine with 2 state slots, fewer
    than the 4-row batch, so admission defers an arrival for want of a
    slot: every decision, token time and stream equals the JAX engine's,
    and nothing is left held. (Seed 0's weights put two logits of one
    step 2.4e-7 apart, inside the 1e-5 tolerance, and the argmax then
    follows the summation order.)"""
    jcfg, cfg = jax_config("hymba-1.5b").reduced(), \
        get_config("hymba-1.5b").reduced()
    jp = JM.init_params(jcfg, jax.random.PRNGKey(3))
    tp = TM.load_params(cfg, jax.tree_util.tree_map(np.asarray, jp),
                        device="cpu")
    kw = dict(ENGINE, n_pages=24, n_state_slots=2)
    jx = PagedJaxExecutor(jcfg, params=jp, **kw)
    tx = PagedTorchExecutor(cfg, params=tp, device="cpu", **kw)
    jres, jstreams = _priced_ssm_run(j_workload, jsched, JLat, jax_loop, jx)
    tres, tstreams = _priced_ssm_run(t_workload, tsched, TLat, torch_loop, tx)
    _assert_same_run(jres, jstreams, tres, tstreams)
    assert tx.n_state_slots < tx.max_batch
    assert tres.defers_by_reason.get("states", 0) > 0
    assert tx.store.leaked() == 0 == jx.store.leaked()
    tx.store.check()


_SERVE = """
import sys
from repro_torch.launch import serve
run = serve.run(serve.parse_args([
    "--reduced", "--device", "cpu", "--duration", "1.5", "--rate", "2",
    "--slots", "2", "--max-seq", "64", *sys.argv[1:]]))
res, ex = run.result, run.executor
assert res.tasks and all(t.finished for t in res.tasks), "a task unfinished"
assert ex.states is not None or ex.cfg.block_kind == "moe", "no state slots"
ex.store.check()
assert ex.pool.used_pages == 0 and not ex.store.leaked(), "store held"
assert not len(ex._queue) and not ex.ledger.outstanding(), "in flight"
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "repro"
             or m.startswith("repro."))
assert not bad, bad
print("CLEAN")
"""


@pytest.mark.parametrize("argv", [
    ("--arch", "hymba-1.5b", "--executor", "paged"),
    ("--arch", "mamba2-780m", "--async-pipeline"),
    ("--arch", "granite-moe-3b-a800m", "--async-pipeline"),
], ids=["hymba-paged", "mamba2-async", "granite-async"])
def test_hetero_serving_run_imports_no_jax(argv):
    """The serve CLI on the CPU over the paged engine, in a process that
    never imports JAX or the JAX package: every task finishes, no page or
    state slot is left held, nothing is in flight at the end, and an
    async run's summary line carries its host-gap counters."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", _SERVE, *argv], env=env,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "CLEAN" in out.stdout
    line = r"slice: n=\d+ SLO=[\d.]+% .*decode_iters=[1-9]"
    if "--async-pipeline" in argv:
        line += r".* host_gap=[\d.]+ms \(dispatch=[\d.]+ .*\) stalls=\d+"
    assert re.search(line, out.stdout), out.stdout
