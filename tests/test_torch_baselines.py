"""The paper's baselines on the port's paged engine, held against the JAX
package: Orca, FastServe, FastServe with proactive KV swap, and SLICE
with KV swap, each over ``PagedTorchExecutor(device="cpu")`` against
``PagedJaxExecutor`` on the same weights, on the priced clock of
``tests/test_torch_serving.py`` (suspend and resume priced too, by
``lat.swap_ms`` of the task's cached tokens). Every scheduling decision is
then deterministic, so the counts, the end clock, every task's token times
and greedy stream, the suspends, resumes and swapped bytes must be equal,
and both engines end with no page held and an empty host arena. The swap
cases run on a pool small enough that they must suspend.

Plus the serve CLI on the CPU under ``--scheduler orca``, ``fastserve``
and ``fastserve --kv-swap`` in a process that imports no JAX and nothing
of the JAX package.
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
from repro_torch.data.workload import poisson_workload as t_workload  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.serving.executor import PagedTorchExecutor  # noqa: E402
from repro_torch.serving.loop import run_serving_loop as torch_loop  # noqa: E402
from test_torch_serving import (ENGINE, PREFILL, ROOT, SAMPLES,  # noqa: E402
                                Priced, _assert_same_run)

# 6 pages of 8 tokens hold one or two of the workload's tasks (a task's
# peak is up to 5 pages): both swap cases suspend on both archs
SWAP_PAGES = 6

# (case, engine pages, scheduler from (module, latency model, page budget))
CASES = {
    "orca": (ENGINE["n_pages"],
             lambda mod, lat, budget: mod.OrcaScheduler(max_batch=4)),
    "fastserve": (ENGINE["n_pages"],
                  lambda mod, lat, budget: mod.FastServeScheduler(
                      max_batch=4)),
    "fastserve-swap": (SWAP_PAGES,
                       lambda mod, lat, budget: mod.FastServeScheduler(
                           max_batch=4, page_budget=budget, kv_swap=True)),
    "slice-swap": (SWAP_PAGES,
                   lambda mod, lat, budget: mod.SliceScheduler(
                       lat, page_budget=budget, kv_swap=True)),
}


@pytest.fixture(autouse=True, scope="module")
def one_cpu_thread():
    """PyTorch's CPU ops on one intra-op thread: beside the other test
    processes its default pool (a thread per core) waits on itself at
    every op, and a reduced step slows many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=["edge-6b", "smollm-360m"])
def weights(request):
    """(JAX config, JAX params, port config, port params): the same
    weights through ``load_params``."""
    jcfg = jax_config(request.param).reduced()
    cfg = get_config(request.param).reduced()
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tp = TM.load_params(cfg, jax.tree_util.tree_map(np.asarray, jp),
                        device="cpu")
    return jcfg, jp, cfg, tp


class SwapPriced(Priced):
    """``Priced`` with suspend and resume priced by the latency model's
    swap term over the task's cached tokens, as the sim engines price
    them."""

    def suspend(self, task):
        self.inner.suspend(task)
        return self.lat.swap_ms(task.prompt_len + task.tokens_done)

    def resume(self, task):
        self.inner.resume(task)
        return self.lat.swap_ms(task.prompt_len + task.tokens_done)


def _run(case, workload, sched_mod, lat_cls, loop, ex):
    """``_priced_run``'s workload under the case's scheduler; returns the
    LoopResult, every task's stream and the scheduler."""
    lat = lat_cls(SAMPLES, PREFILL)
    tasks = workload(4.0, 3.0, realtime_frac=0.5, seed=5, rt_output_len=6,
                     voice_output_len=10, qa_output_len=12,
                     rt_prompt=(4, 12), voice_prompt=(6, 20),
                     qa_prompt=(8, 28))
    for i, t in enumerate(tasks):              # pin ids: prompts derive from them
        t.task_id = 5000 + i
    sched = CASES[case][1](sched_mod, lat, ex.page_budget())
    priced = SwapPriced(ex, lat)
    res = loop(sched, priced, tasks, max_ms=1e6)
    return res, priced.streams, sched


@pytest.mark.parametrize("case", list(CASES))
def test_priced_baseline_matches_jax(weights, case):
    jcfg, jp, cfg, tp = weights
    engine = dict(ENGINE, n_pages=CASES[case][0])
    jx = PagedJaxExecutor(jcfg, params=jp, **engine)
    tx = PagedTorchExecutor(cfg, params=tp, device="cpu", **engine)
    jres, jstreams, jsch = _run(case, j_workload, jsched, JLat, jax_loop, jx)
    tres, tstreams, tsch = _run(case, t_workload, tsched, TLat, torch_loop,
                                tx)
    _assert_same_run(jres, jstreams, tres, tstreams)
    for f in ("suspends", "resumes", "swapped_bytes"):
        assert getattr(tres, f) == getattr(jres, f), f
    if case.endswith("swap"):
        assert tres.suspends >= 1 and tres.resumes == tres.suspends
        assert tres.swapped_bytes > 0
    else:
        assert tres.suspends == 0 and tres.swapped_bytes == 0
    assert all(t.finished for t in tres.tasks)
    assert not any(t.suspended for t in tres.tasks)
    if case.startswith("fastserve"):
        assert tsch.queue_of == {} and tsch.tokens_in_queue == {}
    for ex in (jx, tx):
        ex.pool.check()
        ex.arena.check()
        assert ex.pool.used_pages == 0 and not ex.pool.owners()
        assert ex.arena.bytes_held == 0 and ex.arena.owners_held == 0
    assert all(tx.generated_tokens(t) == [] for t in tres.tasks)  # released


_SERVE = """
import sys
from repro_torch.launch import serve
run = serve.run(serve.parse_args([
    "--reduced", "--device", "cpu", "--duration", "1.5", "--rate", "2",
    "--slots", "2", "--max-seq", "64", *sys.argv[1:]]))
res, ex = run.result, run.executor
assert res.tasks and all(t.finished for t in res.tasks), "a task unfinished"
assert res.resumes == res.suspends, (res.suspends, res.resumes)
assert ex.pool.used_pages == 0 and ex.arena.bytes_held == 0, "store held"
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "repro"
             or m.startswith("repro."))
assert not bad, bad
print("CLEAN")
"""


@pytest.mark.parametrize("argv", [
    ("--scheduler", "orca"),
    ("--scheduler", "fastserve"),
    ("--scheduler", "fastserve", "--kv-swap", "--pages", "4"),
], ids=["orca", "fastserve", "fastserve-swap"])
def test_baseline_serving_run_imports_no_jax(argv):
    """The CLI under a baseline scheduler on the CPU, in a process that
    never imports JAX or the JAX package: every task finishes, every
    suspended task is resumed, the pool and the host arena end empty, and
    the summary line names the scheduler (with its swap counters under
    --kv-swap)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", _SERVE, *argv], env=env,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "CLEAN" in out.stdout
    line = rf"{argv[1]}: n=\d+ SLO=[\d.]+% .*decode_iters=[1-9]"
    if "--kv-swap" in argv:
        line += r".* suspends=\d+ resumes=\d+ swapped=[\d.]+MB"
    assert re.search(line, out.stdout), out.stdout
