"""The port's paged engine and serving path held against the JAX package.

``PagedTorchExecutor(device="cpu")`` against ``PagedJaxExecutor`` on the
same weights and pinned task ids (identical greedy streams, prefill and
decode logits at atol 1e-5), and the SLICE serving loop over both with a
priced clock (each executor returns ms priced from one LatencyModel, not
measured), which makes every scheduling decision deterministic: counts,
per-task token times and streams must be equal. The priced loop also runs
with chunked prefill over both engine pairs (paged, and the slot engines
``TorchExecutor``/``JaxExecutor``). Plus the port's package rules: no
jax, no ``repro.*`` imports, and no silent CPU fallback.
"""
from __future__ import annotations

import dataclasses
import os
import re
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from helpers import assert_logits_close  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.core import schedulers as jsched  # noqa: E402
from repro.core import task as jtask  # noqa: E402
from repro.core.latency_model import MeasuredLatencyModel as JLat  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serving.executor import JaxExecutor, PagedJaxExecutor  # noqa: E402
from repro.serving.loop import run_serving_loop as jax_loop  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import schedulers as tsched  # noqa: E402
from repro_torch.core import task as ttask  # noqa: E402
from repro_torch.core.latency_model import MeasuredLatencyModel as TLat  # noqa: E402
from repro_torch.data.workload import poisson_workload as t_workload  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.serving.executor import (_PREFILL_PRIOR,  # noqa: E402
                                          PagedTorchExecutor, TorchExecutor)
from repro_torch.serving.loop import run_serving_loop as torch_loop  # noqa: E402
from repro.data.workload import poisson_workload as j_workload  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ENGINE = dict(n_pages=24, page_size=8, max_seq=64, max_batch=4)


@pytest.fixture(scope="module", params=["edge-6b", "smollm-360m"])
def engines(request):
    jcfg = jax_config(request.param).reduced()
    cfg = get_config(request.param).reduced()
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, jp)

    def make():
        return (PagedJaxExecutor(jcfg, params=jp, **ENGINE),
                PagedTorchExecutor(cfg, params=TM.load_params(cfg, tree,
                                                              device="cpu"),
                                   device="cpu", **ENGINE))
    return make


def _tasks(mod, lens, base):
    return [mod.Task(mod.SLOSpec(tpot_ms=100.0), 1.0, prompt_len=n,
                     output_len=16, task_id=base + i)
            for i, n in enumerate(lens)]


def test_executor_matches_jax(engines):
    jx, tx = engines()
    jt, tt = _tasks(jtask, (5, 17, 9), 900), _tasks(ttask, (5, 17, 9), 900)
    for a, b in zip(jt, tt):
        jx.prefill(a)
        tx.prefill(b)
        assert_logits_close(tx.last_prefill_logits, jx.last_prefill_logits)
    for step in range(4):
        batch = (slice(0, 3), slice(1, 3))[step % 2]   # 3 rows, then 2
        jx.decode(jt[batch])
        tx.decode(tt[batch])
        assert_logits_close(tx.last_logits, jx.last_logits,
                            err_msg=f"decode {step}")
    assert ([tx.generated_tokens(t) for t in tt]
            == [jx.generated_tokens(t) for t in jt])
    assert tx.last_tok == {k: v for k, v in jx.last_tok.items()}
    for a, b in zip(jt, tt):
        assert tx.pool.page_table(b.task_id) == jx.pool.page_table(a.task_id)
        jx.release(a)
        tx.release(b)
    assert tx.pool.used_pages == 0


def test_page_budget_mirrors_jax(engines):
    jx, tx = engines()
    jb, tb = jx.page_budget(), tx.page_budget()
    for f in ("total_pages", "page_size", "prompt_cap", "seq_cap",
              "max_tasks"):
        assert getattr(tb, f) == getattr(jb, f), f


class Priced:
    """Executor wrapper returning priced ms from a LatencyModel instead of
    the measured time, so the serving loop's clock — and with it every
    scheduling decision — is deterministic and backend-independent. It
    records every task's greedy stream from the engine's logits (the JAX
    slot engine has no ``generated_tokens``)."""

    def __init__(self, inner, lat):
        self.inner, self.lat = inner, lat
        self.streams = {}

    def _first(self, task):
        self.streams[task.task_id] = [
            int(self.inner.last_prefill_logits[0].argmax())]

    def prefill(self, task):
        self.inner.prefill(task)
        self._first(task)
        return self.lat.prefill_ms(task.prompt_len)

    def prefill_chunk(self, task, n_tokens):
        _, done = self.inner.prefill_chunk(task, n_tokens)
        if done:
            self._first(task)
        return self.lat.prefill_ms(n_tokens), done

    def decode(self, tasks, depths=None):
        self.inner.decode(tasks)
        for t, row in zip(tasks, self.inner.last_logits):
            self.streams.setdefault(t.task_id, []).append(int(row.argmax()))
        return self.lat.decode_ms(len(tasks))

    def __getattr__(self, name):           # release, page_budget, ...
        return getattr(self.inner, name)


SAMPLES = [(1, 8.0), (2, 9.0), (4, 11.0)]
PREFILL = [(8, 4.0), (64, 12.0)]


def _priced_run(workload, sched_mod, lat_cls, loop, ex, prefill_chunk=None):
    """SLICE loop over ``ex`` on the priced clock; returns the LoopResult and
    every task's generated stream. A slot engine has no page budget:
    SLICE admits it against its slots."""
    lat = lat_cls(SAMPLES, PREFILL)
    tasks = workload(4.0, 3.0, realtime_frac=0.5, seed=5, rt_output_len=6,
                     voice_output_len=10, qa_output_len=12,
                     rt_prompt=(4, 12), voice_prompt=(6, 20),
                     qa_prompt=(8, 28))
    for i, t in enumerate(tasks):              # pin ids: prompts derive from them
        t.task_id = 5000 + i
    budget = ex.page_budget() if hasattr(ex, "page_budget") else None
    sched = sched_mod.SliceScheduler(lat, page_budget=budget,
                                     prefill_chunk=prefill_chunk)
    priced = Priced(ex, lat)
    res = loop(sched, priced, tasks, max_ms=1e6)
    return res, priced.streams


def _assert_same_run(jres, jstreams, tres, tstreams):
    assert len(jres.tasks) == len(tres.tasks) >= 6
    assert jres.decode_iterations > 0
    for f in ("decode_iterations", "prefills", "prefill_chunks", "end_ms",
              "defers_by_reason"):
        assert getattr(tres, f) == getattr(jres, f), f
    for a, b in zip(jres.tasks, tres.tasks):
        assert (a.task_id, a.kind, a.prompt_len, a.output_len) == (
            b.task_id, b.kind, b.prompt_len, b.output_len)
        assert (a.tokens_done, a.finished, a.dropped) == (
            b.tokens_done, b.finished, b.dropped)
        assert a.token_times_ms == b.token_times_ms
    finished = [t.task_id for t in jres.tasks if t.finished]
    assert finished and all(len(jstreams[i]) > 1 for i in finished)
    assert tstreams == jstreams


def test_priced_slice_loop_matches_jax(engines):
    jx, tx = engines()
    jres, jstreams = _priced_run(j_workload, jsched, JLat, jax_loop, jx)
    tres, tstreams = _priced_run(t_workload, tsched, TLat, torch_loop, tx)
    _assert_same_run(jres, jstreams, tres, tstreams)
    assert all(tx.generated_tokens(t) == [] for t in tres.tasks)  # released
    assert tx.pool.used_pages == 0


@pytest.mark.parametrize("kind", ["paged", "slot"])
def test_priced_chunked_slice_loop_matches_jax(kind):
    """SLICE with ``prefill_chunk`` on the priced clock: chunk and decode
    decisions, token times and streams equal the JAX engine's, on the
    paged engines and on the slot engines (16 slots: SLICE admits the
    slot engine against slots only, and the run never runs out)."""
    jcfg = jax_config("edge-6b").reduced()
    cfg = get_config("edge-6b").reduced()
    jp = JM.init_params(jcfg, jax.random.PRNGKey(1))
    tp = TM.load_params(cfg, jax.tree_util.tree_map(np.asarray, jp),
                        device="cpu")
    if kind == "paged":
        jx = PagedJaxExecutor(jcfg, params=jp, prefill_chunk_size=8, **ENGINE)
        tx = PagedTorchExecutor(cfg, params=tp, device="cpu",
                                prefill_chunk_size=8, **ENGINE)
    else:
        slots = dict(max_slots=16, max_seq=64, prefill_chunk_size=8)
        jx = JaxExecutor(jcfg, params=jp, **slots)
        tx = TorchExecutor(cfg, params=tp, device="cpu", **slots)
    jres, jstreams = _priced_run(j_workload, jsched, JLat, jax_loop, jx, 8)
    tres, tstreams = _priced_run(t_workload, tsched, TLat, torch_loop, tx, 8)
    assert jres.prefill_chunks > jres.prefills > 0
    _assert_same_run(jres, jstreams, tres, tstreams)
    if kind == "paged":
        assert tx.pool.used_pages == 0
    else:
        assert sorted(tx.free) == list(range(16))


_SERVE = """
import sys
from repro_torch.launch import serve
serve.main(["--reduced", "--device", "cpu", "--duration", "1.5",
            "--rate", "2", "--slots", "2", "--max-seq", "64", *sys.argv[1:]])
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "repro"
             or m.startswith("repro."))
assert not bad, bad
print("CLEAN")
"""


def _serve_clean(*argv):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _SERVE, *argv], env=env,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "CLEAN" in out.stdout
    assert re.search(r"slice: n=\d+ SLO=", out.stdout)
    return out.stdout


def test_serving_run_imports_no_jax():
    """Also for an SSM arch with the recurrent state swapped with the
    pages."""
    _serve_clean()
    _serve_clean("--arch", "mamba2-780m", "--kv-swap", "--ratio", "0")


def test_spec_prefix_swap_serving_run_imports_no_jax():
    """The CLI with speculative decoding, the prefix cache and KV swap on,
    on the CPU, in a process that never imports JAX or the JAX package;
    the summary line carries the swap and spec counters."""
    out = _serve_clean("--spec-decode", "--prefix-cache",
                       "--shared-prefix-frac", "0.7", "--kv-swap",
                       "--ratio", "0")
    assert re.search(r"suspends=\d+ resumes=\d+ swapped=[\d.]+MB "
                     r"spec_extra=\d+ accepted=\d+/\d+", out)


def test_port_sources_import_no_jax_or_repro():
    pat = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)", re.M)
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    assert len(files) > 20
    hits = [f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
            for f in files for m in pat.finditer(f.read_text())]
    assert not hits, hits
    smoke = (ROOT / "chip_smoke.py").read_text()
    assert not pat.search(smoke)


def test_cuda_request_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    cfg = get_config("edge-6b").reduced()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PagedTorchExecutor(cfg, device="cuda", **ENGINE)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TM.init_params(cfg, device="cuda")


@pytest.mark.parametrize("option", [{"mesh": types.SimpleNamespace(
    shape={"data": 1, "model": 2}, axis_names=("data", "model"),
    coords={"data": 0, "model": 0}, backend="gloo", agree=float)}])
def test_unported_options_raise(option):
    """MoE under a mesh, once refused, is ported: the engine is built on a
    stand-in mesh (no collective runs while one is built), and the rank
    holds the first half of the experts and the whole router."""
    cfg = get_config("granite-moe-3b-a800m").reduced()
    ex = PagedTorchExecutor(cfg, device="cpu", **ENGINE, **option)
    moe = ex.params["blocks"]["moe"]
    assert moe["wg"].shape[1] == moe["wd"].shape[1] == cfg.n_experts // 2
    assert moe["router"].shape[-1] == cfg.n_experts


def test_latency_probe_leaves_pool_empty():
    cfg = get_config("edge-6b").reduced()
    ex = PagedTorchExecutor(cfg, device="cpu", **ENGINE)
    lat = ex.latency_model()
    assert [b for b, _ in ex.probe_samples] == [1, 2, 4]
    assert all(ms > 0 for _, ms in ex.probe_samples)
    assert lat.decode_ms(1) == ex.probe_samples[0][1]
    assert ex.pool.used_pages == 0 and not ex.pool.owners()


def test_unported_arch_kinds_raise():
    """Encoder-only archs have no prefill or decode: the serving entry
    points refuse them, while their weights are made for ``forward``
    (MoE, SSM and hybrid archs serve on both engines)."""
    cfg = dataclasses.replace(get_config("edge-6b").reduced(), causal=False)
    params = TM.init_params(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="encoder-only"):
        TM.prefill(cfg, params, torch.zeros((1, 4), dtype=torch.long), 8)
    with pytest.raises(NotImplementedError, match="encoder-only"):
        TorchExecutor(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="encoder-only"):
        PagedTorchExecutor(cfg, device="cpu", **ENGINE)


@pytest.fixture
def one_cpu_thread():
    """PyTorch's CPU ops on one intra-op thread for a run on the real
    clock. With its default pool (a thread per core) beside the other test
    processes, a reduced decode step that takes ~3 ms alone took ~1.4 s:
    the pool's threads wait on each other at every op while the cores are
    taken. The probed l(1) then exceeds SLICE's 1000 ms period, Eq. 7
    admits no task, and none finishes. On one thread the step slows only
    by the share of a core the process gets (~40 ms beside ten busy
    processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def fixed_latency_model(monkeypatch):
    """The slot engine probes l(b) as it always does (the probe runs and
    must leave every slot free), but SLICE is handed a fixed curve,
    rising with the batch, in place of the probed one. On a loaded CPU the
    wall-clock probe is not monotone: a probe that caught l(1) above twice
    l(8) prices a lone QA task's cycle above SLICE's 1000 ms budget after
    ``shape_workload`` scales the SLOs by l(8), so Eq. 7 defers every task
    as infeasible, the loop ends drained with none served, and the run
    fails for the noise of the probe, not for the scheduler or the
    engine. The engine's own steps still run on the real clock."""
    probe = TorchExecutor.latency_model
    curve = [(1, 2.0), (2, 2.1), (4, 2.3), (8, 2.7), (16, 3.5)]

    def latency_model(self):
        probe(self)
        assert all(ms > 0 for _, ms in self.probe_samples)
        assert sorted(self.free) == list(range(self.max_slots))
        self.probe_samples = list(curve)
        return TLat(curve, _PREFILL_PRIOR)

    monkeypatch.setattr(TorchExecutor, "latency_model", latency_model)


def test_slot_chunked_serving_run(one_cpu_thread, fixed_latency_model):
    """The CLI over the slot engine with chunked prefill, on the CPU: every
    task finishes, chunks ran, and every slot is free at the end."""
    run = tserve.run(tserve.parse_args([
        "--reduced", "--device", "cpu", "--executor", "slot",
        "--prefill-chunk", "8", "--slots", "16", "--max-seq", "64",
        "--duration", "1.5", "--rate", "2", "--ratio", "0"]))
    assert isinstance(run.executor, TorchExecutor)
    assert run.result.prefill_chunks >= run.result.prefills > 0
    assert all(t.finished for t in run.result.tasks)
    assert sorted(run.executor.free) == list(range(16))


@pytest.mark.parametrize("argv", [["--prefill-chunk", "8", "--scheduler",
                                   "orca"],
                                  ["--prefill-chunk", "8", "--scheduler",
                                   "fastserve", "--executor", "slot"]])
def test_cli_refuses_chunking_without_slice(argv):
    with pytest.raises(SystemExit, match="requires --scheduler slice"):
        tserve.run(tserve.parse_args(["--reduced", "--device", "cpu",
                                      *argv]))


@pytest.mark.parametrize("argv,match", [
    (["--spec-decode", "--executor", "slot"], "requires --executor paged"),
    (["--spec-decode", "--scheduler", "orca"], "requires --scheduler slice"),
    (["--spec-decode", "--scheduler", "fastserve"],
     "requires --scheduler slice"),
    (["--prefix-cache", "--executor", "slot"], "requires --executor paged"),
    (["--kv-swap", "--executor", "slot"], "requires --executor paged"),
    (["--kv-swap", "--scheduler", "orca"],
     "requires --scheduler slice or fastserve"),
    (["--async-pipeline", "--executor", "slot"],
     "requires --executor paged")])
def test_cli_refuses_spec_prefix_swap_where_jax_does(argv, match):
    """The JAX CLI's refusals, raised before any engine is built."""
    with pytest.raises(SystemExit, match=match):
        tserve.run(tserve.parse_args(["--reduced", "--device", "cpu",
                                      *argv]))
