"""The port's compiled decode-type steps (``serving.step_graphs``) and the
sync-free steps they capture, held against the JAX package on the CPU.

(a) ``decode_step_paged`` on reduced dense (edge-6b), SSM (mamba2-780m),
MoE (granite-moe-3b-a800m) and hybrid (hymba-1.5b) arenas, and
``verify_step_paged`` on a dense one, run with every host-sync entry point
patched to raise (``torch.nonzero``, ``Tensor.nonzero``, ``.item``,
``.tolist``, ``.cpu``, ``.numpy``, ``Tensor.__bool__``, ``__int__``,
``__float__``): the steps still equal JAX's at atol 1e-5, with identical
greedy streams. (b) Pad, inactive and untabled rows write only the
arenas' spare page and slot: every pool page and state slot that is not a
live row's target stays bit for bit. (c) Both torch executors run through
the staged step path over batch buckets 1, 2 and 4 (the slot engine
masked and compacted) and verify depths 1 and 3: streams and logits equal
``PagedJaxExecutor`` / ``JaxExecutor`` at 1e-5. (d) The launch-count
contract: a capture's launches are recorded and taken back out of
``ops.LAUNCHES``, and added again on every replay, through the replay
hook with a recorded delta (nothing can be captured here); a replay on a
rebound arena raises. (e) ``last_logits`` is a device-side copy read
lazily: it equals the eager values even after later steps. (f) The
prefill-type steps: ``prefill_chunk_paged`` (dense and MoE) with every
host sync raising, equal to JAX's, its untabled tokens writing only the
spare page; each engine's staged steps (the whole prompt per length with
its splice for every arch, the paged and slot chunk pieces, the paged
prefix-hit suffix, the draft's catch-up and masked decode) run with their
step functions under the same guard and equal the JAX engines (logits
within 1e-5, identical streams, arenas equal on the pool's part); their
pad inputs, which a capture's warm-up runs, write only the spare page,
state slot or slot-cache row.
"""
from __future__ import annotations

import contextlib
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from helpers import assert_logits_close  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.core import task as jtask  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serving import spec_decode as jspec  # noqa: E402
from repro.serving.executor import JaxExecutor, PagedJaxExecutor  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import task as ttask  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.serving import spec_decode as tspec  # noqa: E402
from repro_torch.serving import step_graphs as SG  # noqa: E402
from repro_torch.serving.executor import (PagedTorchExecutor,  # noqa: E402
                                          TorchExecutor)

ARCHS = ["edge-6b", "mamba2-780m", "granite-moe-3b-a800m", "hymba-1.5b"]
PSZ, N_PAGES, MAXP, BUF, N_SLOTS = 4, 12, 6, 24, 4
SYNCS = [(torch, "nonzero"), (torch.Tensor, "nonzero"),
         (torch.Tensor, "item"), (torch.Tensor, "tolist"),
         (torch.Tensor, "cpu"), (torch.Tensor, "numpy"),
         (torch.Tensor, "__bool__"), (torch.Tensor, "__int__"),
         (torch.Tensor, "__float__")]


@contextlib.contextmanager
def no_host_sync():
    """Every host-sync entry point of a tensor raises inside the block."""
    saved = [(obj, name, getattr(obj, name)) for obj, name in SYNCS]

    def raiser(name):
        def f(*a, **k):
            raise AssertionError(f"host sync: {name} called in a step")
        return f

    try:
        for obj, name, _ in saved:
            setattr(obj, name, raiser(name))
        yield
    finally:
        for obj, name, fn in saved:
            setattr(obj, name, fn)


def test_no_host_sync_guard_catches_syncs():
    t = torch.ones(3)
    with no_host_sync():
        for bad in (lambda: t.nonzero(), lambda: torch.nonzero(t),
                    lambda: t.sum().item(), lambda: bool(t[0] > 0),
                    lambda: t.tolist(), lambda: int(t[0])):
            with pytest.raises(AssertionError, match="host sync"):
                bad()
    assert bool(t[0] > 0) and t.nonzero().shape == (3, 1)


@functools.lru_cache(maxsize=None)
def _pair(arch):
    """(JAX config, port config, JAX params, the same weights in the
    port) of a reduced arch, made once."""
    jcfg = jax_config(arch).reduced()
    cfg = get_config(arch).reduced()
    jp = JM.init_params(jcfg, jax.random.PRNGKey(5))
    tree = jax.tree_util.tree_map(np.asarray, jp)
    return jcfg, cfg, jp, TM.load_params(cfg, tree, device="cpu")


def _prefilled(arch, tables=((3, 7), (0, 9, 2)), slots=(2, 0),
               prompts=(5, 11)):
    """JAX and torch arenas with two prompts prefilled into the given
    pages and state slots; returns (jcfg, cfg, jp, tp, jpages, tpages,
    first tokens)."""
    jcfg, cfg, jp, tp = _pair(arch)
    rng = np.random.default_rng(11)
    jpages = JM.init_paged_cache(jcfg, N_PAGES, PSZ)
    tpages = TM.init_paged_cache(cfg, N_PAGES, PSZ, device="cpu")
    if cfg.has_ssm:
        jpages.update(JM.init_state_arena(jcfg, N_SLOTS))
        tpages.update(TM.init_state_arena(cfg, N_SLOTS, device="cpu"))
    toks = []
    for n, phys, slot in zip(prompts, tables, slots):
        prompt = rng.integers(0, cfg.vocab_size, (1, n))
        jl, jc = JM.prefill(jcfg, jp, jnp.asarray(prompt), buf_len=BUF)
        _, tc = TM.prefill(cfg, tp, torch.from_numpy(prompt), buf_len=BUF)
        idx = np.asarray(phys)
        if cfg.has_attention:
            for name, key in (("k_pages", "k"), ("v_pages", "v")):
                src = np.asarray(jc[key])[:, 0, :, :len(phys) * PSZ]
                view = src.reshape(src.shape[0], src.shape[1], len(phys),
                                   PSZ, -1).swapaxes(1, 2)
                jpages[name] = jpages[name].at[:, idx].set(view)
                tsrc = tc[key][:, 0, :, :len(phys) * PSZ]
                tpages[name][:, torch.as_tensor(idx)] = tsrc.reshape(
                    tsrc.shape[0], tsrc.shape[1], len(phys), PSZ,
                    -1).transpose(1, 2)
        if cfg.has_ssm:
            for name, key in (("ssm_state", "ssm"), ("conv_state", "conv")):
                jpages[name] = jpages[name].at[:, slot].set(
                    jc[key][:, 0].astype(jpages[name].dtype))
                tpages[name][:, slot] = tc[key][:, 0].to(tpages[name].dtype)
        toks.append(int(np.asarray(jl)[0].argmax()))
    return jcfg, cfg, jp, tp, jpages, tpages, toks


def _close_arenas(tpages, jpages):
    for name in tpages:
        want = np.asarray(jpages[name])
        scale = max(1.0, float(np.abs(want).max(initial=0.0)))
        assert_logits_close(tpages[name][:, :want.shape[1]].float().numpy(),
                            want, atol=1e-5 * (scale if name == "ssm_state"
                                               else 1.0), err_msg=name)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_paged_has_no_host_sync(arch):
    """Four decode steps over a 4-row batch (row 1 inactive on the
    second step, row 2 a pad row: table all -1 and slot -1, row 3 active
    with its table cut short: untabled), every host sync raising: live
    rows' logits and the arenas equal JAX's, and the greedy streams are
    identical."""
    jcfg, cfg, jp, tp, jpages, tpages, toks = _prefilled(arch)
    tables = [[3, 7], [0, 9, 2]]
    lengths = [5, 11, 0, 9]
    toks = toks + [0, 3]
    streams = {"jax": [[], []], "torch": [[], []]}
    for step in range(4):
        act = [True, step != 1, False, True]
        pt = np.full((4, MAXP), -1, np.int32)
        for r in range(2):
            while len(tables[r]) < lengths[r] // PSZ + 1:
                tables[r].append(N_PAGES - 1 - len(tables[0])
                                 - len(tables[1]))
            pt[r, :len(tables[r])] = tables[r]
        pt[3, :2] = [10, 11]                 # positions 8.. have no page
        kw_j, kw_t = {}, {}
        if cfg.has_ssm:
            sl = np.array([2, 0, -1, 3], np.int32)
            kw_j["state_slots"] = jnp.asarray(sl)
            kw_t["state_slots"] = torch.from_numpy(sl)
        args = [pt, np.asarray(lengths, np.int32), np.asarray(toks, np.int32),
                np.asarray(act)]
        jl, jpages = JM.decode_step_paged(jcfg, jp, jpages,
                                          *map(jnp.asarray, args), **kw_j)
        targs = list(map(torch.from_numpy, args))
        with no_host_sync():
            tl, tpages = TM.decode_step_paged(cfg, tp, tpages, *targs, **kw_t)
        live = np.array([act[0], act[1], False, False])
        assert_logits_close(tl.numpy()[live], np.asarray(jl)[live],
                            err_msg=f"{arch} step {step}")
        _close_arenas(tpages, jpages)
        for r in range(2):
            if act[r]:
                streams["jax"][r].append(int(np.asarray(jl)[r].argmax()))
                streams["torch"][r].append(int(tl[r].argmax()))
                toks[r] = streams["jax"][r][-1]
                lengths[r] += 1
    assert streams["torch"] == streams["jax"]


def test_verify_step_paged_has_no_host_sync():
    """Verify windows of C = 2 and 4 over two prefilled rows and a pad
    row (table all -1), every host sync raising: the real rows' logits at
    every position and the arena equal JAX's, and the windows' greedy
    argmax are identical."""
    jcfg, cfg, jp, tp, jpages, tpages, toks = _prefilled(
        "edge-6b", tables=((3, 7, 4), (0, 9, 2, 5)))
    rng = np.random.default_rng(3)
    for C, lengths in ((2, [5, 11, 0]), (4, [7, 13, 0])):
        pt = np.full((3, MAXP), -1, np.int32)
        pt[0, :3], pt[1, :4] = [3, 7, 4], [0, 9, 2, 5]
        tk = rng.integers(0, cfg.vocab_size, (3, C)).astype(np.int32)
        args = [pt, np.asarray(lengths, np.int32), tk]
        jl, jpages = JM.verify_step_paged(jcfg, jp, jpages,
                                          *map(jnp.asarray, args))
        targs = list(map(torch.from_numpy, args))
        with no_host_sync():
            tl, tpages = TM.verify_step_paged(cfg, tp, tpages, *targs)
        assert_logits_close(tl.numpy()[:2], np.asarray(jl)[:2],
                            err_msg=f"C={C}")
        _close_arenas(tpages, jpages)
        assert (tl[:2].argmax(-1).numpy()
                == np.asarray(jl)[:2].argmax(-1)).all()


@pytest.mark.parametrize("arch", ARCHS)
def test_rows_that_must_not_write_write_only_the_spare(arch):
    """One decode step where only row 0 writes (slot 2, page 7 at offset
    1): an inactive row, a pad row and an active untabled row without a
    state slot ride along.
    Every pool page but the written one, the written page but its offset,
    and every state slot but row 0's are bit for bit what they were; the
    spare page and slot may change."""
    _, cfg, _, tp, _, tpages, toks = _prefilled(arch)
    before = {k: v.clone() for k, v in tpages.items()}
    pt = np.full((4, MAXP), -1, np.int32)
    pt[0, :2], pt[1, :3], pt[3, :1] = [3, 7], [0, 9, 2], [10]
    kw = {}
    if cfg.has_ssm:
        kw["state_slots"] = torch.tensor([2, 0, -1, -1], dtype=torch.int32)
    TM.decode_step_paged(cfg, tp, tpages, torch.from_numpy(pt),
                         torch.tensor([5, 11, 0, 9], dtype=torch.int32),
                         torch.tensor(toks + [0, 1], dtype=torch.int32),
                         torch.tensor([True, False, True, True]), **kw)
    if cfg.has_attention:
        for name in ("k_pages", "v_pages"):
            changed = tpages[name] != before[name]
            assert changed[:, 7, :, 1].any()          # row 0: position 5
            changed[:, 7, :, 1] = False
            changed[:, N_PAGES] = False               # the spare page
            assert not changed.any(), name
    if cfg.has_ssm:
        for name in ("ssm_state", "conv_state"):
            changed = (tpages[name] != before[name]).flatten(2).any(-1)
            assert changed[:, 2].all()                # row 0's slot
            changed[:, 2] = False
            changed[:, N_SLOTS] = False               # the spare slot
            assert not changed.any(), name


def test_verify_pad_rows_write_only_the_spare():
    """A verify window of C = 3 for one row beside two pad rows (tables
    all -1): only the row's three positions and the spare page change."""
    _, cfg, _, tp, _, tpages, toks = _prefilled("edge-6b")
    before = {k: v.clone() for k, v in tpages.items()}
    pt = np.full((3, MAXP), -1, np.int32)
    pt[0, :2] = [3, 7]
    TM.verify_step_paged(cfg, tp, tpages, torch.from_numpy(pt),
                         torch.tensor([5, 0, 0], dtype=torch.int32),
                         torch.tensor([[toks[0], 1, 2]] * 3,
                                      dtype=torch.int32))
    for name in ("k_pages", "v_pages"):
        changed = tpages[name] != before[name]
        assert changed[:, 7, :, 1:4].any(-1).any(1).all()
        changed[:, 7, :, 1:4] = False
        changed[:, N_PAGES] = False
        assert not changed.any(), name


# ------------------------------------------------------------ executors

ENGINE = dict(n_pages=32, page_size=8, max_seq=64, max_batch=4)


@pytest.fixture(scope="module")
def weights():
    jcfg = jax_config("edge-6b").reduced()
    cfg = get_config("edge-6b").reduced()
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, cfg, jp, jax.tree_util.tree_map(np.asarray, jp)


def _tasks(mod, lens, base, out=40):
    return [mod.Task(mod.SLOSpec(tpot_ms=100.0), 1.0, prompt_len=n,
                     output_len=out, task_id=base + i)
            for i, n in enumerate(lens)]


def test_paged_executor_staged_steps_match_jax(weights):
    """Spec engines with a self-draft, over decode buckets 1, 2 and 4
    (1, 2 and 3 tasks) and verify windows at depths 1 and 3 (depth
    buckets 1 and 4): the steps run through the engine's staged steps,
    one per key, and the streams, logits and commits equal JAX's."""
    jcfg, cfg, jp, tree = weights
    tp = TM.load_params(cfg, tree, device="cpu")
    jx = PagedJaxExecutor(jcfg, params=jp, spec_decode=True, draft_cfg=jcfg,
                          draft_params=jp, max_spec_depth=4, **ENGINE)
    tx = PagedTorchExecutor(cfg, params=tp, spec_decode=True, draft_cfg=cfg,
                            draft_params=tp, max_spec_depth=4, device="cpu",
                            **ENGINE)
    assert not tx.graphs.capture                # nothing is captured here
    jt, tt = _tasks(jtask, (5, 17, 9), 5100), _tasks(ttask, (5, 17, 9), 5100)
    for a, b in zip(jt, tt):
        jx.prefill(a)
        tx.prefill(b)
    plan = [(1, None), (2, None), (3, None), (3, [1, 1, 1]), (2, [3, 3]),
            (1, [3]), (3, None), (2, [1, 3])]
    for n, depths in plan:
        jx.decode(jt[:n], depths)
        tx.decode(tt[:n], depths)
        assert tx.last_commits == jx.last_commits
        assert_logits_close(tx.last_logits, jx.last_logits,
                            err_msg=f"n={n} depths={depths}")
    assert ([tx.generated_tokens(t) for t in tt]
            == [jx.generated_tokens(t) for t in jt])
    ran = {k for k, st in tx.graphs.steps.items() if st.runs}
    assert ran == {("decode", 1), ("decode", 2), ("decode", 4),
                   ("verify", 4, 1), ("verify", 2, 4), ("verify", 1, 4),
                   ("prefill", 5), ("prefill", 17), ("prefill", 9)}
    # every verify bucket is made before the first verify is timed
    assert {k for k in tx.graphs.steps if k[0] == "verify"} == {
        ("verify", b, K) for b in (1, 2, 4) for K in (1, 2, 4)}
    for a, b in zip(jt, tt):
        jx.release(a)
        tx.release(b)
    assert tx.pool.used_pages == 0


@pytest.mark.parametrize("compact", [False, True], ids=["masked", "compact"])
def test_slot_executor_staged_steps_match_jax(weights, compact):
    """Slot engines over 1, 2 and 3 active slots (compacted: buckets 1, 2
    and 4): the staged masked step, or one staged step per compacted
    bucket, gives JAX's logits and streams."""
    jcfg, cfg, jp, tree = weights
    jx = JaxExecutor(jcfg, params=jp, max_slots=4, max_seq=64,
                     compact_buckets=compact)
    tx = TorchExecutor(cfg, params=TM.load_params(cfg, tree, device="cpu"),
                       max_slots=4, max_seq=64, compact_buckets=compact,
                       device="cpu")
    jt, tt = _tasks(jtask, (5, 17, 9), 5200), _tasks(ttask, (5, 17, 9), 5200)
    want = []
    for a, b in zip(jt, tt):
        jx.prefill(a)
        tx.prefill(b)
        want.append([int(jx.last_prefill_logits[0].argmax())])
    for sel in ((0,), (0, 2), (0, 1, 2), (1,), (2, 1), (0, 1, 2)):
        jx.decode([jt[i] for i in sel])
        tx.decode([tt[i] for i in sel])
        assert_logits_close(tx.last_logits, jx.last_logits,
                            err_msg=f"decode {sel}")
        for r, i in enumerate(sel):
            want[i].append(int(jx.last_logits[r].argmax()))
    assert [tx.generated_tokens(t) for t in tt] == want
    want = ({("compact", 1), ("compact", 2), ("compact", 4)} if compact
            else {("masked", 4)})
    want |= {("prefill", 5), ("prefill", 17), ("prefill", 9)}
    assert set(tx.graphs.steps) == want
    assert all(st.runs for st in tx.graphs.steps.values())


# ------------------------------------------------------ launch counting

def test_recorded_launches_restore_the_counter():
    """``ops.recorded_launches`` returns what the call launched and
    leaves ``LAUNCHES`` as it was, also when the call raises."""
    start = dict(ops.LAUNCHES)

    def launch_some():
        ops.LAUNCHES["paged_decode_attention"] += 3
        ops.LAUNCHES["moe_grouped_ffn"] += 2
        return "out"

    out, delta = ops.recorded_launches(launch_some)
    assert out == "out" and ops.LAUNCHES == start
    assert delta == {**{k: 0 for k in start}, "paged_decode_attention": 3,
                     "moe_grouped_ffn": 2}

    def fails():
        ops.LAUNCHES["ssd_scan"] += 1
        raise ValueError("refused")

    with pytest.raises(ValueError, match="refused"):
        ops.recorded_launches(fails)
    assert ops.LAUNCHES == start


class _FakeGraph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def test_replay_adds_the_recorded_launches_and_checks_the_arenas():
    """A step's replay hook, given a recorded capture delta and a graph
    stand-in: each replay adds the delta to ``LAUNCHES`` (a replayed step
    counts as the eager one), and a replay after an arena was rebound
    raises instead of writing the old tensor."""
    arena = {"k_pages": torch.zeros(2, 3)}
    step = SG.Step(torch.device("cpu"), {"x": ((2,), torch.int32, 0)},
                   lambda x: (x["x"] * 2,), lambda: list(arena.values()),
                   capture=True)
    with pytest.raises(RuntimeError, match="no graph"):
        step.run({"x": np.array([1, 2], np.int32)})

    def eager_launches():
        ops.LAUNCHES["paged_decode_attention"] += 2
        ops.LAUNCHES["ssd_decode_step"] += 1
        return (step.inputs["x"] * 2,)

    step.outputs, step.launches = ops.recorded_launches(eager_launches)
    step.graph = _FakeGraph()
    step._arena_ptrs = [t.data_ptr() for t in arena.values()]
    ops.reset_launches()
    for _ in range(3):
        out = step.run({"x": np.array([1, 2], np.int32)})
    assert step.graph.replays == 3 and step.runs == 3
    assert ops.LAUNCHES["paged_decode_attention"] == 6
    assert ops.LAUNCHES["ssd_decode_step"] == 3
    assert sum(ops.LAUNCHES.values()) == 9
    assert out is step.outputs
    assert step.inputs["x"].tolist() == [1, 2]        # staged in place
    arena["k_pages"] = torch.zeros(2, 3)                # rebound
    with pytest.raises(RuntimeError, match="arena"):
        step.run({"x": np.array([3, 4], np.int32)})
    assert step.graph.replays == 3
    ops.reset_launches()


def test_uncaptured_step_stages_and_counts_as_eager():
    """Without capture (the CPU, or ``cuda_graphs=False``) ``run`` stages
    the host arrays into the static inputs and runs the step function
    every call; the pads are the inputs' first values."""
    graphs = SG.StepGraphs(torch.device("cpu"), capture=True)
    assert not graphs.capture and graphs.pool is None
    seen = []
    spec = {"idx": ((3,), torch.int64, np.arange(3)),
            "valid": ((3,), torch.bool, False)}
    step = graphs.step("k", spec, lambda x: seen.append(
        (x["idx"].tolist(), x["valid"].tolist())) or (x["idx"],),
        lambda: [])
    assert graphs.step("k", {}, None, None) is step
    assert step.inputs["idx"].tolist() == [0, 1, 2]
    assert step.inputs["valid"].tolist() == [False] * 3
    step.run({"idx": np.array([2, 0, 1]), "valid": np.array([1, 0, 1], bool)})
    assert seen == [([2, 0, 1], [True, False, True])] and step.graph is None
    assert step.runs == 1


# --------------------------------------------------------- lazy logits

def test_lazy_logits_copy_now_and_read_later():
    """``LazyLogits`` copies on the device when made, so a later write to
    the step's output buffer does not reach it; rows and picks select as
    the executors need."""
    t = torch.arange(24, dtype=torch.float32).reshape(2, 3, 4)
    lazy = SG.LazyLogits(t, pick=[2, 0])
    rows = SG.LazyLogits(t[:, 0], rows=[1])
    want_pick = t.numpy()[[0, 1], [2, 0]].copy()
    want_rows = t.numpy()[[1], 0].copy()
    t.zero_()                                           # the next replay
    np.testing.assert_array_equal(lazy.numpy(), want_pick)
    np.testing.assert_array_equal(rows.numpy(), want_rows)
    assert lazy.numpy() is lazy.numpy()


def test_executor_last_logits_are_the_eager_values(weights):
    """A decode's ``last_logits`` read only after two more steps (of
    other buckets) equals the values a twin engine read at once, and both
    equal the model's eager step on the same inputs."""
    _, cfg, _, tree = weights
    twins = [PagedTorchExecutor(cfg, params=TM.load_params(cfg, tree,
                                                           device="cpu"),
                                device="cpu", **ENGINE) for _ in range(2)]
    tasks = _tasks(ttask, (6, 10), 5300)
    for ex in twins:
        for t in tasks:
            ex.prefill(t)
    lengths = torch.tensor([twins[0].pool.length(t.task_id) for t in tasks],
                           dtype=torch.int32)
    toks = torch.tensor([twins[0].last_tok[t.task_id] for t in tasks],
                        dtype=torch.int32)
    pages = {k: v.clone() for k, v in twins[0].pages.items()}
    for ex in twins:
        ex.decode(tasks)
    # the table the step used: the pool extends before the step
    pt = torch.from_numpy(twins[0]._table_np([t.task_id for t in tasks], 2))
    eager, _ = TM.decode_step_paged(cfg, twins[0].params, pages, pt,
                                    lengths, toks)
    now = twins[1].last_logits
    held = twins[0]._last_logits
    twins[0].decode(tasks[:1])
    twins[0].decode(tasks)
    np.testing.assert_array_equal(held.numpy(), now)
    np.testing.assert_array_equal(now, eager.numpy())


# ------------------------------------------------------ prefill-type steps

CHUNK_ARCHS = ["edge-6b", "granite-moe-3b-a800m"]   # attention-only archs


def _guard_steps(graphs):
    """Run the function of every step ``graphs`` holds under
    ``no_host_sync``: the staging (host work) stays outside the guard, the
    step itself (what a capture records) inside."""
    def guarded(fn):
        def run(x):
            with no_host_sync():
                return fn(x)
        return run

    for st in graphs.steps.values():
        st.fn = guarded(st.fn)


@pytest.mark.parametrize("arch", CHUNK_ARCHS)
def test_prefill_chunk_paged_has_no_host_sync(arch):
    """Chunks of C = 3, then 5, over two prefilled rows, a row whose table
    ends mid-chunk (its later tokens untabled) and a pad row (table all
    -1), every host sync raising: the two prefilled rows' last logits and
    the arena equal JAX's (JAX drops the untabled tokens' writes, the port
    sends them to the spare page), and their greedy argmax is identical."""
    jcfg, cfg, jp, tp, jpages, tpages, _ = _prefilled(
        arch, tables=((3, 7, 4), (0, 9, 2, 5)))
    rng = np.random.default_rng(4)
    pt = np.full((4, MAXP), -1, np.int32)
    pt[0, :4], pt[1, :5], pt[2, :2] = [3, 7, 4, 6], [0, 9, 2, 5, 8], [10, 11]
    for C, lengths in ((3, [5, 11, 6, 0]), (5, [8, 14, 9, 0])):
        tk = rng.integers(0, cfg.vocab_size, (4, C)).astype(np.int32)
        args = [pt, np.asarray(lengths, np.int32), tk]
        jl, jpages = JM.prefill_chunk_paged(jcfg, jp, jpages,
                                            *map(jnp.asarray, args))
        targs = list(map(torch.from_numpy, args))
        with no_host_sync():
            tl, tpages = TM.prefill_chunk_paged(cfg, tp, tpages, *targs)
        assert_logits_close(tl.numpy()[:2], np.asarray(jl)[:2],
                            err_msg=f"{arch} C={C}")
        _close_arenas(tpages, jpages)
        assert (tl[:2].argmax(-1).numpy()
                == np.asarray(jl)[:2].argmax(-1)).all()


def test_untabled_chunk_tokens_write_only_the_spare():
    """A chunk of C = 6 at position 5 for a row whose table covers 8
    positions, beside a pad row: positions 5-7 write their page, the three
    untabled ones and the pad row only the spare page."""
    _, cfg, _, tp, _, tpages, _ = _prefilled("edge-6b")
    before = {k: v.clone() for k, v in tpages.items()}
    pt = np.full((2, MAXP), -1, np.int32)
    pt[0, :2] = [3, 7]
    TM.prefill_chunk_paged(cfg, tp, tpages, torch.from_numpy(pt),
                           torch.tensor([5, 0], dtype=torch.int32),
                           torch.ones((2, 6), dtype=torch.int32))
    for name in ("k_pages", "v_pages"):
        changed = tpages[name] != before[name]
        assert changed[:, 7, :, 1:4].any(-1).any(1).all()
        changed[:, 7, :, 1:4] = False
        assert changed[:, N_PAGES].any()              # the spare page
        changed[:, N_PAGES] = False
        assert not changed.any(), name


SMALL = dict(n_pages=32, page_size=8, max_seq=64, max_batch=4)


def _paged_pair(arch, **kw):
    jcfg, cfg, jp, tp = _pair(arch)
    return (PagedJaxExecutor(jcfg, params=jp, **SMALL, **kw),
            PagedTorchExecutor(cfg, params=tp, device="cpu", **SMALL, **kw))


def _drive(jx, tx, jt, tt, prefill, decodes=3):
    """``prefill(ex, task)`` each task on both engines (prefill logits
    within 1e-5), then ``decodes`` decode steps of every task; the greedy
    streams read from each engine's logits identical, decode logits within
    1e-5 and the arenas equal on the pool's part."""
    streams = {"jax": [], "torch": []}
    for a, b in zip(jt, tt):
        prefill(jx, a)
        prefill(tx, b)
        assert_logits_close(tx.last_prefill_logits, jx.last_prefill_logits,
                            err_msg=f"prefill {b.task_id}")
        for name, ex in (("jax", jx), ("torch", tx)):
            streams[name].append([int(ex.last_prefill_logits[0].argmax())])
    for step in range(decodes):
        jx.decode(jt)
        tx.decode(tt)
        assert_logits_close(tx.last_logits, jx.last_logits,
                            err_msg=f"decode {step}")
        for name, ex in (("jax", jx), ("torch", tx)):
            for row, logits in zip(streams[name], ex.last_logits):
                row.append(int(logits.argmax()))
    assert streams["torch"] == streams["jax"]
    if hasattr(tx, "pages"):
        _close_arenas(tx.pages, jx.pages)


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_prefill_step_has_no_host_sync(arch):
    """The paged engine's whole-prompt steps (one per prompt length, the
    splice into the task's pages and state slot inside), their functions
    run with every host sync raising: prefill logits, the decode after
    them, the streams and the page and state arenas equal
    ``PagedJaxExecutor``'s; one step per length."""
    jx, tx = _paged_pair(arch)
    lens = (5, 17)
    for n in lens:
        tx._prefill_step(n)
    _guard_steps(tx.graphs)
    _drive(jx, tx, _tasks(jtask, lens, 5400), _tasks(ttask, lens, 5400),
           lambda ex, t: ex.prefill(t))
    assert {k for k in tx.graphs.steps if k[0] == "prefill"} == {
        ("prefill", 5), ("prefill", 17)}


@pytest.mark.parametrize("arch", CHUNK_ARCHS)
def test_slot_prefill_and_chunk_steps_have_no_host_sync(arch):
    """The slot engine's whole-prompt step and chunk steps (pieces 8, 4,
    2, 1: a 15-token prompt in chunks of 8), their functions run with
    every host sync raising: logits, the decode after them, the streams
    and the cache's slot rows equal ``JaxExecutor``'s."""
    jcfg, cfg, jp, tp = _pair(arch)
    kw = dict(max_slots=3, max_seq=64, prefill_chunk_size=8)
    jx = JaxExecutor(jcfg, params=jp, **kw)
    tx = TorchExecutor(cfg, params=tp, device="cpu", **kw)
    tx._prefill_step(9)
    for c in (8, 4, 2, 1):
        SG.chunk_step(tx, c)
    _guard_steps(tx.graphs)

    def prefill(ex, t):
        if t.prompt_len == 9:
            ex.prefill(t)
        else:
            while not ex.prefill_chunk(t, 8)[1]:
                pass

    _drive(jx, tx, _tasks(jtask, (9, 15), 5500), _tasks(ttask, (9, 15), 5500),
           prefill)
    S = tx.max_slots
    for k, v in tx.cache.items():
        rows = (v[:, :S] if k in ("k", "v") else v[:S]).numpy()
        assert_logits_close(rows, np.asarray(jx.cache[k]), err_msg=k)
    assert all(tx.graphs.steps[("chunk", c)].runs for c in (8, 4, 2, 1))


def test_paged_chunk_and_suffix_steps_match_jax():
    """Prefix-cache engines with chunks of 8: a whole prompt, a prefix
    hit whose suffix runs in power-of-two pieces, a chunked prompt and a
    chunked prefix hit, every chunk-step function run with every host sync
    raising: logits, streams, hits and the arena equal JAX's."""
    jx, tx = _paged_pair("edge-6b", prefill_chunk_size=8, prefix_cache=True)
    for c in (1, 2, 4, 8):
        tx._chunk_step(c)
    _guard_steps(tx.graphs)
    lens, groups = (20, 23, 19, 22), (0, 0, None, 0)
    jt, tt = _tasks(jtask, lens, 5600), _tasks(ttask, lens, 5600)
    for t, g in zip(jt + tt, groups + groups):
        t.prefix_group, t.prefix_len = g, (16 if g is not None else 0)

    def prefill(ex, t):
        if t.task_id in (5600, 5601):
            ex.prefill(t)
        else:
            while not ex.prefill_chunk(t, 8)[1]:
                pass

    _drive(jx, tx, jt, tt, prefill, decodes=2)
    assert tx.prefix_cache.hits == jx.prefix_cache.hits >= 2
    assert {k for k in tx.graphs.steps if k[0] == "chunk"} == {
        ("chunk", c) for c in (1, 2, 4, 8)}
    assert all(tx.graphs.steps[("chunk", c)].runs for c in (1, 2, 4, 8))


def test_staged_draft_matches_jax_without_host_sync():
    """The draft model's staged steps (the masked decode over its slots
    and the catch-up chunk per power of two), every step function run
    with every host sync raising: drafts, the slots and the cache's slot
    rows equal JAX's ``DraftModel`` over a catch-up from scratch, a
    partial one after ``note_commit`` and a re-prefill after ``drop``."""
    jcfg, cfg, jp, tp = _pair("edge-6b")
    jd = jspec.DraftModel(jcfg, params=jp, max_slots=3, max_seq=64)
    td = tspec.DraftModel(cfg, params=tp, max_slots=3, max_seq=64,
                          device="cpu")
    td.make_steps()
    assert set(td.graphs.steps) == {("masked", 3)} | {
        ("chunk", c) for c in (1, 2, 4, 8, 16, 32)}
    _guard_steps(td.graphs)
    rng = np.random.default_rng(5)
    hist = {i: rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32)
            for i, n in ((1, 13), (2, 6))}

    def both(ids, depths):
        items = [(i, hist[i], int(hist[i][-1])) for i in ids]
        out = td.propose(items, depths)
        assert out == jd.propose(items, depths)
        return out

    for i, d in zip((1, 2), both([1, 2], [3, 2])):
        hist[i] = np.concatenate([hist[i], np.asarray(d[:1] + [7], np.int32)])
        jd.note_commit(i, len(hist[i]) - 1)
        td.note_commit(i, len(hist[i]) - 1)
    both([2, 1], [2, 4])
    jd.drop(2)
    td.drop(2)
    both([2], [3])
    assert td.slot_of == jd.slot_of
    for k, v in td.cache.items():
        rows = (v[:, :3] if k in ("k", "v") else v[:3]).numpy()
        assert_logits_close(rows, np.asarray(jd.cache[k]), err_msg=k)


def _run_at_pads(st):
    """Run a step's function on its pad inputs, as a capture's warm-up."""
    st.stage({name: np.array(pad) for name, pad in st.pads.items()})
    st.fn(st.inputs)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_step_pads_write_only_the_spare(arch):
    """A capture's warm-up runs a step on its pad inputs: the paged
    whole-prompt step and chunk step at their pads change only the spare
    page and state slot, never a task's pages or slot."""
    _, tx = _paged_pair(arch)
    tx.prefill(_tasks(ttask, (11,), 5700)[0])
    before = {k: v.clone() for k, v in tx.pages.items()}
    steps = [tx._prefill_step(11)]
    if not tx.cfg.has_ssm:
        steps.append(tx._chunk_step(4))
    for st in steps:
        _run_at_pads(st)
    for name, spare in (("k_pages", TM.spare_page), ("v_pages", TM.spare_page),
                        ("ssm_state", TM.spare_slot),
                        ("conv_state", TM.spare_slot)):
        if name not in tx.pages:
            continue
        same = (tx.pages[name] == before[name]).flatten(2).all(-1)
        same[:, spare(tx.pages)] = True
        assert same.all(), name


def test_slot_step_pads_write_only_the_spare_row():
    """The slot engine's and the draft's steps at their pad inputs (the
    whole prompt, a chunk, the masked decode) change only the spare row of
    their slot cache."""
    _, cfg, _, tp = _pair("edge-6b")
    tx = TorchExecutor(cfg, params=tp, max_slots=3, max_seq=64,
                       prefill_chunk_size=4, device="cpu")
    td = tspec.DraftModel(cfg, params=tp, max_slots=3, max_seq=64,
                          device="cpu")
    for t in _tasks(ttask, (9, 6), 5800):
        tx.prefill(t)
        td.propose([(t.task_id, np.arange(6, dtype=np.int32), 1)], [2])
    for eng, steps in ((tx, [tx._prefill_step(9), SG.chunk_step(tx, 4),
                             SG.masked_step(tx)]),
                       (td, [SG.chunk_step(td, 4), SG.masked_step(td)])):
        before = {k: v.clone() for k, v in eng.cache.items()}
        for st in steps:
            _run_at_pads(st)
        S = eng.max_slots
        for k, v in eng.cache.items():
            rows = (slice(None), slice(0, S)) if k in ("k", "v") else (
                slice(0, S),)
            assert torch.equal(v[rows], before[k][rows]), k
