"""The port's training step under FSDP over 'data' x tensor parallelism
over 'model' (``make_train_step(mesh=...)``, JAX's ``param_specs(
train=True)``, ``opt_state_specs`` and ``batch_spec``), and the
encoder-only forward on a rank's slab, held against JAX's jitted
single-device ``train_step``, ``jax.grad`` and ``forward`` on the CPU in
fp32.

The cases (reduced configs, JAX's ``init_params`` through the numpy
files the ranks load, the batch of 2 x 24 tokens that
``tests/test_torch_train_step.py`` holds one process on):

- smollm-360m (one KV head: the kv_group layout) on (1, 2), (2, 1),
  (2, 2) and (1, 4);
- granite-moe (4 experts: expert-parallel over 2 and 4), and with 6
  experts over 'model' = 4 (each rank a quarter of every expert's d_ff);
- mamba2-780m (16 SSM heads cut, B and C whole) on (1, 2) and (2, 2);
- hymba-1.5b on (2, 2); hubert-xlarge on (1, 2) and (2, 2), its train
  step and its ``forward``;
- smollm-360m and granite-moe on the pod meshes (2, 1, 2) and (2, 2, 1)
  (JAX's ('pod', 'data', 'model'): FSDP over 'data' inside a pod, the
  weights replicated over 'pod', the batch over ('pod', 'data'), here a
  batch of 4 rows);
- granite-moe on the sorted MoE path (``moe_impl="sorted"``, JAX's
  ``moe_ffn``) on (2, 1), (1, 2) and (2, 2), and with 6 experts on (1,
  4), from weights skewed so that the whole batch drops assignments
  (``_skew``), against JAX's sorted path: the capacity and drops are the
  whole batch's, which ``test_sorted_moe_drops_by_the_whole_batch``
  shows a per-group capacity would not give.

Every rank of a case runs 3 steps, each from JAX's state before that
step (its shards of JAX's params, mu and nu: the way
``tests/test_torch_train_step.py`` holds one process), and holds, on its
shards: the loss within 1e-5 (relative) of JAX's, grad_norm within 1e-5
of the exact (float64) norm of ``jax.grad``'s gradient, every leaf's
gradient within ``helpers.ATOL`` (1e-5) of ``jax.grad``'s, and the
params after the step as that test holds them (atol 1e-5 where the
gradient is at least 1e-3 of its leaf's largest, elsewhere within two
diverging AdamW steps, 2 lr (1 + wd |p|)). The first step's gradients of
every rank, put together by ``launch.sharding.gather_train_params``, are
held to ``jax.grad``'s whole leaves here. hubert's ``forward`` on a
rank's serving slab and rows: logits within 1e-5 of JAX's. With row 0's
labels mostly ignored, smollm over (2, 1), granite-moe and mamba2 over
(2, 2), and granite-moe's dense MoE path over (2, 1) and (2, 2) (each
data group one row) against the port's single process: the loss is the whole
batch's mean and the MoE statistics every group's.

Checkpoints of a mesh state (``training.checkpoint.save``/``restore``
with ``mesh=``): smollm's (2, 2) state after one step from JAX's, saved
by the 4-rank group, is the whole state bit for bit (the ranks' shards
put together), in JAX's keys, and JAX's ``restore`` reads it; restored
onto (1, 2) (the 2-rank group, which waits for the file), (2, 1, 2) and
in one process, its next step is within 1e-5 of (2, 2)'s own; JAX's
checkpoint after its first step restored onto (2, 2) gives JAX's second
step within 1e-5.

Also: each rank's shards of the params follow ``param_specs(
train=True)``'s per-device shapes except on the dims of the named
departures, on the pod meshes too; every rank's shards put back together
give the whole tree; the CLI's ``--mesh-shape 1,2``; no rank imports JAX.

One 2-rank and one 4-rank gloo group (spawned once, the two at once)
run every case of their world size.
"""
from __future__ import annotations

import dataclasses
import os
import shutil
import sys
import threading
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from helpers import ATOL  # noqa: E402

LR = 1e-2
SEED = 3
STEPS = 3
B, S = 2, 24
TIMEOUT = 300.0
# config name -> (arch, n_experts or None: the reduced config's)
CONFIGS = {"smollm": ("smollm-360m", None),
           "granite": ("granite-moe-3b-a800m", None),
           "granite6": ("granite-moe-3b-a800m", 6),
           "mamba2": ("mamba2-780m", None),
           "hymba": ("hymba-1.5b", None),
           "hubert": ("hubert-xlarge", None),
           "granite-sorted": ("granite-moe-3b-a800m", None),
           "granite6-sorted": ("granite-moe-3b-a800m", 6),
           "smollm4": ("smollm-360m", None),
           "granite4": ("granite-moe-3b-a800m", None)}
# configs trained on a batch of 4 rows (the pod meshes' 4 data groups)
# rather than B
ROWS = {"smollm4": 4, "granite4": 4}
# configs trained on the sorted MoE path (moe_impl="sorted", JAX's
# moe_ffn) from skewed weights (``_skew``), so that the whole batch drops
# assignments
SORTED = ("granite-sorted", "granite6-sorted")
# the skew: every embedding row shifted by SHIFT times the table's mean
# |entry| and SKEW * d_model^-0.5 added to every layer's router column of
# expert 0, which then takes every token (tests/test_torch_moe.py's skew,
# the shifted inputs being the embeddings)
SHIFT, SKEW = 1.0, 4.0
# case -> (config, (data, model) or (pod, data, model))
CASES = {"smollm-1x2": ("smollm", (1, 2)), "smollm-2x1": ("smollm", (2, 1)),
         "smollm-2x2": ("smollm", (2, 2)), "smollm-1x4": ("smollm", (1, 4)),
         "granite-1x2": ("granite", (1, 2)),
         "granite-1x4": ("granite", (1, 4)),
         "granite6-1x4": ("granite6", (1, 4)),
         "mamba2-1x2": ("mamba2", (1, 2)), "mamba2-2x2": ("mamba2", (2, 2)),
         "granite-2x2": ("granite", (2, 2)),
         "granite-dense-2x1": ("granite", (2, 1)),
         "granite-dense-2x2": ("granite", (2, 2)),
         "hymba-2x2": ("hymba", (2, 2)),
         "hubert-1x2": ("hubert", (1, 2)), "hubert-2x2": ("hubert", (2, 2)),
         "smollm-2x1x2": ("smollm4", (2, 1, 2)),
         "smollm-2x2x1": ("smollm4", (2, 2, 1)),
         "granite-2x1x2": ("granite4", (2, 1, 2)),
         "granite-2x2x1": ("granite4", (2, 2, 1)),
         "granite-sorted-2x1": ("granite-sorted", (2, 1)),
         "granite-sorted-1x2": ("granite-sorted", (1, 2)),
         "granite-sorted-2x2": ("granite-sorted", (2, 2)),
         "granite6-sorted-1x4": ("granite6-sorted", (1, 4))}
# the checkpoints: smollm's (2, 2) state after its first step saved
# (CKPT_FROM), restored onto each of CKPT_ONTO (and in one process, in the
# test process), each then taking the second step; JAX's state after its
# first step, saved by JAX, restored onto CKPT_FROM
CKPT_CONFIG, CKPT_FROM = "smollm", (2, 2)
CKPT_ONTO = [(1, 2), (2, 1, 2)]
CKPT_PORT, CKPT_JAX = "port_2x2.npz", "jax_s1.npz"
FORWARD = ["hubert-1x2", "hubert-2x2"]
# the batch with row 0's labels mostly ignored (3 of its 23 targets kept,
# row 1's 23): the loss is the mean over both rows' 26 targets, not the
# mean of each data group's mean; granite's load-balance statistics are
# every data group's, on the grouped path and on the dense one (case ->
# its moe_impl)
UNEVEN = {"smollm-2x1": "grouped", "granite-2x2": "grouped",
          "mamba2-2x2": "grouped", "granite-dense-2x1": "dense",
          "granite-dense-2x2": "dense"}


CASES_JAX = [c for c in CASES if c not in ("granite-2x2",
                                           "granite-dense-2x1",
                                           "granite-dense-2x2")]


def _ways(shape):
    return int(np.prod(shape))


def _axes(shape):
    """{axis: size} of a (data, model) or (pod, data, model) shape."""
    return dict(zip(("pod", "data", "model")[-len(shape):], shape))


def _opts(name, jax=False):
    """The training ModelOptions of a config: remat, and the sorted MoE
    path for ``SORTED``'s."""
    if jax:
        from repro.models.model import ModelOptions
    else:
        from repro_torch.models.model import ModelOptions
    return ModelOptions(remat=True, moe_impl="sorted" if name in SORTED
                        else "grouped")


def _cfg(name, jax=False):
    arch, experts = CONFIGS[name]
    if jax:
        from repro.configs import get_config
    else:
        from repro_torch.configs import get_config
    cfg = get_config(arch).reduced()
    return cfg if experts is None else dataclasses.replace(
        cfg, n_experts=experts)


def _batch(cfg, rows=B):
    """(inputs, labels) numpy: the tokens ``tests/test_torch_train_step.
    py`` holds one process on (for an embedding-input arch [B,S,D] frames
    drawn after them, N(0, 1) * 0.02 as both training launchers draw
    them), labels the tokens; ``rows`` rows."""
    rng = np.random.default_rng(4)
    toks = rng.integers(0, cfg.vocab_size, (rows, S)).astype(np.int32)
    inputs = toks
    if cfg.embedding_inputs:
        inputs = (rng.standard_normal((rows, S, cfg.d_model)) * 0.02).astype(
            np.float32)
    return inputs, toks.copy()


# ---------------------------------------------------------- the ranks

def _load(path, prefix, like):
    """A whole tree of torch tensors shaped as ``like`` (a dict of
    shapes, ``param_shapes``') from the .npy files ``prefix.<leaf path>``
    under ``path``."""
    def walk(node, at):
        return {k: walk(v, f"{at}{k}.") if isinstance(v, dict) else
                torch.from_numpy(np.load(os.path.join(
                    path, f"{prefix}.{at}{k}.npy"))) for k, v in node.items()}
    return walk(like, "")


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield prefix + k, v


def _rank_case(mesh, name, path):
    """One case on this rank: 3 steps, each from JAX's state before it;
    what the rank saw (errors on its shards, its first step's
    gradients)."""
    from repro_torch.launch import sharding as SH
    from repro_torch.models import model as M
    from repro_torch.training.trainer import (local_batch, make_train_step,
                                              step_grads)
    cfg = _cfg(CASES[name][0])
    shapes = M.param_shapes(cfg)
    inputs, labels = (np.load(os.path.join(path, f"{k}.npy"))
                      for k in ("inputs", "labels"))
    batch = local_batch({"inputs": torch.from_numpy(inputs),
                         "labels": torch.from_numpy(labels)}, mesh)
    opts = _opts(CASES[name][0])
    init_state, train_step = make_train_step(cfg, opts, peak_lr=LR, warmup=1,
                                             total=10, device="cpu",
                                             mesh=mesh)
    state = init_state(_load(path, "s0.p", shapes))

    def local(prefix):
        return dict(_flat(SH.local_train_params(
            cfg, _load(path, prefix, shapes), mesh)))

    out = []
    for i in range(STEPS):
        with torch.no_grad():
            for kind, tree in (("p", state[0]), ("mu", state[1].mu),
                               ("nu", state[1].nu)):
                if kind != "p" and i == 0:
                    continue                       # zeros, as JAX's
                want = local(f"s{i}.{kind}")
                for k, v in _flat(tree):
                    v.copy_(want[k])
            state[1].step.fill_(i)
        p0 = {k: v.detach().clone() for k, v in _flat(state[0])}
        loss, grads, gnorm = step_grads(cfg, state[0], batch, opts, mesh)
        g_want = local(f"g{i}")
        g_max = {k: float(np.abs(v).max()) for k, v in _flat(
            _load(path, f"g{i}", shapes))}
        grad_err = {k: float((g - g_want[k]).abs().max())
                    for k, g in _flat(grads)}
        state, m = train_step(state, batch)
        p_want = local(f"s{i + 1}.p")
        big_err, over = {}, {}
        for k, p in _flat(state[0]):
            p = p.detach()
            big = g_want[k].abs() >= 1e-3 * g_max[k]
            d = (p - p_want[k]).abs()
            big_err[k] = float(d[big].max()) if big.any() else 0.0
            bound = 2 * LR * (1 + 0.1 * p0[k].abs()) + 1e-5
            over[k] = float((d - bound).max())
        out.append({"loss": float(m["loss"]), "gnorm": float(m["grad_norm"]),
                    "loss_g": float(loss), "gnorm_g": float(gnorm),
                    "grad_err": grad_err, "param_big_err": big_err,
                    "param_over": over,
                    "grads": ({k: g.numpy().copy() for k, g in _flat(grads)}
                              if i == 0 else None)})
    return out


def _uneven(labels):
    labels = labels.copy()
    labels[0, 4:] = -1
    return labels


def _rank_uneven(mesh, name, path, moe_impl):
    """``step_grads`` on JAX's first state with ``_uneven`` labels and
    ``moe_impl``: the loss, grad_norm and the rank's gradients."""
    from repro_torch.launch import sharding as SH
    from repro_torch.models import model as M
    from repro_torch.training.trainer import (local_batch, make_train_step,
                                              step_grads)
    cfg = _cfg(CASES[name][0])
    init_state, _ = make_train_step(cfg, device="cpu", mesh=mesh)
    params, _ = init_state(_load(path, "s0.p", M.param_shapes(cfg)))
    batch = local_batch({"inputs": torch.from_numpy(np.load(
        os.path.join(path, "inputs.npy"))), "labels": torch.from_numpy(
            _uneven(np.load(os.path.join(path, "labels.npy"))))}, mesh)
    loss, grads, gnorm = step_grads(
        cfg, params, batch, M.ModelOptions(remat=True, moe_impl=moe_impl),
        mesh)
    return {"loss": float(loss), "gnorm": float(gnorm),
            "grads": {k: g.numpy().copy() for k, g in _flat(grads)}}


def _rank_forward(mesh, name, path):
    """hubert's ``forward`` on the rank's serving slab and its rows: the
    largest |logits - JAX's| over them."""
    from repro_torch.launch import sharding as SH
    from repro_torch.models import model as M
    from repro_torch.models.partitioning import activation_partitioning
    cfg = _cfg(CASES[name][0])
    params = SH.local_params(cfg, _load(path, "s0.p", M.param_shapes(cfg)),
                             mesh)
    n = B // mesh.shape["data"]
    rows = slice(mesh.coords["data"] * n, (mesh.coords["data"] + 1) * n)
    inputs, want = (torch.from_numpy(np.load(os.path.join(
        path, f"{k}.npy"))[rows]) for k in ("inputs", "logits"))
    with torch.no_grad(), activation_partitioning(
            mesh, SH.cut_leaves(cfg, mesh.shape["model"])):
        logits, _ = M.forward(cfg, params, inputs)
    return {"shape": tuple(logits.shape),
            "err": float((logits - want).abs().max())}


def _ckpt_trainer(mesh, path):
    """(init_state, train_step, the rank's rows of the batch) of
    ``CKPT_CONFIG`` on ``mesh`` (None: one process)."""
    from repro_torch.training.trainer import local_batch, make_train_step
    cfg = _cfg(CKPT_CONFIG)
    init_state, train_step = make_train_step(
        cfg, _opts(CKPT_CONFIG), peak_lr=LR, warmup=1, total=10,
        device="cpu", mesh=mesh)
    batch = {k: torch.from_numpy(np.load(os.path.join(path, f"{k}.npy")))
             for k in ("inputs", "labels")}
    return init_state, train_step, (batch if mesh is None
                                    else local_batch(batch, mesh))


def _next_step(state, train_step, batch):
    """One step of a restored state: its loss, grad_norm and the
    (rank's) params after it, numpy by dotted path."""
    state, m = train_step(state, batch)
    return {"loss": float(m["loss"]), "gnorm": float(m["grad_norm"]),
            "params": {k: v.detach().numpy().copy()
                       for k, v in _flat(state[0])}}


def _rank_ckpt_save(mesh, path):
    """``CKPT_FROM``: one step from JAX's first state, the state saved
    (``checkpoint.save(mesh=...)``), then the second step; then JAX's
    checkpoint after its first step restored here, and its next step.
    Returns the rank's state as saved (checkpoint keys) and both next
    steps."""
    from repro_torch.training import checkpoint as CK
    from repro_torch.models import model as M
    cfg = _cfg(CKPT_CONFIG)
    init_state, train_step, batch = _ckpt_trainer(mesh, path)
    state = init_state(_load(path, "s0.p", M.param_shapes(cfg)))
    state, _ = train_step(state, batch)
    saved = {k: v.detach().numpy().copy()
             for k, v in CK._flatten(state).items()}
    CK.save(os.path.join(path, CKPT_PORT), state, cfg=cfg, mesh=mesh)
    if mesh.rank == 0:
        open(os.path.join(path, CKPT_PORT + ".done"), "w").close()
    out = {"saved": saved, "continued": _next_step(state, train_step, batch)}
    restored = CK.restore(os.path.join(path, CKPT_JAX), init_state(0),
                          cfg=cfg, mesh=mesh)
    out["jax"] = _next_step(restored, train_step, batch)
    return out


def _rank_ckpt_restore(mesh, path):
    """``CKPT_PORT`` (once ``CKPT_FROM``'s group has written it) restored
    onto ``mesh``, and its next step."""
    import time

    from repro_torch.training import checkpoint as CK
    done = os.path.join(path, CKPT_PORT + ".done")
    deadline = time.monotonic() + TIMEOUT
    while not os.path.exists(done):
        if time.monotonic() > deadline:
            raise TimeoutError(f"{CKPT_PORT} was never written")
        time.sleep(0.2)
    init_state, train_step, batch = _ckpt_trainer(mesh, path)
    state = CK.restore(os.path.join(path, CKPT_PORT), init_state(0),
                       cfg=_cfg(CKPT_CONFIG), mesh=mesh)
    return _next_step(state, train_step, batch)


def _rank_main(rank, world, paths):
    """A spawned rank: every case of ``world`` ranks, each mesh made once,
    in the same order on every rank (the checkpoint's save first, its
    restores last); returns {case: what the rank saw} and the JAX
    modules it imported (none)."""
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import make_serving_mesh
    meshes, out = {}, {}

    def mesh(shape):
        if shape not in meshes:
            *pod, data, model = shape
            meshes[shape] = make_serving_mesh(pod=pod[0] if pod else 1,
                                              data=data, model=model)
        return meshes[shape]

    ckpt = paths[CKPT_CONFIG]
    if _ways(CKPT_FROM) == world:
        out["ckpt", CKPT_FROM] = _rank_ckpt_save(mesh(CKPT_FROM), ckpt)
    for name, (config, shape) in CASES.items():
        if _ways(shape) != world:
            continue
        if name in CASES_JAX:
            out[name] = _rank_case(mesh(shape), name, paths[config])
        if name in UNEVEN:
            out[name, "uneven"] = _rank_uneven(mesh(shape), name,
                                               paths[config], UNEVEN[name])
        if name in FORWARD:
            out[name, "forward"] = _rank_forward(mesh(shape), name,
                                                 paths[config])
    for shape in CKPT_ONTO:
        if _ways(shape) == world:
            out["ckpt", shape] = _rank_ckpt_restore(mesh(shape), ckpt)
    out["leaked"] = sorted(m for m in sys.modules if m == "jax"
                           or m.startswith(("jax.", "repro.")))
    return out


# ---------------------------------------------------- the JAX side

def _numpy(node):
    if hasattr(node, "_asdict"):
        node = node._asdict()
    if isinstance(node, dict):
        return {k: _numpy(v) for k, v in node.items()}
    return np.asarray(node)


def _save(path, prefix, tree):
    for k, v in _flat(_numpy(tree)):
        np.save(os.path.join(path, f"{prefix}.{k}.npy"), v)


def _skew(name, params):
    """JAX's params of a ``SORTED`` config skewed (``SHIFT``, ``SKEW``),
    the others as they are."""
    if name not in SORTED:
        return params
    embed = params["embed"]
    moe = params["blocks"]["moe"]
    d = embed.shape[-1]
    return {**params, "embed": embed + SHIFT * abs(embed).mean(),
            "blocks": {**params["blocks"], "moe": moe._replace(
                router=moe.router.at[:, :, 0].add(SKEW * d ** -0.5))}}


def _trajectory(name, path):
    """JAX's 3 steps of one config, saved under ``path``: the state
    before each step (s{i}.p/.mu/.nu), jax.grad's gradient there (g{i}),
    the params after the last (s3.p), the batch, for hubert its
    forward's logits, and for ``CKPT_CONFIG`` JAX's checkpoint of its
    state after the first step (``CKPT_JAX``); returns the losses and the
    exact gradient norms."""
    import jax
    import jax.numpy as jnp

    from repro.models import model as JM
    from repro.training import checkpoint as jckpt
    from repro.training import optimizer as jopt
    from repro.training.trainer import make_train_step as jax_train_step
    jcfg = _cfg(name, jax=True)
    params = JM.init_params(jcfg, jax.random.PRNGKey(SEED))
    params = _skew(name, params)
    inputs, labels = _batch(jcfg, ROWS.get(name, B))
    np.save(os.path.join(path, "inputs.npy"), inputs)
    np.save(os.path.join(path, "labels.npy"), labels)
    jb = {"inputs": jnp.asarray(inputs), "labels": jnp.asarray(labels)}
    opts = _opts(name, jax=True)
    _, step = jax_train_step(jcfg, opts, peak_lr=LR, warmup=1, total=10)
    step = jax.jit(step)
    grad = jax.jit(jax.grad(lambda p: JM.loss_fn(
        jcfg, p, jb["inputs"], jb["labels"], opts)))
    state = (params, jopt.adamw(LR)[0](params))
    losses, norms = [], []
    for i in range(STEPS):
        _save(path, f"s{i}.p", state[0])
        if i:                              # zeros before the first step
            _save(path, f"s{i}.mu", state[1].mu)
            _save(path, f"s{i}.nu", state[1].nu)
        g = _numpy(grad(state[0]))
        _save(path, f"g{i}", g)
        norms.append(float(np.sqrt(sum((a.astype(np.float64) ** 2).sum()
                                       for _, a in _flat(g)))))
        state, m = step(state, jb)
        losses.append(float(m["loss"]))
        if i == 0 and name == CKPT_CONFIG:
            jckpt.save(os.path.join(path, CKPT_JAX), state)
    _save(path, f"s{STEPS}.p", state[0])
    if jcfg.is_encoder_only:
        logits, _ = jax.jit(lambda p, x: JM.forward(jcfg, p, x))(
            params, jb["inputs"])
        np.save(os.path.join(path, "logits.npy"), np.asarray(logits))
    return {"losses": losses, "norms": norms}


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """config -> (its directory of JAX's arrays, losses and norms)."""
    root = tmp_path_factory.mktemp("train_mesh")
    out = {}
    for name in CONFIGS:
        path = os.path.join(str(root), name)
        os.makedirs(path)
        out[name] = (path, _trajectory(name, path))
    yield out
    shutil.rmtree(str(root), ignore_errors=True)


@pytest.fixture(scope="module")
def ranks(jax_runs, tmp_path_factory):
    """world -> each rank's results: the 2-rank and the 4-rank group,
    spawned at once."""
    from repro_torch.launch.mesh import spawn_ranks
    paths = {k: v[0] for k, v in jax_runs.items()}
    out, errors = {}, []

    def run(world):
        try:
            out[world] = spawn_ranks(
                _rank_main, world, (world, paths), timeout=TIMEOUT,
                store_dir=str(tmp_path_factory.mktemp(f"tm{world}")))
        except BaseException as e:                    # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=run, args=(w,)) for w in (2, 4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return out


def _results(ranks, name):
    shape = CASES[name][1]
    return ranks[_ways(shape)]


# ------------------------------------------------------------- the steps

@pytest.mark.parametrize("name", CASES_JAX)
def test_train_step_matches_jax(jax_runs, ranks, name):
    """Every rank, 3 steps from JAX's states: loss, grad_norm, every
    leaf's gradient on its shards and its updated shards against JAX's."""
    want = jax_runs[CASES[name][0]][1]
    for r, res in enumerate(_results(ranks, name)):
        for i, got in enumerate(res[name]):
            what = f"{name} rank {r} step {i}"
            loss, norm = want["losses"][i], want["norms"][i]
            for key in ("loss", "loss_g"):
                assert abs(got[key] - loss) <= 1e-5 * abs(loss), (what, key)
            for key in ("gnorm", "gnorm_g"):
                assert abs(got[key] - norm) <= 1e-5 * norm, (what, key)
            for k, err in got["grad_err"].items():
                assert err <= ATOL, (what, k, err)
            for k, err in got["param_big_err"].items():
                assert err <= 1e-5, (what, k, err)
            for k, over in got["param_over"].items():
                assert over <= 0, (what, k, over)


def _gathered(cfg, shape, flats):
    """The whole tree from every rank's {leaf path: numpy} shards."""
    from repro_torch.launch import sharding as SH
    parts = []
    for flat in flats:
        tree = {}
        for k, v in flat.items():
            node = tree
            *head, last = k.split(".")
            for h in head:
                node = node.setdefault(h, {})
            node[last] = torch.from_numpy(v)
        parts.append(tree)
    return dict(_flat(SH.gather_train_params(cfg, parts, _axes(shape))))


@pytest.mark.parametrize("name", CASES_JAX)
def test_gathered_grads_match_jax(jax_runs, ranks, name):
    """The first step's gradients of every rank, put back together
    (``gather_train_params``), against ``jax.grad``'s whole leaves."""
    from repro_torch.models import model as M
    config, shape = CASES[name]
    cfg = _cfg(config)
    got = _gathered(cfg, shape, [res[name][0]["grads"]
                                 for res in _results(ranks, name)])
    want = dict(_flat(_load(jax_runs[config][0], "g0",
                            M.param_shapes(cfg))))
    for k, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[k].numpy(), rtol=0,
                                   atol=ATOL, err_msg=f"{name} {k}")


@pytest.mark.parametrize("name", UNEVEN)
def test_uneven_labels_match_one_process(jax_runs, ranks, name):
    """Row 0 of the batch mostly ignored, each data group one row: every
    rank's loss and grad_norm within 1e-5 (relative) of the port's single
    process on the whole batch, and the ranks' gradients put together
    within 1e-5 of its."""
    from repro_torch.models import model as M
    from repro_torch.training.trainer import step_grads
    config, shape = CASES[name]
    cfg = _cfg(config)
    path = jax_runs[config][0]
    params = _load(path, "s0.p", M.param_shapes(cfg))
    for _, p in _flat(params):
        p.requires_grad_(True)
    batch = {"inputs": torch.from_numpy(np.load(os.path.join(
        path, "inputs.npy"))), "labels": torch.from_numpy(_uneven(np.load(
            os.path.join(path, "labels.npy"))))}
    loss, grads, gnorm = step_grads(
        cfg, params, batch, M.ModelOptions(remat=True,
                                           moe_impl=UNEVEN[name]))
    results = [res[name, "uneven"] for res in _results(ranks, name)]
    for r, got in enumerate(results):
        assert abs(got["loss"] - float(loss)) <= 1e-5 * float(loss), r
        assert abs(got["gnorm"] - float(gnorm)) <= 1e-5 * float(gnorm), r
    got = _gathered(cfg, shape, [res["grads"] for res in results])
    for k, g in _flat(grads):
        np.testing.assert_allclose(got[k].numpy(), g.numpy(), rtol=0,
                                   atol=ATOL, err_msg=f"{name} {k}")


# ------------------------------------------------------------ checkpoints

def _split_key(key):
    """(container part, dotted parameter path or None) of a checkpoint
    key of a (params, AdamWState) tree: "0|blocks|wq" -> ("0",
    "blocks.wq"), "1|.mu|embed" -> ("1|.mu", "embed"), "1|.step" ->
    ("1|.step", None)."""
    parts = key.split("|")
    n = 1 if parts[0] == "0" else 2
    return "|".join(parts[:n]), ".".join(p.lstrip(".") for p in parts[n:]) \
        or None


def _ckpt_results(ranks, shape):
    return [res["ckpt", shape] for res in ranks[_ways(shape)]]


def test_mesh_checkpoint_is_the_gathered_state(jax_runs, ranks):
    """The file the (2, 2) ranks saved holds, key for key in JAX's
    scheme, the keys one process's save writes, and each leaf equals bit
    for bit the ranks' shards put together by ``gather_train_params``'s
    gatherer (the step rank 0's), at ``param_shapes``' shapes."""
    from repro_torch.launch import sharding as SH
    from repro_torch.models import model as M
    from repro_torch.training import checkpoint as CK
    cfg = _cfg(CKPT_CONFIG)
    path = jax_runs[CKPT_CONFIG][0]
    saved = [r["saved"] for r in _ckpt_results(ranks, CKPT_FROM)]
    leaf = SH.train_gatherer(cfg, _axes(CKPT_FROM))
    shapes = dict(_flat(M.param_shapes(cfg)))
    init_state, _, _ = _ckpt_trainer(None, path)
    with np.load(os.path.join(path, CKPT_PORT)) as f:
        assert set(f.files) == set(CK._flatten(init_state(0)))
        for key in f.files:
            _, at = _split_key(key)
            if at is None:
                want = saved[0][key]
            else:
                want = leaf(at, [torch.from_numpy(s[key])
                                 for s in saved]).numpy()
                assert f[key].shape == tuple(shapes[at]), key
            assert f[key].dtype == want.dtype, key
            np.testing.assert_array_equal(f[key], want, err_msg=key)


def test_jax_restores_mesh_checkpoint(jax_runs, ranks):
    """JAX's ``restore`` reads the file the (2, 2) ranks saved into its
    own (params, AdamWState) tree, every leaf the file's."""
    import jax

    from repro.models import model as JM
    from repro.training import checkpoint as jckpt
    from repro.training import optimizer as jopt
    path = os.path.join(jax_runs[CKPT_CONFIG][0], CKPT_PORT)
    jp = JM.init_params(_cfg(CKPT_CONFIG, jax=True),
                        jax.random.PRNGKey(SEED))
    got = jckpt._flatten(jckpt.restore(path, (jp, jopt.adamw(LR)[0](jp))))[0]
    with np.load(path) as f:
        assert set(got) == set(f.files)
        for key, v in got.items():
            np.testing.assert_array_equal(np.asarray(v), f[key], err_msg=key)


@pytest.fixture(scope="module")
def ckpt_one(jax_runs, ranks):
    """The (2, 2) file restored in one process: its params before the
    next step, that step's gradient, and the step."""
    from repro_torch.training import checkpoint as CK
    from repro_torch.training.optimizer import leaves
    from repro_torch.training.trainer import step_grads
    path = jax_runs[CKPT_CONFIG][0]
    init_state, train_step, batch = _ckpt_trainer(None, path)
    state = CK.restore(os.path.join(path, CKPT_PORT), init_state(0))
    for p in leaves(state[0]):
        p.requires_grad_(True)
    p0 = {k: v.detach().numpy().copy() for k, v in _flat(state[0])}
    _, grads, _ = step_grads(_cfg(CKPT_CONFIG), state[0], batch,
                             _opts(CKPT_CONFIG))
    return {"p0": p0, "grads": {k: g.numpy() for k, g in _flat(grads)},
            "step": _next_step(state, train_step, batch)}


def _step_close(got, want, grads, p0, what):
    """A step's loss and grad_norm within 1e-5 (relative) of ``want``'s,
    its params within 1e-5 where the gradient is at least 1e-3 of its
    leaf's largest, elsewhere within two diverging AdamW steps."""
    assert abs(got["loss"] - want["loss"]) <= 1e-5 * abs(want["loss"]), what
    assert abs(got["gnorm"] - want["gnorm"]) <= 1e-5 * want["gnorm"], what
    for k, p in got["params"].items():
        d = np.abs(p - want["params"][k])
        big = np.abs(grads[k]) >= 1e-3 * np.abs(grads[k]).max()
        if big.any():
            assert d[big].max() <= 1e-5, (what, k, float(d[big].max()))
        bound = 2 * LR * (1 + 0.1 * np.abs(p0[k])) + 1e-5
        assert (d - bound).max() <= 0, (what, k)


def _mesh_step(ranks, shape, key):
    """Every rank's step of ``key`` on a mesh of ``shape``, the params put
    together; the ranks' losses and norms are asserted equal."""
    runs = [r if key is None else r[key] for r in _ckpt_results(ranks,
                                                                 shape)]
    for r in runs[1:]:
        assert (r["loss"], r["gnorm"]) == (runs[0]["loss"], runs[0]["gnorm"])
    params = {k: v.numpy() for k, v in _gathered(
        _cfg(CKPT_CONFIG), shape, [r["params"] for r in runs]).items()}
    return {"loss": runs[0]["loss"], "gnorm": runs[0]["gnorm"],
            "params": params}


@pytest.mark.parametrize("onto", CKPT_ONTO + [None],
                         ids=[f"{'x'.join(map(str, s))}" for s in CKPT_ONTO]
                         + ["one-process"])
def test_mesh_checkpoint_restores_anywhere(ranks, ckpt_one, onto):
    """The (2, 2) state's file restored onto (1, 2), (2, 1, 2) and in one
    process: the next step within 1e-5 of (2, 2)'s own next step from
    the state it saved."""
    want = _mesh_step(ranks, CKPT_FROM, "continued")
    got = ckpt_one["step"] if onto is None else _mesh_step(ranks, onto,
                                                           None)
    _step_close(got, want, ckpt_one["grads"], ckpt_one["p0"], onto)


def test_jax_checkpoint_restores_onto_mesh(jax_runs, ranks):
    """JAX's checkpoint of its state after the first step (``jax``
    ``save``) restored onto (2, 2): the next step within 1e-5 of JAX's
    second."""
    from repro_torch.models import model as M
    cfg = _cfg(CKPT_CONFIG)
    path, traj = jax_runs[CKPT_CONFIG]
    shapes = M.param_shapes(cfg)

    def whole(prefix):
        return {k: v.numpy() for k, v in _flat(_load(path, prefix, shapes))}

    want = {"loss": traj["losses"][1], "gnorm": traj["norms"][1],
            "params": whole("s2.p")}
    _step_close(_mesh_step(ranks, CKPT_FROM, "jax"), want, whole("g1"),
                whole("s1.p"), "jax")


# ------------------------------------------------------------ sorted MoE

SORTED_CASES = [c for c, (config, _) in CASES.items() if config in SORTED]


def _kept(ids, E, K):
    """Which of the [N, K] assignments ``ids`` a capacity over these N
    tokens keeps: a stable sort by expert, C = max(int(N K / E * 1.25 +
    0.999), K) of each expert's first, as JAX's ``moe_ffn``."""
    e = ids.reshape(-1)
    order = np.argsort(e, kind="stable")
    es = e[order]
    pos = np.empty_like(order)
    pos[order] = np.arange(e.size) - np.searchsorted(es, np.arange(E))[es]
    return pos < max(int(e.size / E * 1.25 + 0.999), K)


@pytest.mark.parametrize("name", SORTED_CASES)
def test_sorted_moe_drops_by_the_whole_batch(jax_runs, name, monkeypatch):
    """Every layer's routing ids of the case's first step (JAX's skewed
    weights through the port's single-process forward, ``moe.route``
    recording them), in numpy: the whole batch drops assignments in every
    layer, and where the case splits the batch over data groups a
    capacity of each group's own would keep another set. The case's
    steps (``test_train_step_matches_jax``) are held to JAX's whole-batch
    dispatch, so a per-group dispatch fails them."""
    from repro_torch.models import model as M
    from repro_torch.models import moe as MOE
    config, shape = CASES[name]
    cfg = _cfg(config)
    path = jax_runs[config][0]
    seen, route = [], MOE.route

    def record(*args, **kw):
        out = route(*args, **kw)
        seen.append(out[1].numpy().copy())
        return out

    monkeypatch.setattr(MOE, "route", record)
    inputs, labels = (torch.from_numpy(np.load(os.path.join(
        path, f"{k}.npy"))) for k in ("inputs", "labels"))
    with torch.no_grad():
        M.loss_fn(cfg, _load(path, "s0.p", M.param_shapes(cfg)), inputs,
                  labels, _opts(config))
    E, K = cfg.n_experts, cfg.top_k
    groups = int(np.prod(shape[:-1]))
    assert len(seen) == cfg.n_layers
    for layer, ids in enumerate(seen):
        whole = _kept(ids, E, K)
        assert (~whole).sum() >= 1, (name, layer)
        if groups > 1:
            own = np.concatenate([_kept(g, E, K)
                                  for g in np.split(ids, groups)])
            assert (own != whole).any(), (name, layer)


@pytest.mark.parametrize("name", FORWARD)
def test_encoder_forward_matches_jax(ranks, name):
    """hubert's forward on a rank's slab of the weights and its rows of
    the batch: logits [B / data, S, V] within 1e-5 of JAX's."""
    shape = CASES[name][1]
    for r, res in enumerate(_results(ranks, name)):
        got = res[name, "forward"]
        assert got["shape"][0] == B // shape[0], (name, r)
        assert got["err"] <= ATOL, (name, r, got["err"])


@pytest.mark.parametrize("world", [2, 4])
def test_no_rank_imports_jax(ranks, world):
    for r, res in enumerate(ranks[world]):
        assert res["leaked"] == [], (world, r)


# ------------------------------------------------------------- layout

def _fake_mesh(shape, rank):
    sizes = _axes(shape)
    return types.SimpleNamespace(
        shape=sizes, axis_names=tuple(sizes), coords=dict(zip(sizes, map(
            int, np.unravel_index(rank, tuple(shape))))))


LAYOUTS = [("smollm-360m", (2, 2)), ("smollm-360m", (16, 16)),
           ("granite-moe-3b-a800m", (16, 16)), ("mamba2-780m", (16, 16)),
           ("hymba-1.5b", (16, 16)), ("hubert-xlarge", (16, 16)),
           ("edge-6b", (2, 4)), ("smollm-360m", (2, 1, 2)),
           ("granite-moe-3b-a800m", (2, 2, 1)),
           ("smollm-360m", (2, 16, 16)), ("granite-moe-3b-a800m", (2, 16, 16)),
           ("mamba2-780m", (2, 16, 16))]


@pytest.mark.parametrize("arch,shape", LAYOUTS,
                         ids=[f"{a}-{'x'.join(map(str, s))}"
                              for a, s in LAYOUTS])
def test_shards_follow_param_specs(arch, shape):
    """Rank 0's shard of every leaf at full width has the per-device
    shape of ``param_specs(train=True)`` on every dim but where the
    port keeps whole heads (a dim the spec cuts over 'model', or the
    'data' dim of such a slab, which no longer divides): the named
    departures."""
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import sharding as SH
    from repro_torch.launch import specs as SP
    cfg = get_config(arch)
    mesh = _fake_mesh(shape, 0)
    whole = SP.param_specs_struct(cfg)
    mine = dict(_flat(SH.local_train_params(cfg, whole, mesh)))
    specs = dict(_flat(SH.param_specs(cfg, mesh, train=True)))
    cuts = dict(_flat(SH.train_cuts(cfg, mesh)))
    departed = set()
    for path, t in _flat(whole):
        want = D.spec_shape(t.shape, specs[path], mesh)
        have = tuple(mine[path].shape)
        model_dim = None if cuts[path].model is None else \
            cuts[path].model[0] % t.ndim
        for dim, (w, h, ax) in enumerate(zip(want, have, specs[path])):
            if w == h:
                continue
            departed.add(path)
            assert ax == "model" or (ax == "data" and (
                model_dim == dim or specs[path][dim] == "data")), (path, dim)
            if ax == "data":          # the rank's slab stays whole there
                assert cuts[path].data is None, path
    expected = {"smollm-360m": {"blocks.wq", "blocks.wk", "blocks.wv",
                                "blocks.wo"}}
    if shape[-2:] == (16, 16) and arch in expected:
        assert departed == expected[arch]
    if arch == "granite-moe-3b-a800m":
        assert not any(p.startswith("blocks.moe") for p in departed)


@pytest.mark.parametrize("arch,shape", [
    ("smollm-360m", (2, 2)), ("smollm-360m", (1, 4)),
    ("granite-moe-3b-a800m", (2, 2)), ("mamba2-780m", (2, 2)),
    ("hymba-1.5b", (2, 2)), ("hubert-xlarge", (2, 1)),
    ("smollm-360m", (2, 1, 2)), ("granite-moe-3b-a800m", (2, 2, 1))])
def test_train_shards_put_back_together(arch, shape):
    """Every rank's shards (``local_train_params``) put back together
    (``gather_train_params``) are the whole reduced params, exactly."""
    from repro_torch.configs import get_config
    from repro_torch.launch import sharding as SH
    from repro_torch.models import model as M
    cfg = get_config(arch).reduced()
    whole = M.init_params(cfg, seed=1, device="cpu")
    parts = [SH.local_train_params(cfg, whole, _fake_mesh(shape, r))
             for r in range(_ways(shape))]
    got = dict(_flat(SH.gather_train_params(cfg, parts, _axes(shape))))
    for k, v in _flat(whole):
        assert torch.equal(got[k], v), k


def test_train_cli_mesh_shape(capfd):
    """``--mesh-shape 1,2 --reduced --device cpu``: two gloo ranks, the
    step lines, the agreed ms a step and each rank's peak memory; equal
    losses on both ranks, no JAX imported."""
    from repro_torch.launch import train
    run = train.run(train.parse_args([
        "--reduced", "--device", "cpu", "--steps", "3", "--mesh-shape",
        "1,2"]))
    out = capfd.readouterr().out
    assert "mesh data=1 model=2: 2 ranks over gloo" in out
    assert "step    0 loss=" in out and "step    2 loss=" in out
    assert "ms/step (each step the slowest rank's)" in out
    assert "losses equal on every rank" in out
    assert len(run.ranks) == 2
    losses = [r["losses"] for r in run.ranks]
    assert losses[0] == losses[1] and all(map(np.isfinite, losses[0]))
    assert all(r["jax_modules"] == [] for r in run.ranks)


def test_train_cli_pod_mesh_shape(capfd):
    """``--mesh-shape 2,1,2``: four gloo ranks on JAX's ('pod', 'data',
    'model') shape, the first line naming the three axes; equal losses on
    every rank, and the same losses as one process within 1e-5."""
    from repro_torch.launch import train
    args = ["--reduced", "--device", "cpu", "--steps", "2"]
    one = train.run(train.parse_args(args))
    run = train.run(train.parse_args(args + ["--mesh-shape", "2,1,2"]))
    out = capfd.readouterr().out
    assert "mesh pod=2 data=1 model=2: 4 ranks over gloo" in out
    assert "losses equal on every rank" in out
    assert run.shape == (2, 1, 2) and len(run.ranks) == 4
    assert all(r["losses"] == run.ranks[0]["losses"] for r in run.ranks)
    np.testing.assert_allclose(run.ranks[0]["losses"], one.losses,
                               rtol=1e-5)
    assert all(r["jax_modules"] == [] for r in run.ranks)
