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
  step and its ``forward``.

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
batch's mean and the MoE statistics every group's. The sorted MoE path,
whose drops are the whole batch's, is refused on a split batch.

Also: each rank's shards of the params follow ``param_specs(
train=True)``'s per-device shapes except on the dims of the named
departures; every rank's shards put back together give the whole tree;
the CLI's ``--mesh-shape 1,2``; no rank imports JAX.

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
           "hubert": ("hubert-xlarge", None)}
# case -> (config, (data, model))
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
         "hubert-1x2": ("hubert", (1, 2)), "hubert-2x2": ("hubert", (2, 2))}
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


def _cfg(name, jax=False):
    arch, experts = CONFIGS[name]
    if jax:
        from repro.configs import get_config
    else:
        from repro_torch.configs import get_config
    cfg = get_config(arch).reduced()
    return cfg if experts is None else dataclasses.replace(
        cfg, n_experts=experts)


def _batch(cfg):
    """(inputs, labels) numpy: the tokens ``tests/test_torch_train_step.
    py`` holds one process on (for an embedding-input arch [B,S,D] frames
    drawn after them, N(0, 1) * 0.02 as both training launchers draw
    them), labels the tokens."""
    rng = np.random.default_rng(4)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    inputs = toks
    if cfg.embedding_inputs:
        inputs = (rng.standard_normal((B, S, cfg.d_model)) * 0.02).astype(
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
    init_state, train_step = make_train_step(cfg, peak_lr=LR, warmup=1,
                                             total=10, device="cpu",
                                             mesh=mesh)
    state = init_state(_load(path, "s0.p", shapes))
    opts = M.ModelOptions(remat=True)

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


def _rank_sorted_refused(mesh, name, path):
    """The sorted MoE path on a batch split over data groups: the error
    every rank raises (None where it ran)."""
    from repro_torch.models import model as M
    from repro_torch.training.trainer import (local_batch, make_train_step,
                                              step_grads)
    cfg = _cfg(CASES[name][0])
    init_state, _ = make_train_step(cfg, device="cpu", mesh=mesh)
    params, _ = init_state(_load(path, "s0.p", M.param_shapes(cfg)))
    batch = local_batch({k: torch.from_numpy(np.load(os.path.join(
        path, f"{k}.npy"))) for k in ("inputs", "labels")}, mesh)
    try:
        step_grads(cfg, params, batch,
                   M.ModelOptions(remat=True, moe_impl="sorted"), mesh)
    except NotImplementedError as e:
        return str(e)
    return None


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


def _rank_main(rank, world, paths):
    """A spawned rank: every case of ``world`` ranks, each mesh made once,
    in the same order on every rank; returns {case: what the rank saw}
    and the JAX modules it imported (none)."""
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import make_serving_mesh
    meshes, out = {}, {}
    for name, (config, shape) in CASES.items():
        if shape[0] * shape[1] != world:
            continue
        if shape not in meshes:
            meshes[shape] = make_serving_mesh(data=shape[0], model=shape[1])
        if name in CASES_JAX:
            out[name] = _rank_case(meshes[shape], name, paths[config])
        if name in UNEVEN:
            out[name, "uneven"] = _rank_uneven(meshes[shape], name,
                                               paths[config], UNEVEN[name])
        if name == "granite-dense-2x1":
            out[name, "sorted"] = _rank_sorted_refused(meshes[shape], name,
                                                       paths[config])
        if name in FORWARD:
            out[name, "forward"] = _rank_forward(meshes[shape], name,
                                                 paths[config])
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


def _trajectory(name, path):
    """JAX's 3 steps of one config, saved under ``path``: the state
    before each step (s{i}.p/.mu/.nu), jax.grad's gradient there (g{i}),
    the params after the last (s3.p), the batch, and for hubert its
    forward's logits; returns the losses and the exact gradient norms."""
    import jax
    import jax.numpy as jnp

    from repro.models import model as JM
    from repro.training import optimizer as jopt
    from repro.training.trainer import make_train_step as jax_train_step
    jcfg = _cfg(name, jax=True)
    params = JM.init_params(jcfg, jax.random.PRNGKey(SEED))
    inputs, labels = _batch(jcfg)
    np.save(os.path.join(path, "inputs.npy"), inputs)
    np.save(os.path.join(path, "labels.npy"), labels)
    jb = {"inputs": jnp.asarray(inputs), "labels": jnp.asarray(labels)}
    opts = JM.ModelOptions(remat=True)
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
    return ranks[shape[0] * shape[1]]


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
    return dict(_flat(SH.gather_train_params(
        cfg, parts, {"data": shape[0], "model": shape[1]})))


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


def test_sorted_moe_refused_on_split_batch(ranks):
    """The sorted MoE path drops by the whole batch's capacity, which a
    data group's rows cannot give: every rank of (2, 1) refuses it."""
    for r, res in enumerate(_results(ranks, "granite-dense-2x1")):
        err = res["granite-dense-2x1", "sorted"]
        assert err is not None and "under a mesh" in err, r


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
    axes = ("data", "model")
    sizes = dict(zip(axes, shape))
    return types.SimpleNamespace(shape=sizes, axis_names=axes, coords={
        "data": rank // shape[1], "model": rank % shape[1]})


LAYOUTS = [("smollm-360m", (2, 2)), ("smollm-360m", (16, 16)),
           ("granite-moe-3b-a800m", (16, 16)), ("mamba2-780m", (16, 16)),
           ("hymba-1.5b", (16, 16)), ("hubert-xlarge", (16, 16)),
           ("edge-6b", (2, 4))]


@pytest.mark.parametrize("arch,shape", LAYOUTS,
                         ids=[f"{a}-{d}x{m}" for a, (d, m) in LAYOUTS])
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
    if shape == (16, 16) and arch in expected:
        assert departed == expected[arch]
    if arch == "granite-moe-3b-a800m":
        assert not any(p.startswith("blocks.moe") for p in departed)


@pytest.mark.parametrize("arch,shape", [
    ("smollm-360m", (2, 2)), ("smollm-360m", (1, 4)),
    ("granite-moe-3b-a800m", (2, 2)), ("mamba2-780m", (2, 2)),
    ("hymba-1.5b", (2, 2)), ("hubert-xlarge", (2, 1))])
def test_train_shards_put_back_together(arch, shape):
    """Every rank's shards (``local_train_params``) put back together
    (``gather_train_params``) are the whole reduced params, exactly."""
    from repro_torch.configs import get_config
    from repro_torch.launch import sharding as SH
    from repro_torch.models import model as M
    cfg = get_config(arch).reduced()
    whole = M.init_params(cfg, seed=1, device="cpu")
    parts = [SH.local_train_params(cfg, whole, _fake_mesh(shape, r))
             for r in range(shape[0] * shape[1])]
    got = dict(_flat(SH.gather_train_params(
        cfg, parts, {"data": shape[0], "model": shape[1]})))
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
