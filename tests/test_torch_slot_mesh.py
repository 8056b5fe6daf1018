"""The slot ``prefill`` and ``decode_step`` in JAX's sharded cache layout
(``cache_specs``: the batch over ('pod', 'data'), the K/V and ``kv_pos``
slots over 'model'), on the CPU against JAX's single-device functions.

Each case is a reduced config on a (data, model) mesh of gloo ranks
spawned by ``launch.mesh.spawn_ranks``: every rank holds its slab of the
weights (``launch.sharding.local_params``) and runs ``prefill`` on the
whole prompt batch, then decode steps with a fixed active-mask pattern,
under ``activation_partitioning``, each row's next token its own argmax
(an inactive row keeps its token). JAX's ``prefill`` + ``decode_step``
run here on the same weights (JAX's ``init_params`` through
``load_params``) and tokens. Held: active rows' logits within 1e-5
(``helpers.ATOL``, fp32) on every rank, greedy streams identical, each
rank's cache after the prefill and after the last step equal to the
slice of JAX's cache that JAX's own ``cache_specs`` gives its
coordinates (the SSM state on the rank's heads as the spec cuts it; the
conv tail on the rank's ``[x | B | C]`` channels, the port's named
departure, where the spec cuts contiguous blocks; positions exact, K/V
and states by the slot tests' cache measure), no JAX module in any rank.

Layouts: smollm with 6 query / 2 KV heads over (1, 2) (heads cut by KV
slab, the ring cut in two) and over (1, 4) (heads whole: 6 do not
divide 4, like smollm-360m's 15 over 16); edge-6b with 8 / 2 heads over
(1, 4) (ranks share a KV head: the kv_group layout) on a 64-slot ring and
on a 50-slot one that 'model' does not divide (every rank the whole
sequence); mamba2 over (2, 1) (rows only) and smollm with a batch of 3
over (2, 1) (the groups do not divide it: nothing split); granite-moe
(experts over 'model', rows over 'data') and hymba (two 65-token
prompts into its 64-slot window ring, cut in two, a row a data group;
its 16 SSM heads 8 a rank) over (2, 2). The SSM mixer cut by heads
(``launch.sharding.ssm_split``): mamba2's 16 heads over (1, 2) and
(1, 4), hymba's over (1, 4) (its attention in the kv_group layout), and
a mamba2 of 6 heads (d_model 192, heads of 64) over (1, 4), which 'model'
does not divide: every head on every rank.
One 2-rank and one 4-rank group, each spawned once, run every case of
their world. Also: ``local_cache`` and ``gather_cache`` against JAX's
specs at the production meshes' shapes, and the SSM mixer under a
one-rank context (the collective path) against the mixer without one.
"""
from __future__ import annotations

import dataclasses
import math
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from helpers import assert_logits_close  # noqa: E402
from test_torch_sharded_moe import _numpy  # noqa: E402

TIMEOUT = 240.0
STEPS = 6
# name -> (arch, config replacements)
CFGS = {
    "smollm62": ("smollm-360m", dict(n_heads=6, n_kv_heads=2)),
    "edge82": ("edge-6b", dict(n_heads=8, n_kv_heads=2)),
    "mamba2": ("mamba2-780m", {}),
    "granite": ("granite-moe-3b-a800m", {}),
    "hymba": ("hymba-1.5b", {}),
    "mamba2-6h": ("mamba2-780m", dict(d_model=192, ssm_head_dim=64)),
}
# case -> (ranks, (data, model), config, batch, prompt length, buf_len)
CASES = {
    "smollm-1x2": (2, (1, 2), "smollm62", 4, 20, 64),
    "mamba2-2x1": (2, (2, 1), "mamba2", 4, 20, 64),
    "smollm-2x1-b3": (2, (2, 1), "smollm62", 3, 20, 64),
    "granite-2x2": (4, (2, 2), "granite", 4, 20, 64),
    "hymba-2x2": (4, (2, 2), "hymba", 2, 65, 64),
    "edge-1x4": (4, (1, 4), "edge82", 4, 20, 64),
    "edge-1x4-buf50": (4, (1, 4), "edge82", 4, 20, 50),
    "smollm-1x4": (4, (1, 4), "smollm62", 4, 20, 64),
    # the SSM cut by heads: 4 prompts of 16 tokens (at mamba2-2x1's 4 of
    # 20 the single-device port already lands 9.66e-6 from JAX, and
    # mamba2-1x4's four partial sums of out_proj and of the norm's squares
    # add 2.6e-6 to it, 1.013e-5 in all: fp32 order, ROADMAP.md Queue C)
    "mamba2-1x2": (2, (1, 2), "mamba2", 4, 16, 64),
    "mamba2-1x4": (4, (1, 4), "mamba2", 4, 16, 64),
    "hymba-1x4": (4, (1, 4), "hymba", 4, 16, 64),
    "mamba2-6h-1x4": (4, (1, 4), "mamba2-6h", 4, 16, 64),
}


def _cfg(name, package):
    import importlib
    arch, repl = CFGS[name]
    cfg = importlib.import_module(f"{package}.configs").get_config(arch)
    return dataclasses.replace(cfg.reduced(), **repl)


def _inputs(case):
    """The case's prompts [B,S] (drawn as ``test_torch_slot_ssm``'s ring
    prefill draws its own) and the active pattern [STEPS,B]."""
    _, _, name, B, S, _ = CASES[case]
    rng = np.random.default_rng(S)
    prompts = rng.integers(0, 1024, (B, S)).astype(np.int32)
    active = np.array([[(b + t) % 3 != 2 for b in range(B)]
                       for t in range(STEPS)])
    return prompts, active


def _next(tokens, logits, active):
    """Greedy: an active row's argmax, an inactive row keeps its token."""
    return np.where(active, logits.argmax(-1), tokens).astype(np.int32)


# ------------------------------------------------------------ the ranks

def _run_case(mesh, case, tree):
    from repro_torch.launch import sharding as SH
    from repro_torch.models import model as TM
    from repro_torch.models.partitioning import activation_partitioning
    _, _, name, _, _, buf_len = CASES[case]
    cfg = _cfg(name, "repro_torch")
    params = SH.local_params(cfg, TM.load_params(cfg, tree, device="cpu"),
                             mesh)
    prompts, active = _inputs(case)

    def snap(cache):
        return {k: v.numpy().copy() for k, v in cache.items()}

    seen = {"logits": [], "tokens": []}
    cut = SH.cut_leaves(cfg, mesh.shape["model"])
    with activation_partitioning(mesh, cut):
        logits, cache = TM.prefill(cfg, params, torch.from_numpy(prompts),
                                   buf_len)
        seen["prefill"] = logits.numpy().copy()
        seen["cache0"] = snap(cache)
        tokens = logits.numpy().argmax(-1).astype(np.int32)
        for t in range(STEPS):
            seen["tokens"].append(tokens)
            logits, cache = TM.decode_step(
                cfg, params, cache, torch.from_numpy(tokens),
                torch.from_numpy(active[t]), buf_len=buf_len)
            seen["logits"].append(logits.numpy().copy())
            tokens = _next(tokens, seen["logits"][-1], active[t])
    seen["tokens"].append(tokens)
    seen["cache"] = snap(cache)
    return seen


def _rank_main(rank, world, trees):
    """A spawned rank: every case of ``world`` ranks on its mesh (each
    mesh made once, in the same order on every rank); returns {case: what
    the rank saw} and the JAX modules it imported (none)."""
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import make_serving_mesh
    meshes, out = {}, {}
    for case, (ranks, shape, name, *_) in CASES.items():
        if ranks != world:
            continue
        if shape not in meshes:
            meshes[shape] = make_serving_mesh(data=shape[0], model=shape[1])
        out[case] = _run_case(meshes[shape], case, trees[name])
    out["leaked"] = sorted(m for m in sys.modules if m == "jax"
                           or m.startswith(("jax.", "repro.")))
    return out


# ------------------------------------------------------------ JAX side

@pytest.fixture(scope="module")
def weights():
    """Per config: (JAX cfg, JAX params, numpy tree), drawn from
    PRNGKey(4), the weights ``tests/test_torch_slot_ssm.py`` holds the
    ring prefill to JAX with. The SSD core's fp32 sums run in another
    order in torch than in XLA (~3e-6 relative): at other keys the
    single-device port's mamba2 and hymba logits land 1.0e-5 to 2.5e-5
    from JAX's on these prompts, with or without a mesh (ROADMAP.md
    Queue C)."""
    import jax
    from repro.models import model as JM
    out = {}
    for name in CFGS:
        cfg = _cfg(name, "repro")
        params = JM.init_params(cfg, jax.random.PRNGKey(4))
        out[name] = (cfg, params, _numpy(params))
    return out


def _spawn(weights, world, tmp_path_factory):
    from repro_torch.launch.mesh import spawn_ranks
    trees = {k: v[2] for k, v in weights.items()}
    return spawn_ranks(_rank_main, world, (world, trees), timeout=TIMEOUT,
                       store_dir=str(tmp_path_factory.mktemp(f"slot{world}")))


@pytest.fixture(scope="module")
def ranks2(weights, tmp_path_factory):
    return _spawn(weights, 2, tmp_path_factory)


@pytest.fixture(scope="module")
def ranks4(weights, tmp_path_factory):
    return _spawn(weights, 4, tmp_path_factory)


def _jax_run(weights, case):
    """JAX's single-device prefill + decode steps on the case's inputs,
    observed as a rank observes its own (called as the other tests of the
    port call them, not jitted)."""
    import jax.numpy as jnp
    from repro.models import model as JM
    _, _, name, _, _, buf_len = CASES[case]
    cfg, params, _ = weights[name]
    prompts, active = _inputs(case)
    logits, cache = JM.prefill(cfg, params, jnp.asarray(prompts),
                               buf_len=buf_len)
    seen = {"logits": [], "tokens": [], "prefill": np.asarray(logits),
            "cache0": {k: np.asarray(v) for k, v in cache.items()}}
    tokens = np.asarray(logits).argmax(-1).astype(np.int32)
    for t in range(STEPS):
        seen["tokens"].append(tokens)
        logits, cache = JM.decode_step(cfg, params, cache,
                                       jnp.asarray(tokens),
                                       jnp.asarray(active[t]))
        seen["logits"].append(np.asarray(logits))
        tokens = _next(tokens, seen["logits"][-1], active[t])
    seen["tokens"].append(tokens)
    seen["cache"] = {k: np.asarray(v) for k, v in cache.items()}
    return seen


def _spec_part(cfg, key, arr, shape, coords, batch, buf_len):
    """The part of a whole cache leaf that JAX's ``cache_specs`` gives the
    device at ``coords`` of a mesh of ``shape``, but the conv tail's
    channels over 'model': where 'model' divides the SSM heads, the x
    channels of the rank's heads, then the whole B and C (the port's
    named departure), else every channel."""
    from repro.launch.sharding import cache_specs
    mesh = types.SimpleNamespace(shape=dict(shape), axis_names=tuple(shape))
    spec = cache_specs(cfg, mesh, batch, buf_len=buf_len)[key]
    for dim, axes in enumerate(spec):
        if axes is None or (axes == "model" and key == "conv"):
            continue
        names = (axes,) if isinstance(axes, str) else tuple(axes)
        ways = math.prod(shape[a] for a in names)
        index = 0
        for a in names:
            index = index * shape[a] + coords[a]
        n = arr.shape[dim] // ways
        arr = np.take(arr, np.arange(index * n, (index + 1) * n), axis=dim)
    ways = shape["model"]
    if key == "conv" and cfg.ssm_heads % ways == 0:
        di, r = cfg.ssm_inner, coords["model"]
        n = di // ways
        arr = np.take(arr, np.r_[r * n:(r + 1) * n,
                                 di:di + 2 * cfg.ssm_state], axis=2)
    return arr


def _check_cache(cfg, got, want, shape, coords, batch, buf_len, what):
    """Each leaf of a rank's cache against its part of JAX's: positions
    and lengths exactly, K/V and the SSM state by the measure the slot
    tests hold caches to (``test_torch_slot_ssm._assert_state_close``)."""
    from test_torch_slot_ssm import _assert_state_close  # imports JAX
    assert sorted(got) == sorted(want), what
    for key, arr in want.items():
        part = _spec_part(cfg, key, arr, shape, coords, batch, buf_len)
        assert got[key].shape == part.shape, (what, key)
        if key in ("length", "kv_pos"):
            np.testing.assert_array_equal(got[key], part,
                                          err_msg=f"{what} {key}")
        else:
            _assert_state_close(got[key], part, f"{what} {key}")


def _check(weights, ranks, case):
    world, shape, name, batch, _, buf_len = CASES[case]
    cfg = weights[name][0]
    want = _jax_run(weights, case)
    _, active = _inputs(case)
    mesh_shape = {"data": shape[0], "model": shape[1]}
    for r, res in enumerate(ranks):
        assert res["leaked"] == [], res["leaked"][:5]
        got = res[case]
        what = f"{case} rank {r}"
        coords = {"data": r // shape[1], "model": r % shape[1]}
        assert_logits_close(got["prefill"], want["prefill"],
                            err_msg=f"{what} prefill")
        for t in range(STEPS):
            assert_logits_close(got["logits"][t][active[t]],
                                want["logits"][t][active[t]],
                                err_msg=f"{what} step {t}")
        np.testing.assert_array_equal(np.stack(got["tokens"]),
                                      np.stack(want["tokens"]), err_msg=what)
        for at in ("cache0", "cache"):
            _check_cache(cfg, got[at], want[at], mesh_shape, coords, batch,
                         buf_len, f"{what} {at}")


@pytest.mark.parametrize("case", [c for c in CASES if CASES[c][0] == 2])
def test_two_ranks_match_jax(weights, ranks2, case):
    _check(weights, ranks2, case)


@pytest.mark.parametrize("case", [c for c in CASES if CASES[c][0] == 4])
def test_four_ranks_match_jax(weights, ranks4, case):
    _check(weights, ranks4, case)


def test_ranks_hold_their_part_only(ranks2, ranks4):
    """What each layout cuts: hymba's ring of 64 to 32 slots, its batch
    of 2 to 1 row and its 16 SSM heads to 8; the 50-slot ring kept whole
    over 4; edge-6b's rank holds both KV heads (its weights one); the
    batch of 3 whole over 2 data groups; mamba2's 16 SSM heads whole over
    (2, 1), 8 a rank over (1, 2) and 4 over (1, 4), each with its x
    channels of the conv tail and the whole B and C (N = 16 each); 6
    heads whole over 4."""
    hymba = ranks4[0]["hymba-2x2"]["cache"]
    assert hymba["k"].shape == (2, 1, 1, 32, 32)
    assert hymba["ssm"].shape == (2, 1, 8, 32, 16)
    assert hymba["length"].shape == (1,)
    assert ranks4[1]["edge-1x4-buf50"]["cache"]["k"].shape == (2, 4, 2, 50, 32)
    assert ranks4[3]["edge-1x4"]["cache"]["kv_pos"].shape == (4, 16)
    assert ranks2[1]["smollm-2x1-b3"]["cache"]["k"].shape == (2, 3, 2, 64, 32)
    assert ranks2[1]["mamba2-2x1"]["cache"]["ssm"].shape == (2, 2, 16, 32, 16)
    for ranks, case, heads in ((ranks2, "mamba2-1x2", 8),
                               (ranks4, "mamba2-1x4", 4),
                               (ranks4, "hymba-1x4", 4),
                               (ranks4, "mamba2-6h-1x4", 6)):
        for res in ranks:
            cache = res[case]["cache"]
            P = cache["ssm"].shape[3]
            assert cache["ssm"].shape == (2, 4, heads, P, 16), case
            assert cache["conv"].shape == (2, 4, heads * P + 32, 3), case


# ------------------------------------------------ local_cache, gather_cache

@pytest.mark.parametrize("arch,shape,batch,buf_len", [
    ("smollm-360m", {"data": 16, "model": 16}, 32, 64),
    ("hymba-1.5b", {"pod": 2, "data": 16, "model": 16}, 64, 1024),
    ("mamba2-780m", {"data": 2, "model": 2}, 4, 64),
    ("edge-6b", {"data": 2, "model": 4}, 3, 50),
    ("mamba2-780m", {"data": 1, "model": 2}, 4, 64),
    ("mamba2-780m", {"data": 1, "model": 4}, 4, 64),
    ("mamba2-780m", {"data": 16, "model": 16}, 32, 64),
    ("hymba-1.5b", {"data": 1, "model": 2}, 4, 64),
    ("hymba-1.5b", {"data": 1, "model": 4}, 4, 64),
    ("hymba-1.5b", {"data": 16, "model": 16}, 32, 64),
])
def test_local_cache_is_jax_spec_part(arch, shape, batch, buf_len):
    """``local_cache`` of a whole cache at a few coordinates is JAX's
    ``cache_specs`` part (the conv tail's channels the port's ``[x | B |
    C]`` of the rank's SSM heads), and ``gather_cache`` of every
    coordinate's part is the whole again. Reduced widths (16 SSM heads:
    one a rank over 16), the production meshes' shapes, batches and
    rings."""
    from repro.configs import get_config as jax_config
    from repro_torch.configs import get_config
    from repro_torch.launch import sharding as SH
    from repro_torch.models import model as TM
    cfg = get_config(arch).reduced()
    jcfg = jax_config(arch).reduced()
    whole = TM.init_cache(cfg, batch, buf_len, device="cpu")
    rng = np.random.default_rng(0)
    for k, v in whole.items():
        v.copy_(torch.from_numpy(rng.integers(-9, 99, v.shape)).to(v.dtype))
    axes = tuple(shape)
    parts = []
    for r in range(math.prod(shape.values())):
        coords = dict(zip(axes, map(int, np.unravel_index(
            r, tuple(shape.values())))))
        mesh = types.SimpleNamespace(shape=dict(shape), axis_names=axes,
                                     coords=coords)
        part = SH.local_cache(cfg, whole, mesh)
        parts.append(part)
        if r % 7 == 0:
            for k, v in whole.items():
                want = _spec_part(jcfg, k, v.numpy(), shape, coords, batch,
                                  buf_len)
                np.testing.assert_array_equal(part[k].numpy(), want,
                                              err_msg=f"{k} at {coords}")
                assert part[k].is_contiguous()
    back = SH.gather_cache(cfg, parts, shape, batch, buf_len)
    for k, v in whole.items():
        np.testing.assert_array_equal(back[k].numpy(), v.numpy(), err_msg=k)


def test_model_functions_unchanged_without_a_context():
    """No context: ``seq_slice``, ``batch_rows`` and ``combine_model_lse``
    cut nothing, so prefill and decode_step are the single-device
    functions (held to JAX by the slot tests)."""
    from repro_torch.models import partitioning as P
    out = torch.ones(2, 3, 4)
    assert P.seq_slice(64) is None and P.batch_rows(4) is None
    assert P.combine_model_lse(out, torch.zeros(2, 3)) is out


def test_ssm_mixer_one_rank_context_is_the_mixer(tmp_path):
    """Under a one-rank context (a gloo group of one process) the mixer
    cuts its heads into one slab and takes the collective path (the gated
    norm and out_proj through ``partitioning.rms_norm_out_model``, two
    all-reduces a call): its output, final state and conv tail, and the
    in-place decode step's output and arenas, equal the mixer's without
    a context at 1e-6 (reduced mamba2, fp32)."""
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch import sharding as SH
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.models import model as TM
    from repro_torch.models import partitioning as P
    from repro_torch.models import ssm as SSM
    cfg = get_config("mamba2-780m").reduced()
    params = TM.init_params(cfg, seed=5, device="cpu")
    p = {k: v[1] for k, v in params["blocks"]["ssm"].items()}
    # the zero-initialised norm weight and conv bias, drawn instead
    g = torch.Generator().manual_seed(6)
    p["norm_w"] = 0.3 * torch.randn(p["norm_w"].shape, generator=g)
    p["conv_b"] = 0.3 * torch.randn(p["conv_b"].shape, generator=g)
    x = torch.randn(3, 21, cfg.d_model, generator=g)
    xt = torch.randn(3, cfg.d_model, generator=g)
    dims = (cfg.ssm_inner, cfg.ssm_state, cfg.ssm_head_dim)
    slots = torch.arange(3, dtype=torch.int32)
    active = torch.tensor([True, False, True])

    def run():
        y, h, conv = SSM.ssm_mixer_with_state(p, x, *dims)
        hs, cs = h.clone(), conv.clone()
        yt = SSM.ssm_mixer_step(p, xt, *dims, hs, cs, slots, active)
        return y, h, conv, yt, hs, cs

    want = run()
    assert not dist.is_initialized()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        mesh = make_serving_mesh(data=1, model=1)
        seen = []
        with P.activation_partitioning(mesh, SH.cut_leaves(cfg, 1)), \
                P.recording(lambda *a: seen.append(a[:2])):
            assert P.cut("ssm.out_proj") and P.cut("ssm.in_proj")
            got = run()
    finally:
        dist.destroy_process_group()
    assert seen == [("all-reduce", "model")] * 4
    for name, a, b in zip(("y", "state", "conv", "step y", "step state",
                           "step conv"), got, want):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-6,
                                   err_msg=name)


def test_margins_cli_on_the_cpu(capsys):
    """``launch.slot_mesh_margins`` (the card's measurement of how far a
    mesh lands from one process, by cut leaves, and of one process against
    a reordering of its own sums) runs on the CPU at a reduced size: a
    line for the reordered single process and one for each variant, every
    rank alike, each within 1e-4."""
    import re
    from repro_torch.launch import slot_mesh_margins
    slot_mesh_margins.main([
        "--arch", "hymba-1.5b", "--reduced", "--device", "cpu", "--mesh",
        "1,2", "--layers", "2", "--batch", "2", "--prompt", "24", "--buf",
        "64", "--steps", "2", "--variants", "all,ssm,none", "--reorder",
        "100"])
    out = capsys.readouterr().out
    assert "2 layers, one process, out_proj's product cut at 100" in out
    for v in ("all", "ssm", "none"):
        line = next(x for x in out.splitlines()
                    if x.startswith(f"2 layers, mesh, cut {v}:"))
        assert line.endswith("every rank alike"), line
        err = float(re.search(r"max_abs_err=(\S+) ", line).group(1))
        assert err < 1e-4, line
