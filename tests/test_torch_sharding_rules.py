"""The port's sharding rules (``repro_torch.launch.sharding``) held against
the JAX package's (``repro.launch.sharding``), and the serving layout a
tensor-parallel rank holds.

The rules are pure functions of (config, ``mesh.shape``,
``mesh.axis_names``): a stand-in mesh serves both packages, so they are
compared at the production meshes (16, 16) and (2, 16, 16) as at the
serving meshes (1, 2) and (1, 4), for every registry arch at full width.
JAX's PartitionSpecs and NamedTuples are turned into tuples and dicts.

The serving layout follows ``param_specs(train=False)`` wherever that
spec splits whole heads, d_ff columns or vocabulary rows; every leaf where
it differs is one of the departures the module documents (JAX splits
inside a head or splits d_model there; the port keeps whole heads). Its
slabs put the whole parameters back together, and a rank drawing only its
slab (``init_params(cut=...)``) gets exactly the slab of the whole draw.
"""
from __future__ import annotations

import dataclasses
import types

import pytest

torch = pytest.importorskip("torch")

from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import list_archs  # noqa: E402
from repro.launch import sharding as JS  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import sharding as TS  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402

MESHES = [(1, 2), (1, 4), (2, 2), (16, 16), (2, 16, 16)]
# archs a serving mesh takes: causal, attention-only, dense or MoE
MESH_ARCHS = [a for a in list_archs()
              if get_config(a).block_kind in ("dense", "moe")
              and get_config(a).causal and not get_config(a).has_ssm]


def fake_mesh(shape, rank: int = 0):
    axes = ("pod", "data", "model") if len(shape) == 3 else ("data", "model")
    sizes = dict(zip(axes, shape))
    return types.SimpleNamespace(shape=sizes, axis_names=axes,
                                 coords={"model": rank % sizes["model"]})


def plain(tree):
    """A JAX spec tree as the port writes it: tuples and dicts."""
    if isinstance(tree, JP):
        return tuple(tree)
    if hasattr(tree, "_asdict"):
        return {k: plain(v) for k, v in tree._asdict().items()}
    if isinstance(tree, dict):
        return {k: plain(v) for k, v in tree.items()}
    return tree


def leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def cut_specs(cfg, ways):
    """The serving layout as specs of the stacked leaves: "model" on a
    (dim, "model") cut, "kv_group" on a KV-group cut, None elsewhere."""
    shapes = TM.param_shapes(cfg)

    def walk(cuts, shp):
        out = {}
        for k, cut in cuts.items():
            if isinstance(cut, dict):
                out[k] = walk(cut, shp[k])
                continue
            dims = [None] * len(shp[k])
            if cut is not None:
                dims[cut[0]] = cut[1]
            out[k] = tuple(dims)
        return out

    return walk(TS.serving_cuts(cfg, ways), shapes)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("arch", list_archs())
def test_rules_equal_jax(arch, shape):
    jcfg, cfg = jax_config(arch), get_config(arch)
    mesh = fake_mesh(shape)
    for train in (False, True):
        assert TS.param_specs(cfg, mesh, train) == plain(
            JS.param_specs(jcfg, mesh, train)), train
    assert TS.page_specs(cfg, mesh) == plain(JS.page_specs(jcfg, mesh))
    for batch, buf_len in ((128, 32768), (3, None), (256, 4096)):
        assert TS.cache_specs(cfg, mesh, batch, buf_len) == plain(
            JS.cache_specs(jcfg, mesh, batch, buf_len)), (batch, buf_len)
    for batch, ndim in ((256, 2), (32, 3), (3, 2)):
        assert TS.batch_spec(mesh, batch, ndim) == tuple(
            JS.batch_spec(mesh, batch, ndim))
    ps = TS.param_specs(cfg, mesh, True)
    assert plain(TS.opt_state_specs(ps)._asdict()) == plain(
        JS.opt_state_specs(JS.param_specs(jcfg, mesh, True)))


@pytest.mark.parametrize("ways", [2, 4, 16])
@pytest.mark.parametrize("arch", MESH_ARCHS)
def test_serving_layout_follows_param_specs(arch, ways):
    """Leaf by leaf the rank's cut equals param_specs(train=False), or the
    leaf is a documented departure: JAX splits inside a head or d_model
    there, and the port keeps the leaf whole (or, for K/V, the one head
    its query heads read). The MoE group follows the spec in both its
    branches: whole experts (granite-moe's 40 over 2 and 4,
    llama4-scout's 16 over 2, 4 and 16) or every expert's d_ff columns
    (granite-moe over 16)."""
    cfg = get_config(arch)
    want = dict(leaves(TS.param_specs(cfg, fake_mesh((1, ways)), False)))
    got = dict(leaves(cut_specs(cfg, ways)))
    assert got.keys() == want.keys()
    attn = TS.attention_split(cfg, ways)
    for path, spec in got.items():
        if spec == want[path]:
            continue
        name = path.split(".")[-1]
        if name in ("wq", "wo"):
            assert not attn, path
        elif name in ("wk", "wv"):
            assert cfg.n_kv_heads % ways or not attn, path
        elif name in ("embed", "lm_head"):
            assert cfg.padded_vocab % ways, path
        else:
            raise AssertionError(f"{arch} {path}: {spec} != {want[path]}")
        assert "model" not in spec, (path, spec)
        if "kv_group" in spec:
            assert attn and cfg.n_kv_heads % ways, path


def test_cut_leaves_name_moe_apart():
    """The MoE group's leaves are named by their path in the group, so an
    MoE layout never cuts a dense MLP's wg/wu/wd, nor a dense layout an
    MoE's: granite-moe cuts "moe.wd" and no "wd", edge-6b "wd" and no
    "moe.wd". Over 3 ranks granite-moe's 40 experts do not divide, its
    d_ff of 512 does not either: the experts stay whole."""
    moe, dense = get_config("granite-moe-3b-a800m"), get_config("edge-6b")
    for ways in (1, 2, 4, 16):
        cut = TS.cut_leaves(moe, ways)
        assert {"moe.wg", "moe.wu", "moe.wd"} <= cut, ways
        assert not {"wg", "wu", "wd", "router", "moe.router"} & cut, ways
    assert not {"moe.wg", "moe.wu", "moe.wd"} & TS.cut_leaves(moe, 3)
    cut = TS.cut_leaves(dense, 2)
    assert {"wg", "wu", "wd"} <= cut and not any("moe" in n for n in cut)


@pytest.mark.parametrize("experts,ways", [(4, 2), (4, 4), (3, 2), (6, 4)])
def test_moe_slabs_cut_whole_params(experts, ways):
    """The ranks' MoE slabs, expert-parallel (4 experts over 2 and 4) or
    inside each expert (3 over 2, 6 over 4), put every leaf back together
    along the cut, the router whole on every rank, and init_params(cut=)
    draws exactly each slab."""
    cfg = dataclasses.replace(get_config("granite-moe-3b-a800m").reduced(),
                              n_experts=experts)
    full = TM.init_params(cfg, seed=4, device="cpu")["blocks"]["moe"]
    cuts = TS.serving_cuts(cfg, ways)["blocks"]["moe"]
    dim = -3 if experts % ways == 0 else None
    for k in ("wg", "wu", "wd"):
        assert cuts[k][0] == (dim or (-2 if k == "wd" else -1)), k
    slabs = [TS.local_params(cfg, {"blocks": {"moe": full}},
                             fake_mesh((1, ways), r))["blocks"]["moe"]
             for r in range(ways)]
    for r in range(ways):
        drawn = TM.init_params(cfg, seed=4, device="cpu", cut=TS.cutter(
            cfg, fake_mesh((1, ways), r)))["blocks"]["moe"]
        for k in full:
            assert torch.equal(drawn[k], slabs[r][k]), (r, k)
    assert all(torch.equal(s["router"], full["router"]) for s in slabs)
    for k in ("wg", "wu", "wd"):
        assert torch.equal(torch.cat([s[k] for s in slabs], cuts[k][0]),
                           full[k]), k


def test_edge_6b_head_slabs():
    """edge-6b (Hq 32, Hkv 2): 16 query heads and KV head r a rank over 2;
    8 query heads and the KV head they read over 4 (0 on ranks 0-1, 1 on
    ranks 2-3); every leaf follows the spec over 2."""
    cfg = get_config("edge-6b")
    assert [TS.head_slab(cfg, 2, r) for r in range(2)] == [(16, 1, 0),
                                                           (16, 1, 1)]
    assert [TS.head_slab(cfg, 4, r) for r in range(4)] == [
        (8, 1, 0), (8, 1, 0), (8, 1, 1), (8, 1, 1)]
    assert cut_specs(cfg, 2) == TS.param_specs(cfg, fake_mesh((1, 2)), False)
    assert cut_specs(cfg, 4)["blocks"]["wk"] == (None, None, "kv_group")
    # smollm-360m: 15 query heads do not split over 2 (JAX splits inside a
    # head); its 5 KV heads over 5 ranks do
    smol = get_config("smollm-360m")
    assert not TS.attention_split(smol, 2)
    assert TS.head_slab(smol, 5, 3) == (3, 1, 3)


@pytest.mark.parametrize("ways,kv", [(2, 2), (4, 4), (2, 1), (4, 1)])
def test_local_params_cut_whole_params(ways, kv):
    """The ranks' slabs put every leaf back together (concatenated along
    the cut, or, for a KV-group cut, each rank's head is the head its
    queries read), and init_params(cut=...) draws exactly the slab of the
    whole draw."""
    cfg = dataclasses.replace(get_config("smollm-360m").reduced(),
                              n_kv_heads=kv)
    full = TM.init_params(cfg, seed=3, device="cpu")
    cuts = TS.serving_cuts(cfg, ways)
    slabs = [TS.local_params(cfg, full, fake_mesh((1, ways), r))
             for r in range(ways)]
    drawn = [TM.init_params(cfg, seed=3, device="cpu",
                            cut=TS.cutter(cfg, fake_mesh((1, ways), r)))
             for r in range(ways)]
    whole = dict(leaves(full))
    cut_of = dict(leaves(cuts))
    for r in range(ways):
        for path, x in leaves(slabs[r]):
            assert torch.equal(x, dict(leaves(drawn[r]))[path]), (r, path)
    for path, w in whole.items():
        parts = [dict(leaves(s))[path] for s in slabs]
        cut = cut_of[path]
        if cut is None:
            assert all(torch.equal(p, w) for p in parts), path
        elif cut[1] == "model":
            assert torch.equal(torch.cat(parts, dim=cut[0]), w), path
        else:
            hd = cfg.head_dim
            for r, p in enumerate(parts):
                kv0 = TS.head_slab(cfg, ways, r)[2]
                assert torch.equal(p, w[..., kv0 * hd:(kv0 + 1) * hd]), path
