"""Sharding rules of the port (the counterpart of ``repro.launch.sharding``)
and the serving layout a tensor-parallel rank holds.

The rules — ``param_specs``, ``page_specs``, ``cache_specs``,
``batch_spec``, ``opt_state_specs`` — are copies of the JAX package's,
pure functions of (config, ``mesh.shape``, ``mesh.axis_names``): each
returns, per leaf of the tree ``models.model.init_params`` makes, a tuple
of axis names (``None``, a name, or a tuple of names) where JAX returns a
``PartitionSpec``. They read no process group, so they can be evaluated
for the (16, 16) and (2, 16, 16) production meshes with a stand-in mesh.

Serving: tensor-parallel over 'model' (d_ff / head-projection / expert
axis), weights replicated over 'data'/'pod'; batch over ('pod','data') when
divisible. KV caches are additionally sequence-parallel over 'model'.
Training: additionally FSDP-shards the non-'model' weight dim over 'data'.
Every rule guards on divisibility and falls back to the next-best
dimension, as jit input shardings require.

A slot cache (``models.model.init_cache``'s layout) follows
``cache_specs`` exactly: ``local_cache`` cuts a whole cache to a rank's
part (its rows of a batch split over ('pod', 'data'), its slice of the
K/V and ``kv_pos`` slots over 'model', every KV head), what the slot
``prefill`` returns and ``decode_step`` takes under
``models.partitioning.activation_partitioning``; ``gather_cache`` puts
the ranks' parts back together. The SSM state ``ssm`` [L,B,H,P,N] is cut
on H where 'model' divides the heads (``ssm_split``, JAX's ``hshard``),
as the spec cuts it; the conv tail ``conv`` [L,B,C,K-1] then holds the
rank's channels ``[x of its heads | B | C]`` (``ssm_index``), where the
spec cuts C in contiguous blocks that are not whole heads (a named
departure); where the heads do not divide, both keep every head.

The serving layout (``serving_cuts``, ``local_params``, ``head_slab``)
is what a rank of ``serving.executor.PagedTorchExecutor(mesh=...)`` holds.
It follows ``param_specs(train=False)`` wherever that spec splits whole
heads, whole d_ff columns, whole experts or whole vocabulary rows; where
the spec splits inside a head, or splits d_model, the port keeps whole
heads, because a kernel takes whole heads:

- attention shards by query heads when ``n_heads % ways == 0`` and every
  rank's query heads read the same number of KV heads; otherwise every
  rank holds all of it (replicated). wq and wo are cut by query heads;
- the K/V projections and the KV arena hold ``n_kv_heads / ways`` heads a
  rank when that divides; otherwise each rank holds the one KV head its
  query heads read (edge-6b over 4 ranks: 8 query heads a rank, KV head
  0 on ranks 0-1 and KV head 1 on ranks 2-3), which no PartitionSpec
  expresses (JAX splits d_model, or inside a head, there);
- wg/wu are cut by d_ff columns and wd by d_ff rows when ``d_ff % ways ==
  0``, else replicated, as the spec does;
- the embedding is cut by vocabulary rows and lm_head by vocabulary
  columns when ``padded_vocab % ways == 0``; else both are replicated
  (JAX splits d_model there);
- MoE (the ``moe`` group), as the spec chooses: expert-parallel when
  ``n_experts % ways == 0``, wg/wu/wd cut on the expert dim (rank r holds
  experts [r*E/ways, (r+1)*E/ways)); otherwise tensor-parallel inside
  each expert, wg/wu cut by d_ff columns and wd by d_ff rows when
  ``d_ff % ways == 0``, else whole. The router and ln2 stay whole;
- the SSM mixer (the ``ssm`` group) is cut by heads when ``ssm_heads %
  ways == 0`` (``ssm_split``): rank r holds heads [r*H/ways,
  (r+1)*H/ways). norm_w is cut in ``ways`` blocks and out_proj by rows,
  as the spec does (d_inner's blocks are whole heads); a_log, d_skip and
  dt_bias stay whole, as the spec keeps them (the mixer narrows them to
  its heads). in_proj's columns are the rank's ``[z | x | B | C | dt]``
  and conv_w/conv_b's channels its ``[x | B | C]`` (``ssm_index``: the
  single B/C group whole on every rank), where the spec cuts d_in_proj
  and conv_dim in contiguous blocks that split heads (JAX's GSPMD moves
  data inside the step there; a kernel takes whole heads). Where the
  heads do not divide every SSM leaf stays whole. Only the slot
  ``prefill`` and ``decode_step`` run on a cut mixer: a serving mesh
  refuses SSM archs, as in JAX;
- norms are replicated.

A cut product is a partial sum over 'model' (wo's, wd's and out_proj's
rows, an expert slab's or a d_ff slab's share of the MoE combine) or a
slab of the output (the vocabulary); ``models.partitioning`` puts the
whole together. ``cut_leaves`` names a group's leaves by their path in the
group ("moe.wd"), so a dense MLP's "wd" and an MoE's never meet.
"""
from __future__ import annotations

import math
import types
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.launch.mesh import batch_axes, batch_ways
from repro_torch.models import ssm as SSM

Spec = Tuple[Any, ...]
# a serving cut: (dim, how) with how "model" (one of `ways` equal blocks,
# the rank's), "kv_group" (one KV head, the one the rank's queries read)
# or "ssm_heads" (the columns or channels of the rank's SSM heads,
# ``ssm_index``)
Cut = Optional[Tuple[int, str]]


def _div(n: int, ways: int) -> bool:
    return ways > 0 and n % ways == 0


def _axes(names: Tuple[str, ...]):
    """A dim's axes as a PartitionSpec normalises them: one name alone."""
    return names[0] if len(names) == 1 else names


# ------------------------------------------------------------------ rules

def param_specs(cfg: ArchConfig, mesh, train: bool) -> Dict[str, Any]:
    """Spec tree matching init_params' structure."""
    mways = mesh.shape["model"]
    dways = mesh.shape["data"]
    fsdp = "data" if train else None

    def fs(dim: int):
        return fsdp if (fsdp and _div(dim, dways)) else None

    def ms(dim: int):
        return "model" if _div(dim, mways) else None

    def mat(d_in: int, d_out: int):
        """[*, d_in, d_out] weight: prefer model on d_out, FSDP on d_in;
        if d_out is not divisible, swap."""
        if _div(d_out, mways):
            return fs(d_in), "model"
        if _div(d_in, mways):
            return "model", fs(d_out)
        return fs(d_in), None

    D, F, V = cfg.d_model, cfg.d_ff, cfg.padded_vocab
    blk: Dict[str, Any] = {"ln1": (None, None)}
    if cfg.has_attention:
        iq, oq = mat(D, cfg.q_dim)
        ik, ok_ = mat(D, cfg.kv_dim)
        blk.update(
            wq=(None, iq, oq), wk=(None, ik, ok_), wv=(None, ik, ok_),
            wo=(None, oq if oq == "model" else ms(cfg.q_dim), fs(D)),
        )
    if cfg.has_ssm:
        d_in_proj = 2 * cfg.ssm_inner + 2 * cfg.ssm_state + cfg.ssm_heads
        conv_dim = cfg.ssm_inner + 2 * cfg.ssm_state
        ii, oo = mat(D, d_in_proj)
        blk["ssm"] = dict(
            in_proj=(None, ii, oo),
            conv_w=(None, ms(conv_dim), None),
            conv_b=(None, ms(conv_dim)),
            a_log=(None, None),
            d_skip=(None, None),
            dt_bias=(None, None),
            norm_w=(None, ms(cfg.ssm_inner)),
            out_proj=(None, ms(cfg.ssm_inner), fs(D)),
        )
    if cfg.block_kind == "moe":
        E = cfg.n_experts
        if _div(E, mways):  # expert-parallel
            blk["moe"] = dict(
                router=(None, fs(D), None),
                wg=(None, "model", fs(D), None),
                wu=(None, "model", fs(D), None),
                wd=(None, "model", None, fs(D)),
            )
        else:               # tensor-parallel inside each expert
            blk["moe"] = dict(
                router=(None, fs(D), None),
                wg=(None, None, fs(D), ms(F)),
                wu=(None, None, fs(D), ms(F)),
                wd=(None, None, ms(F), fs(D)),
            )
        blk["ln2"] = (None, None)
    elif cfg.d_ff > 0:
        blk.update(
            wg=(None, fs(D), ms(F)),
            wu=(None, fs(D), ms(F)),
            wd=(None, ms(F), fs(D)),
            ln2=(None, None),
        )
    # embeddings: vocab over 'model' when divisible, else d_model
    if _div(V, mways):
        emb = ("model", fs(D))
        head = (fs(D), "model")
    else:  # odd vocab: shard the d_model dim instead
        emb = (fs(V), ms(D))
        head = (ms(D), None)
    out: Dict[str, Any] = {
        "embed": emb,
        "final_norm": (None,),
        "blocks": blk,
    }
    if not cfg.tied_embeddings:
        out["lm_head"] = head
    return out


def page_specs(cfg: ArchConfig, mesh) -> Dict[str, Any]:
    """KV page arena [L, n_pages, Hkv, page_size, hd]: per-device KV-head
    slabs over 'model' when the head count divides the axis, replicated
    otherwise. Page tables stay replicated host data either way."""
    mways = mesh.shape["model"]
    h = "model" if _div(cfg.n_kv_heads, mways) else None
    spec = (None, None, h, None, None)
    return {"k_pages": spec, "v_pages": spec}


def cache_specs(cfg: ArchConfig, mesh, batch: int,
                buf_len: Optional[int] = None) -> Dict[str, Any]:
    mways = mesh.shape["model"]
    b_ax = batch_axes(mesh)
    bshard = _axes(b_ax) if _div(batch, batch_ways(mesh)) else None
    c: Dict[str, Any] = {"length": (bshard,)}
    if cfg.has_attention:
        # sequence-parallel KV over 'model'
        sshard = "model" if (buf_len is None or _div(buf_len, mways)) else None
        c["k"] = (None, bshard, None, sshard, None)
        c["v"] = (None, bshard, None, sshard, None)
        c["kv_pos"] = (bshard, sshard)
    if cfg.has_ssm:
        hshard = "model" if _div(cfg.ssm_heads, mways) else None
        conv_dim = cfg.ssm_inner + 2 * cfg.ssm_state
        c["ssm"] = (None, bshard, hshard, None, None)
        c["conv"] = (None, bshard,
                     "model" if _div(conv_dim, mways) else None, None)
    return c


def _block(shape: Dict[str, int], coords: Dict[str, int],
           axes) -> Tuple[int, int]:
    """(ways, this rank's block) of a dim split over ``axes`` (a name or
    a tuple of names, the first major)."""
    names = (axes,) if isinstance(axes, str) else tuple(axes)
    index = 0
    for a in names:
        index = index * shape[a] + coords[a]
    return math.prod(shape[a] for a in names), index


def _cache_cuts(cfg: ArchConfig, mesh, cache: Dict[str, Any], batch: int,
                buf_len: Optional[int]) -> Dict[str, List[Tuple[int, Any]]]:
    """Per leaf of a slot cache, the (dim, axes) ``cache_specs`` cuts, but
    ``conv``'s over 'model': its channels (dim 2) are the rank's ``[x | B
    | C]`` (``ssm_index``) where 'model' divides the SSM heads, else
    whole."""
    specs = cache_specs(cfg, mesh, batch, buf_len)
    out = {}
    for k in cache:
        out[k] = [(d, ax) for d, ax in enumerate(specs[k]) if ax is not None
                  and not (k == "conv" and ax == "model")]
        if k == "conv" and ssm_split(cfg, mesh.shape["model"]):
            out[k].append((2, "model"))
    return out


def local_cache(cfg: ArchConfig, cache: Dict[str, torch.Tensor],
                mesh) -> Dict[str, torch.Tensor]:
    """This rank's part of a whole slot cache (the counterpart of
    ``jax.device_put(cache, to_shardings(mesh, cache_specs(...)))``): per
    ``cache_specs`` for the cache's batch and ring length, its rows of
    every leaf where 'data' (('pod', 'data')) divides the batch, and its
    slice of the slots of ``k``, ``v`` and ``kv_pos`` where 'model'
    divides the ring, with every KV head; where 'model' divides the SSM
    heads, its heads of ``ssm`` and its ``[x | B | C]`` channels of
    ``conv``. Each leaf an own contiguous tensor: the whole cache can be
    freed after."""
    buf_len = cache["k"].shape[3] if "k" in cache else None
    cuts = _cache_cuts(cfg, mesh, cache, cache["length"].shape[0], buf_len)
    out = {}
    for key, x in cache.items():
        for dim, axes in cuts[key]:
            ways, index = _block(mesh.shape, mesh.coords, axes)
            if key == "conv" and axes == "model":
                x = x.index_select(dim, ssm_index(cfg, ways, index, "conv",
                                                  x.device))
                continue
            n = x.shape[dim] // ways
            x = x.narrow(dim, index * n, n)
        out[key] = x.clone(memory_format=torch.contiguous_format)
    return out


def gather_cache(cfg: ArchConfig, parts: List[Dict[str, torch.Tensor]],
                 shape: Dict[str, int], batch: int,
                 buf_len: Optional[int]) -> Dict[str, torch.Tensor]:
    """The whole slot cache of ``batch`` rows and ``buf_len`` slots from
    every rank's part (``local_cache``'s layout), ``parts`` in rank order
    of a mesh of ``shape`` (ordered axes, 'model' last; a rank's
    coordinates row-major, as ``launch.mesh.make_serving_mesh`` numbers
    them). Where a leaf is not cut over an axis, the first rank's copy
    stands for the others: ``conv``'s channels are the ranks' x channels
    side by side, in rank order, then the first rank's B and C."""
    axes = tuple(shape)
    mesh = types.SimpleNamespace(shape=dict(shape), axis_names=axes)
    coords = [dict(zip(axes, map(int, np.unravel_index(r, tuple(
        shape.values()))))) for r in range(len(parts))]
    cuts = _cache_cuts(cfg, mesh, parts[0], batch, buf_len)
    out = {}
    for key, leaf_cuts in cuts.items():
        grid: Dict[tuple, torch.Tensor] = {}
        for c, part in zip(coords, parts):
            at = tuple(_block(shape, c, axes)[1] for _, axes in leaf_cuts)
            grid.setdefault(at, part[key])

        def build(at: tuple) -> torch.Tensor:
            if len(at) == len(leaf_cuts):
                return grid[at]
            dim, axes = leaf_cuts[len(at)]
            ways = _block(shape, coords[0], axes)[0]
            parts = [build(at + (i,)) for i in range(ways)]
            if key == "conv" and axes == "model":
                n = cfg.ssm_inner // ways
                parts = [p.narrow(dim, 0, n) for p in parts] + [
                    parts[0].narrow(dim, n, 2 * cfg.ssm_state)]
            return torch.cat(parts, dim)

        out[key] = build(())
    return out


def batch_spec(mesh, global_batch: int, ndim: int) -> Spec:
    """[B, ...] activations: batch over ('pod','data') when divisible."""
    b_ax = batch_axes(mesh)
    bshard = _axes(b_ax) if _div(global_batch, batch_ways(mesh)) else None
    return (bshard, *([None] * (ndim - 1)))


def opt_state_specs(param_spec_tree):
    """AdamWState(step, mu, nu): moments shard like params."""
    from repro_torch.training.optimizer import AdamWState
    return AdamWState(step=(), mu=param_spec_tree, nu=param_spec_tree)


# --------------------------------------------------------- serving layout

def attention_split(cfg: ArchConfig, ways: int) -> bool:
    """Whether attention is cut by query heads over ``ways`` ranks: the
    heads divide, and each rank's query heads read whole KV heads (a
    slab of them) or share one."""
    if not cfg.has_attention:
        return False
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    if hq % ways:
        return False
    return hkv % ways == 0 or (hq // hkv) % (hq // ways) == 0


def ssm_split(cfg: ArchConfig, ways: int) -> bool:
    """Whether the SSM mixer is cut by heads over ``ways`` model ranks
    (JAX's ``cache_specs`` ``hshard``): the arch has SSM layers and its
    heads divide."""
    return cfg.has_ssm and cfg.ssm_heads % ways == 0


def ssm_index(cfg: ArchConfig, ways: int, rank: int, leaf: str,
              device=None) -> torch.Tensor:
    """int64 indices of model rank ``rank``'s part (of ``ways``) of the
    SSM heads' dim: for ``leaf`` "in_proj" its output columns ``[z | x |
    B | C | dt]``, the z, x and dt of its heads and the whole B and C (one
    group, read by every head); for "conv" (conv_w, conv_b and the cache's
    conv tail) its channels ``[x | B | C]``."""
    di, N, H = cfg.ssm_inner, cfg.ssm_state, cfg.ssm_heads
    n, h = di // ways, H // ways
    x = torch.arange(rank * n, (rank + 1) * n, device=device)
    bc = torch.arange(di, di + 2 * N, device=device)
    if leaf == "conv":
        return torch.cat([x, bc])
    dt = torch.arange(rank * h, (rank + 1) * h, device=device)
    return torch.cat([x, di + x, di + bc, 2 * di + 2 * N + dt])


def head_slab(cfg: ArchConfig, ways: int, rank: int) -> Tuple[int, int, int]:
    """(query heads, KV heads, first KV head) that model rank ``rank`` of
    ``ways`` holds."""
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    if not attention_split(cfg, ways):
        return hq, hkv, 0
    qn = hq // ways
    if hkv % ways == 0:
        return qn, hkv // ways, rank * (hkv // ways)
    return qn, 1, rank * qn // (hq // hkv)


def serving_cuts(cfg: ArchConfig, ways: int) -> Dict[str, Any]:
    """The serving layout over ``ways`` model ranks: per leaf of
    init_params' tree a Cut, (dim, "model"), (dim, "kv_group") or (dim,
    "ssm_heads"), or None (whole). Over one rank every leaf that can be
    cut is, into one slab."""
    attn = attention_split(cfg, ways)
    kv = None
    if attn:
        kv = (-1, "model") if cfg.n_kv_heads % ways == 0 else (-1, "kv_group")
    mlp = _div(cfg.d_ff, ways)
    vocab = _div(cfg.padded_vocab, ways)
    blk: Dict[str, Cut] = {"ln1": None}
    if cfg.has_attention:
        blk.update(wq=(-1, "model") if attn else None, wk=kv, wv=kv,
                   wo=(-2, "model") if attn else None)
    if cfg.has_ssm:
        blk["ssm"] = dict.fromkeys(SSM.param_shapes(
            cfg.d_model, cfg.ssm_inner, cfg.ssm_state, cfg.ssm_head_dim,
            cfg.ssm_conv))
        if ssm_split(cfg, ways):
            blk["ssm"].update(in_proj=(-1, "ssm_heads"),
                              conv_w=(-2, "ssm_heads"),
                              conv_b=(-1, "ssm_heads"),
                              norm_w=(-1, "model"), out_proj=(-2, "model"))
    if cfg.block_kind == "moe":
        if _div(cfg.n_experts, ways):         # expert-parallel
            wg = wd = (-3, "model")
        else:                                 # inside each expert
            wg, wd = ((-1, "model"), (-2, "model")) if mlp else (None, None)
        blk["moe"] = {"router": None, "wg": wg, "wu": wg, "wd": wd}
        blk["ln2"] = None
    elif cfg.d_ff > 0:
        blk.update(wg=(-1, "model") if mlp else None,
                   wu=(-1, "model") if mlp else None,
                   wd=(-2, "model") if mlp else None, ln2=None)
    out: Dict[str, Any] = {"embed": (0, "model") if vocab else None,
                           "final_norm": None, "blocks": blk}
    if not cfg.tied_embeddings:
        out["lm_head"] = (-1, "model") if vocab else None
    return out


def cut_leaves(cfg: ArchConfig, ways: int) -> frozenset:
    """Names of the leaves cut over ``ways`` model ranks, for
    ``models.partitioning.activation_partitioning``: a top-level or block
    leaf by its name ("wd"), a group's by its path in the group
    ("moe.wd")."""
    def names(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                yield from names(v, prefix if k == "blocks"
                                 else f"{prefix}{k}.")
            elif v is not None:
                yield prefix + k
    return frozenset(names(serving_cuts(cfg, ways), ""))


def cutter(cfg: ArchConfig, mesh) -> Callable[[str, torch.Tensor],
                                              torch.Tensor]:
    """``cut(path, x)``: this rank's slab of the leaf at ``path`` ("embed",
    "blocks.wq", "blocks.ssm.in_proj", ...), from the whole leaf or one
    layer of a stacked one (every cut dim counts from the end but the
    embedding's vocabulary rows), as an own contiguous tensor; a whole
    leaf is returned as is."""
    ways, rank = mesh.shape["model"], mesh.coords["model"]
    cuts = serving_cuts(cfg, ways)
    _, _, kv0 = head_slab(cfg, ways, rank)

    def cut(path: str, x: torch.Tensor) -> torch.Tensor:
        node = cuts
        for part in path.split("."):
            node = node[part]
        if node is None:
            return x
        dim, how = node
        if how == "kv_group":
            hd = cfg.head_dim
            return x.narrow(dim, kv0 * hd, hd).clone(
                memory_format=torch.contiguous_format)
        if how == "ssm_heads":
            leaf = "in_proj" if path.endswith("in_proj") else "conv"
            return x.index_select(dim, ssm_index(cfg, ways, rank, leaf,
                                                 x.device))
        n = x.shape[dim] // ways
        return x.narrow(dim, rank * n, n).clone(
            memory_format=torch.contiguous_format)

    return cut


def local_params(cfg: ArchConfig, params: Dict[str, Any],
                 mesh) -> Dict[str, Any]:
    """This rank's slab of whole parameters (the counterpart of
    ``jax.device_put(params, to_shardings(mesh, param_specs(...)))``, with
    the serving layout above); the whole params can be freed after."""
    cut = cutter(cfg, mesh)

    def walk(node, prefix):
        return {k: walk(v, f"{prefix}{k}.") if isinstance(v, dict)
                else cut(f"{prefix}{k}", v) for k, v in node.items()}

    return walk(params, "")
