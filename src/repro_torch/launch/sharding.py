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

The training layout (``train_cuts``, ``local_train_params``,
``gather_train_params``) is what a rank of
``training.trainer.make_train_step(mesh=...)`` holds of the params and
of mu and nu: the serving layout's slab over 'model', then, over
'data', its block of the dim that ``param_specs(train=True)`` cuts there
(FSDP), wherever the slab's length of that dim divides (a whole head's
slab of a dim the spec cuts inside heads may not: that leaf stays whole
over 'data', a departure by leaf). After the backward,
``reduce_train_grads`` sums the gradients of what several ranks hold
copies of, and ``counted_parts`` names what a rank counts in the whole
gradient's norm.
"""
from __future__ import annotations

import math
import types
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.launch.mesh import batch_axes, batch_ways, mesh_coords
from repro_torch.models import ssm as SSM
from repro_torch.models.model import param_shapes

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


def _paths(tree, prefix=""):
    """(dotted path, leaf) pairs of a tree shaped as init_params'."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _paths(v, f"{prefix}{k}.")
        else:
            yield prefix + k, v


def _name(path: str) -> str:
    """A leaf's name from its dotted path: a top-level or block leaf by
    its name, a group's by its path in the group ("moe.wd"), the names
    ``models.partitioning`` reads (``cut_leaves``, ``TrainLayout.fsdp``)."""
    return path.removeprefix("blocks.")


def cut_leaves(cfg: ArchConfig, ways: int) -> frozenset:
    """Names of the leaves cut over ``ways`` model ranks, for
    ``models.partitioning.activation_partitioning``: a top-level or block
    leaf by its name ("wd"), a group's by its path in the group
    ("moe.wd")."""
    return frozenset(_name(path) for path, c in _paths(serving_cuts(cfg, ways))
                     if c is not None)


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
    return _cut_tree(params, cutter(cfg, mesh))


def _cut_tree(params: Dict[str, Any], cut) -> Dict[str, Any]:
    """``params`` with ``cut(path, leaf)`` in place of each leaf."""
    def walk(node, prefix):
        return {k: walk(v, f"{prefix}{k}.") if isinstance(v, dict)
                else cut(f"{prefix}{k}", v) for k, v in node.items()}

    return walk(params, "")


# --------------------------------------------------------- training layout

class TrainCut(NamedTuple):
    """A leaf's cut in the training layout: ``model`` the serving
    layout's Cut over 'model'; ``data`` the dim (counted from the end)
    that ``param_specs(train=True)`` puts over 'data' (FSDP), or None
    where the spec keeps it whole over 'data' or where the rank's model
    slab of that dim does not divide over 'data'."""
    model: Cut
    data: Optional[int]


def _slab_len(cfg: ArchConfig, ways: int, cut: Cut, shape: tuple, dim: int,
              leaf: str) -> int:
    """The length of dim ``dim`` (>= 0) of a leaf of ``shape`` in the rank's
    model slab under ``cut``."""
    if cut is None or cut[0] % len(shape) != dim:
        return shape[dim]
    how = cut[1]
    if how == "kv_group":
        return cfg.head_dim
    if how == "ssm_heads":
        return len(ssm_index(cfg, ways, 0, leaf, "meta"))
    return shape[dim] // ways


def train_cuts(cfg: ArchConfig, mesh) -> Dict[str, Any]:
    """The training layout over ``mesh``: per leaf of init_params' tree a
    ``TrainCut``. Over 'model' it is the serving layout (whole heads, the
    kv_group layout, the SSM by heads with B and C whole, the MoE's
    expert-parallel or in-expert cut); over 'data' the dim that
    ``param_specs(train=True)`` (``fs()``) cuts, wherever the rank's
    slab of it divides. mu and nu follow the params
    (``opt_state_specs``)."""
    ways, dways = mesh.shape["model"], mesh.shape["data"]

    def walk(cuts, specs, shapes):
        out = {}
        for k, c in cuts.items():
            if isinstance(c, dict):
                out[k] = walk(c, specs[k], shapes[k])
                continue
            spec, shape = specs[k], shapes[k]
            d = spec.index("data") if "data" in spec else None
            if d is not None:
                leaf = "in_proj" if k == "in_proj" else "conv"
                if _slab_len(cfg, ways, c, shape, d, leaf) % dways:
                    d = None
            out[k] = TrainCut(c, None if d is None else d - len(shape))
        return out

    return walk(serving_cuts(cfg, ways), param_specs(cfg, mesh, train=True),
                param_shapes(cfg))


class TrainLayout(NamedTuple):
    """What a training step over a mesh reads of the layout, made once for
    the mesh (``train_layout``): ``cuts`` each leaf's ``TrainCut`` by its
    dotted path; ``model`` the leaves cut over 'model' (``cut_leaves``);
    ``fsdp`` those cut over 'data', by name, each with its dim (from the
    end): the maps ``models.partitioning.activation_partitioning``
    takes."""
    cuts: Dict[str, TrainCut]
    model: frozenset
    fsdp: Dict[str, int]


def train_layout(cfg: ArchConfig, mesh) -> TrainLayout:
    """The training layout over ``mesh``, as a step reads it."""
    cuts = dict(_paths(train_cuts(cfg, mesh)))
    return TrainLayout(cuts, cut_leaves(cfg, mesh.shape["model"]),
                       {_name(p): tc.data for p, tc in cuts.items()
                        if tc.data is not None})


def train_cutter(cfg: ArchConfig, mesh) -> Callable[[str, torch.Tensor],
                                                    torch.Tensor]:
    """``cut(path, x)``: this rank's shard of the leaf at ``path`` in the
    training layout, from the whole leaf or one layer of a stacked one:
    its model slab (``cutter``), then its block of the 'data' dim, as an
    own contiguous tensor."""
    model_cut = cutter(cfg, mesh)
    cuts = train_layout(cfg, mesh).cuts
    dways, index = mesh.shape["data"], mesh.coords["data"]

    def cut(path: str, x: torch.Tensor) -> torch.Tensor:
        x = model_cut(path, x)
        d = cuts[path].data
        if d is None:
            return x
        n = x.shape[d] // dways
        return x.narrow(d, index * n, n).clone(
            memory_format=torch.contiguous_format)

    return cut


def local_train_params(cfg: ArchConfig, params: Dict[str, Any],
                       mesh) -> Dict[str, Any]:
    """This rank's shards of whole parameters in the training layout (the
    counterpart of ``jax.device_put(params, to_shardings(mesh,
    param_specs(cfg, mesh, train=True)))``); the whole params can be
    freed after. The same cut takes whole AdamW moments to the rank's."""
    return _cut_tree(params, train_cutter(cfg, mesh))


def train_gatherer(cfg: ArchConfig, shape: Dict[str, int]
                   ) -> Callable[[str, List[torch.Tensor]], torch.Tensor]:
    """``leaf(path, shards)``: the whole leaf at ``path`` (of the params,
    or of a moment or gradient) from every rank's shard of it in the
    training layout, ``shards`` in rank order of a mesh of ``shape``.
    Where a leaf is not cut over an axis, the first rank's copy stands
    for the others: pod 0's, a KV head from the first rank holding it,
    the SSM's B and C columns and channels from model rank 0."""
    mesh = types.SimpleNamespace(shape=dict(shape), axis_names=tuple(shape))
    cuts = train_layout(cfg, mesh).cuts
    coords = [mesh_coords(shape, r)
              for r in range(math.prod(shape.values()))]
    ways = shape["model"]
    kv0 = [head_slab(cfg, ways, m)[2] for m in range(ways)]
    di, N = cfg.ssm_inner, cfg.ssm_state
    n, h = di // max(ways, 1), cfg.ssm_heads // max(ways, 1)
    # per model rank, pod 0's ranks (row-major: in data order)
    first = [[r for r, c in enumerate(coords)
              if c["model"] == m and c.get("pod", 0) == 0]
             for m in range(ways)]

    def leaf(path: str, shards: List[torch.Tensor]) -> torch.Tensor:
        model_cut, d = cuts[path]
        slabs = [shards[rs[0]] if d is None else
                 torch.cat([shards[r] for r in rs], d) for rs in first]
        if model_cut is None:
            return slabs[0]
        dim, how = model_cut
        if how == "model":
            return torch.cat(slabs, dim)
        if how == "kv_group":
            return torch.cat([slabs[kv0.index(j)]
                              for j in range(cfg.n_kv_heads)], dim)
        if path.endswith("in_proj"):      # [z | x | B | C | dt] a rank
            pieces = ([s.narrow(dim, 0, n) for s in slabs]
                      + [s.narrow(dim, n, n) for s in slabs]
                      + [slabs[0].narrow(dim, 2 * n, 2 * N)]
                      + [s.narrow(dim, 2 * n + 2 * N, h) for s in slabs])
        else:                             # [x | B | C] a rank
            pieces = ([s.narrow(dim, 0, n) for s in slabs]
                      + [slabs[0].narrow(dim, n, 2 * N)])
        return torch.cat(pieces, dim)

    return leaf


def gather_train_params(cfg: ArchConfig, parts: List[Dict[str, Any]],
                        shape: Dict[str, int]) -> Dict[str, Any]:
    """Whole parameters (or moments, or gradients) from every rank's
    shards in the training layout, ``parts`` in rank order of a mesh of
    ``shape`` (``train_gatherer`` leaf by leaf)."""
    leaf = train_gatherer(cfg, shape)
    flat = [dict(_paths(p)) for p in parts]
    return _cut_tree(parts[0], lambda path, _: leaf(
        path, [f[path] for f in flat]))


def _model_shared(cfg: ArchConfig, path: str, tc: TrainCut, ways: int):
    """What of a leaf's rank copy other model ranks hold too, and so gets
    only a part of its gradient on each: "all" (a_log, d_skip and dt_bias,
    whole on every rank, of which the SSM cut by heads reads the rank's
    heads), "kv_group" (the KV head the rank's queries share with other
    ranks'), "ssm_bc" (B and C, read by every head) or None."""
    if tc.model is None:
        return ("all" if path.split(".")[-1] in ("a_log", "d_skip", "dt_bias")
                and ssm_split(cfg, ways) else None)
    return {"kv_group": "kv_group", "ssm_heads": "ssm_bc"}.get(tc.model[1])


def _bc_at(cfg: ArchConfig, path: str, ways: int) -> int:
    """Where the B and C columns (in_proj's ``[z | x | B | C | dt]``) or
    channels (the conv's ``[x | B | C]``) start in a rank's SSM slab;
    2 * ssm_state of them."""
    n = cfg.ssm_inner // ways
    return 2 * n if path.endswith("in_proj") else n


def reduce_train_grads(cfg: ArchConfig, mesh, layout: TrainLayout,
                       grads: Dict[str, Any]) -> None:
    """Complete a rank's gradients in place, after the backward of a step
    on its shards (``models.partitioning``, the collectives through it):
    the parts other model ranks hold too (``_model_shared``) summed over
    'model', the ranks sharing a KV head over a zero-filled buffer of
    every KV head; the leaves whole over 'data' summed over the data
    groups (the shards over 'data' were summed by FSDP's backward, and
    on a mesh with 'pod' are summed over the pods here)."""
    from repro_torch.models import partitioning as P
    ways = mesh.shape["model"]
    rank = mesh.coords["model"]
    cuts = layout.cuts
    _, _, kv0 = head_slab(cfg, ways, rank)
    hd = cfg.head_dim
    model, kv, data, pod = [], [], [], []
    for path, g in _paths(grads):
        tc = cuts[path]
        shared = _model_shared(cfg, path, tc, ways)
        if shared == "all":
            model.append(g)
        elif shared == "ssm_bc":
            model.append(g.narrow(tc.model[0], _bc_at(cfg, path, ways),
                                  2 * cfg.ssm_state))
        elif shared == "kv_group":
            dim = tc.model[0]
            shape = list(g.shape)
            shape[dim] = cfg.n_kv_heads * hd
            full = g.new_zeros(shape)
            full.narrow(dim, kv0 * hd, hd).copy_(g)
            kv.append((g, full, dim))
            model.append(full)
        (data if tc.data is None else pod).append(g)
    if ways > 1:
        P.sum_grads(model, "model")
        for g, full, dim in kv:
            g.copy_(full.narrow(dim, kv0 * hd, hd))
    if P.data_ways() > 1:
        P.sum_grads(data, "data")
    if "pod" in mesh.shape and mesh.shape["pod"] > 1:
        P.sum_grads(pod, "pod")


def counted_parts(cfg: ArchConfig, mesh, layout: TrainLayout,
                  grads: Dict[str, Any]) -> List[torch.Tensor]:
    """The parts of a rank's (completed) gradients that it counts in the
    whole gradient's norm: every block of every leaf once over the mesh,
    however many ranks hold a copy (a leaf whole over 'data' on the first
    data group, whole over 'model' on model rank 0, a shared KV head on
    the first rank holding it, the SSM's B and C on model rank 0)."""
    ways, rank = mesh.shape["model"], mesh.coords["model"]
    cuts = layout.cuts
    first_data = all(mesh.coords.get(a, 0) == 0 for a in ("pod", "data"))
    first_pod = mesh.coords.get("pod", 0) == 0
    kv0 = [head_slab(cfg, ways, m)[2] for m in range(ways)]
    out = []
    for path, g in _paths(grads):
        tc = cuts[path]
        if not (first_data if tc.data is None else first_pod):
            continue
        if tc.model is None:
            if rank == 0:
                out.append(g)
        elif tc.model[1] == "kv_group":
            if rank == 0 or kv0[rank] != kv0[rank - 1]:
                out.append(g)
        elif tc.model[1] == "ssm_heads" and rank > 0:
            dim, at = tc.model[0], _bc_at(cfg, path, ways)
            end = at + 2 * cfg.ssm_state
            out += [g.narrow(dim, 0, at),
                    g.narrow(dim, end, g.shape[dim] - end)]
        else:
            out.append(g)
    return out
