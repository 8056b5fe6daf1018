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
- norms are replicated. SSM weights have no serving layout: a mesh
  refuses those archs, as in JAX.

A cut product is a partial sum over 'model' (wo's and wd's rows, an
expert slab's or a d_ff slab's share of the MoE combine) or a slab of
the output (the vocabulary); ``models.partitioning`` puts the whole
together. ``cut_leaves`` names a group's leaves by their path in the
group ("moe.wd"), so a dense MLP's "wd" and an MoE's never meet.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.launch.mesh import batch_axes, batch_ways

Spec = Tuple[Any, ...]
# a serving cut: (dim, how) with how "model" (one of `ways` equal blocks,
# the rank's) or "kv_group" (one KV head, the one the rank's queries read)
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
    init_params' tree (attention archs, dense or MoE: no SSM group) a Cut,
    (dim, "model") or (dim, "kv_group"), or None (whole). Over one rank
    every leaf that can be cut is, into one slab."""
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
    "blocks.wq", ...), from the whole leaf or one layer of a stacked one
    (every cut dim counts from the end but the embedding's vocabulary
    rows), as an own contiguous tensor; a whole leaf is returned as is."""
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
