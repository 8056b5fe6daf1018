"""The unified model in PyTorch — dense GQA, MoE, Mamba2-SSD, hybrid
(parallel attention + SSM) and encoder-only — the port of
``repro.models.model``.

Parameters are a plain dict of tensors with the JAX pytree's names and
layouts — ``x @ W`` with ``W [D, out]``, per-layer weights stacked over a
leading layer axis, the JAX ``SSMParams``/``MoEParams`` NamedTuples as
dicts under ``blocks["ssm"]``/``blocks["moe"]`` — so ``load_params`` can
take the JAX package's own ``init_params`` output (as numpy) and both
packages compute on the same weights. Attention, the SSD scan and decode
step and the grouped-expert FFN go through ``kernels.ops``: the
hand-written CUDA kernels on the card, their plain versions on the CPU.
The training forward is the exception: it computes the JAX training
path's own math (dense or chunked attention, ``ssd_chunked``, the grouped
MoE's einsums) in plain torch, which autograd differentiates; no kernel
has a backward, and ``kernels.ops`` refuses to run one under autograd.

Entry points:
  forward(params, inputs, opts)             -> (logits, aux)  (train/encode)
  loss_fn(params, inputs, labels, opts)     -> loss
  prefill(params, inputs, buf_len)          -> (last_logits, cache)
  prefill_chunk(params, cache, tokens)      -> (last_logits, cache)
  decode_step(params, cache, tokens, active) -> (logits, cache)
  prefill_chunk_paged(params, pages, ...)   -> (last_logits, pages)
  decode_step_paged(params, pages, ...)     -> (logits, pages)
  verify_step_paged(params, pages, ...)     -> (logits [B,C,V], pages)

``forward`` and ``loss_fn`` take every arch, encoder-only included (its
inputs, like a VLM's, may be [B,S,D] embeddings). ``prefill``,
``decode_step`` and ``decode_step_paged`` serve every causal arch
(attention layers on the slot cache's ring or the paged KV arena, SSM
layers on the slot cache's recurrent state or the constant-size state
arena of ``init_state_arena``, hybrids both, DESIGN.md §12); the chunk
and verify steps serve attention-only archs, dense or MoE.

Tensor parallelism (DESIGN.md §9): the serving entry points compute on a
rank's slab of the weights (``launch.sharding.local_params``) and KV
arena, taking their head counts and widths from the weights' shapes, and
meet the other ranks at ``models.partitioning``'s collectives: a sum after
each row-parallel product (wo, wd), the vocabulary-sharded embedding
lookup and the gather of the vocabulary-sharded logits. Without an
installed context and on whole weights they are the single-device
functions.

Unlike the functional JAX code, every serving step writes the new K/V
(and ``kv_pos``/``length``, or the recurrent state) into the slot cache, the
page arena or the state arena in place: these are the engine's largest
buffers, and a view of some rows of the slot cache (``cache[k][:, s:s+1]``)
is updated through to the whole.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import partitioning as P
from repro_torch.models import ssm as SSM

Params = Dict[str, Any]
Cache = Dict[str, torch.Tensor]


def resolve_device(device) -> torch.device:
    """torch.device for ``device``; raises when CUDA is asked for and this
    process has none (the port never carries on on the CPU instead)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not "
                           "available; pass device='cpu' to run the plain "
                           "versions on the CPU")
    return dev


def _check_causal(cfg: ArchConfig) -> None:
    """The serving entry points' gate: encoder-only archs train and encode
    through ``forward`` but have no prefill or decode (DESIGN.md §4)."""
    if not (cfg.causal and (cfg.has_attention or cfg.has_ssm)):
        raise NotImplementedError(
            f"{cfg.name}: the serving entry points take causal decoders "
            "with attention and/or SSM layers; encoder-only archs have no "
            "prefill or decode (DESIGN.md §4), only forward")


def _check_kv_only(cfg: ArchConfig, what: str) -> None:
    """The chunk and verify steps carry per-token K/V only."""
    _check_causal(cfg)
    if cfg.has_ssm or not cfg.has_attention:
        raise NotImplementedError(
            f"{cfg.name}: {what} serves attention-only archs (dense or MoE); "
            "SSM and hybrid archs serve through prefill and "
            "decode_step_paged (DESIGN.md §12, ROADMAP.md)")


# ------------------------------------------------------------------ init

def param_shapes(cfg: ArchConfig) -> Params:
    """Shape of every parameter, nested as in the JAX pytree."""
    D, Lh, f = cfg.d_model, cfg.n_layers, cfg.d_ff
    shapes: Params = {"embed": (cfg.padded_vocab, D), "final_norm": (D,)}
    if not cfg.tied_embeddings:
        shapes["lm_head"] = (D, cfg.padded_vocab)
    blk: Params = {"ln1": (Lh, D)}
    if cfg.has_attention:
        blk.update(wq=(Lh, D, cfg.q_dim), wk=(Lh, D, cfg.kv_dim),
                   wv=(Lh, D, cfg.kv_dim), wo=(Lh, cfg.q_dim, D))
    if cfg.has_ssm:
        blk["ssm"] = {k: (Lh, *v) for k, v in SSM.param_shapes(
            D, cfg.ssm_inner, cfg.ssm_state, cfg.ssm_head_dim,
            cfg.ssm_conv).items()}
    if cfg.block_kind == "moe":
        blk["moe"] = {k: (Lh, *v) for k, v in
                      MOE.param_shapes(D, f, cfg.n_experts).items()}
        blk["ln2"] = (Lh, D)
    elif f > 0:
        blk.update(wg=(Lh, D, f), wu=(Lh, D, f), wd=(Lh, f, D), ln2=(Lh, D))
    shapes["blocks"] = blk
    return shapes


def _init_rule(cfg: ArchConfig, group: str, name: str):
    """How the JAX init fills one parameter: ("zeros"|"ones"|"a_log", None)
    or ("normal", scale)."""
    D = cfg.d_model
    if name in ("final_norm", "ln1", "ln2", "conv_b", "norm_w"):
        return "zeros", None
    if group == "ssm":
        return {"in_proj": ("normal", D ** -0.5),
                "conv_w": ("normal", cfg.ssm_conv ** -0.5),
                "a_log": ("a_log", None), "d_skip": ("ones", None),
                "dt_bias": ("normal", 0.1),
                "out_proj": ("normal", cfg.ssm_inner ** -0.5)}[name]
    if name == "wo":
        return "normal", cfg.q_dim ** -0.5
    if name == "wd":
        return "normal", cfg.d_ff ** -0.5
    return "normal", D ** -0.5


def init_params(cfg: ArchConfig, seed: int = 0, dtype=torch.float32,
                device="cuda", cut=None) -> Params:
    """Random weights with the JAX init's shapes and scales (normal *
    D^-0.5; wo by q_dim^-0.5, wd by d_ff^-0.5; norms zero; the SSM and MoE
    groups as ``init_ssm_params``/``init_moe_params`` draw them), from a
    torch.Generator seeded with ``seed`` on ``device``. Stacked weights are
    drawn one layer at a time, so the fp32 draw never holds more than one
    layer's matrix beside the result. ``cut(path, x)`` (``launch.sharding.
    cutter``) keeps a slab of each drawn leaf or layer: a tensor-parallel
    rank draws what every rank draws and keeps only its slab."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def draw(shape, s):
        return (torch.randn(shape, generator=gen, device=dev) * s).to(dtype)

    def fill(group, name, shape, path):
        kind, s = _init_rule(cfg, group, name)
        keep = (lambda x: x) if cut is None else (lambda x: cut(path, x))
        if kind == "zeros":
            return keep(torch.zeros(shape, dtype=dtype, device=dev))
        if kind == "ones":
            return keep(torch.ones(shape, dtype=dtype, device=dev))
        if kind == "a_log":
            row = torch.log(torch.linspace(1.0, 16.0, shape[-1], device=dev))
            return keep(row.expand(shape).to(dtype).contiguous())
        if len(shape) == 2 and group is None:
            return keep(draw(shape, s))
        first = keep(draw(shape[1:], s))
        out = torch.empty((shape[0], *first.shape), dtype=dtype, device=dev)
        out[0] = first
        for layer in range(1, shape[0]):
            out[layer] = keep(draw(shape[1:], s))
        return out

    shapes = param_shapes(cfg)
    p: Params = {k: fill(None, k, v, k) for k, v in shapes.items()
                 if k != "blocks"}
    p["blocks"] = {}
    for k, v in shapes["blocks"].items():
        if isinstance(v, dict):
            p["blocks"][k] = {kk: fill(k, kk, vv, f"blocks.{k}.{kk}")
                              for kk, vv in v.items()}
        else:
            p["blocks"][k] = fill("blocks", k, v, f"blocks.{k}")
    return p


def load_params(cfg: ArchConfig, tree: Params, device="cuda") -> Params:
    """The weight bridge: a JAX ``init_params`` pytree (arrays or numpy;
    ``SSMParams``/``MoEParams`` NamedTuples or dicts) -> the port's
    parameter dict on ``device``, with every shape checked and each
    array's type kept (bf16 stays bf16)."""
    dev = resolve_device(device)

    def conv(name, arr, shape):
        a = np.asarray(arr)
        to = None
        if a.dtype.name == "bfloat16":     # numpy has no bf16 of its own
            a, to = a.astype(np.float32), torch.bfloat16
        if tuple(a.shape) != tuple(shape):
            raise ValueError(f"param {name}: shape {a.shape} != {shape}")
        return torch.from_numpy(np.array(a)).to(dev, to)   # own, writable copy

    def as_dict(node):
        return node._asdict() if hasattr(node, "_asdict") else node

    def load(prefix, node, shapes):
        node = as_dict(node)
        missing = sorted(f"{prefix}{k}" for k in set(shapes) - set(node))
        if missing:
            raise KeyError(f"params missing {missing}")
        out = {}
        for k, s in shapes.items():
            if isinstance(s, dict):
                out[k] = load(f"{prefix}{k}.", node[k], s)
            else:
                out[k] = conv(f"{prefix}{k}", node[k], s)
        return out

    shapes = param_shapes(cfg)
    blocks = shapes.pop("blocks")
    p = load("", {k: v for k, v in tree.items() if k != "blocks"}, shapes)
    if "blocks" not in tree:
        raise KeyError("params missing ['blocks']")
    p["blocks"] = load("blocks.", tree["blocks"], blocks)
    return p


def init_cache(cfg: ArchConfig, batch: int, buf_len: int,
               dtype=torch.float32, device="cuda") -> Cache:
    """Empty slot cache: length [batch] = 0; for attention layers k/v
    [L,batch,Hkv,buf_len,hd] (ring of buf_len slots) and kv_pos
    [batch,buf_len] = -1; for SSM layers ssm [L,batch,H,P,N] (f32: the
    recurrence accumulates in f32) and conv [L,batch,C,K-1] in ``dtype``,
    zero."""
    _check_causal(cfg)
    dev = resolve_device(device)
    c: Cache = {"length": torch.zeros((batch,), dtype=torch.int32,
                                      device=dev)}
    if cfg.has_attention:
        shape = (cfg.n_layers, batch, cfg.n_kv_heads, buf_len, cfg.head_dim)
        c["k"] = torch.zeros(shape, dtype=dtype, device=dev)
        c["v"] = torch.zeros(shape, dtype=dtype, device=dev)
        c["kv_pos"] = torch.full((batch, buf_len), -1, dtype=torch.int32,
                                 device=dev)
    if cfg.has_ssm:
        c["ssm"] = torch.zeros((cfg.n_layers, batch, cfg.ssm_heads,
                                cfg.ssm_head_dim, cfg.ssm_state),
                               dtype=torch.float32, device=dev)
        c["conv"] = torch.zeros((cfg.n_layers, batch,
                                 cfg.ssm_inner + 2 * cfg.ssm_state,
                                 cfg.ssm_conv - 1), dtype=dtype, device=dev)
    return c


# slot-cache fields laid out layer-major ([L, batch, ...]); the others are
# [batch, ...]
LAYER_FIELDS = ("k", "v", "ssm", "conv")


def cache_window(cfg: ArchConfig, buf_len: int) -> Optional[int]:
    """The sliding window a slot cache of buf_len slots attends under: the
    arch's window when the ring is no longer than it, else none."""
    if cfg.sliding_window and buf_len <= cfg.sliding_window:
        return cfg.sliding_window
    return None


def init_paged_cache(cfg: ArchConfig, n_pages: int, page_size: int,
                     dtype=torch.float32, device="cuda",
                     kv_heads: Optional[int] = None) -> Cache:
    """Shared KV page arena: k/v_pages [L, n_pages + 1, Hkv, page_size,
    hd]. Pages 0..n_pages-1 are the pool's; page n_pages is the spare
    (``spare_page``), which no page table names: the decode and verify
    steps send the K/V of rows that must not write there, where JAX drops
    them through the same out-of-bounds index, so every row writes and no
    step syncs with the host. Attention-free (pure SSM) archs get a
    zero-width arena (Hkv = hd = 0): the page table stays the logical
    token-length ledger of every arch (DESIGN.md §12) but the pages hold
    no bytes. ``kv_heads``: the heads a tensor-parallel rank's slab holds
    (``launch.sharding.head_slab``), all of them by default."""
    _check_causal(cfg)
    dev = resolve_device(device)
    hkv = (kv_heads or cfg.n_kv_heads) if cfg.has_attention else 0
    hd = cfg.head_dim if cfg.has_attention else 0
    shape = (cfg.n_layers, n_pages + 1, hkv, page_size, hd)
    return {"k_pages": torch.zeros(shape, dtype=dtype, device=dev),
            "v_pages": torch.zeros(shape, dtype=dtype, device=dev)}


def init_state_arena(cfg: ArchConfig, n_slots: int, dtype=torch.float32,
                     device="cuda") -> Cache:
    """Constant-size recurrent-state arena (DESIGN.md §12): per layer one
    [H, P, N] SSD state per slot (f32: the recurrence accumulates in f32)
    and one [C, K-1] conv tail per slot in ``dtype``, for n_slots + 1
    slots: slot n_slots is the spare, which no row owns and the decode
    step's rows that must not write send their conv tail to. Slot
    ownership lives in serving.state_store.SSMStateStore."""
    if not cfg.has_ssm:
        raise ValueError(f"{cfg.name}: a state arena needs SSM layers")
    dev = resolve_device(device)
    return {
        "ssm_state": torch.zeros((cfg.n_layers, n_slots + 1, cfg.ssm_heads,
                                  cfg.ssm_head_dim, cfg.ssm_state),
                                 dtype=torch.float32, device=dev),
        "conv_state": torch.zeros((cfg.n_layers, n_slots + 1,
                                   cfg.ssm_inner + 2 * cfg.ssm_state,
                                   cfg.ssm_conv - 1), dtype=dtype,
                                  device=dev),
    }


def spare_page(pages: Cache) -> int:
    """Index of the KV arena's spare page (its last; ``init_paged_cache``)."""
    return pages["k_pages"].shape[1] - 1


def spare_slot(pages: Cache) -> int:
    """Index of the state arena's spare slot (its last;
    ``init_state_arena``)."""
    return pages["conv_state"].shape[1] - 1


# ------------------------------------------------------------------ blocks

def embed_inputs(cfg: ArchConfig, params: Params,
                 inputs: torch.Tensor) -> torch.Tensor:
    """Token ids [B,S] -> embeddings [B,S,D]; embedding-input archs
    (audio frames, vision patches) pass [B,S,D] through. A rank's
    vocabulary slab of the table looks up through
    ``partitioning.embed_model``."""
    if inputs.ndim == 3:
        return inputs
    if P.cut("embed"):
        return P.embed_model(params["embed"], inputs)
    return params["embed"][inputs.long()]


def unembed(cfg: ArchConfig, params: Params, x: torch.Tensor,
            keep_padded: bool = False) -> torch.Tensor:
    """Final norm and projection to the vocabulary. ``keep_padded``
    returns all padded_vocab lanes, the pad lanes biased by -1e30 (the
    loss path, as in JAX); otherwise the pad lanes are sliced off. A
    rank's vocabulary slab of the head gives a slab of the logits, which
    ``partitioning.gather_model`` puts together."""
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    head = params["embed"].T if cfg.tied_embeddings else params["lm_head"]
    logits = x @ head
    Vp, V = cfg.padded_vocab, cfg.vocab_size
    if P.cut("embed" if cfg.tied_embeddings else "lm_head"):
        logits = P.gather_model(logits, -1)
    if Vp == V:
        return logits
    if not keep_padded:
        return logits[..., :V]
    lane = torch.arange(Vp, device=logits.device)
    bias = torch.where(lane >= V, -1e30, 0.0).to(logits.dtype)
    return logits + bias


def _ffn(cfg: ArchConfig, blk: Params, layer: int,
         x: torch.Tensor) -> torch.Tensor:
    """Post-mixer FFN (residual applied by the caller). MoE blocks dispatch
    as the JAX model's default ``moe_impl="grouped"``: a sequence of T > 1
    tokens a row through ``moe_ffn_grouped`` (per-example capacity, drops),
    one token a row through the lossless ``moe_ffn_grouped_decode``. A
    rank's slab of the experts, or of their d_ff columns, gives a partial
    sum, summed over the model axis after the combine."""
    if cfg.block_kind == "moe":
        h = L.rms_norm(x, blk["ln2"][layer], cfg.norm_eps)
        mp = {k: v[layer] for k, v in blk["moe"].items()}
        # an expert-parallel slab: E_local of the E experts, the rank's
        first = P.model_index() * mp["wg"].shape[0] if (
            mp["wg"].shape[0] < cfg.n_experts) else 0
        if h.ndim == 3 and h.shape[1] > 1:
            y = MOE.moe_ffn_grouped(mp, h, cfg.top_k, first_expert=first)[0]
        else:
            y = MOE.moe_ffn_grouped_decode(mp, h, cfg.top_k,
                                           first_expert=first)[0]
        return P.reduce_model(y) if P.cut("moe.wd") else y
    if cfg.d_ff <= 0:
        return torch.zeros_like(x)
    h = L.rms_norm(x, blk["ln2"][layer], cfg.norm_eps)
    return L.gated_mlp(h, blk["wg"][layer], blk["wu"][layer],
                       blk["wd"][layer], partial=P.cut("wd"))


def _proj_qkv(cfg: ArchConfig, blk: Params, layer: int, h: torch.Tensor):
    """Input projections of one layer from the normed input, heads split:
    h [..., D] -> q [..., Hq, hd], k/v [..., Hkv, hd], the head counts
    those of the weights (a tensor-parallel rank's slab)."""
    lead = h.shape[:-1]
    q = (h @ blk["wq"][layer]).reshape(*lead, -1, cfg.head_dim)
    k = (h @ blk["wk"][layer]).reshape(*lead, -1, cfg.head_dim)
    v = (h @ blk["wv"][layer]).reshape(*lead, -1, cfg.head_dim)
    return q, k, v


def _attn_out(cfg: ArchConfig, blk: Params, layer: int,
              a: torch.Tensor) -> torch.Tensor:
    """Attention output [..., H, hd] through wo: a slab of the heads (a
    tensor-parallel rank's rows of wo) gives a partial sum, summed over
    the model axis."""
    y = a.reshape(*a.shape[:-2], -1) @ blk["wo"][layer]
    return P.reduce_model(y) if P.cut("wo") else y


def _qkv(cfg: ArchConfig, blk: Params, layer: int, x: torch.Tensor):
    """Normed input projections of one layer: x [..., D] -> q, k, v."""
    return _proj_qkv(cfg, blk, layer,
                     L.rms_norm(x, blk["ln1"][layer], cfg.norm_eps))


def _ssm_params(blk: Params, layer: int) -> SSM.SSMParams:
    return {k: v[layer] for k, v in blk["ssm"].items()}


def _mix(parts: List[torch.Tensor]) -> torch.Tensor:
    """The block's mixer output: attention's or the SSM's, or their mean
    for hybrid blocks (the JAX model's 0.5 * (attn + ssm))."""
    return parts[0] if len(parts) == 1 else 0.5 * (parts[0] + parts[1])


def detached(params: Params) -> Params:
    """``params`` with every tensor detached from autograd (the same
    storage): what the engines serve, so that weights fresh from a
    training step never reach a kernel wrapper as tensors that require
    grad."""
    return {k: detached(v) if isinstance(v, dict) else v.detach()
            for k, v in params.items()}


# ------------------------------------------------------------------ forward

@dataclasses.dataclass(frozen=True)
class ModelOptions:
    """How ``forward`` computes, as the JAX package's ModelOptions.

    attn_impl: auto | dense | chunked (``resolve_attn``). moe_impl:
    grouped | grouped_kernel | sorted | dense; a sequence takes the grouped
    einsums under both grouped names, and only a one-token-a-row forward
    with grouped_kernel reaches the grouped-expert kernel, as in JAX.
    remat: recompute each layer in the backward
    (``torch.utils.checkpoint``, non-reentrant), as ``jax.checkpoint``
    over the layer scan. use_ssd_kernel: the SSD core through
    ``ops.ssd_scan`` (forward only). train_window: caps the attention
    window. unroll: kept for parity; in JAX it unrolls the layer scan for
    cost analysis, and the port's layers are a Python loop already, so it
    has no effect."""
    attn_impl: str = "auto"
    moe_impl: str = "grouped"
    remat: bool = False
    use_ssd_kernel: bool = False
    train_window: Optional[int] = None
    unroll: bool = False

    def resolve_attn(self, seq_len: int) -> str:
        if self.attn_impl != "auto":
            return self.attn_impl
        return "chunked" if seq_len > 2048 else "dense"


def _layers(node):
    """The stacked [L, ...] block weights as one dict a layer, the views
    taken by one ``unbind`` a leaf, so the backward stacks each leaf's
    gradient once (indexing layer by layer would add a full-size gradient
    a layer)."""
    if not isinstance(node, dict):
        return node.unbind(0)
    parts = {k: _layers(v) for k, v in node.items()}
    n = len(next(iter(parts.values())))
    return [{k: v[i] for k, v in parts.items()} for i in range(n)]


def _ffn_seq(cfg: ArchConfig, lp: Params, x: torch.Tensor,
             moe_impl: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward's post-mixer FFN over one layer's weights ``lp``
    (residual applied by the caller): (out, aux), JAX's ``_ffn``."""
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.block_kind == "moe":
        h = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
        grouped = moe_impl in ("grouped", "grouped_kernel")
        if grouped and h.ndim == 3 and h.shape[1] > 1:
            return MOE.moe_ffn_grouped(lp["moe"], h, cfg.top_k,
                                       use_kernel=False)
        if grouped:
            return MOE.moe_ffn_grouped_decode(
                lp["moe"], h, cfg.top_k,
                use_kernel=moe_impl == "grouped_kernel")
        if moe_impl == "dense":
            return MOE.moe_ffn_dense(lp["moe"], h, cfg.top_k)
        return MOE.moe_ffn(lp["moe"], h, cfg.top_k)
    if cfg.d_ff > 0:
        h = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
        return L.gated_mlp(h, lp["wg"], lp["wu"], lp["wd"]), zero
    return torch.zeros_like(x), zero


def _block_seq(cfg: ArchConfig, lp: Params, x: torch.Tensor,
               positions: torch.Tensor, impl: str, window: Optional[int],
               opts: ModelOptions) -> Tuple[torch.Tensor, torch.Tensor]:
    """One layer over a full sequence: (x, aux), JAX's ``_block_seq``
    without the cache."""
    B, S, _ = x.shape
    h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
    parts = []
    if cfg.has_attention:
        q = (h @ lp["wq"]).reshape(B, S, cfg.n_heads, cfg.head_dim)
        k = (h @ lp["wk"]).reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
        v = (h @ lp["wv"]).reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
        q = L.apply_rope(q, positions, cfg.rope_theta)
        k = L.apply_rope(k, positions, cfg.rope_theta)
        if impl == "dense":
            mask = L.band_mask(positions, positions, cfg.causal, window)
            a = L.attention(q, k, v, mask)
        else:
            a = L.chunked_attention(q, k, v, positions, positions,
                                    causal=cfg.causal, window=window)
        parts.append(a.reshape(B, S, cfg.q_dim) @ lp["wo"])
    if cfg.has_ssm:
        parts.append(SSM.ssm_mixer(lp["ssm"], h, cfg.ssm_inner,
                                   cfg.ssm_state, cfg.ssm_head_dim,
                                   use_kernel=opts.use_ssd_kernel))
    x = x + _mix(parts)
    f_out, aux = _ffn_seq(cfg, lp, x, opts.moe_impl)
    return x + f_out, aux


def forward(cfg: ArchConfig, params: Params, inputs: torch.Tensor,
            opts: ModelOptions = ModelOptions(),
            keep_padded: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward (training, encoding), any arch. inputs: token
    ids [B,S], or [B,S,D] embeddings for embedding-input archs. Returns
    (logits [B,S,V] — padded_vocab lanes with ``keep_padded`` — and the
    MoE load-balance loss averaged over layers, f32). The window is
    ``opts.train_window``, else the arch's sliding window when it is
    shorter than S."""
    x = embed_inputs(cfg, params, inputs)
    S = x.shape[1]
    positions = torch.arange(S, device=x.device)
    impl = opts.resolve_attn(S)
    window = opts.train_window or (
        cfg.sliding_window if (cfg.sliding_window and cfg.sliding_window < S)
        else None)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = opts.remat and torch.is_grad_enabled()
    for lp in _layers(params["blocks"]):
        if remat:
            x, a = torch.utils.checkpoint.checkpoint(
                _block_seq, cfg, lp, x, positions, impl, window, opts,
                use_reentrant=False)
        else:
            x, a = _block_seq(cfg, lp, x, positions, impl, window, opts)
        aux = aux + a
    return unembed(cfg, params, x, keep_padded=keep_padded), aux / cfg.n_layers


def loss_fn(cfg: ArchConfig, params: Params, inputs: torch.Tensor,
            labels: torch.Tensor, opts: ModelOptions = ModelOptions(),
            aux_weight: float = 0.01) -> torch.Tensor:
    """Next-token (causal) or per-frame (encoder) cross-entropy in f32,
    over the labels >= 0 (negative labels are ignored), plus
    ``aux_weight`` times the MoE load-balance loss: JAX's ``loss_fn``."""
    logits, aux = forward(cfg, params, inputs, opts, keep_padded=True)
    if cfg.causal:
        logits = logits[:, :-1]
        targets = labels[:, 1:]
    else:
        targets = labels
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    # an ignored label picks lane 0 here (JAX picks the last lane); its
    # term is multiplied by 0 either way
    picked = torch.gather(logits, -1,
                          targets.long().clamp(min=0)[..., None])[..., 0]
    valid = (targets >= 0).float()
    ce = ((lse - picked) * valid).sum() / valid.sum().clamp(min=1.0)
    return ce + aux_weight * aux


# ------------------------------------------------------------------ prefill

def prefill(cfg: ArchConfig, params: Params, inputs: torch.Tensor,
            buf_len: int) -> Tuple[torch.Tensor, Cache]:
    """Process prompts (all rows full length S): attention in the
    flash-prefill kernel, the SSD scan of SSM layers in the ssd-scan
    kernel, hybrid blocks both. Returns (last-position logits [B,V], cache)
    with the JAX cache layout: length [B]; for attention layers k/v
    [L,B,Hkv,buf_len,hd] (zero past S) and kv_pos [B,buf_len] (-1 past S);
    for SSM layers ssm [L,B,H,P,N] f32 and conv [L,B,C,K-1], the final
    recurrent state.

    buf_len >= S for full-attention archs. With buf_len < S the cache is a
    ring holding the last buf_len tokens, position p at slot p % buf_len
    (kv_pos [B,buf_len] their positions); for a sliding-window arch (long
    context) buf_len must then be the window, which attention keeps."""
    _check_causal(cfg)
    x = embed_inputs(cfg, params, inputs)
    B, S, _ = x.shape
    window = cfg.sliding_window if (cfg.sliding_window and buf_len < S) \
        else None
    if window is not None and buf_len != window:
        raise ValueError(f"{cfg.name}: a ring prefill of {S} tokens needs "
                         f"buf_len == the sliding window {window}, got "
                         f"{buf_len}")
    positions = torch.arange(S, device=x.device)
    blk = params["blocks"]
    ks, vs, hs, cs = [], [], [], []
    for layer in range(cfg.n_layers):
        h = L.rms_norm(x, blk["ln1"][layer], cfg.norm_eps)
        parts = []
        if cfg.has_attention:
            q, k, v = _proj_qkv(cfg, blk, layer, h)
            q = L.apply_rope(q, positions, cfg.rope_theta)
            k = L.apply_rope(k, positions, cfg.rope_theta)
            a = ops.flash_prefill(q, k, v, causal=cfg.causal, window=window)
            parts.append(_attn_out(cfg, blk, layer, a))
            ks.append(k)
            vs.append(v)
        if cfg.has_ssm:
            s_out, h_last, conv_last = SSM.ssm_mixer_with_state(
                _ssm_params(blk, layer), h, cfg.ssm_inner, cfg.ssm_state,
                cfg.ssm_head_dim)
            parts.append(s_out)
            hs.append(h_last)
            cs.append(conv_last)
        x = x + _mix(parts)
        x = x + _ffn(cfg, blk, layer, x)
    cache: Cache = {
        "length": torch.full((B,), S, dtype=torch.int32, device=x.device)}
    if cfg.has_attention:
        k, v = (torch.stack(t).transpose(2, 3) for t in (ks, vs))
        pos = torch.arange(buf_len, dtype=torch.int32, device=x.device)
        if buf_len >= S:
            pad = (0, 0, 0, buf_len - S)             # [.., S, hd] -> buf_len
            cache["k"] = torch.nn.functional.pad(k, pad)
            cache["v"] = torch.nn.functional.pad(v, pad)
            kv_pos = torch.where(pos < S, pos, -1)
        else:
            # ring: the last buf_len tokens, position p at slot
            # p % buf_len: tail token i (position S - buf_len + i) lands
            # at slot (S + i) % buf_len, a roll of the tail by S % buf_len
            shift = S % buf_len
            cache["k"] = torch.roll(k[..., S - buf_len:, :], shift, dims=-2)
            cache["v"] = torch.roll(v[..., S - buf_len:, :], shift, dims=-2)
            kv_pos = torch.roll(pos + (S - buf_len), shift)
        cache["kv_pos"] = kv_pos.repeat(B, 1)
    if cfg.has_ssm:
        cache["ssm"] = torch.stack(hs)
        cache["conv"] = torch.stack(cs)
    return unembed(cfg, params, x[:, -1]), cache


# ---------------------------------------------------------- chunked prefill

def prefill_chunk(cfg: ArchConfig, params: Params, cache: Cache,
                  tokens: torch.Tensor) -> Tuple[torch.Tensor, Cache]:
    """Process ONE prompt chunk against a slot cache (DESIGN.md §5), in
    place.

    tokens: [B,C], the next C prompt tokens of every row, appended at each
    row's ``cache['length']``. The chunk's K/V and kv_pos are written into
    the buffer, then its queries attend over everything cached so far in
    the flash-prefill-chunk kernel, which reads the [B,Hkv,S,hd] layer
    buffer through its strides (no copy). Caller guarantees length+C <=
    buf_len (no ring wrap). Returns (logits of the chunk's last position
    [B,V], cache).
    """
    _check_kv_only(cfg, "slot prefill_chunk")
    B, C = tokens.shape
    dev = tokens.device
    x = embed_inputs(cfg, params, tokens)                 # [B,C,D]
    length = cache["length"]
    q_pos = length[:, None] + torch.arange(C, dtype=length.dtype, device=dev)
    barr = torch.arange(B, device=dev)[:, None]
    slot = q_pos.long()                                    # append-only
    window = cache_window(cfg, cache["k"].shape[3])
    cache["kv_pos"][barr, slot] = q_pos
    blk = params["blocks"]
    for layer in range(cfg.n_layers):
        q, k, v = _qkv(cfg, blk, layer, x)
        q = L.apply_rope(q, q_pos, cfg.rope_theta)
        k = L.apply_rope(k, q_pos, cfg.rope_theta)
        kc, vc = cache["k"][layer], cache["v"][layer]     # [B,Hkv,S,hd]
        kc[barr, :, slot] = k
        vc[barr, :, slot] = v
        a = ops.flash_prefill_chunk(q, kc.transpose(1, 2), vc.transpose(1, 2),
                                    length, window=window)
        x = x + _attn_out(cfg, blk, layer, a)
        x = x + _ffn(cfg, blk, layer, x)
    length += C
    return unembed(cfg, params, x[:, -1]), cache


def prefill_chunk_paged(cfg: ArchConfig, params: Params, pages: Cache,
                        page_table: torch.Tensor, lengths: torch.Tensor,
                        tokens: torch.Tensor) -> Tuple[torch.Tensor, Cache]:
    """Process ONE prompt chunk against the paged KV arena (DESIGN.md §5),
    in place.

    tokens: [B,C] appended at logical positions lengths[b]+i; the page
    table [B,maxp] must already cover lengths+C tokens (the pool extends
    BEFORE the chunk). The chunk's K/V is written into its pages (tokens
    whose page-table entry is -1, or whose position lies past the table,
    write only the arena's spare page), then its queries attend over the
    gathered page view in the flash-prefill-chunk kernel: untabled
    entries gather page 0 at positions past the chunk end, so causal
    masking covers them. No host sync. Returns (logits of the chunk's
    last position [B,V], pages); lengths and tables are the caller's.
    """
    _check_kv_only(cfg, "prefill_chunk_paged")
    B, C = tokens.shape
    dev = tokens.device
    k_all, v_all = pages["k_pages"], pages["v_pages"]
    psz, maxp = k_all.shape[3], page_table.shape[1]
    x = embed_inputs(cfg, params, tokens)                 # [B,C,D]
    q_pos = lengths[:, None] + torch.arange(C, dtype=lengths.dtype,
                                            device=dev)
    barr = torch.arange(B, device=dev)[:, None]
    # the JAX gather clamps an out-of-range logical page; clamp the same way
    pt_row = page_table[barr, (q_pos // psz).clamp(max=maxp - 1).long()]
    # JAX drops untabled tokens' scatter through an out-of-bounds index;
    # here they write the spare page, as the verify step's do, so each
    # pool target has one writer and the step never syncs with the host
    writes = (pt_row >= 0) & (q_pos < maxp * psz)
    w_page = torch.where(writes, pt_row, spare_page(pages)).long()
    w_off = torch.where(writes, q_pos % psz, 0).long()
    blk = params["blocks"]
    for layer in range(cfg.n_layers):
        q, k, v = _qkv(cfg, blk, layer, x)
        q = L.apply_rope(q, q_pos, cfg.rope_theta)
        k = L.apply_rope(k, q_pos, cfg.rope_theta)
        k_all[layer, w_page, :, w_off] = k
        v_all[layer, w_page, :, w_off] = v
        kc = L.gather_pages(k_all[layer], page_table)     # [B,Hkv,maxp*psz,hd]
        vc = L.gather_pages(v_all[layer], page_table)
        a = ops.flash_prefill_chunk(q, kc.transpose(1, 2), vc.transpose(1, 2),
                                    lengths)
        x = x + _attn_out(cfg, blk, layer, a)
        x = x + _ffn(cfg, blk, layer, x)
    return unembed(cfg, params, x[:, -1]), pages


# ------------------------------------------------------------ slot decode

def decode_step(cfg: ArchConfig, params: Params, cache: Cache,
                tokens: torch.Tensor,
                active: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Cache]:
    """One decode iteration for every (active) row of a slot cache, in
    place: attention layers in the decode-attention kernel over the ring,
    SSM layers through the ssd-decode kernel over the cache's own ``ssm``
    rows (row b is state slot b), hybrid blocks both.

    tokens: [B] int; active: [B] bool (the decode-mask-matrix column from
    SLICE's rate allocator). The new token of row b goes to ring slot
    length[b] % buf_len; with a ring no longer than the arch's sliding
    window, attention keeps only that window. Inactive rows keep their
    state (K/V, kv_pos, length, the SSD state and the conv tail unchanged)
    and their logits are garbage to be ignored. Returns (logits [B,V],
    cache).
    """
    _check_causal(cfg)
    B = tokens.shape[0]
    dev = tokens.device
    if active is None:
        active = torch.ones((B,), dtype=torch.bool, device=dev)
    x = embed_inputs(cfg, params, tokens)                 # [B,D]
    length = cache["length"]
    q_pos = length.clone()
    rows = torch.arange(B, device=dev)
    if cfg.has_attention:
        buf_len = cache["k"].shape[3]
        window = cache_window(cfg, buf_len)
        slot = (q_pos % buf_len).long()
        kv_pos = cache["kv_pos"]
        kv_pos[rows, slot] = torch.where(active, q_pos, kv_pos[rows, slot])
        sel = active[:, None, None]
    if cfg.has_ssm:
        state_slots = rows.to(torch.int32)
    blk = params["blocks"]
    for layer in range(cfg.n_layers):
        h = L.rms_norm(x, blk["ln1"][layer], cfg.norm_eps)
        parts = []
        if cfg.has_attention:
            q, k, v = _proj_qkv(cfg, blk, layer, h)
            q = L.apply_rope(q[:, None], q_pos[:, None], cfg.rope_theta)[:, 0]
            k = L.apply_rope(k[:, None], q_pos[:, None], cfg.rope_theta)[:, 0]
            kc, vc = cache["k"][layer], cache["v"][layer]     # [B,Hkv,S,hd]
            kc[rows, :, slot] = torch.where(sel, k, kc[rows, :, slot])
            vc[rows, :, slot] = torch.where(sel, v, vc[rows, :, slot])
            a = ops.decode_attention(q, kc, vc, kv_pos, q_pos, window=window)
            parts.append(_attn_out(cfg, blk, layer, a))
        if cfg.has_ssm:
            parts.append(SSM.ssm_mixer_step(
                _ssm_params(blk, layer), h, cfg.ssm_inner, cfg.ssm_state,
                cfg.ssm_head_dim, cache["ssm"][layer], cache["conv"][layer],
                state_slots, active))
        x = x + _mix(parts)
        x = x + _ffn(cfg, blk, layer, x)
    length += active.to(length.dtype)
    return unembed(cfg, params, x), cache


# ------------------------------------------------------------ paged decode

def decode_step_paged(cfg: ArchConfig, params: Params, pages: Cache,
                      page_table: torch.Tensor, lengths: torch.Tensor,
                      tokens: torch.Tensor,
                      active: Optional[torch.Tensor] = None,
                      state_slots: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, Cache]:
    """One decode iteration with per-layer cache-kind dispatch (DESIGN.md
    §12): attention layers read and write the paged KV arena (attention in
    the paged-decode kernel), SSM layers the state arena (the recurrence in
    the ssd-decode kernel), hybrid blocks both in the same step.

    pages: init_paged_cache dict, plus the init_state_arena entries for
    SSM/hybrid archs; page_table: [B, maxp] int32 physical page per
    logical page (-1 unused; row b must cover lengths[b]+1 tokens);
    lengths: [B] int32 cached tokens per row (the new token is written at
    logical position lengths[b]); tokens: [B]; active: [B] bool — inactive
    and untabled rows write only the arena's spare page (and slot) and
    their logits are garbage to be ignored; state_slots: [B] int32
    state-arena slot per row (-1 pad rows, which write only the spare),
    required for SSM/hybrid archs. The new K/V and state are written in
    place. No host sync: the step can be captured as a CUDA graph.
    Returns (logits [B,V], pages).

    With the batch split over 'data' (``partitioning.batch_rows``), this
    rank computes its data group's rows only, then gathers the logits and
    the step's new K/V of every row from the other groups and writes them
    into its own arena (``_share_rows``), which stays replicated over
    'data' as JAX's ``page_specs`` has it.
    """
    _check_causal(cfg)
    if cfg.has_ssm and state_slots is None:
        raise ValueError(f"{cfg.name}: SSM layers need state_slots")
    B = tokens.shape[0]
    dev = tokens.device
    if active is None:
        active = torch.ones((B,), dtype=torch.bool, device=dev)
    k_all, v_all = pages["k_pages"], pages["v_pages"]
    psz, maxp = k_all.shape[3], page_table.shape[1]
    q_pos = lengths
    if cfg.has_attention:
        rows = torch.arange(B, device=dev)
        # the JAX gather clamps an out-of-range logical page; indexing
        # here would raise, so clamp the same way
        pt_row = page_table[rows, (q_pos // psz).clamp(max=maxp - 1).long()]
        # JAX drops the scatter of inactive/untabled rows through an
        # out-of-bounds index; here every row writes and those rows write
        # the spare page, so the step never syncs with the host
        writes = active & (pt_row >= 0)
        w_page = torch.where(writes, pt_row, spare_page(pages)).long()
        w_off = torch.where(writes, q_pos % psz, 0).long()
        all_page, all_off = w_page, w_off
    mine = P.batch_rows(B)
    if mine is not None:
        tokens, page_table, q_pos, active = (
            t[mine] for t in (tokens, page_table, q_pos, active))
        w_page, w_off = w_page[mine], w_off[mine]
    x = embed_inputs(cfg, params, tokens)              # [B,D]
    ks, vs = [], []
    if cfg.has_ssm:
        s_write = SSM.write_slots(state_slots, active, spare_slot(pages))
    blk = params["blocks"]
    for layer in range(cfg.n_layers):
        h = L.rms_norm(x, blk["ln1"][layer], cfg.norm_eps)
        parts = []
        if cfg.has_attention:
            q, k, v = _proj_qkv(cfg, blk, layer, h)
            q = L.apply_rope(q[:, None], q_pos[:, None], cfg.rope_theta)[:, 0]
            k = L.apply_rope(k[:, None], q_pos[:, None], cfg.rope_theta)[:, 0]
            k_all[layer, w_page, :, w_off] = k
            v_all[layer, w_page, :, w_off] = v
            ks.append(k)
            vs.append(v)
            a = ops.paged_decode_attention(q, k_all[layer], v_all[layer],
                                           page_table, q_pos)
            parts.append(_attn_out(cfg, blk, layer, a))
        if cfg.has_ssm:
            parts.append(SSM.ssm_mixer_step(
                _ssm_params(blk, layer), h, cfg.ssm_inner, cfg.ssm_state,
                cfg.ssm_head_dim, pages["ssm_state"][layer],
                pages["conv_state"][layer], state_slots, active, s_write))
        x = x + _mix(parts)
        x = x + _ffn(cfg, blk, layer, x)
    logits = unembed(cfg, params, x)
    if mine is not None:
        logits = _share_rows(pages, all_page, all_off, ks, vs, logits)
    return logits, pages


def _share_rows(pages: Cache, w_page: torch.Tensor, w_off: torch.Tensor,
                ks: List[torch.Tensor], vs: List[torch.Tensor],
                logits: torch.Tensor) -> torch.Tensor:
    """After a step whose batch is split over 'data': every group's rows
    of the logits and of the new K/V of every layer (``ks``/``vs``, this
    group's rows [n, ..., Hkv, hd] a layer), gathered in one collective;
    the K/V of every row written into this rank's arena at ``w_page`` /
    ``w_off`` (every row's targets, [B] or [B,C]; this group's own rows
    again, with the same values). Returns the logits of every row."""
    k, v, logits = P.gather_data(torch.stack(ks, 1), torch.stack(vs, 1),
                                 logits)
    # [B, L, ..., Hkv, hd] -> the arena index's [B, ..., L, Hkv, hd]
    at = w_page.ndim
    pages["k_pages"][:, w_page, :, w_off] = k.movedim(1, at)
    pages["v_pages"][:, w_page, :, w_off] = v.movedim(1, at)
    return logits


# ------------------------------------------------------- speculative verify

def verify_step_paged(cfg: ArchConfig, params: Params, pages: Cache,
                      page_table: torch.Tensor, lengths: torch.Tensor,
                      tokens: torch.Tensor) -> Tuple[torch.Tensor, Cache]:
    """Multi-token draft-verify step over the paged KV arena (DESIGN.md
    §8), in place; attention in the paged-verify kernel.

    tokens: [B,C], the last committed token followed by C-1 draft tokens,
    appended at logical positions lengths[b]+i; the page table [B,maxp]
    must already cover lengths+C tokens (the pool extends BEFORE the step;
    the caller rolls back pages of rejected drafts with pool.truncate).
    The window's K/V is written into its pages (tokens whose page-table
    entry is -1, such as pad rows', write only the arena's spare page),
    then query i attends over positions 0..lengths[b]+i. No host sync.
    Returns (logits [B,C,V], pages):
    logits[:, i] is the next-token distribution after window token i. Pad
    rows' logits are garbage to be ignored, as inactive decode rows'. A
    batch split over 'data' runs as in ``decode_step_paged``.
    """
    _check_kv_only(cfg, "verify_step_paged")
    B, C = tokens.shape
    dev = tokens.device
    k_all, v_all = pages["k_pages"], pages["v_pages"]
    psz, maxp = k_all.shape[3], page_table.shape[1]
    q_pos = lengths[:, None] + torch.arange(C, dtype=lengths.dtype,
                                            device=dev)
    barr = torch.arange(B, device=dev)[:, None]
    pt_row = page_table[barr, (q_pos // psz).clamp(max=maxp - 1).long()]
    # a bucket's pad positions can run past the table (q_pos >= maxp*psz):
    # they are untabled like -1 entries, never the clamped last page, whose
    # committed K/V they would overwrite. Untabled tokens write the spare
    # page, so no step syncs with the host.
    writes = (pt_row >= 0) & (q_pos < maxp * psz)
    w_page = torch.where(writes, pt_row, spare_page(pages)).long()
    w_off = torch.where(writes, q_pos % psz, 0).long()
    all_page, all_off = w_page, w_off
    mine = P.batch_rows(B)
    if mine is not None:
        tokens, page_table, lengths, q_pos, w_page, w_off = (
            t[mine] for t in (tokens, page_table, lengths, q_pos, w_page,
                              w_off))
    x = embed_inputs(cfg, params, tokens)                 # [B,C,D]
    ks, vs = [], []
    blk = params["blocks"]
    for layer in range(cfg.n_layers):
        q, k, v = _qkv(cfg, blk, layer, x)
        q = L.apply_rope(q, q_pos, cfg.rope_theta)
        k = L.apply_rope(k, q_pos, cfg.rope_theta)
        k_all[layer, w_page, :, w_off] = k
        v_all[layer, w_page, :, w_off] = v
        ks.append(k)
        vs.append(v)
        a = ops.paged_verify_attention(q, k_all[layer], v_all[layer],
                                       page_table, lengths)
        x = x + _attn_out(cfg, blk, layer, a)
        x = x + _ffn(cfg, blk, layer, x)
    logits = unembed(cfg, params, x)
    if mine is not None:
        logits = _share_rows(pages, all_page, all_off, ks, vs, logits)
    return logits, pages
