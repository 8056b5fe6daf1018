"""Causal decoders in PyTorch — dense GQA, MoE, Mamba2-SSD and hybrid
(parallel attention + SSM) — the serving subset of ``repro.models.model``.

Parameters are a plain dict of tensors with the JAX pytree's names and
layouts — ``x @ W`` with ``W [D, out]``, per-layer weights stacked over a
leading layer axis, the JAX ``SSMParams``/``MoEParams`` NamedTuples as
dicts under ``blocks["ssm"]``/``blocks["moe"]`` — so ``load_params`` can
take the JAX package's own ``init_params`` output (as numpy) and both
packages compute on the same weights. Attention, the SSD scan and decode
step and the grouped-expert FFN go through ``kernels.ops``: the
hand-written CUDA kernels on the card, their plain versions on the CPU.

Entry points:
  prefill(params, inputs, buf_len)          -> (last_logits, cache)
  prefill_chunk(params, cache, tokens)      -> (last_logits, cache)
  decode_step(params, cache, tokens, active) -> (logits, cache)
  prefill_chunk_paged(params, pages, ...)   -> (last_logits, pages)
  decode_step_paged(params, pages, ...)     -> (logits, pages)
  verify_step_paged(params, pages, ...)     -> (logits [B,C,V], pages)

``prefill`` and ``decode_step_paged`` serve every causal arch (attention
layers on the paged KV arena, SSM layers on the constant-size state arena
of ``init_state_arena``, hybrids both, DESIGN.md §12); the slot-cache
functions and the paged chunk and verify steps serve attention-only archs,
dense or MoE.

Unlike the functional JAX code, every step writes the new K/V (and
``kv_pos``/``length``, or the recurrent state) into the slot cache, the
page arena or the state arena in place: these are the engine's largest
buffers, and a view of some rows of the slot cache (``cache[k][:, s:s+1]``)
is updated through to the whole.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
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
    if not (cfg.causal and (cfg.has_attention or cfg.has_ssm)):
        raise NotImplementedError(
            f"{cfg.name}: the port serves causal decoders with attention "
            "and/or SSM layers; encoder-only archs are still to port "
            "(ROADMAP.md)")


def _check_kv_only(cfg: ArchConfig, what: str) -> None:
    """The slot cache and the paged chunk/verify steps carry per-token K/V
    only."""
    _check_causal(cfg)
    if cfg.has_ssm or not cfg.has_attention:
        raise NotImplementedError(
            f"{cfg.name}: {what} serves attention-only archs (dense or MoE); "
            "SSM and hybrid archs serve through prefill and "
            "decode_step_paged (DESIGN.md §12, ROADMAP.md)")


# ------------------------------------------------------------------ init

def param_shapes(cfg: ArchConfig) -> Params:
    """Shape of every parameter, nested as in the JAX pytree."""
    _check_causal(cfg)
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
                device="cuda") -> Params:
    """Random weights with the JAX init's shapes and scales (normal *
    D^-0.5; wo by q_dim^-0.5, wd by d_ff^-0.5; norms zero; the SSM and MoE
    groups as ``init_ssm_params``/``init_moe_params`` draw them), from a
    torch.Generator seeded with ``seed`` on ``device``. Stacked weights are
    drawn one layer at a time, so the fp32 draw never holds more than one
    layer's matrix beside the result."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def draw(shape, s):
        return (torch.randn(shape, generator=gen, device=dev) * s).to(dtype)

    def fill(group, name, shape):
        kind, s = _init_rule(cfg, group, name)
        if kind == "zeros":
            return torch.zeros(shape, dtype=dtype, device=dev)
        if kind == "ones":
            return torch.ones(shape, dtype=dtype, device=dev)
        if kind == "a_log":
            row = torch.log(torch.linspace(1.0, 16.0, shape[-1], device=dev))
            return row.expand(shape).to(dtype).contiguous()
        if len(shape) == 2 and group is None:
            return draw(shape, s)
        out = torch.empty(shape, dtype=dtype, device=dev)
        for layer in range(shape[0]):
            out[layer] = draw(shape[1:], s)
        return out

    shapes = param_shapes(cfg)
    p: Params = {k: fill(None, k, v) for k, v in shapes.items()
                 if k != "blocks"}
    p["blocks"] = {}
    for k, v in shapes["blocks"].items():
        if isinstance(v, dict):
            p["blocks"][k] = {kk: fill(k, kk, vv) for kk, vv in v.items()}
        else:
            p["blocks"][k] = fill("blocks", k, v)
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
    """Empty slot cache: k/v [L,batch,Hkv,buf_len,hd] (ring of buf_len
    slots), kv_pos [batch,buf_len] = -1, length [batch] = 0."""
    _check_kv_only(cfg, "the slot cache")
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, buf_len, cfg.head_dim)
    return {"length": torch.zeros((batch,), dtype=torch.int32, device=dev),
            "k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev),
            "kv_pos": torch.full((batch, buf_len), -1, dtype=torch.int32,
                                 device=dev)}


def cache_window(cfg: ArchConfig, buf_len: int) -> Optional[int]:
    """The sliding window a slot cache of buf_len slots attends under: the
    arch's window when the ring is no longer than it, else none."""
    if cfg.sliding_window and buf_len <= cfg.sliding_window:
        return cfg.sliding_window
    return None


def init_paged_cache(cfg: ArchConfig, n_pages: int, page_size: int,
                     dtype=torch.float32, device="cuda") -> Cache:
    """Shared KV page arena: k/v_pages [L, n_pages + 1, Hkv, page_size,
    hd]. Pages 0..n_pages-1 are the pool's; page n_pages is the spare
    (``spare_page``), which no page table names: the decode and verify
    steps send the K/V of rows that must not write there, where JAX drops
    them through the same out-of-bounds index, so every row writes and no
    step syncs with the host. Attention-free (pure SSM) archs get a
    zero-width arena (Hkv = hd = 0): the page table stays the logical
    token-length ledger of every arch (DESIGN.md §12) but the pages hold
    no bytes."""
    _check_causal(cfg)
    dev = resolve_device(device)
    hkv = cfg.n_kv_heads if cfg.has_attention else 0
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
    """Token ids [B,S] -> embeddings [B,S,D]."""
    return params["embed"][inputs.long()]


def unembed(cfg: ArchConfig, params: Params, x: torch.Tensor) -> torch.Tensor:
    """Final norm and projection to the vocabulary (pad lanes sliced off)."""
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    head = params["embed"].T if cfg.tied_embeddings else params["lm_head"]
    logits = x @ head
    if cfg.padded_vocab != cfg.vocab_size:
        logits = logits[..., :cfg.vocab_size]
    return logits


def _ffn(cfg: ArchConfig, blk: Params, layer: int,
         x: torch.Tensor) -> torch.Tensor:
    """Post-mixer FFN (residual applied by the caller). MoE blocks dispatch
    as the JAX model's default ``moe_impl="grouped"``: a sequence of T > 1
    tokens a row through ``moe_ffn_grouped`` (per-example capacity, drops),
    one token a row through the lossless ``moe_ffn_grouped_decode``."""
    if cfg.block_kind == "moe":
        h = L.rms_norm(x, blk["ln2"][layer], cfg.norm_eps)
        mp = {k: v[layer] for k, v in blk["moe"].items()}
        if h.ndim == 3 and h.shape[1] > 1:
            return MOE.moe_ffn_grouped(mp, h, cfg.top_k)[0]
        return MOE.moe_ffn_grouped_decode(mp, h, cfg.top_k)[0]
    if cfg.d_ff <= 0:
        return torch.zeros_like(x)
    h = L.rms_norm(x, blk["ln2"][layer], cfg.norm_eps)
    return L.gated_mlp(h, blk["wg"][layer], blk["wu"][layer], blk["wd"][layer])


def _proj_qkv(cfg: ArchConfig, blk: Params, layer: int, h: torch.Tensor):
    """Input projections of one layer from the normed input, heads split:
    h [..., D] -> q [..., Hq, hd], k/v [..., Hkv, hd]."""
    lead = h.shape[:-1]
    q = (h @ blk["wq"][layer]).reshape(*lead, cfg.n_heads, cfg.head_dim)
    k = (h @ blk["wk"][layer]).reshape(*lead, cfg.n_kv_heads, cfg.head_dim)
    v = (h @ blk["wv"][layer]).reshape(*lead, cfg.n_kv_heads, cfg.head_dim)
    return q, k, v


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


# ------------------------------------------------------------------ prefill

def prefill(cfg: ArchConfig, params: Params, inputs: torch.Tensor,
            buf_len: int) -> Tuple[torch.Tensor, Cache]:
    """Process prompts (all rows full length S): attention in the
    flash-prefill kernel, the SSD scan of SSM layers in the ssd-scan
    kernel, hybrid blocks both. Returns (last-position logits [B,V], cache)
    with the JAX cache layout: length [B]; for attention layers k/v
    [L,B,Hkv,buf_len,hd] (zero past S) and kv_pos [B,buf_len] (-1 past S);
    for SSM layers ssm [L,B,H,P,N] f32 and conv [L,B,C,K-1], the final
    recurrent state. buf_len >= S (the ring branch for sliding-window long
    context is not ported)."""
    _check_causal(cfg)
    x = embed_inputs(cfg, params, inputs)
    B, S, _ = x.shape
    if buf_len < S:
        raise NotImplementedError("ring-buffer prefill (buf_len < S) is "
                                  "still to port (ROADMAP.md)")
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
            a = ops.flash_prefill(q, k, v, causal=cfg.causal)
            parts.append(a.reshape(B, S, cfg.q_dim) @ blk["wo"][layer])
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
        pad = (0, 0, 0, buf_len - S)                 # [.., S, hd] -> buf_len
        cache["k"] = torch.nn.functional.pad(torch.stack(ks).transpose(2, 3),
                                             pad)
        cache["v"] = torch.nn.functional.pad(torch.stack(vs).transpose(2, 3),
                                             pad)
        pos = torch.arange(buf_len, dtype=torch.int32, device=x.device)
        cache["kv_pos"] = torch.where(pos < S, pos, -1).repeat(B, 1)
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
        x = x + a.reshape(B, C, cfg.q_dim) @ blk["wo"][layer]
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
        x = x + a.reshape(B, C, cfg.q_dim) @ blk["wo"][layer]
        x = x + _ffn(cfg, blk, layer, x)
    return unembed(cfg, params, x[:, -1]), pages


# ------------------------------------------------------------ slot decode

def decode_step(cfg: ArchConfig, params: Params, cache: Cache,
                tokens: torch.Tensor,
                active: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Cache]:
    """One decode iteration for every (active) row of a slot cache, in
    place; attention in the decode-attention kernel.

    tokens: [B] int; active: [B] bool (the decode-mask-matrix column from
    SLICE's rate allocator). The new token of row b goes to ring slot
    length[b] % buf_len; with a ring no longer than the arch's sliding
    window, attention keeps only that window. Inactive rows keep their
    state (K/V, kv_pos and length unchanged) and their logits are garbage
    to be ignored. Returns (logits [B,V], cache).
    """
    _check_kv_only(cfg, "slot decode_step")
    B = tokens.shape[0]
    dev = tokens.device
    if active is None:
        active = torch.ones((B,), dtype=torch.bool, device=dev)
    x = embed_inputs(cfg, params, tokens)                 # [B,D]
    length = cache["length"]
    q_pos = length.clone()
    buf_len = cache["k"].shape[3]
    window = cache_window(cfg, buf_len)
    rows = torch.arange(B, device=dev)
    slot = (q_pos % buf_len).long()
    kv_pos = cache["kv_pos"]
    kv_pos[rows, slot] = torch.where(active, q_pos, kv_pos[rows, slot])
    sel = active[:, None, None]
    blk = params["blocks"]
    for layer in range(cfg.n_layers):
        q, k, v = _qkv(cfg, blk, layer, x)
        q = L.apply_rope(q[:, None], q_pos[:, None], cfg.rope_theta)[:, 0]
        k = L.apply_rope(k[:, None], q_pos[:, None], cfg.rope_theta)[:, 0]
        kc, vc = cache["k"][layer], cache["v"][layer]     # [B,Hkv,S,hd]
        kc[rows, :, slot] = torch.where(sel, k, kc[rows, :, slot])
        vc[rows, :, slot] = torch.where(sel, v, vc[rows, :, slot])
        a = ops.decode_attention(q, kc, vc, kv_pos, q_pos, window=window)
        x = x + a.reshape(B, cfg.q_dim) @ blk["wo"][layer]
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
    x = params["embed"][tokens.long()]                 # [B,D]
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
            a = ops.paged_decode_attention(q, k_all[layer], v_all[layer],
                                           page_table, q_pos)
            parts.append(a.reshape(B, cfg.q_dim) @ blk["wo"][layer])
        if cfg.has_ssm:
            parts.append(SSM.ssm_mixer_step(
                _ssm_params(blk, layer), h, cfg.ssm_inner, cfg.ssm_state,
                cfg.ssm_head_dim, pages["ssm_state"][layer],
                pages["conv_state"][layer], state_slots, active, s_write))
        x = x + _mix(parts)
        x = x + _ffn(cfg, blk, layer, x)
    return unembed(cfg, params, x), pages


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
    rows' logits are garbage to be ignored, as inactive decode rows'.
    """
    _check_kv_only(cfg, "verify_step_paged")
    B, C = tokens.shape
    dev = tokens.device
    k_all, v_all = pages["k_pages"], pages["v_pages"]
    psz, maxp = k_all.shape[3], page_table.shape[1]
    x = embed_inputs(cfg, params, tokens)                 # [B,C,D]
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
    blk = params["blocks"]
    for layer in range(cfg.n_layers):
        q, k, v = _qkv(cfg, blk, layer, x)
        q = L.apply_rope(q, q_pos, cfg.rope_theta)
        k = L.apply_rope(k, q_pos, cfg.rope_theta)
        k_all[layer, w_page, :, w_off] = k
        v_all[layer, w_page, :, w_off] = v
        a = ops.paged_verify_attention(q, k_all[layer], v_all[layer],
                                       page_table, lengths)
        x = x + a.reshape(B, C, cfg.q_dim) @ blk["wo"][layer]
        x = x + _ffn(cfg, blk, layer, x)
    return unembed(cfg, params, x), pages
