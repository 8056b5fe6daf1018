"""Dense GQA decoder in PyTorch: the main-path subset of ``repro.models.model``.

Parameters are a plain dict of tensors with the JAX pytree's names and
layouts — ``x @ W`` with ``W [D, out]``, per-layer weights stacked over a
leading layer axis — so ``load_params`` can take the JAX package's own
``init_params`` output (as numpy) and both packages compute on the same
weights. Attention goes through ``kernels.ops``: the hand-written CUDA
kernels on the card, their plain versions on the CPU.

Entry points:
  prefill(params, inputs, buf_len)          -> (last_logits, cache)
  prefill_chunk(params, cache, tokens)      -> (last_logits, cache)
  decode_step(params, cache, tokens, active) -> (logits, cache)
  prefill_chunk_paged(params, pages, ...)   -> (last_logits, pages)
  decode_step_paged(params, pages, ...)     -> (logits, pages)
  verify_step_paged(params, pages, ...)     -> (logits [B,C,V], pages)

Unlike the functional JAX code, every step writes the new K/V (and
``kv_pos``/``length``) into the slot cache or the page arena in place:
these are the engine's largest buffers, and a view of some rows of the
slot cache (``cache[k][:, s:s+1]``) is updated through to the whole.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L

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


def _check_dense(cfg: ArchConfig) -> None:
    if not (cfg.causal and cfg.has_attention and not cfg.has_ssm
            and cfg.block_kind == "dense"):
        raise NotImplementedError(
            f"{cfg.name}: the port serves dense causal GQA decoders only; "
            "MoE, SSM, hybrid and encoder archs are still to port "
            "(ROADMAP.md)")


# ------------------------------------------------------------------ init

def param_shapes(cfg: ArchConfig) -> Params:
    """Shape of every parameter, nested as in the JAX pytree."""
    _check_dense(cfg)
    D, Lh, f = cfg.d_model, cfg.n_layers, cfg.d_ff
    shapes: Params = {"embed": (cfg.padded_vocab, D), "final_norm": (D,)}
    if not cfg.tied_embeddings:
        shapes["lm_head"] = (D, cfg.padded_vocab)
    blk = {"ln1": (Lh, D), "wq": (Lh, D, cfg.q_dim), "wk": (Lh, D, cfg.kv_dim),
           "wv": (Lh, D, cfg.kv_dim), "wo": (Lh, cfg.q_dim, D)}
    if f > 0:
        blk.update(wg=(Lh, D, f), wu=(Lh, D, f), wd=(Lh, f, D), ln2=(Lh, D))
    shapes["blocks"] = blk
    return shapes


def init_params(cfg: ArchConfig, seed: int = 0, dtype=torch.float32,
                device="cuda") -> Params:
    """Random weights with the JAX init's shapes and scales (normal *
    D^-0.5; wo by q_dim^-0.5, wd by d_ff^-0.5; norms zero), drawn from a
    torch.Generator seeded with ``seed`` on ``device``. Stacked weights are
    drawn one layer at a time, so the fp32 draw never holds more than one
    layer's matrix beside the result."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    D = cfg.d_model
    scale = {"wo": cfg.q_dim ** -0.5, "wd": cfg.d_ff ** -0.5 if cfg.d_ff else 0}

    def draw(shape, s):
        return (torch.randn(shape, generator=gen, device=dev) * s).to(dtype)

    def fill(name, shape):
        if name in ("final_norm", "ln1", "ln2"):
            return torch.zeros(shape, dtype=dtype, device=dev)
        s = scale.get(name, D ** -0.5)
        if len(shape) == 2:
            return draw(shape, s)
        out = torch.empty(shape, dtype=dtype, device=dev)
        for layer in range(shape[0]):
            out[layer] = draw(shape[1:], s)
        return out

    shapes = param_shapes(cfg)
    p: Params = {k: fill(k, v) for k, v in shapes.items() if k != "blocks"}
    p["blocks"] = {k: fill(k, v) for k, v in shapes["blocks"].items()}
    return p


def load_params(cfg: ArchConfig, tree: Params, device="cuda") -> Params:
    """The weight bridge: a JAX ``init_params`` pytree (arrays or numpy)
    -> the port's parameter dict on ``device``, with every shape checked
    and each array's type kept (bf16 stays bf16)."""
    dev = resolve_device(device)

    def conv(name, arr, shape):
        a = np.asarray(arr)
        to = None
        if a.dtype.name == "bfloat16":     # numpy has no bf16 of its own
            a, to = a.astype(np.float32), torch.bfloat16
        if tuple(a.shape) != tuple(shape):
            raise ValueError(f"param {name}: shape {a.shape} != {shape}")
        return torch.from_numpy(np.array(a)).to(dev, to)   # own, writable copy

    shapes = param_shapes(cfg)
    missing = set(shapes) - set(tree) | {
        f"blocks.{k}" for k in set(shapes["blocks"]) - set(tree["blocks"])}
    if missing:
        raise KeyError(f"params missing {sorted(missing)}")
    p: Params = {k: conv(k, tree[k], s) for k, s in shapes.items()
                 if k != "blocks"}
    p["blocks"] = {k: conv(f"blocks.{k}", tree["blocks"][k], s)
                   for k, s in shapes["blocks"].items()}
    return p


def init_cache(cfg: ArchConfig, batch: int, buf_len: int,
               dtype=torch.float32, device="cuda") -> Cache:
    """Empty slot cache: k/v [L,batch,Hkv,buf_len,hd] (ring of buf_len
    slots), kv_pos [batch,buf_len] = -1, length [batch] = 0."""
    _check_dense(cfg)
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
    """Shared KV page arena: k/v_pages [L, n_pages, Hkv, page_size, hd]."""
    _check_dense(cfg)
    dev = resolve_device(device)
    shape = (cfg.n_layers, n_pages, cfg.n_kv_heads, page_size, cfg.head_dim)
    return {"k_pages": torch.zeros(shape, dtype=dtype, device=dev),
            "v_pages": torch.zeros(shape, dtype=dtype, device=dev)}


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
    if cfg.d_ff <= 0:
        return torch.zeros_like(x)
    h = L.rms_norm(x, blk["ln2"][layer], cfg.norm_eps)
    return L.gated_mlp(h, blk["wg"][layer], blk["wu"][layer], blk["wd"][layer])


def _qkv(cfg: ArchConfig, blk: Params, layer: int, x: torch.Tensor):
    """Normed input projections of one layer, heads split: x [..., D] ->
    q [..., Hq, hd], k/v [..., Hkv, hd]."""
    h = L.rms_norm(x, blk["ln1"][layer], cfg.norm_eps)
    lead = x.shape[:-1]
    q = (h @ blk["wq"][layer]).reshape(*lead, cfg.n_heads, cfg.head_dim)
    k = (h @ blk["wk"][layer]).reshape(*lead, cfg.n_kv_heads, cfg.head_dim)
    v = (h @ blk["wv"][layer]).reshape(*lead, cfg.n_kv_heads, cfg.head_dim)
    return q, k, v


# ------------------------------------------------------------------ prefill

def prefill(cfg: ArchConfig, params: Params, inputs: torch.Tensor,
            buf_len: int) -> Tuple[torch.Tensor, Cache]:
    """Process prompts (all rows full length S) with attention in the
    flash-prefill kernel. Returns (last-position logits [B,V], cache) with
    the JAX cache layout: k/v [L,B,Hkv,buf_len,hd] (zero past S), kv_pos
    [B,buf_len] (-1 past S), length [B]. buf_len >= S (the ring branch for
    sliding-window long context is not ported)."""
    _check_dense(cfg)
    x = embed_inputs(cfg, params, inputs)
    B, S, _ = x.shape
    if buf_len < S:
        raise NotImplementedError("ring-buffer prefill (buf_len < S) is "
                                  "still to port (ROADMAP.md)")
    positions = torch.arange(S, device=x.device)
    blk = params["blocks"]
    ks, vs = [], []
    for layer in range(cfg.n_layers):
        q, k, v = _qkv(cfg, blk, layer, x)
        q = L.apply_rope(q, positions, cfg.rope_theta)
        k = L.apply_rope(k, positions, cfg.rope_theta)
        a = ops.flash_prefill(q, k, v, causal=cfg.causal)
        x = x + a.reshape(B, S, cfg.q_dim) @ blk["wo"][layer]
        x = x + _ffn(cfg, blk, layer, x)
        ks.append(k)
        vs.append(v)
    pad = (0, 0, 0, buf_len - S)                     # [.., S, hd] -> buf_len
    cache: Cache = {
        "length": torch.full((B,), S, dtype=torch.int32, device=x.device),
        "k": torch.nn.functional.pad(torch.stack(ks).transpose(2, 3), pad),
        "v": torch.nn.functional.pad(torch.stack(vs).transpose(2, 3), pad),
    }
    pos = torch.arange(buf_len, dtype=torch.int32, device=x.device)
    cache["kv_pos"] = torch.where(pos < S, pos, -1).repeat(B, 1)
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
    _check_dense(cfg)
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
    whose page-table entry is -1 write nothing), then its queries attend
    over the gathered page view in the flash-prefill-chunk kernel:
    untabled entries gather page 0 at positions past the chunk end, so
    causal masking covers them. Returns (logits of the chunk's last
    position [B,V], pages); lengths and tables are the caller's.
    """
    _check_dense(cfg)
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
    # torch raises on one, so select the tokens that write (one host sync)
    w_b, w_c = (pt_row >= 0).nonzero(as_tuple=True)
    w_page = pt_row[w_b, w_c].long()
    w_off = (q_pos[w_b, w_c] % psz).long()
    blk = params["blocks"]
    for layer in range(cfg.n_layers):
        q, k, v = _qkv(cfg, blk, layer, x)
        q = L.apply_rope(q, q_pos, cfg.rope_theta)
        k = L.apply_rope(k, q_pos, cfg.rope_theta)
        k_all[layer, w_page, :, w_off] = k[w_b, w_c]
        v_all[layer, w_page, :, w_off] = v[w_b, w_c]
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
    _check_dense(cfg)
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
                      active: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, Cache]:
    """One decode iteration over the paged KV arena, attention in the
    paged-decode kernel.

    pages: init_paged_cache dict; page_table: [B, maxp] int32 physical page
    per logical page (-1 unused; row b must cover lengths[b]+1 tokens);
    lengths: [B] int32 cached tokens per row (the new token is written at
    logical position lengths[b]); tokens: [B]; active: [B] bool — inactive
    and untabled rows write nothing and their logits are garbage to be
    ignored. The new K/V is written into ``pages`` in place before
    attention reads it. Returns (logits [B,V], pages).
    """
    _check_dense(cfg)
    B = tokens.shape[0]
    dev = tokens.device
    if active is None:
        active = torch.ones((B,), dtype=torch.bool, device=dev)
    k_all, v_all = pages["k_pages"], pages["v_pages"]
    psz, maxp = k_all.shape[3], page_table.shape[1]
    x = params["embed"][tokens.long()]                 # [B,D]
    q_pos = lengths
    rows = torch.arange(B, device=dev)
    # the JAX gather clamps an out-of-range logical page; indexing here
    # would raise, so clamp the same way
    pt_row = page_table[rows, (q_pos // psz).clamp(max=maxp - 1).long()]
    # JAX drops the scatter of inactive/untabled rows through an
    # out-of-bounds index; torch raises on one, so select the rows that
    # write instead (one host sync per step)
    w_rows = (active & (pt_row >= 0)).nonzero().squeeze(1)
    w_page = pt_row[w_rows].long()
    w_off = (q_pos[w_rows] % psz).long()
    blk = params["blocks"]
    for layer in range(cfg.n_layers):
        q, k, v = _qkv(cfg, blk, layer, x)
        q = L.apply_rope(q[:, None], q_pos[:, None], cfg.rope_theta)[:, 0]
        k = L.apply_rope(k[:, None], q_pos[:, None], cfg.rope_theta)[:, 0]
        k_all[layer, w_page, :, w_off] = k[w_rows]
        v_all[layer, w_page, :, w_off] = v[w_rows]
        a = ops.paged_decode_attention(q, k_all[layer], v_all[layer],
                                       page_table, q_pos)
        x = x + a.reshape(B, cfg.q_dim) @ blk["wo"][layer]
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
    entry is -1, such as pad rows', write nothing), then query i attends
    over positions 0..lengths[b]+i. Returns (logits [B,C,V], pages):
    logits[:, i] is the next-token distribution after window token i. Pad
    rows' logits are garbage to be ignored, as inactive decode rows'.
    """
    _check_dense(cfg)
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
    # committed K/V they would overwrite. Select the tokens that write
    # (one host sync).
    writes = (pt_row >= 0) & (q_pos < maxp * psz)
    w_b, w_c = writes.nonzero(as_tuple=True)
    w_page = pt_row[w_b, w_c].long()
    w_off = (q_pos[w_b, w_c] % psz).long()
    blk = params["blocks"]
    for layer in range(cfg.n_layers):
        q, k, v = _qkv(cfg, blk, layer, x)
        q = L.apply_rope(q, q_pos, cfg.rope_theta)
        k = L.apply_rope(k, q_pos, cfg.rope_theta)
        k_all[layer, w_page, :, w_off] = k[w_b, w_c]
        v_all[layer, w_page, :, w_off] = v[w_b, w_c]
        a = ops.paged_verify_attention(q, k_all[layer], v_all[layer],
                                       page_table, lengths)
        x = x + a.reshape(B, C, cfg.q_dim) @ blk["wo"][layer]
        x = x + _ffn(cfg, blk, layer, x)
    return unembed(cfg, params, x), pages
