"""Core transformer layers in PyTorch: RMSNorm, RoPE, GQA attention (plain
softmax, over a ring cache, for a prompt chunk, and over a paged KV
arena for one decode query or a verify window), gated MLP.

Each function keeps the JAX package's layout and arithmetic
(``repro.models.layers``): the same shapes at the public boundary, softmax
in fp32, NEG_INF = -1e30 as the mask value. They are the plain versions
of the hand-written kernels (``repro_torch.kernels.ref``) and run on any
device.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models import partitioning as P

NEG_INF = -1e30


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)
    return (x * (1.0 + w.float())).to(dt)


# ---------------------------------------------------------------- RoPE

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)     # python-scalar base: no host->device copy


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., S, H, hd]; positions: broadcastable to [..., S]. Half-split
    rotation (first half against second half), not interleaved."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                   # [hd/2]
    ang = positions[..., None].float() * freqs                # [..., S, hd/2]
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------- masks

def band_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
              window: Optional[int]) -> torch.Tensor:
    """[..., Sq, Sk] boolean keep-mask from absolute positions."""
    d = q_pos[..., :, None] - k_pos[..., None, :]
    m = torch.ones(d.shape, dtype=torch.bool, device=d.device)
    if causal:
        m &= d >= 0
    if window is not None:
        m &= d < window
    return m


# ---------------------------------------------------------------- attention

def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Plain softmax attention. q: [B,Sq,Hq,hd], k/v: [B,Sk,Hkv,hd].

    GQA: query head h reads KV head h // (Hq // Hkv). mask: None, [Sq,Sk]
    or [B,Sq,Sk] (True = keep). Softmax in fp32.
    """
    B, Sq, Hq, hd = q.shape
    Hkv = k.shape[2]
    g = Hq // Hkv
    qg = q.reshape(B, Sq, Hkv, g, hd)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k).float()
    scores = scores * hd ** -0.5
    if mask is not None:
        if mask.ndim == 2:
            mask = mask[None]
        scores = torch.where(mask[:, None, None], scores,
                             torch.full_like(scores, NEG_INF))
    p = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v)
    return out.reshape(B, Sq, Hq, hd)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      q_pos: torch.Tensor, k_pos: torch.Tensor,
                      causal: bool = True, window: Optional[int] = None,
                      q_chunk: int = 512, k_chunk: int = 1024) -> torch.Tensor:
    """Flash-style attention in plain torch: online softmax over
    q_chunk x k_chunk tiles, O(chunk) score memory, differentiable (the
    training forward's long-sequence path, as in the JAX model). Shapes as
    ``attention``; q_pos/k_pos: [Sq]/[Sk] absolute positions for the band
    mask. Sq and Sk are padded to chunk multiples, padded queries at
    position -1e9 and padded keys at +1e9, so the band mask drops them."""
    B, Sq, Hq, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    g = Hq // Hkv
    nq = -(-Sq // q_chunk)
    nk = -(-Sk // k_chunk)
    pq = nq * q_chunk - Sq
    pk = nk * k_chunk - Sk
    qf = F.pad(q, (0, 0, 0, 0, 0, pq)).reshape(B, nq, q_chunk, Hkv, g, hd)
    kf = F.pad(k, (0, 0, 0, 0, 0, pk)).reshape(B, nk, k_chunk, Hkv, hd)
    vf = F.pad(v, (0, 0, 0, 0, 0, pk)).reshape(B, nk, k_chunk, Hkv, hd)
    qpf = F.pad(q_pos, (0, pq), value=-(10 ** 9)).reshape(nq, q_chunk)
    kpf = F.pad(k_pos, (0, pk), value=10 ** 9).reshape(nk, k_chunk)
    scale = hd ** -0.5
    f32 = torch.float32
    outs = []
    for i in range(nq):
        qc = qf[:, i]                                   # [B,qc,Hkv,g,hd]
        m = torch.full((B, Hkv, g, q_chunk), NEG_INF, dtype=f32,
                       device=q.device)
        l = torch.zeros((B, Hkv, g, q_chunk), dtype=f32, device=q.device)
        acc = torch.zeros((B, Hkv, g, q_chunk, hd), dtype=f32,
                          device=q.device)
        for j in range(nk):
            kc, vc = kf[:, j], vf[:, j]
            s = torch.einsum("bqhgd,bkhd->bhgqk", qc, kc).float() * scale
            keep = band_mask(qpf[i], kpf[j], causal, window)   # [qc,kc]
            s = torch.where(keep[None, None, None], s,
                            torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhgqk,bkhd->bhgqd", p.to(vc.dtype), vc).float()
            m = m_new
        outs.append((acc / l.clamp(min=1e-30)[..., None]).to(q.dtype))
    # [nq x (B,Hkv,g,qc,hd)] -> [B, Sq, Hq, hd]
    out = torch.stack(outs, dim=1).permute(0, 1, 4, 2, 3, 5)
    return out.reshape(B, nq * q_chunk, Hq, hd)[:, :Sq]


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, kv_pos: torch.Tensor,
                     q_pos: torch.Tensor,
                     window: Optional[int] = None) -> torch.Tensor:
    """Single-token decode over a (possibly ring-buffer) KV cache.

    q: [B,Hq,hd] (RoPE'd); k/v_cache: [B,Hkv,Sbuf,hd]; kv_pos: [B,Sbuf]
    absolute position per slot, -1 = empty; q_pos: [B]; window: keep only
    keys with q_pos - kv_pos < window.
    """
    B, Hq, hd = q.shape
    Hkv = k_cache.shape[1]
    g = Hq // Hkv
    qg = q.reshape(B, Hkv, g, hd)
    s = torch.einsum("bhgd,bhsd->bhgs", qg, k_cache).float()
    s = s * hd ** -0.5
    keep = (kv_pos >= 0) & (kv_pos <= q_pos[:, None])
    if window is not None:
        keep &= q_pos[:, None] - kv_pos < window
    s = torch.where(keep[:, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1).to(v_cache.dtype)
    out = torch.einsum("bhgs,bhsd->bhgd", p, v_cache)
    return out.reshape(B, Hq, hd)


def chunk_decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, kv_pos: torch.Tensor,
                           q_pos: torch.Tensor,
                           window: Optional[int] = None) -> torch.Tensor:
    """Prompt-chunk attention over a KV cache buffer: the multi-query
    generalisation of ``decode_attention`` and the plain version of the
    flash-prefill-chunk kernel.

    q: [B,C,Hq,hd], RoPE'd at absolute positions q_pos [B,C];
    k/v_cache: [B,Hkv,Sbuf,hd] with the chunk's own KV already written;
    kv_pos: [B,Sbuf] absolute position per slot, -1 = empty. Causal, and
    within ``window`` when given.
    """
    d = q_pos[:, :, None] - kv_pos[:, None, :]           # [B,C,Sbuf]
    keep = (kv_pos[:, None, :] >= 0) & (d >= 0)
    if window is not None:
        keep &= d < window
    return attention(q, k_cache.transpose(1, 2), v_cache.transpose(1, 2), keep)


def gather_pages(pages: torch.Tensor, page_table: torch.Tensor) -> torch.Tensor:
    """pages: [P,Hkv,psz,hd]; page_table: [B,maxp] (-1 = unused, gathered as
    page 0 and masked by the caller via kv positions).
    Returns the contiguous view [B,Hkv,maxp*psz,hd]."""
    B, maxp = page_table.shape
    _, Hkv, psz, hd = pages.shape
    gathered = pages[page_table.clamp(min=0).long()]    # [B,maxp,Hkv,psz,hd]
    return gathered.permute(0, 2, 1, 3, 4).reshape(B, Hkv, maxp * psz, hd)


def paged_kv_positions(page_table: torch.Tensor, page_size: int) -> torch.Tensor:
    """Logical token position per gathered KV slot, -1 where the page-table
    entry is unused."""
    B, maxp = page_table.shape
    pos = torch.arange(maxp * page_size, dtype=torch.int32,
                       device=page_table.device)
    valid = (page_table >= 0).repeat_interleave(page_size, dim=1)
    return torch.where(valid, pos[None, :], torch.full_like(pos, -1)[None, :])


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, page_table: torch.Tensor,
                           q_pos: torch.Tensor) -> torch.Tensor:
    """Single-token decode over a PAGED KV cache (the plain version of the
    paged-decode kernel).

    q: [B,Hq,hd] (RoPE'd); k/v_pages: [P,Hkv,psz,hd]; page_table: [B,maxp]
    physical page per logical page, -1 = unused; q_pos: [B] position of the
    newest token. Attends over logical positions 0..q_pos. A row with no
    live entry averages page 0 here (the kernel gives 0): callers ignore
    such rows.
    """
    psz = k_pages.shape[2]
    kc = gather_pages(k_pages, page_table)
    vc = gather_pages(v_pages, page_table)
    kv_pos = paged_kv_positions(page_table, psz)
    return decode_attention(q, kc, vc, kv_pos, q_pos)


def paged_verify_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, page_table: torch.Tensor,
                           q_start: torch.Tensor) -> torch.Tensor:
    """Multi-token verify attention over a PAGED KV cache: the C-query
    generalisation of ``paged_decode_attention`` (the plain version of the
    paged-verify kernel), used by speculative decoding's verify step.

    q: [B,C,Hq,hd], the C = depth+1 verify queries RoPE'd at positions
    ``q_start[b]+i``; k/v_pages: [P,Hkv,psz,hd] with the window's own K/V
    already written; page_table: [B,maxp], -1 = unused; q_start: [B]
    position of the first verify query. Query i attends over logical
    positions 0..q_start+i (causal within the window).
    """
    psz = k_pages.shape[2]
    C = q.shape[1]
    kc = gather_pages(k_pages, page_table)
    vc = gather_pages(v_pages, page_table)
    kv_pos = paged_kv_positions(page_table, psz)
    q_pos = q_start[:, None] + torch.arange(C, dtype=q_start.dtype,
                                            device=q.device)
    return chunk_decode_attention(q, kc, vc, kv_pos, q_pos)


# ---------------------------------------------------------------- MLP

def gated_mlp(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
              wd: torch.Tensor, partial: bool = False) -> torch.Tensor:
    """``partial``: wg/wu hold a slab of d_ff's columns and wd its rows (a
    tensor-parallel rank's), so the product is a partial sum, summed over
    the model axis (``partitioning.reduce_model``)."""
    y = (F.silu(x @ wg) * (x @ wu)) @ wd
    return P.reduce_model(y) if partial else y
