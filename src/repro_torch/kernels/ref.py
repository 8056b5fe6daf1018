"""Plain PyTorch versions of the hand-written kernels (same contracts).

They are what ``kernels.ops`` runs for CPU tensors, and what
``chip_smoke.py`` holds each kernel against on the card. They share the
model's layer code, as the JAX package's oracles do (``repro.kernels.ref``).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models.layers import (attention, band_mask,
                                       chunk_decode_attention,
                                       decode_attention)
from repro_torch.models.layers import paged_decode_attention as _paged
from repro_torch.models.layers import paged_verify_attention as _verify


def decode_attention_ref(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, kv_pos: torch.Tensor,
                         q_pos: torch.Tensor,
                         window: Optional[int] = None) -> torch.Tensor:
    """Same contract as csrc/decode_attention.cu: one query token per row
    over a ring cache. q [B,Hq,hd], k/v_cache [B,Hkv,S,hd], kv_pos [B,S]
    int32 (-1 empty), q_pos [B] int32 -> [B,Hq,hd]; keys kept where
    0 <= kv_pos <= q_pos (and q_pos - kv_pos < window). A row with nothing
    live averages every slot here (the kernel gives 0): callers ignore
    such rows."""
    return decode_attention(q, k_cache, v_cache, kv_pos, q_pos, window)


def paged_decode_attention_ref(q: torch.Tensor, k_pages: torch.Tensor,
                               v_pages: torch.Tensor, page_table: torch.Tensor,
                               q_pos: torch.Tensor) -> torch.Tensor:
    """Same contract as csrc/paged_decode_attention.cu: gather each
    sequence's pages into a contiguous view, then plain decode attention
    over it. q [B,Hq,hd], k/v_pages [P,Hkv,psz,hd], page_table [B,maxp]
    int32 (-1 unused), q_pos [B] int32 -> [B,Hq,hd]."""
    return _paged(q, k_pages, v_pages, page_table, q_pos)


def paged_verify_attention_ref(q: torch.Tensor, k_pages: torch.Tensor,
                               v_pages: torch.Tensor, page_table: torch.Tensor,
                               q_start: torch.Tensor) -> torch.Tensor:
    """Same contract as the verify entry point of
    csrc/paged_decode_attention.cu: C queries per sequence at positions
    q_start[b]+i over the gathered page view, query i keeping positions
    0..q_start[b]+i. q [B,C,Hq,hd], k/v_pages [P,Hkv,psz,hd], page_table
    [B,maxp] int32 (-1 unused), q_start [B] int32 -> [B,C,Hq,hd]."""
    return _verify(q, k_pages, v_pages, page_table, q_start)


def flash_prefill_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool = True,
                      window: Optional[int] = None) -> torch.Tensor:
    """Same contract as csrc/flash_prefill.cu: q [B,S,Hq,hd], k/v
    [B,S,Hkv,hd] -> [B,S,Hq,hd] under the band mask of absolute positions
    0..S-1 (causal and/or sliding window, or none)."""
    S = q.shape[1]
    pos = torch.arange(S, device=q.device)
    return attention(q, k, v, band_mask(pos, pos, causal, window))


def flash_prefill_chunk_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, q_start: torch.Tensor,
                            window: Optional[int] = None) -> torch.Tensor:
    """Same contract as the chunk entry point of csrc/flash_prefill.cu:
    chunk queries q [B,C,Hq,hd] at absolute positions q_start[b]+i over
    the whole KV buffer k/v [B,S,Hkv,hd] (key j at position j), causal and
    within ``window`` when given, so stale data past the chunk end is
    masked -> [B,C,Hq,hd]. k/v may be strided views."""
    B, C = q.shape[:2]
    S = k.shape[1]
    q_pos = q_start[:, None] + torch.arange(C, device=q.device)
    kv_pos = torch.arange(S, device=q.device).expand(B, S)
    return chunk_decode_attention(q, k.transpose(1, 2), v.transpose(1, 2),
                                  kv_pos, q_pos, window)
