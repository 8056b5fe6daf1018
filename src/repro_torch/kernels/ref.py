"""Plain PyTorch versions of the hand-written kernels (same contracts).

They are what ``kernels.ops`` runs for CPU tensors, and what
``chip_smoke.py`` holds each kernel against on the card. They share the
model's layer code, as the JAX package's oracles do (``repro.kernels.ref``).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models.layers import attention, band_mask
from repro_torch.models.layers import paged_decode_attention as _paged


def paged_decode_attention_ref(q: torch.Tensor, k_pages: torch.Tensor,
                               v_pages: torch.Tensor, page_table: torch.Tensor,
                               q_pos: torch.Tensor) -> torch.Tensor:
    """Same contract as csrc/paged_decode_attention.cu: gather each
    sequence's pages into a contiguous view, then plain decode attention
    over it. q [B,Hq,hd], k/v_pages [P,Hkv,psz,hd], page_table [B,maxp]
    int32 (-1 unused), q_pos [B] int32 -> [B,Hq,hd]."""
    return _paged(q, k_pages, v_pages, page_table, q_pos)


def flash_prefill_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool = True,
                      window: Optional[int] = None) -> torch.Tensor:
    """Same contract as csrc/flash_prefill.cu: q [B,S,Hq,hd], k/v
    [B,S,Hkv,hd] -> [B,S,Hq,hd] under the band mask of absolute positions
    0..S-1 (causal and/or sliding window, or none)."""
    S = q.shape[1]
    pos = torch.arange(S, device=q.device)
    return attention(q, k, v, band_mask(pos, pos, causal, window))
