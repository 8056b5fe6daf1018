"""One SLICE scheduling cycle over the decode-mask matrix (PyTorch port).

The counterpart of ``repro.core.decode_cycle``: the JAX package compiles
the whole cycle into one ``lax.scan``; here it is a loop over the mask's
columns, one slot-cache ``model.decode_step`` per column, in place:

    tokens_out[c, s] = token decoded at column c for slot s (or -1)

The decode-mask column IS the active-slot mask of the fixed-shape decode
step (Algorithm 3's decoding loop, lines 12-33). A slot that emits
``eos_id`` stops taking part in later columns (lines 20-24).
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import model as M


def decode_cycle(cfg: ArchConfig, params, cache: M.Cache,
                 tokens: torch.Tensor, mask: torch.Tensor, eos_id: int = -1
                 ) -> Tuple[torch.Tensor, torch.Tensor, M.Cache]:
    """Run one full scheduling cycle.

    cache: slot cache for B slots (updated in place); tokens: [B] last
    token per slot; mask: [B, v0] decode-mask matrix mapped to slots (row
    = slot). Returns (tokens_out [v0, B] int32 with -1 for inactive,
    last_tokens [B], cache).
    """
    B, v0 = mask.shape
    cols = mask.T.bool()                                  # [v0, B]
    tokens = tokens.to(torch.int32)
    live = torch.ones((B,), dtype=torch.bool, device=tokens.device)
    minus1 = torch.full_like(tokens, -1)
    out = []
    for c in range(v0):
        active = cols[c] & live
        logits, cache = M.decode_step(cfg, params, cache, tokens, active)
        new = logits.argmax(-1).to(torch.int32)
        tokens = torch.where(active, new, tokens)
        out.append(torch.where(active, new, minus1))
        live = live & ~(active & (new == eos_id))
    return torch.stack(out), tokens, cache


def cycle_throughput_estimate(mask: torch.Tensor,
                              lat_table: torch.Tensor) -> torch.Tensor:
    """Eq. 7 on tensors: cycle duration (ms) of a mask under a latency
    table l[b] (b = active slots in a column, clamped to the table)."""
    counts = mask.to(torch.int64).sum(0)                  # [v0]
    return lat_table[counts.clamp(0, lat_table.shape[0] - 1)].sum()
