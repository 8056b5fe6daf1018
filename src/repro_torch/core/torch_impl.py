"""SLICE's admission as tensor ops: the port of ``repro.core.jax_impl``.

A vectorized form of Algorithms 2 and 3 with no host loop, for a control
plane that runs the admission solve on the device over many queued tasks,
held against the reference Python implementation (``core.selection``,
``core.mask_matrix``) in the tests.

Key identity: with tasks in greedy (utility-rate-descending) order, the
period of prefix k is T(k) = sum_c l(n_c(k)) where n_c(k) = #{i<=k: v_i>c}.
All prefixes are evaluated at once as a cumulative-count matrix,
O(N * Vmax) and branch-free.
"""
from __future__ import annotations

from typing import Tuple

import torch


def utility_rate(utility: torch.Tensor, tpot_ms: torch.Tensor) -> torch.Tensor:
    """Eq. (6), vectorized."""
    return utility * (tpot_ms / 1000.0)


def quantized_rates(tpot_ms: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.ceil(1000.0 / tpot_ms), min=1).to(torch.int32)


def build_mask_matrix(rates_desc: torch.Tensor, v0: int) -> torch.Tensor:
    """M[k, c] = c < v_k. rates_desc: [n] int; width v0."""
    cols = torch.arange(v0, device=rates_desc.device)
    return (cols[None, :] < rates_desc[:, None]).to(torch.int8)


def period_from_counts(counts: torch.Tensor,
                       lat_table: torch.Tensor) -> torch.Tensor:
    """counts: [..., C] batch size per column; lat_table: [Bmax+1] l(b) ms."""
    idx = counts.clamp(0, lat_table.shape[0] - 1).long()
    return lat_table[idx].sum(-1)


def select_tasks(utility: torch.Tensor, tpot_ms: torch.Tensor,
                 valid: torch.Tensor, lat_table: torch.Tensor,
                 budget_ms: float = 1000.0, v_max: int = 64
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Vectorized Algorithm 2.

    utility/tpot_ms/valid: [N] task attributes (valid=False rows ignored);
    lat_table: [Bmax+1] with lat_table[b] = l(b) ms, lat_table[0] = 0.
    Returns (selected [N] bool, order [N] greedy order, a stable sort)."""
    neg_inf = torch.full_like(utility, float("-inf"))
    r = torch.where(valid, utility_rate(utility, tpot_ms), neg_inf)
    order = torch.argsort(-r, stable=True)      # invalid rows last
    v = torch.where(valid, quantized_rates(tpot_ms),
                    torch.zeros_like(tpot_ms, dtype=torch.int32))[order]
    cols = torch.arange(v_max, device=v.device)
    counts = torch.cumsum(v[:, None] > cols[None, :], dim=0)   # n_c(k)
    ok = period_from_counts(counts, lat_table) < budget_ms
    # greedy admits the longest prefix of consecutive OKs
    admitted = (torch.cumprod(ok.to(torch.int32), dim=0) == 1) & valid[order]
    selected = torch.zeros_like(admitted).scatter(0, order, admitted)
    return selected, order


def cycle_token_schedule(mask: torch.Tensor) -> torch.Tensor:
    """Per-column active-row masks, ready to feed decode_step(active=...).
    mask: [n, v0] -> [v0, n] bool (scan axis first)."""
    return mask.T.to(torch.bool)
