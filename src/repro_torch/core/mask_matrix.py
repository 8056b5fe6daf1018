"""Decode-mask matrix (paper §IV-D, Algorithm 3 step 1 + Eq. 7).

Rows = tasks sorted by required rate v_i descending; row k has its first v_k
entries set to 1; width = v_0 (the highest rate). Scanning columns left to
right and batching the 1-rows of each column delivers exactly v_i decode
steps per task per cycle.
"""
from __future__ import annotations

import math
from typing import List, Sequence

import numpy as np

from repro_torch.core.latency_model import LatencyModel


def quantized_rate(tpot_ms: float) -> int:
    """Tokens per 1000 ms cycle. Paper Alg.3 floors non-leading rates; we ceil
    every rate (DESIGN.md deviation #3): flooring would allot fewer tokens per
    cycle than the SLO requires and guarantee a TPOT violation."""
    return max(1, math.ceil(1000.0 / tpot_ms))


def build_mask_matrix(rates_desc: Sequence[int]) -> np.ndarray:
    """rates_desc: v_i sorted descending. Returns M [n_tasks, v_0] uint8."""
    if len(rates_desc) == 0:
        return np.zeros((0, 0), np.uint8)
    v0 = int(rates_desc[0])
    rows = np.asarray(rates_desc)[:, None]
    assert (np.diff(np.asarray(rates_desc)) <= 0).all(), "rates must be sorted desc"
    return (np.arange(v0)[None, :] < rows).astype(np.uint8)


def column_batches(mask: np.ndarray) -> List[np.ndarray]:
    """Per-column row-index arrays — the dynamic decode batches of one cycle."""
    return [np.nonzero(mask[:, c])[0] for c in range(mask.shape[1])]


def estimate_period_ms(rates_desc: Sequence[int], lat: LatencyModel) -> float:
    """Eq. (7): T_period = v_b*l(b+1) + sum_j (v_j - v_{j+1}) * l(j+1).

    Equivalently: column c of the mask matrix has batch size
    n_c = #{i : v_i > c}, and T_period = sum_c l(n_c). We compute the
    column-sum form (exact for the left-aligned matrix) — it also stays
    correct for non-left-aligned layouts produced by the stagger optimizer.
    """
    if len(rates_desc) == 0:
        return 0.0
    v = np.asarray(rates_desc, dtype=np.int64)
    v0 = int(v[0])
    # batch size per column: counts[c] = #{i: v_i > c}
    counts = (v[:, None] > np.arange(v0)[None, :]).sum(0)
    return float(sum(lat(int(c)) for c in counts))


def estimate_period_eq7_ms(rates_desc: Sequence[int], lat: LatencyModel) -> float:
    """Literal transcription of Eq. (7) (used to cross-check the column form)."""
    if len(rates_desc) == 0:
        return 0.0
    v = list(rates_desc)
    b = len(v) - 1
    total = v[b] * lat(b + 1)
    for j in range(b):
        total += (v[j] - v[j + 1]) * lat(j + 1)
    return float(total)


def mask_matrix_period_ms(mask: np.ndarray, lat: LatencyModel) -> float:
    """Exact cycle duration of an arbitrary 0/1 matrix under latency model l."""
    return float(sum(lat(int(n)) for n in mask.sum(0)))


def stagger_columns(mask: np.ndarray) -> np.ndarray:
    """Beyond-paper optimization: left-aligned rows bunch every task's tokens
    at the start of the cycle, which (a) makes early columns the largest
    batches and (b) produces bursty token gaps (long stall at cycle end for
    low-rate tasks -> worst-case inter-token gap ~ cycle length).

    Spreading each row's v_k ones evenly across the cycle (round-robin
    phase) keeps per-cycle quotas identical (same row sums) while smoothing
    both batch sizes and inter-token intervals. Column batch sizes change, so
    admission must re-check the period with mask_matrix_period_ms.
    """
    n, v0 = mask.shape
    out = np.zeros_like(mask)
    for k in range(n):
        v = int(mask[k].sum())
        if v == 0:
            continue
        # evenly spaced positions, phase-shifted per row to decorrelate
        pos = (np.floor(np.arange(v) * v0 / v) + k) % v0
        out[k, pos.astype(int)] = 1
    return out
