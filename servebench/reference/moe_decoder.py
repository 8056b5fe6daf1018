"""Plain MoE decoder: ``common``'s block with a routed gated-SiLU FFN.

Routing as the port's model states it: router logits ``h @ router``,
softmax over the E experts, the top K by probability, their
probabilities divided by their sum. A prompt's tokens are routed in the
groups its prefill ran them in (``spans``: the whole prompt for an atomic
prefill, each chunk piece for a chunked one), each with capacity
C = max(int(T * K / E * 1.25 + 0.999), K) per expert for a group of T
tokens: an assignment is dropped when C earlier tokens of its group went
to the same expert. Decoded tokens are routed alone and nothing of
theirs is dropped. Each kept assignment adds its weight times its
expert's ``(silu(h @ wg) * (h @ wu)) @ wd``.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from servebench.reference import common

CAPACITY_FACTOR = 1.25


def keep_mask(ids: torch.Tensor, n_experts: int, top_k: int,
              groups: List[Tuple[int, int]]) -> torch.Tensor:
    """[N, K] bool: which assignments survive their group's capacity."""
    keep = torch.ones(ids.shape, dtype=torch.bool, device=ids.device)
    for s, e in groups:
        T = e - s
        C = max(int(T * top_k / n_experts * CAPACITY_FACTOR + 0.999), top_k)
        onehot = torch.zeros((T, n_experts), dtype=torch.int64,
                             device=ids.device)
        onehot.scatter_(1, ids[s:e], 1)
        earlier = torch.cumsum(onehot, 0) - onehot    # earlier tokens per e
        keep[s:e] = torch.gather(earlier, 1, ids[s:e]) < C
    return keep


def ffn(m: Dict, weights: Dict, layer: int, h: torch.Tensor, spans: List,
        quant: Optional[str]) -> torch.Tensor:
    E, K = m["n_experts"], m["top_k"]
    w = common.layer_weights(weights, layer, ("router", "wg", "wu", "wd"),
                             quant, group="moe")
    a = common.act(h, quant)
    probs = torch.softmax(a @ w["router"], dim=-1)
    gate, ids = torch.topk(probs, K, dim=-1)
    gate = gate / gate.sum(-1, keepdim=True).clamp(min=1e-9)
    # spans: per sequence, its capacity groups in its own positions
    groups, at = [], 0
    for size, seq_groups in spans:
        groups += [(at + s, at + e) for s, e in seq_groups]
        at += size
    keep = keep_mask(ids, E, K, groups)
    y = torch.zeros_like(h)
    for e in range(E):
        tok, slot = torch.nonzero((ids == e) & keep, as_tuple=True)
        if tok.numel() == 0:
            continue
        x = a[tok]
        out = common.act(F.silu(x @ w["wg"][e]) * (x @ w["wu"][e]),
                         quant) @ w["wd"][e]
        y.index_add_(0, tok, out * gate[tok, slot, None])
    return y


def forward(m: Dict, weights: Dict, seqs: List[torch.Tensor],
            n_prompt: List[int], spans: List, head,
            quant: Optional[str] = None) -> None:
    """See ``common.forward``. ``spans[i]`` is (len(seqs[i]), the capacity
    groups of sequence i as (start, end) positions)."""
    common.forward(m, weights, seqs, n_prompt, ffn, spans, head, quant)
