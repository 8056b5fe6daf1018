"""Plain dense GQA decoder: ``common``'s block with a gated SiLU MLP,
``(silu(h @ wg) * (h @ wu)) @ wd``."""
from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from servebench.reference import common


def ffn(m: Dict, weights: Dict, layer: int, h: torch.Tensor, spans: List,
        quant: Optional[str]) -> torch.Tensor:
    w = common.layer_weights(weights, layer, ("wg", "wu", "wd"), quant)
    a = common.act(h, quant)
    return common.act(F.silu(a @ w["wg"]) * (a @ w["wu"]), quant) @ w["wd"]


def forward(m: Dict, weights: Dict, seqs: List[torch.Tensor],
            n_prompt: List[int], spans: List, head,
            quant: Optional[str] = None) -> None:
    """See ``common.forward``; ``spans`` is unused by a dense model."""
    common.forward(m, weights, seqs, n_prompt, ffn, spans, head, quant)
