"""FLOPs a step of the model needs, from its shapes and the keys each
query attends: a multiply-add is 2 FLOPs; the embedding lookup, norms,
activations and softmax are not counted; an MoE token counts its router
and its top-k experts only; a prefill or chunk computes the LM head for
its last position only, a decode step for every row. The model's layout
(``layouts/<name>.py``) gives the weights a token multiplies through,
how many layers attend, and the work of a recurrence a token."""
from __future__ import annotations

from typing import Dict, Sequence

from servebench.harness import registry


def token_params(m: Dict) -> int:
    """Weights one token multiplies through in the layers (LM head
    apart)."""
    return registry.layout_of(m).token_params(m)


def head_params(m: Dict) -> int:
    return m["d_model"] * m["vocab_size"]


def attn_flops(m: Dict, keys: int) -> int:
    """QK and PV of one query over ``keys`` keys, every attending layer
    and head."""
    layers = registry.layout_of(m).attn_layers(m)
    return 4 * m["head_dim"] * m["n_heads"] * layers * keys


def decode(m: Dict, keys: Sequence[int]) -> int:
    """One decode step; ``keys[r]`` is row r's keys, its new token's
    included."""
    lay = registry.layout_of(m)
    per = 2 * (token_params(m) + head_params(m)) + lay.recurrence_flops(m)
    return sum(per + attn_flops(m, k) for k in keys)


def chunk(m: Dict, start: int, n: int) -> int:
    """``n`` prompt tokens after ``start`` cached ones (a whole prompt:
    start 0); causal, so query i sees start + i + 1 keys."""
    keys = n * start + n * (n + 1) // 2
    rec = registry.layout_of(m).recurrence_flops(m)
    return ((2 * token_params(m) + rec) * n + 2 * head_params(m)
            + attn_flops(m, keys))
