"""FLOPs a step of the model needs, from its shapes and the keys each
query attends: a multiply-add is 2 FLOPs; the embedding lookup, norms,
activations and softmax are not counted; an MoE token counts its router
and its top-k experts only; a prefill or chunk computes the LM head for
its last position only, a decode step for every row."""
from __future__ import annotations

from typing import Dict, Sequence


def token_params(m: Dict) -> int:
    """Weights one token multiplies through in the layers (LM head
    apart)."""
    D, F, hd = m["d_model"], m["d_ff"], m["head_dim"]
    attn = D * m["n_heads"] * hd * 2 + D * m["n_kv_heads"] * hd * 2
    if m["block_kind"] == "moe":
        ffn = D * m["n_experts"] + m["top_k"] * 3 * D * F
    else:
        ffn = 3 * D * F
    return m["n_layers"] * (attn + ffn)


def head_params(m: Dict) -> int:
    return m["d_model"] * m["vocab_size"]


def attn_flops(m: Dict, keys: int) -> int:
    """QK and PV of one query over ``keys`` keys, every layer and head."""
    return 4 * m["head_dim"] * m["n_heads"] * m["n_layers"] * keys


def decode(m: Dict, keys: Sequence[int]) -> int:
    """One decode step; ``keys[r]`` is row r's keys, its new token's
    included."""
    per = 2 * (token_params(m) + head_params(m))
    return sum(per + attn_flops(m, k) for k in keys)


def chunk(m: Dict, start: int, n: int) -> int:
    """``n`` prompt tokens after ``start`` cached ones (a whole prompt:
    start 0); causal, so query i sees start + i + 1 keys."""
    keys = n * start + n * (n + 1) // 2
    return 2 * token_params(m) * n + 2 * head_params(m) + attn_flops(m, keys)
