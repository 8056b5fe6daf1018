"""Layout of a model whose layers are all alike: GQA attention, then a
gated SiLU MLP or a routed MoE FFN whose router is as wide as the experts
held (``block_kind`` ``dense`` or ``moe``).

The tree is the one the port's engines take (``PagedTorchExecutor(
params=...)``): ``x @ W`` with ``W [in, out]``, each layer's matrices
stacked over a leading layer axis, MoE weights under ``blocks["moe"]``,
an untied LM head. Scales follow the port's own init (normal * D^-0.5;
``wo`` by q_dim^-0.5, ``wd`` by d_ff^-0.5), except that the norm weights
are drawn too (normal * 0.1, where the port zeros them) so that their
``1 + w`` is exercised. ``attn_leaves``, ``mlp_leaves`` and
``attn_params`` are shared with the layouts of other block kinds.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from servebench.harness.weights import NORM_SCALE, padded_vocab

BLOCK_KINDS = ("dense", "moe")
Leaves = List[Tuple[str, Tuple[int, ...], float]]


def attn_leaves(m: Dict) -> Leaves:
    """The attention projections ``wq``, ``wk``, ``wv``, ``wo``."""
    L, D = m["n_layers"], m["d_model"]
    q, kv = m["n_heads"] * m["head_dim"], m["n_kv_heads"] * m["head_dim"]
    return [("blocks.wq", (L, D, q), D ** -0.5),
            ("blocks.wk", (L, D, kv), D ** -0.5),
            ("blocks.wv", (L, D, kv), D ** -0.5),
            ("blocks.wo", (L, q, D), q ** -0.5)]


def mlp_leaves(m: Dict) -> Leaves:
    """The gated MLP's ``wg``, ``wu``, ``wd``."""
    L, D, F = m["n_layers"], m["d_model"], m["d_ff"]
    return [("blocks.wg", (L, D, F), D ** -0.5),
            ("blocks.wu", (L, D, F), D ** -0.5),
            ("blocks.wd", (L, F, D), F ** -0.5)]


def attn_params(m: Dict) -> int:
    """Weights of one layer's attention projections."""
    D, hd = m["d_model"], m["head_dim"]
    return D * m["n_heads"] * hd * 2 + D * m["n_kv_heads"] * hd * 2


def leaves(m: Dict) -> Leaves:
    """(path, shape, scale) of every weight of the model dims ``m`` (a
    configuration file's ``port`` block), in draw order."""
    L, D, F = m["n_layers"], m["d_model"], m["d_ff"]
    V = padded_vocab(m["vocab_size"])
    out = [("embed", (V, D), D ** -0.5), ("lm_head", (D, V), D ** -0.5),
           ("final_norm", (D,), NORM_SCALE),
           ("blocks.ln1", (L, D), NORM_SCALE), ("blocks.ln2", (L, D), NORM_SCALE),
           *attn_leaves(m)]
    if m["block_kind"] == "moe":
        E = m["n_experts"]
        out += [("blocks.moe.router", (L, D, E), D ** -0.5),
                ("blocks.moe.wg", (L, E, D, F), D ** -0.5),
                ("blocks.moe.wu", (L, E, D, F), D ** -0.5),
                ("blocks.moe.wd", (L, E, F, D), F ** -0.5)]
    else:
        out += mlp_leaves(m)
    return out


def token_params(m: Dict) -> int:
    """Weights one token multiplies through in the layers (LM head
    apart): every layer's attention projections, and its MLP or its
    router and top-k experts."""
    D, F = m["d_model"], m["d_ff"]
    if m["block_kind"] == "moe":
        ffn = D * m["n_experts"] + m["top_k"] * 3 * D * F
    else:
        ffn = 3 * D * F
    return m["n_layers"] * (attn_params(m) + ffn)


def attn_layers(m: Dict) -> int:
    """Every layer attends."""
    return m["n_layers"]


def recurrence_flops(m: Dict) -> int:
    """No work a token beyond its matrix products and attention."""
    return 0
