"""Random weights from the run's seed, made on the device in one draw.

The layout is the one the port's engines take (``PagedTorchExecutor(
params=...)``): ``x @ W`` with ``W [in, out]``, each layer's matrices
stacked over a leading layer axis, MoE weights under ``blocks["moe"]``.
Scales follow the port's own init (normal * D^-0.5; ``wo`` by q_dim^-0.5,
``wd`` by d_ff^-0.5), except that the norm weights are drawn too
(normal * 0.1, where the port zeros them) so that their ``1 + w`` is
exercised. One ``torch.randn`` over a flat buffer in the served type
makes every leaf; each leaf is a view of it, scaled in place. The same
seed gives the same weights on every call, so the reference remakes them
after the program is gone instead of taking the program's.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

NORM_SCALE = 0.1


def padded_vocab(vocab: int) -> int:
    """The port's padding of an odd vocabulary to a multiple of 2048
    (``ArchConfig.padded_vocab``); the pad rows are never read."""
    return vocab if vocab % 16 == 0 else -(-vocab // 2048) * 2048


def leaves(m: Dict) -> List[Tuple[str, Tuple[int, ...], float]]:
    """(path, shape, scale) of every weight of the model dims ``m`` (a
    configuration file's ``port`` block)."""
    L, D, F = m["n_layers"], m["d_model"], m["d_ff"]
    q, kv = m["n_heads"] * m["head_dim"], m["n_kv_heads"] * m["head_dim"]
    V = padded_vocab(m["vocab_size"])
    out = [("embed", (V, D), D ** -0.5), ("lm_head", (D, V), D ** -0.5),
           ("final_norm", (D,), NORM_SCALE),
           ("blocks.ln1", (L, D), NORM_SCALE), ("blocks.ln2", (L, D), NORM_SCALE),
           ("blocks.wq", (L, D, q), D ** -0.5),
           ("blocks.wk", (L, D, kv), D ** -0.5),
           ("blocks.wv", (L, D, kv), D ** -0.5),
           ("blocks.wo", (L, q, D), q ** -0.5)]
    if m["block_kind"] == "moe":
        E = m["n_experts"]
        out += [("blocks.moe.router", (L, D, E), D ** -0.5),
                ("blocks.moe.wg", (L, E, D, F), D ** -0.5),
                ("blocks.moe.wu", (L, E, D, F), D ** -0.5),
                ("blocks.moe.wd", (L, E, F, D), F ** -0.5)]
    else:
        out += [("blocks.wg", (L, D, F), D ** -0.5),
                ("blocks.wu", (L, D, F), D ** -0.5),
                ("blocks.wd", (L, F, D), F ** -0.5)]
    return out


def n_params(m: Dict) -> int:
    return sum(int(torch.Size(s).numel()) for _, s, _ in leaves(m))


def make(m: Dict, seed: int, device, dtype=torch.bfloat16) -> Dict:
    """The weights of seed ``seed``: a nested dict of views of one flat
    buffer drawn by a generator on ``device``."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    specs = leaves(m)
    flat = torch.randn(sum(int(torch.Size(s).numel()) for _, s, _ in specs),
                       generator=gen, device=device, dtype=dtype)
    params: Dict = {}
    at = 0
    for path, shape, scale in specs:
        n = int(torch.Size(shape).numel())
        leaf = flat[at:at + n].view(shape)
        leaf.mul_(scale)
        at += n
        node = params
        *heads, last = path.split(".")
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = leaf
    return params
