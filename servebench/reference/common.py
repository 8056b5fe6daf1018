"""The decoder both references share: embedding, pre-norm blocks of
GQA attention and a feed-forward part, final norm and LM head.

The block is the port's: RMSNorm scaling by ``1 + w``; rotary embedding
over the whole head, halves rotated against each other; causal softmax
attention in float32 at scale head_dim^-0.5, query head h reading KV
head h // (Hq / Hkv); residual adds; untied LM head over the first
``vocab_size`` rows. The whole sequence (prompt and served tokens) runs
at once, layer by layer over every sequence, so each layer's weights are
widened to float32 once; attention runs in blocks of queries.

``quant="fp8"`` is the control: the same arithmetic with every matmul
input (weights per output column, activations per row, and Q, K, V per
head) rounded to float8 e4m3 with a per-row scale first.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import torch

F32 = torch.float32
Q_BLOCK = 1024


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def q8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale per slice along
    ``dim`` (its largest magnitude maps to 448), back in float32."""
    s = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12) / 448.0
    return (x / s).to(torch.float8_e4m3fn).to(F32) * s


def wide(w: torch.Tensor, quant: Optional[str], dim: int = -2) -> torch.Tensor:
    """A weight in float32 (``x @ w``: ``dim`` is its input axis)."""
    w = w.to(F32)
    return q8(w, dim) if quant == "fp8" else w


def act(x: torch.Tensor, quant: Optional[str]) -> torch.Tensor:
    return q8(x, -1) if quant == "fp8" else x


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * (
        1.0 + w.to(F32))


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x [T, H, hd] at positions 0..T-1."""
    T, _, hd = x.shape
    freqs = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=F32,
                                         device=x.device) / hd)
    ang = torch.arange(T, dtype=F32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(m: Dict, lw: Dict, h: torch.Tensor,
              quant: Optional[str]) -> torch.Tensor:
    """Causal GQA self-attention of one sequence's normed input h [T, D]."""
    T = h.shape[0]
    hd, Hq, Hkv = m["head_dim"], m["n_heads"], m["n_kv_heads"]
    g = Hq // Hkv
    a = act(h, quant)
    q = rope((a @ lw["wq"]).view(T, Hq, hd), m["rope_theta"])
    k = rope((a @ lw["wk"]).view(T, Hkv, hd), m["rope_theta"])
    v = (a @ lw["wv"]).view(T, Hkv, hd)
    q, k, v = act(q, quant), act(k, quant), act(v, quant)
    q = q.view(T, Hkv, g, hd)
    pos = torch.arange(T, device=h.device)
    out = torch.empty((T, Hkv, g, hd), dtype=F32, device=h.device)
    for s in range(0, T, Q_BLOCK):
        e = min(T, s + Q_BLOCK)
        sc = torch.einsum("qhgd,khd->hgqk", q[s:e], k[:e]) * hd ** -0.5
        sc = sc.masked_fill(pos[None, :e] > pos[s:e, None], float("-inf"))
        p = torch.softmax(sc, dim=-1)
        out[s:e] = torch.einsum("hgqk,khd->qhgd", p, v[:e])
    return act(out.reshape(T, Hq * hd), quant) @ lw["wo"]


def layer_weights(weights: Dict, layer: int, names: Sequence[str],
                  quant: Optional[str], group: Optional[str] = None) -> Dict:
    src = weights["blocks"] if group is None else weights["blocks"][group]
    return {n: wide(src[n][layer], quant) for n in names}


FFN = Callable[[Dict, Dict, int, torch.Tensor, List, Optional[str]],
               torch.Tensor]


def forward(m: Dict, weights: Dict, seqs: List[torch.Tensor],
            n_prompt: List[int], ffn: FFN, spans: List,
            head: Callable[[int, torch.Tensor], None],
            quant: Optional[str] = None) -> None:
    """Run every sequence (token ids [T_i]) through the model and call
    ``head(i, logits)`` with the float32 logits [T_i - n_prompt_i + 1, V]
    of positions n_prompt_i - 1 .. T_i - 1: those that predicted each
    served token. ``ffn(m, weights, layer, h, spans, quant)`` is the
    feed-forward part over every sequence's normed rows at once (h
    [sum T_i, D]); ``spans`` passes through to it."""
    no_tf32()
    eps = m["norm_eps"]
    emb = weights["embed"]
    xs = [act(emb[s].to(F32), quant) for s in seqs]
    sizes = [x.shape[0] for x in xs]
    for layer in range(m["n_layers"]):
        lw = layer_weights(weights, layer, ("wq", "wk", "wv", "wo"), quant)
        ln1 = weights["blocks"]["ln1"][layer]
        for i, x in enumerate(xs):
            xs[i] = x + attention(m, lw, rms_norm(x, ln1, eps), quant)
        del lw
        x = torch.cat(xs)
        h = rms_norm(x, weights["blocks"]["ln2"][layer], eps)
        x = x + ffn(m, weights, layer, h, spans, quant)
        xs = list(torch.split(x, sizes))
    lm = wide(weights["lm_head"][:, : m["vocab_size"]], quant)
    for i, x in enumerate(xs):
        rows = rms_norm(x[n_prompt[i] - 1:], weights["final_norm"], eps)
        head(i, act(rows, quant) @ lm)
