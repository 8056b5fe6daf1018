"""Mixture-of-Experts FFN in PyTorch: the port of ``repro.models.moe``.

Top-k routing with sort-based capacity dispatch into a dense [E, C, D]
expert buffer. Parameters are a dict with the names of the JAX
``MoEParams`` fields (router [D,E], wg/wu [E,D,F], wd [E,F,D]).

The per-expert gated FFN of both grouped paths (``moe_ffn_grouped`` for
sequences, ``moe_ffn_grouped_decode`` for one token per row) runs through
``kernels.ops.moe_grouped_ffn`` when ``use_kernel`` (the serving
default): the hand-written CUDA kernel on the card, its plain version on
the CPU. With ``use_kernel=False`` (the training forward) it is the JAX
functions' three einsums over the same buffers, which autograd
differentiates. Dispatch and combine stay tensor code, as they are jnp
code outside the Pallas kernel in JAX.

Routing must agree with JAX bit for bit, so the argsort is stable
(``torch.argsort(..., stable=True)``, as ``jnp.argsort``) and segment
starts come from a left ``torch.searchsorted``: capacity drops in
``moe_ffn_grouped`` depend on each assignment's position after that sort.

Under a mesh (DESIGN.md §9) the grouped paths run on a rank's slab of
the experts (``launch.sharding.serving_cuts``). Expert-parallel, the
slab holds E_local of the E experts, from ``first_expert``: tokens are
replicated over 'model', so every rank routes them with the whole router
over all E and dispatches as the single device does (the capacity and the
drops from the global E), then runs the kernel on its experts' part of
the buffer only and combines the assignments to them; the others give 0.
Tensor-parallel inside each expert, the slab holds every expert's share
of the d_ff columns and the kernel runs with those columns. Either way
each rank's output is a partial sum, which the model sums over 'model'
after the combine (``partitioning.reduce_model``): one all-reduce a
layer, no all-to-all. With the whole experts (no mesh) the functions are
the single-device ones.

The grouped paths combine a token's K expert outputs without atomics:
the weighted outputs go back to (token, k) order through the sort's
permutation and are summed over k, where JAX scatter-adds them. The sum
is then the same on every run, on the card as on the CPU, so a step
captured as a CUDA graph can be held to its eager run bit for bit.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops

MoEParams = Dict[str, torch.Tensor]


def param_shapes(d_model: int, d_ff: int, n_experts: int) -> Dict[str, tuple]:
    """Shape of each MoEParams field (one layer)."""
    return {"router": (d_model, n_experts),
            "wg": (n_experts, d_model, d_ff), "wu": (n_experts, d_model, d_ff),
            "wd": (n_experts, d_ff, d_model)}


def route(router: torch.Tensor, x: torch.Tensor, top_k: int
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: [N,D] -> (weights [N,K] in x's type, expert_ids [N,K], aux_loss
    scalar f32, the Switch-style load-balance loss)."""
    logits = (x @ router).float()                       # [N,E]
    probs = torch.softmax(logits, dim=-1)
    w, ids = torch.topk(probs, top_k, dim=-1)
    w = w / w.sum(-1, keepdim=True).clamp(min=1e-9)
    E = router.shape[-1]
    me = probs.mean(0)
    ce = torch.zeros((E,), dtype=torch.float32, device=x.device)
    ce.index_add_(0, ids.reshape(-1),
                  torch.ones((ids.numel(),), device=x.device))
    ce = ce / ce.sum().clamp(min=1.0)
    aux = E * torch.sum(me * ce)
    return w.to(x.dtype), ids, aux


def _dispatch(e_flat: torch.Tensor, K: int, E: int):
    """Stable sort of a [G, M] block of expert ids: (order, sorted ids,
    token index, position of each assignment within its expert's
    segment, assignments per expert [G, E] int32). The counts are the
    differences of consecutive segment starts, the last segment ending at
    M: tensor ops only, no host sync."""
    order = torch.argsort(e_flat, dim=-1, stable=True)
    es = torch.gather(e_flat, -1, order)
    ts = order // K
    experts = torch.arange(E, device=e_flat.device).expand(e_flat.shape[0], E)
    seg_start = torch.searchsorted(es.contiguous(), experts.contiguous())
    pos = (torch.arange(es.shape[-1], device=es.device)
           - torch.gather(seg_start, -1, es))
    ends = torch.cat([seg_start[:, 1:],
                      torch.full_like(seg_start[:, :1], es.shape[-1])], 1)
    return order, es, ts, pos, (ends - seg_start).to(torch.int32)


def moe_ffn(p: MoEParams, x: torch.Tensor, top_k: int,
            capacity_factor: float = 1.25
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Global-argsort dispatch. x: [B,T,D] or [N,D] -> (y same shape,
    aux_loss). Assignments past an expert's capacity are dropped."""
    orig_shape = x.shape
    D = orig_shape[-1]
    x2 = x.reshape(-1, D)
    N = x2.shape[0]
    E, K = p["router"].shape[-1], top_k
    w, ids, aux = route(p["router"], x2, K)
    order, es, ts, pos, _ = _dispatch(ids.reshape(1, -1), K, E)
    es, ts, pos = es[0], ts[0], pos[0]
    ws = w.reshape(-1)[order[0]]
    C = max(int(N * K / E * capacity_factor + 0.999), K)
    keep = pos < C
    buf = torch.zeros((E, C, D), dtype=x.dtype, device=x.device)
    buf[es[keep], pos[keep]] = x2[ts[keep]]
    h = torch.einsum("ecd,edf->ecf", buf, p["wg"])
    h = F.silu(h) * torch.einsum("ecd,edf->ecf", buf, p["wu"])
    out = torch.einsum("ecf,efd->ecd", h, p["wd"])
    y_assign = out[es, pos.clamp(max=C - 1)] * keep[:, None]
    y = torch.zeros((N, D), dtype=x.dtype, device=x.device)
    y.index_add_(0, ts, y_assign * ws[:, None])
    return y.reshape(orig_shape), aux


def _experts(p: MoEParams, buf: torch.Tensor) -> torch.Tensor:
    """The gated expert FFN over per-example buffers [B,E,C,D], as the JAX
    functions' einsums compute it (expert e's weights on buf[:, e])."""
    h = torch.einsum("becd,edf->becf", buf, p["wg"])
    h = F.silu(h) * torch.einsum("becd,edf->becf", buf, p["wu"])
    return torch.einsum("becf,efd->becd", h, p["wd"])


def _local(es: torch.Tensor, p: MoEParams, first_expert: int):
    """(E_local, whether each sorted assignment's expert is one of the
    slab's, its index in the slab): the slab holds experts
    [first_expert, first_expert + E_local) of ``p``'s expert dim."""
    El = p["wg"].shape[0]
    le = es - first_expert
    return El, (le >= 0) & (le < El), le


def moe_ffn_grouped(p: MoEParams, x: torch.Tensor, top_k: int,
                    capacity_factor: float = 1.25, use_kernel: bool = True,
                    first_expert: int = 0
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batch-local dispatch: sort and scatter WITHIN each example
    (GShard-style groups), capacity C = max(int(T*K/E*cf + 0.999), K) per
    example; assignments past it are dropped. x: [B,T,D], T > 1. With
    ``use_kernel`` the per-example buffers [B,E,C,D] go through
    ``ops.moe_grouped_ffn`` as G = B*E groups in ONE launch, group g using
    expert g mod E, with each group's kept assignments (its count clamped
    to C) as its live rows; without, through the einsums of ``_experts``.
    On a slab of E_local experts from ``first_expert`` (E from the
    router, so the capacity and drops are the whole layer's), the buffers
    hold the slab's experts only, [B,E_local,C,D], and the result is the
    slab's share of the output."""
    B, T, D = x.shape
    E, K = p["router"].shape[-1], top_k
    w, ids, aux = route(p["router"], x.reshape(-1, D), K)
    C = max(int(T * K / E * capacity_factor + 0.999), K)
    order, es, ts, pos, counts = _dispatch(ids.reshape(B, T * K), K, E)
    ws = torch.gather(w.reshape(B, T * K), 1, order)
    El, mine, le = _local(es, p, first_expert)
    keep = (pos < C) & mine
    bi = torch.arange(B, device=x.device)[:, None]
    # row of each assignment in the flat [B*El*C] buffer; dropped ones, and
    # another slab's, go to one spare row past its end (JAX drops them
    # through an out-of-bounds index), so no boolean mask, and no host
    # sync, is needed
    row = torch.where(keep, (bi * El + le) * C + pos, B * El * C)
    buf = torch.zeros((B * El * C + 1, D), dtype=x.dtype, device=x.device)
    buf[row] = x[bi, ts]
    if use_kernel:
        live = counts[:, first_expert:first_expert + El].clamp(max=C)
        out = ops.moe_grouped_ffn(buf[:-1].view(B * El, C, D), p["wg"],
                                  p["wu"], p["wd"],
                                  live.reshape(B * El).contiguous())
    else:
        out = _experts(p, buf[:-1].view(B, El, C, D))
    out = out.reshape(B * El * C, D)
    y_assign = out[row.clamp(max=B * El * C - 1)] * keep[..., None]
    # back to (token, k) order: sorted assignment j is assignment order[j]
    y_tk = torch.empty_like(y_assign)
    y_tk[bi, order] = y_assign * ws[..., None]
    return y_tk.view(B, T, K, D).sum(2), aux


def moe_ffn_grouped_decode(p: MoEParams, x: torch.Tensor, top_k: int,
                           use_kernel: bool = True, first_expert: int = 0
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decode-step dispatch: ONE token per row ([B,D] or [B,1,D]), the whole
    batch one group with capacity C = B*K, so nothing is dropped and each
    expert sees only its routed rows. With ``use_kernel`` the expert FFN
    runs through ``ops.moe_grouped_ffn`` with each expert's routed rows as
    its live rows (at most B of its C), so empty experts read no weight;
    without, through the einsums of ``_experts``. On a slab of E_local
    experts from ``first_expert`` the buffer holds the slab's experts
    only, [E_local,C,D], and the result is the slab's share."""
    orig_shape = x.shape
    D = orig_shape[-1]
    x2 = x.reshape(-1, D)
    B = x2.shape[0]
    E, K = p["router"].shape[-1], top_k
    w, ids, aux = route(p["router"], x2, K)
    order, es, ts, pos, counts = _dispatch(ids.reshape(1, B * K), K, E)
    es, ts, pos = es[0], ts[0], pos[0]
    ws = w.reshape(-1)[order[0]]
    C = B * K                                            # lossless capacity
    El, mine, le = _local(es, p, first_expert)
    # another slab's assignments write, and read, a spare row past the end
    row = torch.where(mine, le * C + pos, El * C)
    buf = torch.zeros((El * C + 1, D), dtype=x.dtype, device=x.device)
    buf[row] = x2[ts]
    if use_kernel:
        out = ops.moe_grouped_ffn(buf[:-1].view(El, C, D), p["wg"], p["wu"],
                                  p["wd"],
                                  counts[0, first_expert:first_expert + El])
    else:
        out = _experts(p, buf[:-1].view(1, El, C, D))[0]
    y_assign = out.reshape(El * C, D)[row.clamp(max=El * C - 1)]
    # back to (token, k) order: sorted assignment j is assignment order[j]
    y_tk = torch.empty((B * K, D), dtype=x.dtype, device=x.device)
    y_tk[order[0]] = y_assign * (ws * mine)[:, None]
    return y_tk.view(B, K, D).sum(1).reshape(orig_shape), aux


def moe_ffn_dense(p: MoEParams, x: torch.Tensor, top_k: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Oracle: every expert over every token, combined with the top-k
    weights."""
    orig_shape = x.shape
    x2 = x.reshape(-1, orig_shape[-1])
    w, ids, aux = route(p["router"], x2, top_k)
    h = torch.einsum("nd,edf->enf", x2, p["wg"])
    h = F.silu(h) * torch.einsum("nd,edf->enf", x2, p["wu"])
    all_out = torch.einsum("enf,efd->end", h, p["wd"])   # [E,N,D]
    E = p["router"].shape[-1]
    onehot = F.one_hot(ids, E).to(x2.dtype)              # [N,K,E]
    comb = torch.einsum("nke,nk->en", onehot, w)
    y = torch.einsum("end,en->nd", all_out, comb)
    return y.reshape(orig_shape), aux
