"""Plain PyTorch versions of the hand-written kernels (same contracts).

They are what ``kernels.ops`` runs for CPU tensors, and what
``chip_smoke.py`` holds each kernel against on the card. They share the
model's layer code, as the JAX package's oracles do (``repro.kernels.ref``).
The SSD versions call ``models.ssm`` at call time (that module imports
``kernels.ops``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import (NEG_INF, attention, band_mask,
                                       chunk_decode_attention,
                                       decode_attention, gather_pages,
                                       paged_kv_positions, rms_norm,
                                       rope_rotate, silu_mul)
from repro_torch.models.layers import paged_decode_attention as _paged
from repro_torch.models.layers import paged_verify_attention as _verify


def decode_attention_ref(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, kv_pos: torch.Tensor,
                         q_pos: torch.Tensor, window: Optional[int] = None,
                         return_lse: bool = False):
    """Same contract as csrc/decode_attention.cu: one query token per row
    over a ring cache. q [B,Hq,hd], k/v_cache [B,Hkv,S,hd], kv_pos [B,S]
    int32 (-1 empty), q_pos [B] int32 -> [B,Hq,hd]; keys kept where
    0 <= kv_pos <= q_pos (and q_pos - kv_pos < window). A row with nothing
    live averages every slot here (the kernel gives 0): callers ignore
    such rows. With ``return_lse``, (out, each row's log-sum-exp f32
    [B,Hq], -1e30 for a row that keeps nothing, as the kernel writes)."""
    return decode_attention(q, k_cache, v_cache, kv_pos, q_pos, window,
                            return_lse)


def decode_attention_split_ref(q: torch.Tensor, k_cache: torch.Tensor,
                               v_cache: torch.Tensor, kv_pos: torch.Tensor,
                               q_pos: torch.Tensor, window: Optional[int],
                               slots_per_split: int) -> torch.Tensor:
    """The split-and-combine form of csrc/decode_attention.cu, in fp32,
    for the tests: it pins the rule the CUDA combine pass implements.
    Inputs as ``decode_attention_ref``. Split s covers slots
    s*sps..(s+1)*sps-1, in slot order: a ring keeps position p in slot
    p % S, so no split can be skipped by position and the combine reads
    every split. A split gives each row (m, l, acc) over the slots it
    keeps: m = -1e30, l = 0 where it keeps none, and then its acc is
    never read (l = 0 is the flag). The splits are merged in one online
    log-sum-exp pass, as the combine kernel does; the row's output is
    O / max(L, 1e-30), so a row with nothing live gives exact 0 (the
    unsplit plain version averages every slot there)."""
    B, Hq, hd = q.shape
    Hkv, S = k_cache.shape[1], k_cache.shape[2]
    g = Hq // Hkv
    qg = q.float().reshape(B, Hkv, g, hd)
    sc = torch.einsum("bhgd,bhsd->bhgs", qg, k_cache.float()) * hd ** -0.5
    keep = (kv_pos >= 0) & (kv_pos <= q_pos[:, None])
    if window is not None:
        keep &= q_pos[:, None] - kv_pos < window
    keep = keep[:, None, None, :]
    M = torch.full((B, Hkv, g), NEG_INF, device=q.device)
    L = torch.zeros((B, Hkv, g), device=q.device)
    O = torch.zeros((B, Hkv, g, hd), device=q.device)
    for s0 in range(0, S, slots_per_split):
        cut = slice(s0, s0 + slots_per_split)
        kp = keep[..., cut]
        m = torch.where(kp, sc[..., cut], NEG_INF).amax(-1)
        p = torch.where(kp, torch.exp(sc[..., cut] - m[..., None]), 0.0)
        l = p.sum(-1)
        acc = torch.einsum("bhgs,bhsd->bhgd", p, v_cache[:, :, cut].float())
        acc = torch.where((l > 0)[..., None], acc, 0.0)
        m_new = torch.maximum(M, m)
        c, w = torch.exp(M - m_new), torch.exp(m - m_new)
        L = L * c + l * w
        O = O * c[..., None] + acc * w[..., None]
        M = m_new
    return (O / L.clamp(min=1e-30)[..., None]).reshape(B, Hq, hd)


def paged_decode_attention_ref(q: torch.Tensor, k_pages: torch.Tensor,
                               v_pages: torch.Tensor, page_table: torch.Tensor,
                               q_pos: torch.Tensor) -> torch.Tensor:
    """Same contract as csrc/paged_decode_attention.cu: gather each
    sequence's pages into a contiguous view, then plain decode attention
    over it. q [B,Hq,hd], k/v_pages [P,Hkv,psz,hd], page_table [B,maxp]
    int32 (-1 unused), q_pos [B] int32 -> [B,Hq,hd]."""
    return _paged(q, k_pages, v_pages, page_table, q_pos)


def paged_verify_attention_ref(q: torch.Tensor, k_pages: torch.Tensor,
                               v_pages: torch.Tensor, page_table: torch.Tensor,
                               q_start: torch.Tensor) -> torch.Tensor:
    """Same contract as the verify entry point of
    csrc/paged_decode_attention.cu: C queries per sequence at positions
    q_start[b]+i over the gathered page view, query i keeping positions
    0..q_start[b]+i. q [B,C,Hq,hd], k/v_pages [P,Hkv,psz,hd], page_table
    [B,maxp] int32 (-1 unused), q_start [B] int32 -> [B,C,Hq,hd]."""
    return _verify(q, k_pages, v_pages, page_table, q_start)


def paged_attention_split_ref(q: torch.Tensor, k_pages: torch.Tensor,
                              v_pages: torch.Tensor, page_table: torch.Tensor,
                              q_start: torch.Tensor,
                              pages_per_split: int) -> torch.Tensor:
    """The split-and-combine form of csrc/paged_decode_attention.cu, in
    fp32, for the tests: it pins the merge rule the CUDA combine pass
    implements. q [B,C,Hq,hd] (decode: C = 1), pages, table and q_start
    as ``paged_verify_attention_ref``. Split s covers the table's pages
    s*pps..(s+1)*pps-1 and gives each row (m, l, acc) over the keys it
    keeps there: m = -1e30, l = 0, acc = 0 where it keeps none, and a
    split whose first position lies past the row's position is not read
    at all. The row's output is sum_s acc_s e^(m_s - M) / max(L, 1e-30),
    M = max_s m_s, L = sum_s l_s e^(m_s - M): a row with no live key gives
    exact 0 (the unsplit plain version averages page 0 there)."""
    B, C, Hq, hd = q.shape
    _, Hkv, psz, _ = k_pages.shape
    maxp = page_table.shape[1]
    g = Hq // Hkv
    kc = gather_pages(k_pages, page_table).float()      # [B,Hkv,S,hd]
    vc = gather_pages(v_pages, page_table).float()
    kv_pos = paged_kv_positions(page_table, psz)        # [B,S]
    q_pos = q_start[:, None] + torch.arange(C, device=q.device)     # [B,C]
    qg = q.float().reshape(B, C, Hkv, g, hd)
    sc = torch.einsum("bchgd,bhsd->bhcgs", qg, kc) * hd ** -0.5
    keep = ((kv_pos[:, None, :] >= 0)
            & (kv_pos[:, None, :] <= q_pos[:, :, None]))[:, None, :, None]
    span = pages_per_split * psz
    ms, ls, accs = [], [], []
    for s0 in range(0, maxp * psz, span):
        cut = slice(s0, s0 + span)
        kp = keep[..., cut]
        m = torch.where(kp, sc[..., cut], NEG_INF).amax(-1)   # [B,Hkv,C,g]
        p = torch.where(kp, torch.exp(sc[..., cut] - m[..., None]), 0.0)
        read = (s0 <= q_pos)[:, None, :, None]                # [B,1,C,1]
        ms.append(torch.where(read, m, NEG_INF))
        ls.append(torch.where(read, p.sum(-1), 0.0))
        accs.append(torch.where(read[..., None], torch.einsum(
            "bhcgs,bhsd->bhcgd", p, vc[:, :, cut]), 0.0))
    m_all = torch.stack(ms)
    w = torch.exp(m_all - m_all.amax(0))
    den = (torch.stack(ls) * w).sum(0).clamp(min=1e-30)
    out = (torch.stack(accs) * w[..., None]).sum(0) / den[..., None]
    return out.permute(0, 2, 1, 3, 4).reshape(B, C, Hq, hd)


def flash_prefill_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool = True,
                      window: Optional[int] = None) -> torch.Tensor:
    """Same contract as csrc/flash_prefill.cu: q [B,S,Hq,hd], k/v
    [B,S,Hkv,hd] -> [B,S,Hq,hd] under the band mask of absolute positions
    0..S-1 (causal and/or sliding window, or none)."""
    S = q.shape[1]
    pos = torch.arange(S, device=q.device)
    return attention(q, k, v, band_mask(pos, pos, causal, window))


def flash_prefill_chunk_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, q_start: torch.Tensor,
                            window: Optional[int] = None) -> torch.Tensor:
    """Same contract as the chunk entry point of csrc/flash_prefill.cu:
    chunk queries q [B,C,Hq,hd] at absolute positions q_start[b]+i over
    the whole KV buffer k/v [B,S,Hkv,hd] (key j at position j), causal and
    within ``window`` when given, so stale data past the chunk end is
    masked -> [B,C,Hq,hd]. k/v may be strided views."""
    B, C = q.shape[:2]
    S = k.shape[1]
    q_pos = q_start[:, None] + torch.arange(C, device=q.device)
    kv_pos = torch.arange(S, device=q.device).expand(B, S)
    return chunk_decode_attention(q, k.transpose(1, 2), v.transpose(1, 2),
                                  kv_pos, q_pos, window)


def ssd_scan_ref(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                 b: torch.Tensor, c: torch.Tensor, d_skip: torch.Tensor,
                 dt_bias: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Same contract as csrc/ssd_scan.cu: the Mamba2 SSD scan from a zero
    state, any T. x [B,T,H,P]; dt [B,T,H]; b,c [B,T,N]; a_log, d_skip,
    dt_bias [H] -> (y [B,T,H,P] in x's type, final state [B,H,P,N] f32).
    The chunked dual form with 64-step chunks, T padded with dt = -1e9."""
    from repro_torch.models.ssm import ssd_chunked
    return ssd_chunked(x, dt, a_log, b, c, d_skip, dt_bias, chunk=64)


def ssd_scan_passes_ref(x: torch.Tensor, dt: torch.Tensor,
                        a_log: torch.Tensor, b: torch.Tensor,
                        c: torch.Tensor, d_skip: torch.Tensor,
                        dt_bias: torch.Tensor, chunk: int = 64
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The three passes of csrc/ssd_scan.cu written plainly, in fp32, for
    the tests. Inputs and outputs as ``ssd_scan_ref``. Within chunk n,
    dt_k = softplus(dt + bias) (0 for rows past T, as the kernel does) and
    cum the in-chunk cumulative sum of dt_k A.
    1. Chunk states: S_n = sum_k exp(cum_last - cum_k) dt_k x_k B_k^T, the
       state chunk n adds from a zero start, and its decay exp(cum_last).
    2. State passing, over the chunks in order: h_in(n) is the state
       entering chunk n, h_in(n+1) = decay_n h_in(n) + S_n; the last is
       the final state.
    3. Chunk outputs: y_q = sum_{k<=q} (C_q . B_k) exp(cum_q - cum_k) dt_k
       x_k + exp(cum_q) C_q h_in(n) + D x_q, the decay masked before exp.
    """
    B, T, H, P = x.shape
    N = b.shape[-1]
    nc = -(-T // chunk)
    pad = nc * chunk - T
    f32 = torch.float32
    A = -torch.exp(a_log.to(f32))                              # [H]
    dtp = torch.logaddexp(dt.to(f32) + dt_bias.to(f32),
                          torch.zeros((), dtype=f32, device=x.device))
    dtq = F.pad(dtp, (0, 0, 0, pad)).reshape(B, nc, chunk, H)
    xq = F.pad(x.to(f32), (0, 0, 0, 0, 0, pad)).reshape(B, nc, chunk, H, P)
    bq = F.pad(b.to(f32), (0, 0, 0, pad)).reshape(B, nc, chunk, N)
    cq = F.pad(c.to(f32), (0, 0, 0, pad)).reshape(B, nc, chunk, N)
    cum = torch.cumsum(dtq * A, dim=2)                         # [B,nc,Q,H]
    last = cum[:, :, -1]                                       # [B,nc,H]
    # 1. chunk states and decays
    w = dtq * torch.exp(last[:, :, None] - cum)
    states = torch.einsum("bnkh,bnkhp,bnks->bnhps", w, xq, bq)
    decay = torch.exp(last)
    # 2. state passing
    h = torch.zeros((B, H, P, N), dtype=f32, device=x.device)
    h_in = []
    for n in range(nc):
        h_in.append(h)
        h = decay[:, n, :, None, None] * h + states[:, n]
    h_in = torch.stack(h_in, dim=1)                            # [B,nc,H,P,N]
    # 3. chunk outputs
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]        # [B,nc,q,k,H]
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                   device=x.device))
    seg = torch.where(causal[None, None, :, :, None], seg, float("-inf"))
    att = (torch.einsum("bnqs,bnks->bnqk", cq, bq)[..., None]
           * torch.exp(seg) * dtq[:, :, None])                 # [B,nc,q,k,H]
    y = torch.einsum("bnqkh,bnkhp->bnqhp", att, xq)
    y = y + torch.exp(cum)[..., None] * torch.einsum("bnqs,bnhps->bnqhp",
                                                     cq, h_in)
    y = y + xq * d_skip.to(f32)[:, None]
    return y.reshape(B, nc * chunk, H, P)[:, :T].to(x.dtype), h


def ssd_decode_step_ref(x: torch.Tensor, dt: torch.Tensor,
                        a_log: torch.Tensor, b: torch.Tensor,
                        c: torch.Tensor, d_skip: torch.Tensor,
                        dt_bias: torch.Tensor, state: torch.Tensor,
                        slots: torch.Tensor,
                        active: torch.Tensor) -> torch.Tensor:
    """Same contract as csrc/ssd_decode.cu: one SSD recurrence step of B
    rows over a state arena, in place. x [B,H,P]; dt [B,H]; b,c [B,N];
    a_log, d_skip, dt_bias [H]; state [S,H,P,N] f32; slots [B] int32;
    active [B] bool. Row b gathers state[slots[b]], steps it
    (``models.ssm.ssd_step``) and, when active and slots[b] >= 0, writes
    h' back. Returns y [B,H,P] in x's type, 0 for rows with slot -1."""
    from repro_torch.models.ssm import ssd_step
    live = slots >= 0
    rd = slots.long().clamp(min=0)
    y, h_new = ssd_step(x, dt, a_log, b, c, d_skip, dt_bias, state[rd])
    # every row stores into the slot it read, so nothing is selected on
    # the host: the value is that of the slot's writer (live rows' slots
    # are distinct, so there is at most one), else the slot's own state,
    # and rows that share a slot store the same value
    S = state.shape[0]
    owner = torch.full((S + 1,), -1, dtype=torch.long, device=state.device)
    owner.scatter_(0, torch.where(active & live, rd, S),
                   torch.arange(rd.shape[0], device=state.device))
    o = owner[rd]
    state[rd] = torch.where((o >= 0)[:, None, None, None],
                            h_new[o.clamp(min=0)], state[rd])
    return y * live[:, None, None]


def moe_grouped_ffn_ref(buf: torch.Tensor, wg: torch.Tensor,
                        wu: torch.Tensor, wd: torch.Tensor,
                        counts: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Same contract as csrc/moe_grouped_ffn.cu: per-group gated MLP
    silu(x Wg) * (x Wu) Wd over a dispatched buffer, f32 inside. buf
    [G,C,D] with G a multiple of E, group g using expert g mod E; wg/wu
    [E,D,F]; wd [E,F,D]; counts [G] int32 live rows per group (None: all
    C) -> [G,C,D] in buf's type, rows at or past a group's count zero.
    Zero rows give zero rows."""
    E = wg.shape[0]
    G, C, D = buf.shape
    x = buf.reshape(G // E, E, C, D).float()
    h = torch.einsum("gecd,edf->gecf", x, wg.float())
    h = F.silu(h) * torch.einsum("gecd,edf->gecf", x, wu.float())
    out = torch.einsum("gecf,efd->gecd", h, wd.float()).reshape(G, C, D)
    if counts is not None:
        live = torch.arange(C, device=buf.device) < counts[:, None]
        out = torch.where(live[..., None], out, torch.zeros_like(out))
    return out.to(buf.dtype)


def add_rms_norm_ref(x: torch.Tensor, delta: Optional[torch.Tensor],
                     w: torch.Tensor, eps: float
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Same contract as the add_rms_norm entry of csrc/decode_fused.cu:
    x [..., D] += delta in place (None: x unchanged), then (x, its RMSNorm
    with weight w [D]): the decode step's ``x = x + mix`` followed by
    ``layers.rms_norm``, rounding for rounding."""
    if delta is not None:
        x.add_(delta)
    return x, rms_norm(x, w, eps)


def rope_kv_write_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      q_pos: torch.Tensor, freqs: torch.Tensor,
                      k_pages: torch.Tensor, v_pages: torch.Tensor,
                      w_page: torch.Tensor, w_off: torch.Tensor
                      ) -> torch.Tensor:
    """Same contract as the rope_kv_write entry of csrc/decode_fused.cu:
    q [B,Hq,hd] and k [B,Hkv,hd] rotated at q_pos [B] (``layers.
    rope_rotate`` over the table freqs [hd/2]); rotated k and v [B,Hkv,hd]
    written into one layer's k/v_pages [P,Hkv,psz,hd] at (w_page[b], :,
    w_off[b], :) (int64 [B]); returns rotated q."""
    pos = q_pos[:, None]
    q = rope_rotate(q[:, None], pos, freqs)[:, 0]
    k = rope_rotate(k[:, None], pos, freqs)[:, 0]
    k_pages[w_page, :, w_off] = k
    v_pages[w_page, :, w_off] = v
    return q


def silu_mul_ref(g: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Same contract as the silu_mul entry of csrc/decode_fused.cu:
    silu(g) * u, each op rounded to g's type (``layers.silu_mul``)."""
    return silu_mul(g, u)
