"""Mamba2 / SSD (state-space duality) mixer in PyTorch: the port of
``repro.models.ssm`` [arXiv:2405.21060].

Layout follows the Mamba2 block: in_proj -> (z, xBC, dt); causal depthwise
conv over xBC; SSD core (chunked dual form for prefill, recurrence for
decode); gated RMSNorm; out_proj. Single B/C group (G=1). Heads
H = d_inner / head_dim P; state size N.

Parameters are a dict with the names of the JAX ``SSMParams`` fields.
``ssd_chunked`` and ``ssd_step`` are the plain versions of the SSD core.
The serving paths go through ``kernels.ops`` (``ssd_scan`` for a prefill
without carried state, ``ssd_decode_step`` for the decode recurrence),
which launch the hand-written CUDA kernels on the card and run these plain
versions on the CPU; the training forward's ``ssm_mixer`` computes
``ssd_chunked`` (differentiable) unless asked for the kernel, as the JAX
mixer does. Softplus is ``torch.logaddexp(x, 0)``, as
``jax.nn.softplus`` computes it.

Unlike the JAX functions, ``ssm_mixer_step`` updates the state arenas it
is given in place, as the model's paged decode updates its KV pages.

Under ``models.partitioning.activation_partitioning`` with the SSM cut
by heads (``cut("ssm.out_proj")``; ``launch.sharding``'s serving
layout), ``ssm_mixer_with_state`` and ``ssm_mixer_step`` run on this
rank's heads: ``d_inner`` stays the whole width, the rank's width is
``norm_w``'s, its in_proj columns ``[z | x | B | C | dt]`` and conv
channels ``[x | B | C]`` are its heads' with the whole B and C, a_log,
d_skip and dt_bias are narrowed to its heads, the states are the rank's
heads, and the gated norm and out_proj's partial sum go through
``partitioning.rms_norm_out_model``. The training forward's
``ssm_mixer`` runs on a rank's heads the same way under a training
mesh (``training.trainer.make_train_step(mesh=...)``), its input entering
through ``partitioning.enter_model``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models import partitioning as P
from repro_torch.models.layers import rms_norm

SSMParams = Dict[str, torch.Tensor]


def param_shapes(d_model: int, d_inner: int, n_state: int, head_dim: int,
                 conv_k: int) -> Dict[str, tuple]:
    """Shape of each SSMParams field (one layer)."""
    H = d_inner // head_dim
    conv_dim = d_inner + 2 * n_state
    return {"in_proj": (d_model, 2 * d_inner + 2 * n_state + H),
            "conv_w": (conv_dim, conv_k), "conv_b": (conv_dim,),
            "a_log": (H,), "d_skip": (H,), "dt_bias": (H,),
            "norm_w": (d_inner,), "out_proj": (d_inner, d_model)}


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) as ``jax.nn.softplus`` computes it (no threshold
    branch, unlike ``F.softplus``)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _split_proj(zxbcdt: torch.Tensor, d_inner: int, n_state: int):
    z = zxbcdt[..., :d_inner]
    xbc = zxbcdt[..., d_inner:2 * d_inner + 2 * n_state]
    dt = zxbcdt[..., 2 * d_inner + 2 * n_state:]
    return z, xbc, dt


def _rank_heads(p: SSMParams, head_dim: int):
    """(the width of this rank's heads, their count, (a_log, d_skip,
    dt_bias) narrowed to them): every head without a cut."""
    di = p["norm_w"].shape[-1]
    H = di // head_dim
    prm = (p["a_log"], p["d_skip"], p["dt_bias"])
    if P.cut("ssm.out_proj"):
        prm = tuple(t.narrow(-1, P.model_index() * H, H) for t in prm)
    return di, H, prm


def _gated_out(p: SSMParams, y: torch.Tensor, z: torch.Tensor,
               d_inner: int) -> torch.Tensor:
    """rms_norm(y * silu(z), norm_w) @ out_proj over the whole d_inner:
    across the model axis where the heads are cut."""
    g = y * F.silu(z)
    if P.cut("ssm.out_proj"):
        return P.rms_norm_out_model(g, p["norm_w"], p["out_proj"], d_inner)
    return rms_norm(g, p["norm_w"]) @ p["out_proj"]


def causal_conv(xbc: torch.Tensor, w: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv via K shifted adds. xbc: [B,T,C], w: [C,K]."""
    K = w.shape[-1]
    T = xbc.shape[1]
    out = xbc * w[:, -1]
    for i in range(1, K):
        shifted = F.pad(xbc, (0, 0, i, 0))[:, :T]
        out = out + shifted * w[:, K - 1 - i]
    return F.silu(out + b)


def causal_conv_step(x: torch.Tensor, conv_state: torch.Tensor,
                     w: torch.Tensor, b: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decode step. x: [B,C]; conv_state: [B,C,K-1] (oldest first).
    Returns (y [B,C], conv_state' [B,C,K-1])."""
    window = torch.cat([conv_state, x[:, :, None]], dim=-1)    # [B,C,K]
    y = F.silu((window * w).sum(-1) + b)
    return y, window[:, :, 1:]


# ------------------------------------------------------------------ SSD core

def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                b: torch.Tensor, c: torch.Tensor, d_skip: torch.Tensor,
                dt_bias: torch.Tensor, chunk: int = 64,
                h0: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD, the plain version. x: [B,T,H,P]; dt: [B,T,H]; b,c:
    [B,T,N]; h0: [B,H,P,N] state entering the sequence (zeros when None).
    Returns (y [B,T,H,P] in x's type, final_state [B,H,P,N] f32).

    Dual form: within a chunk the recurrence is computed as masked
    (quasi-attention) matmuls; across chunks a loop carries the state. T is
    padded to a chunk multiple with dt = -1e9, so softplus(dt + bias) ~ 0
    and padded steps neither decay the state nor feed it."""
    B, T, H, P = x.shape
    N = b.shape[-1]
    pad = (-T) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad), value=-1e9)
        b = F.pad(b, (0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, pad))
    Tp = T + pad
    nc = Tp // chunk
    f32 = torch.float32
    A = -torch.exp(a_log.to(f32))                              # [H]
    dt = softplus(dt.to(f32) + dt_bias)                        # [B,Tp,H]
    xq = x.reshape(B, nc, chunk, H, P).to(f32)
    dtq = dt.reshape(B, nc, chunk, H)
    bq = b.reshape(B, nc, chunk, N).to(f32)
    cq = c.reshape(B, nc, chunk, N).to(f32)

    dA = dtq * A                                               # [B,nc,q,H]
    cum = torch.cumsum(dA, dim=2)
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]        # [B,nc,q,k,H]
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=x.device))
    # mask BEFORE exp: masked (q<k) entries have seg>0 and would overflow
    seg = torch.where(mask[None, None, :, :, None], seg,
                      torch.tensor(float("-inf"), device=x.device))
    L = torch.exp(seg)
    cb = torch.einsum("bnqs,bnks->bnqk", cq, bq)               # [B,nc,q,k]
    att = cb[..., None] * L                                    # [B,nc,q,k,H]
    xdt = xq * dtq[..., None]                                  # [B,nc,k,H,P]
    y_intra = torch.einsum("bnqkh,bnkhp->bnqhp", att, xdt)
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)          # [B,nc,q,H]
    states = torch.einsum("bnks,bnkh,bnkhp->bnhps", bq, dtq * decay_to_end,
                          xq)
    chunk_decay = torch.exp(dA.sum(dim=2))                     # [B,nc,H]
    h = (torch.zeros((B, H, P, N), dtype=f32, device=x.device) if h0 is None
         else h0.to(f32))
    h_prev = []
    for n in range(nc):                     # emit the state BEFORE chunk n
        h_prev.append(h)
        h = h * chunk_decay[:, n, :, None, None] + states[:, n]
    h_prev = torch.stack(h_prev, dim=1)                        # [B,nc,H,P,N]
    decay_in = torch.exp(cum)                                  # [B,nc,q,H]
    y_inter = torch.einsum("bnqs,bnqh,bnhps->bnqhp", cq, decay_in, h_prev)
    y = (y_intra + y_inter).reshape(B, Tp, H, P)
    y = y + xq.reshape(B, Tp, H, P) * d_skip[None, None, :, None]
    return y[:, :T].to(x.dtype), h


def ssd_step(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor, d_skip: torch.Tensor,
             dt_bias: torch.Tensor, h: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-token recurrence, the plain version. x: [B,H,P]; dt: [B,H];
    b,c: [B,N]; h: [B,H,P,N] -> (y [B,H,P] in x's type, h' f32)."""
    f32 = torch.float32
    A = -torch.exp(a_log.to(f32))
    dt = softplus(dt.to(f32) + dt_bias)                        # [B,H]
    g = torch.exp(dt * A)                                      # [B,H]
    xf = x.to(f32)
    h_new = h * g[..., None, None] + torch.einsum(
        "bhp,bn,bh->bhpn", xf, b.to(f32), dt)
    y = torch.einsum("bhpn,bn->bhp", h_new, c.to(f32))
    y = y + xf * d_skip[None, :, None]
    return y.to(x.dtype), h_new


# ------------------------------------------------------------------ block

def ssm_mixer(p: SSMParams, x: torch.Tensor, d_inner: int, n_state: int,
              head_dim: int, chunk: int = 64,
              use_kernel: bool = False) -> torch.Tensor:
    """Full-sequence mixer without state I/O (training, encoding). x:
    [B,T,D] -> y [B,T,D]. By default the SSD core is ``ssd_chunked``, so
    autograd reaches every parameter; ``use_kernel`` sends it through
    ``ops.ssd_scan`` (forward only: the wrapper refuses inputs that
    require grad under autograd)."""
    y, _, _ = ssm_mixer_with_state(p, x, d_inner, n_state, head_dim,
                                   chunk=chunk, use_kernel=use_kernel)
    return y


def ssm_mixer_with_state(p: SSMParams, x: torch.Tensor, d_inner: int,
                         n_state: int, head_dim: int, chunk: int = 64,
                         h0: Optional[torch.Tensor] = None,
                         conv0: Optional[torch.Tensor] = None,
                         use_kernel: bool = True):
    """Full-sequence mixer. x: [B,T,D]. Returns (y [B,T,D], final ssm
    state [B,H,P,N] f32, final conv state [B,C,K-1]).

    ``h0``/``conv0`` carry state in from an earlier piece of the sequence
    (``conv0`` the [B,C,K-1] raw-input conv tail, ``h0`` the [B,H,P,N] SSD
    state). With ``use_kernel`` (the serving default) and without ``h0``
    the SSD core runs through ``ops.ssd_scan`` (the kernel on the card,
    ``ssd_chunked`` on the CPU), as the JAX mixer runs its kernel only
    then; otherwise it runs the plain ``ssd_chunked``."""
    B, T, D = x.shape
    di, H, (a_log, d_skip, dt_bias) = _rank_heads(p, head_dim)
    K = p["conv_w"].shape[-1]
    zxbcdt = x @ p["in_proj"]
    z, xbc, dt = _split_proj(zxbcdt, di, n_state)
    if conv0 is not None:
        # prepend the carried raw-input tail, convolve, drop the warm-up
        # rows: position 0 then sees the history of one unchunked call
        xbc_ext = torch.cat([conv0.transpose(1, 2), xbc], dim=1)
        xbc_conv = causal_conv(xbc_ext, p["conv_w"], p["conv_b"])[:, K - 1:]
    else:
        xbc_ext = xbc
        xbc_conv = causal_conv(xbc, p["conv_w"], p["conv_b"])
    xs = xbc_conv[..., :di]
    b = xbc_conv[..., di:di + n_state]
    c = xbc_conv[..., di + n_state:]
    xh = xs.reshape(B, T, H, head_dim)              # a view: strides kept
    args = (xh, dt, a_log, b, c, d_skip, dt_bias)
    if use_kernel and h0 is None:
        y, h_last = ops.ssd_scan(*args)
    else:
        y, h_last = ssd_chunked(*args, chunk=chunk, h0=h0)
    y = _gated_out(p, y.reshape(B, T, di), z, d_inner)
    # conv state = last K-1 raw (pre-conv) inputs, left-padded with zeros
    # when the sequence (with any carried history) is shorter than K-1
    pad = max(K - 1 - xbc_ext.shape[1], 0)
    tail = F.pad(xbc_ext, (0, 0, pad, 0))[:, -(K - 1):]
    conv_state = tail.transpose(1, 2)                          # [B,C,K-1]
    return y, h_last, conv_state


def write_slots(slots: torch.Tensor, active: torch.Tensor,
                spare: int) -> torch.Tensor:
    """[B] int64: the state-arena slot each row of a decode step writes its
    conv tail to: its own for rows that are active with a slot, the
    arena's ``spare`` slot for the rest (inactive rows, slot -1), so every
    row writes and nothing is selected on the host."""
    return torch.where(active & (slots >= 0), slots, spare).long()


def ssm_mixer_step(p: SSMParams, x: torch.Tensor, d_inner: int, n_state: int,
                   head_dim: int, ssm_state: torch.Tensor,
                   conv_state: torch.Tensor, slots: torch.Tensor,
                   active: torch.Tensor,
                   write_to: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One decode step over state arenas, in place. x: [B,D]; ssm_state
    [S,H,P,N] f32 and conv_state [S,C,K-1] arenas; row b reads slot
    ``slots[b]`` ([B] int32). Rows that are inactive ([B] bool
    ``active``) or whose slot is -1 leave every owned slot as it was; a
    slot -1 row's output is garbage to be ignored. ``write_to``
    (``write_slots``, found once by a caller stepping many layers) is
    where each row's conv tail goes: its own slot, or the arena's spare.
    Without ``write_to`` every row owns a distinct slot >= 0 (the slot
    cache, row b at slot b) and writes its conv tail there, an inactive
    row its old tail back. The SSD recurrence runs through
    ``ops.ssd_decode_step``, which gathers, steps and writes back the
    slots itself. No host sync. Returns y [B,D]."""
    B, D = x.shape
    di, H, (a_log, d_skip, dt_bias) = _rank_heads(p, head_dim)
    zxbcdt = x @ p["in_proj"]
    z, xbc, dt = _split_proj(zxbcdt, di, n_state)
    rd = slots.long().clamp(min=0)
    conv_old = conv_state[rd]
    xbc_c, conv_new = causal_conv_step(xbc, conv_old, p["conv_w"],
                                       p["conv_b"])
    # the conv tail is kept in the arena's type, as JAX casts it
    conv_new = conv_new.to(conv_state.dtype)
    if write_to is None:
        conv_state[rd] = torch.where(active[:, None, None], conv_new,
                                     conv_old)
    else:
        conv_state[write_to] = conv_new
    xs = xbc_c[:, :di].reshape(B, H, head_dim)
    b = xbc_c[:, di:di + n_state]
    c = xbc_c[:, di + n_state:]
    y = ops.ssd_decode_step(xs, dt, a_log, b, c, d_skip, dt_bias, ssm_state,
                            slots, active)
    return _gated_out(p, y.reshape(B, di), z, d_inner)
