"""Layout of a model whose every layer holds a Mamba-2 (SSD) mixer, with
GQA attention beside it where the model has attention heads (``block_kind``
``ssm``: mamba2-780m; ``hybrid``: hymba-1.5b, whose layers average the
two mixers' outputs), then a gated SiLU MLP where ``d_ff`` > 0.

The tree is the port's (``models.model.param_shapes``): ``embed``, an
``lm_head`` only where ``tied_embeddings`` is false, ``final_norm``, and
under ``blocks`` each leaf stacked over the layers: ``ln1``; ``wq``,
``wk``, ``wv``, ``wo`` where ``n_heads`` > 0; the mixer under ``ssm``:
``in_proj`` [D, 2 di + 2 N + H] (its columns z, x, B, C, dt), the
depthwise ``conv_w`` [di + 2 N, K] and ``conv_b`` over x, B and C,
``a_log``, ``d_skip``, ``dt_bias`` [H], the gated norm's ``norm_w`` [di]
and ``out_proj`` [di, D]; ``ln2``, ``wg``, ``wu``, ``wd`` where
``d_ff`` > 0. Here di = ssm_expand * D, H = di / ssm_head_dim, N =
ssm_state (one B/C group), K = ssm_conv; the port block states each of
these keys and ``tied_embeddings``.

Scales: the matrices as the port's init draws them (normal * D^-0.5;
``wo`` by q_dim^-0.5, ``wd`` by d_ff^-0.5, ``conv_w`` by K^-0.5,
``out_proj`` by di^-0.5); the norm weights (``1 + w``) and ``conv_b`` at
0.1; ``dt_bias`` at 0.1 as the port draws it; ``a_log`` and ``d_skip`` at
1, where the port sets log(1..16) and ones. Any draw keeps the recurrence
bounded: A = -exp(a_log) < 0 and dt = softplus(dt_raw + dt_bias) > 0, so
each step scales the state by exp(dt A), strictly between 0 and 1, and
adds dt x B of inputs that come from the normed residual through
``in_proj``, the convolution and SiLU; the state is a decaying sum, never
growing by more than one such term a token, and the gated RMSNorm
renormalises the readout before ``out_proj``. a_log's spread (A from
about -7 to -0.14 within two standard deviations) gives heads that forget
within a few tokens beside heads that carry the state for tens.
"""
from __future__ import annotations

from typing import Dict, Tuple

from servebench.harness.weights import NORM_SCALE, padded_vocab
from servebench.layouts.uniform import (Leaves, attn_leaves, attn_params,
                                        mlp_leaves)

BLOCK_KINDS = ("ssm", "hybrid")


def _ssm_dims(m: Dict) -> Tuple[int, int, int, int]:
    """(di, H, N, K) of the port block ``m``."""
    di = m["ssm_expand"] * m["d_model"]
    return di, di // m["ssm_head_dim"], m["ssm_state"], m["ssm_conv"]


def leaves(m: Dict) -> Leaves:
    """(path, shape, scale) of every weight of the port block ``m``, in
    draw order."""
    L, D, F = m["n_layers"], m["d_model"], m["d_ff"]
    di, H, N, K = _ssm_dims(m)
    V = padded_vocab(m["vocab_size"])
    out = [("embed", (V, D), D ** -0.5)]
    if not m["tied_embeddings"]:
        out.append(("lm_head", (D, V), D ** -0.5))
    out += [("final_norm", (D,), NORM_SCALE),
            ("blocks.ln1", (L, D), NORM_SCALE)]
    if m["n_heads"] > 0:
        out += attn_leaves(m)
    out += [("blocks.ssm.in_proj", (L, D, 2 * di + 2 * N + H), D ** -0.5),
            ("blocks.ssm.conv_w", (L, di + 2 * N, K), K ** -0.5),
            ("blocks.ssm.conv_b", (L, di + 2 * N), NORM_SCALE),
            ("blocks.ssm.a_log", (L, H), 1.0),
            ("blocks.ssm.d_skip", (L, H), 1.0),
            ("blocks.ssm.dt_bias", (L, H), 0.1),
            ("blocks.ssm.norm_w", (L, di), NORM_SCALE),
            ("blocks.ssm.out_proj", (L, di, D), di ** -0.5)]
    if F > 0:
        out += [("blocks.ln2", (L, D), NORM_SCALE), *mlp_leaves(m)]
    return out


def token_params(m: Dict) -> int:
    """Weights one token multiplies through in the layers (LM head
    apart), a multiply-add each: the attention projections where the
    model has them, the mixer's ``in_proj``, ``conv_w`` (the depthwise
    convolution's K taps over each of x, B and C) and ``out_proj``, and
    the MLP where ``d_ff`` > 0."""
    D, F = m["d_model"], m["d_ff"]
    di, H, N, K = _ssm_dims(m)
    mixer = D * (2 * di + 2 * N + H) + (di + 2 * N) * K + di * D
    return m["n_layers"] * (attn_params(m) + mixer + 3 * D * F)


def attn_layers(m: Dict) -> int:
    """Every layer attends where the model has attention heads."""
    return m["n_layers"] if m["n_heads"] > 0 else 0


def recurrence_flops(m: Dict) -> int:
    """FLOPs of the SSD recurrence a token, every layer: for each of the
    di * N state elements, the state update h = exp(dt A) h + (dt x) B
    (a multiply and a multiply-add, 3 FLOPs) and the readout y = h C (a
    multiply-add, 2): 5 di N a layer. The decay's exponential, dt x, the
    skip D x, the gate and the norm are not counted; the chunked scan of
    a prefill does more work than this for the same result and is
    counted as this."""
    di, _, N, _ = _ssm_dims(m)
    return m["n_layers"] * 5 * di * N
