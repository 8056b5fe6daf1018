"""The port's training forward (``repro_torch.models.model.forward``) held
against the JAX model's ``forward`` on the same weights: the JAX
package's ``init_params`` goes through the weight bridge ``load_params``,
the inputs (token ids, or [B,S,D] embeddings for the embedding-input
archs) are made with numpy from a seed, fp32 on the CPU.

Logits are held to the repo's contract, atol 1e-5 (``tests/helpers.py``),
taken relative to the logits' magnitude (``_close``; |logit| is about 4
to 5 here): an SSM layer's SSD core takes exp of a cumulative sum along
the sequence, and XLA's and torch's cumsums add in different orders, so
the two packages differ by about |cumsum| * eps there, more the longer
the sequence. Every registry arch (edge-6b included), reduced; the MoE
dispatch options, dense and chunked attention, the training window, the
SSD kernel option (against JAX's Pallas kernel in interpret mode, as
``tests/test_kernels.py`` runs it) and ``chunked_attention`` alone.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from helpers import ATOL, assert_logits_close  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.registry import list_archs  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402

ARCHS = list(list_archs())
_PAIRS = {}


def _pair(arch):
    """(JAX cfg, port cfg, JAX params, port params), reduced, one draw of
    weights an arch for the whole module."""
    if arch not in _PAIRS:
        jcfg = jax_config(arch).reduced()
        cfg = get_config(arch).reduced()
        jp = JM.init_params(jcfg, jax.random.PRNGKey(7))
        tree = jax.tree_util.tree_map(np.asarray, jp)
        _PAIRS[arch] = (jcfg, cfg, jp, TM.load_params(cfg, tree, device="cpu"))
    return _PAIRS[arch]


def _inputs(cfg, B, S, seed=0):
    rng = np.random.default_rng(seed)
    if cfg.embedding_inputs:
        return rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    return rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


def _close(got, want, err_msg=""):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    assert_logits_close(got.detach().numpy(), want, atol=ATOL * scale,
                        err_msg=err_msg)


def _both(arch, x, jopts=JM.ModelOptions(), topts=TM.ModelOptions(),
          keep_padded=False):
    jcfg, cfg, jp, tp = _pair(arch)
    jl, ja = JM.forward(jcfg, jp, jnp.asarray(x), jopts, keep_padded)
    tl, ta = TM.forward(cfg, tp, torch.from_numpy(x), topts, keep_padded)
    return (tl, ta), (jl, ja)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(arch):
    """Logits over every position (and the padded vocabulary, pad lanes
    at -1e30) and the layer-averaged MoE aux loss."""
    _, cfg, _, _ = _pair(arch)
    x = _inputs(cfg, 2, 24)
    (tl, ta), (jl, ja) = _both(arch, x)
    assert tl.shape == (2, 24, cfg.vocab_size)
    _close(tl, jl, "logits")
    _close(ta, ja, "aux")
    (tp, _), (jp, _) = _both(arch, x, keep_padded=True)
    assert tp.shape == (2, 24, cfg.padded_vocab)
    V = cfg.vocab_size
    _close(tp[..., :V], np.asarray(jp)[..., :V], "padded logits")
    np.testing.assert_array_equal(tp[..., V:].detach().numpy(),
                                  np.asarray(jp)[..., V:])


@pytest.mark.parametrize("moe_impl", ["grouped", "grouped_kernel", "sorted",
                                      "dense"])
def test_forward_moe_impls_match_jax(moe_impl):
    """granite-moe (reduced) under each MoE dispatch: the grouped
    einsums (per-example capacity and drops), the global sort, the dense
    oracle; grouped_kernel is the grouped einsums for a sequence."""
    _, cfg, _, _ = _pair("granite-moe-3b-a800m")
    x = _inputs(cfg, 3, 20, seed=1)
    (tl, ta), (jl, ja) = _both("granite-moe-3b-a800m", x,
                               JM.ModelOptions(moe_impl=moe_impl),
                               TM.ModelOptions(moe_impl=moe_impl))
    _close(tl, jl)
    _close(ta, ja)


def test_forward_one_token_moe_matches_jax():
    """A one-token sequence takes the lossless decode dispatch (its
    einsums; the kernel only under no autograd, as grouped_kernel)."""
    _, cfg, _, _ = _pair("llama4-scout-17b-a16e")
    x = _inputs(cfg, 4, 1, seed=2)
    (tl, _), (jl, _) = _both("llama4-scout-17b-a16e", x)
    _close(tl, jl)
    with torch.no_grad():
        (tk, _), _ = _both("llama4-scout-17b-a16e", x,
                           topts=TM.ModelOptions(moe_impl="grouped_kernel"))
    _close(tk, jl)


@pytest.mark.parametrize("impl,window", [("dense", None), ("chunked", None),
                                         ("dense", 37), ("chunked", 37)])
def test_forward_attn_impls_and_window_match_jax(impl, window):
    """smollm-360m (reduced) at S = 600: chunked attention runs two
    512-query chunks; ``train_window`` caps the band."""
    _, cfg, _, _ = _pair("smollm-360m")
    x = _inputs(cfg, 1, 600, seed=3)
    (tl, _), (jl, _) = _both(
        "smollm-360m", x, JM.ModelOptions(attn_impl=impl, train_window=window),
        TM.ModelOptions(attn_impl=impl, train_window=window))
    _close(tl, jl)


@pytest.mark.parametrize("S", [1, 2048, 2049, 4096])
def test_resolve_attn_matches_jax(S):
    for impl in ("auto", "dense", "chunked"):
        assert (TM.ModelOptions(attn_impl=impl).resolve_attn(S)
                == JM.ModelOptions(attn_impl=impl).resolve_attn(S))


def test_ssd_kernel_forward_matches_jax_interpret():
    """``use_ssd_kernel=True`` (mamba2, reduced, S = 70: two SSD chunks)
    against JAX's forward through the Pallas scan in interpret mode, and
    against the default forward; under autograd the wrapper refuses."""
    arch = "mamba2-780m"
    _, cfg, _, tp = _pair(arch)
    x = _inputs(cfg, 2, 70, seed=4)
    opts = TM.ModelOptions(use_ssd_kernel=True)
    with torch.no_grad():
        (tk, _), (jk, _) = _both(arch, x, JM.ModelOptions(use_ssd_kernel=True),
                                 opts)
        plain, _ = TM.forward(cfg, tp, torch.from_numpy(x))
    _close(tk, jk)
    np.testing.assert_array_equal(tk.numpy(), plain.numpy())
    for p in tp["blocks"]["ssm"].values():
        p.requires_grad_(True)
    try:
        with pytest.raises(RuntimeError, match="no backward"):
            TM.forward(cfg, tp, torch.from_numpy(x), opts)
    finally:
        for p in tp["blocks"]["ssm"].values():
            p.requires_grad_(False)


@pytest.mark.parametrize("window", [None, 37])
def test_chunked_attention_matches_jax(window):
    """q_chunk 32, k_chunk 48 at S = 130 (both padded), as
    ``tests/test_models.py`` runs JAX's, against JAX's and against the
    port's dense attention: atol 2e-5."""
    B, S, Hq, Hkv, hd = 2, 130, 4, 2, 16
    rng = np.random.default_rng(5)
    q, k, v = (rng.standard_normal((B, S, h, hd)).astype(np.float32)
               for h in (Hq, Hkv, Hkv))
    pos = np.arange(S)
    want = JL.chunked_attention(*map(jnp.asarray, (q, k, v, pos, pos)), True,
                                window, q_chunk=32, k_chunk=48)
    tq, tk, tv, tpos = map(torch.from_numpy, (q, k, v, pos))
    got = TL.chunked_attention(tq, tk, tv, tpos, tpos, True, window,
                               q_chunk=32, k_chunk=48)
    dense = TL.attention(tq, tk, tv, TL.band_mask(tpos, tpos, True, window))
    assert_logits_close(got.numpy(), np.asarray(want), atol=2e-5)
    assert_logits_close(got.numpy(), dense.numpy(), atol=2e-5)


def test_chunked_attention_is_differentiable():
    """Gradients through the online softmax equal the dense attention's."""
    rng = np.random.default_rng(6)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 70, 2, 8))
                                .astype(np.float32)).requires_grad_(True)
               for _ in range(3))
    pos = torch.arange(70)
    out = TL.chunked_attention(q, k, v, pos, pos, True, 20, q_chunk=16,
                               k_chunk=24)
    g1 = torch.autograd.grad(out.square().sum(), (q, k, v))
    ref = TL.attention(q, k, v, TL.band_mask(pos, pos, True, 20))
    g2 = torch.autograd.grad(ref.square().sum(), (q, k, v))
    for a, b in zip(g1, g2):
        assert_logits_close(a.numpy(), b.numpy(), atol=2e-5)
