"""The port's MoE FFN (``repro_torch.models.moe``) and the plain version
of its grouped-expert kernel held against the JAX package: the same
weights (JAX ``init_moe_params``) and the same inputs, made with numpy
from a seed, fp32 on the CPU. Routing must agree exactly (the top-k
expert ids are asserted equal before any output is compared, and the
inputs of ``moe_ffn_grouped`` are ones where capacity drops happen);
outputs
agree at atol 1e-5 (``tests/helpers.py``). The plain grouped FFN is also
held against the Pallas kernel in interpret mode.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from helpers import assert_logits_close  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import moe as JMOE  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import moe as TMOE  # noqa: E402

D, F, E, K = 16, 32, 5, 2


def _params(seed=0, skew=0.0):
    """JAX weights and the port's copy; ``skew`` adds skew*D^-0.5 to the
    router's expert-0 column, which favours expert 0 for inputs whose
    components sum to a positive value (``_x`` with ``shift``)."""
    jp = JMOE.init_moe_params(jax.random.PRNGKey(seed), D, F, E)
    jp = jp._replace(router=jp.router.at[:, 0].add(skew * D ** -0.5))
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp._asdict().items()}
    return jp, tp


def _x(shape, seed, shift=0.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            + shift).astype(np.float32)


def _close(t, j):
    assert_logits_close(t.numpy(), np.asarray(j))


def test_route_matches_jax():
    jp, tp = _params()
    x = _x((23, D), 1)
    wj, ij, aj = JMOE.route(jp.router, jnp.asarray(x), K)
    wt, it, at = TMOE.route(tp["router"], torch.from_numpy(x), K)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    _close(wt, wj)
    _close(at, aj)


def _drops(ids, T, C):
    """Assignments past capacity per example of a [B,T,K] id block, by the
    stable-sort position rule."""
    n = 0
    for row in ids.reshape(ids.shape[0], -1):
        _, counts = np.unique(row, return_counts=True)
        n += int(np.maximum(counts - C, 0).sum())
    return n


@pytest.mark.parametrize("B,T", [(2, 24), (1, 7)])
def test_moe_ffn_grouped_matches_jax_with_drops(B, T):
    """Per-example capacity C = max(int(T*K/E*1.25 + 0.999), K): some
    assignments overflow (asserted) and are dropped by their position
    after the stable sort; the port drops the same ones."""
    jp, tp = _params(1, skew=2.0)
    x = _x((B, T, D), T)
    _, ids, _ = JMOE.route(jp.router, jnp.asarray(x.reshape(-1, D)), K)
    C = max(int(T * K / E * 1.25 + 0.999), K)
    assert _drops(np.asarray(ids).reshape(B, T, K), T, C) > 0
    yj, aj = JMOE.moe_ffn_grouped(jp, jnp.asarray(x), K)
    yt, at = TMOE.moe_ffn_grouped(tp, torch.from_numpy(x), K)
    _close(yt, yj)
    _close(at, aj)


def test_moe_ffn_global_matches_jax():
    jp, tp = _params(2, skew=1.0)
    x = _x((3, 9, D), 3)
    yj, _ = JMOE.moe_ffn(jp, jnp.asarray(x), K)
    yt, _ = TMOE.moe_ffn(tp, torch.from_numpy(x), K)
    _close(yt, yj)


@pytest.mark.parametrize("shape", [(7, D), (4, 1, D)])
def test_moe_ffn_grouped_decode_and_dense_match_jax(shape):
    jp, tp = _params(3)
    x = _x(shape, 4)
    yj, _ = JMOE.moe_ffn_grouped_decode(jp, jnp.asarray(x), K)
    yt, _ = TMOE.moe_ffn_grouped_decode(tp, torch.from_numpy(x), K)
    _close(yt, yj)
    dj, _ = JMOE.moe_ffn_dense(jp, jnp.asarray(x), K)
    dt, _ = TMOE.moe_ffn_dense(tp, torch.from_numpy(x), K)
    _close(dt, dj)
    _close(yt, dj)                     # lossless dispatch == the oracle


def test_skewed_routing_grouped_decode_matches_dense():
    """Routing that is genuinely uneven (asserted, unlike the reference
    test's precondition, whose zero-mean inputs cancel its router skew):
    inputs shifted by +2, so the skewed expert-0 column gives every row a
    large expert-0 logit and expert 0 takes every row. The lossless
    grouped decode still equals the dense oracle and JAX."""
    jp, tp = _params(4, skew=6.0)
    x = _x((12, D), 5, shift=2.0)
    _, ids, _ = TMOE.route(tp["router"], torch.from_numpy(x), K)
    loads = np.bincount(ids.numpy().ravel(), minlength=E)
    assert loads[0] == 12 and loads.max() >= 2 * loads.min() + 1, loads
    yt, _ = TMOE.moe_ffn_grouped_decode(tp, torch.from_numpy(x), K)
    dt, _ = TMOE.moe_ffn_dense(tp, torch.from_numpy(x), K)
    yj, _ = JMOE.moe_ffn_grouped_decode(jp, jnp.asarray(x), K)
    _close(yt, dt.numpy())
    _close(yt, yj)


@pytest.mark.parametrize("G", [E, 3 * E])
def test_grouped_ffn_plain_matches_pallas_interpret(G):
    """``ops.moe_grouped_ffn`` on [G,C,D] (G = E, or per-example buffers
    G = B*E using expert g mod E) against the Pallas kernel on each
    example's [E,C,D] block; zero rows give zero rows."""
    jp, tp = _params(5)
    buf = _x((G, 6, D), 6)
    buf[:, 4:] = 0.0
    yt = ops.moe_grouped_ffn(torch.from_numpy(buf), tp["wg"], tp["wu"],
                             tp["wd"])
    want = np.concatenate([np.asarray(jops.moe_grouped_ffn(
        jnp.asarray(buf[i:i + E]), jp.wg, jp.wu, jp.wd, interpret=True))
        for i in range(0, G, E)])
    _close(yt, want)
    assert torch.all(yt[:, 4:] == 0)
