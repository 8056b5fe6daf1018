"""The port's Mamba2 / SSD mixer (``repro_torch.models.ssm``) and the plain
versions of its two kernels held against the JAX package: the same
inputs, made with numpy from a seed, through ``repro.models.ssm`` and
through the port, fp32 on the CPU, at atol 1e-5 (``tests/helpers.py``)
on outputs and states alike. The port's ``ops.ssd_scan`` and
``ops.ssd_decode_step`` (their plain versions here) are also held against
the Pallas kernels run in interpret mode, as ``tests/test_kernels.py``
runs them.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from helpers import assert_logits_close  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402


def _ssd_inputs(B, T, H, P, N, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, H, P)).astype(np.float32)
    dt = (rng.standard_normal((B, T, H)) * 0.5).astype(np.float32)
    b = rng.standard_normal((B, T, N)).astype(np.float32)
    c = rng.standard_normal((B, T, N)).astype(np.float32)
    a_log = np.log(np.linspace(1.0, 4.0, H)).astype(np.float32)
    d_skip = np.ones((H,), np.float32)
    dt_bias = (rng.standard_normal(H) * 0.1).astype(np.float32)
    return x, dt, a_log, b, c, d_skip, dt_bias


def _both(arrs):
    return ([jnp.asarray(a) for a in arrs], [torch.from_numpy(a) for a in arrs])


def _close(t, j, **kw):
    assert_logits_close(t.numpy() if hasattr(t, "numpy") else t,
                        np.asarray(j), **kw)


def test_softplus_matches_jax_past_torch_threshold():
    """F.softplus switches to the identity past 20; jax.nn.softplus (and
    the port) does not."""
    import jax
    v = np.array([-1e9, -30.0, -1.0, 0.0, 1.0, 19.9, 20.5, 35.0, 80.0],
                 np.float32)
    np.testing.assert_array_equal(TS.softplus(torch.from_numpy(v)).numpy(),
                                  np.asarray(jax.nn.softplus(jnp.asarray(v))))


@pytest.mark.parametrize("B,T,H,P,N,chunk", [(2, 64, 3, 16, 8, 16),
                                             (1, 40, 2, 16, 8, 16),
                                             (2, 13, 2, 8, 4, 64)])
def test_ssd_chunked_matches_jax(B, T, H, P, N, chunk):
    """Ragged T (dt = -1e9 padding) included."""
    (j, t) = _both(_ssd_inputs(B, T, H, P, N, seed=T))
    yj, hj = JS.ssd_chunked(*j, chunk=chunk)
    yt, ht = TS.ssd_chunked(*t, chunk=chunk)
    _close(yt, yj)
    _close(ht, hj)


def test_ssd_chunked_with_h0_matches_jax():
    B, T, H, P, N = 2, 21, 2, 8, 4
    arrs = _ssd_inputs(B, T, H, P, N, seed=4)
    h0 = np.random.default_rng(5).standard_normal((B, H, P, N)).astype(
        np.float32)
    (j, t) = _both(arrs)
    yj, hj = JS.ssd_chunked(*j, chunk=8, h0=jnp.asarray(h0))
    yt, ht = TS.ssd_chunked(*t, chunk=8, h0=torch.from_numpy(h0))
    _close(yt, yj)
    _close(ht, hj)


def test_ssd_step_matches_jax():
    B, H, P, N = 3, 4, 8, 16
    x, dt, a_log, b, c, d_skip, dt_bias = _ssd_inputs(B, 1, H, P, N, seed=6)
    h = np.random.default_rng(7).standard_normal((B, H, P, N)).astype(
        np.float32)
    arrs = (x[:, 0], dt[:, 0], a_log, b[:, 0], c[:, 0], d_skip, dt_bias, h)
    (j, t) = _both(arrs)
    yj, hj = JS.ssd_step(*j)
    yt, ht = TS.ssd_step(*t)
    _close(yt, yj)
    _close(ht, hj)


def test_causal_conv_and_step_match_jax():
    rng = np.random.default_rng(8)
    xbc = rng.standard_normal((2, 9, 12)).astype(np.float32)
    w = rng.standard_normal((12, 4)).astype(np.float32) * 0.5
    bias = rng.standard_normal(12).astype(np.float32)
    st = rng.standard_normal((2, 12, 3)).astype(np.float32)
    _close(TS.causal_conv(*map(torch.from_numpy, (xbc, w, bias))),
           JS.causal_conv(*map(jnp.asarray, (xbc, w, bias))))
    yt, st_t = TS.causal_conv_step(*map(torch.from_numpy,
                                        (xbc[:, 0], st, w, bias)))
    yj, st_j = JS.causal_conv_step(*map(jnp.asarray, (xbc[:, 0], st, w, bias)))
    _close(yt, yj)
    _close(st_t, st_j)


D, DI, NS, HD, K = 32, 64, 8, 16, 4


def _mixer_params(seed=0):
    import jax
    jp = JS.init_ssm_params(jax.random.PRNGKey(seed), D, DI, NS, HD, K)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp._asdict().items()}
    return jp, tp


@pytest.mark.parametrize("T", [9, 2])
def test_ssm_mixer_with_state_matches_jax(T):
    """T = 2 < K-1: the conv tail is left-padded with zeros."""
    jp, tp = _mixer_params()
    x = np.random.default_rng(T).standard_normal((2, T, D)).astype(np.float32)
    yj, hj, cj = JS.ssm_mixer_with_state(jp, jnp.asarray(x), DI, NS, HD)
    yt, ht, ct = TS.ssm_mixer_with_state(tp, torch.from_numpy(x), DI, NS, HD)
    _close(yt, yj)
    _close(ht, hj)
    _close(ct, cj)


def test_ssm_mixer_carried_state_matches_jax():
    """A second piece of the sequence with h0/conv0 carried in (the plain
    ssd_chunked path) equals JAX's, and both equal the one-piece call."""
    jp, tp = _mixer_params(1)
    x = np.random.default_rng(9).standard_normal((1, 14, D)).astype(
        np.float32)
    _, h1, c1 = TS.ssm_mixer_with_state(tp, torch.from_numpy(x[:, :5]), DI,
                                        NS, HD)
    yt, ht, ct = TS.ssm_mixer_with_state(tp, torch.from_numpy(x[:, 5:]), DI,
                                         NS, HD, h0=h1, conv0=c1)
    _, jh1, jc1 = JS.ssm_mixer_with_state(jp, jnp.asarray(x[:, :5]), DI, NS,
                                          HD)
    yj, hj, cj = JS.ssm_mixer_with_state(jp, jnp.asarray(x[:, 5:]), DI, NS,
                                         HD, h0=jh1, conv0=jc1)
    _close(yt, yj)
    _close(ht, hj)
    _close(ct, cj)
    yfull, hfull, _ = TS.ssm_mixer_with_state(tp, torch.from_numpy(x), DI, NS,
                                              HD)
    _close(yt, yfull[:, 5:].numpy())
    _close(ht, hfull.numpy())


def test_ssm_mixer_step_over_arena_matches_jax():
    """Rows over a shuffled arena of 6 slots and a spare: two live rows,
    an inactive row and a pad row (slot -1). Live rows' outputs equal
    JAX's step on their gathered state; the arena's 6 slots afterwards
    hold JAX's new state in the live rows' slots and are unchanged
    everywhere else (the other rows' conv tails go to the spare)."""
    jp, tp = _mixer_params(2)
    rng = np.random.default_rng(10)
    H = DI // HD
    arena = rng.standard_normal((7, H, HD, NS)).astype(np.float32)
    conv = rng.standard_normal((7, DI + 2 * NS, K - 1)).astype(np.float32)
    x = rng.standard_normal((4, D)).astype(np.float32)
    slots = np.array([4, 1, 3, -1], np.int32)
    active = np.array([True, True, False, False])
    s_t, c_t = torch.from_numpy(arena.copy()), torch.from_numpy(conv.copy())
    slots_t, active_t = torch.from_numpy(slots), torch.from_numpy(active)
    yt = TS.ssm_mixer_step(tp, torch.from_numpy(x), DI, NS, HD, s_t, c_t,
                           slots_t, active_t,
                           TS.write_slots(slots_t, active_t, 6))
    rd = np.clip(slots, 0, None)
    yj, hj, cj = JS.ssm_mixer_step(jp, jnp.asarray(x), DI, NS, HD,
                                   jnp.asarray(arena[rd]),
                                   jnp.asarray(conv[rd]))
    _close(yt[:3], np.asarray(yj)[:3])
    want_s, want_c = arena[:6].copy(), conv[:6].copy()
    want_s[[4, 1]] = np.asarray(hj)[:2]
    want_c[[4, 1]] = np.asarray(cj)[:2]
    _close(s_t[:6], want_s)
    _close(c_t[:6], want_c)
    np.testing.assert_array_equal(s_t.numpy()[[0, 2, 3, 5]],
                                  arena[[0, 2, 3, 5]])


@pytest.mark.parametrize("B,T,H,P,N", [(1, 40, 2, 16, 8), (2, 64, 1, 8, 4)])
def test_ssd_scan_plain_matches_pallas_interpret(B, T, H, P, N):
    """``ops.ssd_scan`` (chunk 64, any T) against the Pallas kernel in
    interpret mode through its wrapper (dt = -1e9 padding to chunk 16)."""
    (j, t) = _both(_ssd_inputs(B, T, H, P, N, seed=T + 1))
    yj, hj = jops.ssd_scan(*j, chunk=16, interpret=True)
    yt, ht = ops.ssd_scan(*t)
    _close(yt, yj, atol=2e-5)
    _close(ht, hj, atol=2e-5)


@pytest.mark.parametrize("H,P,N", [(4, 8, 16),
                                   # the CUDA kernel's slab-plan branches
                                   # at small H: the reduced configs'
                                   # width, N/4 = 3, P = 80 (a ragged last
                                   # slab), N = 256 (N/4 past a warp)
                                   (2, 32, 16), (2, 24, 12), (1, 80, 64),
                                   (1, 64, 256)])
def test_ssd_decode_plain_matches_pallas_interpret(H, P, N):
    """``ops.ssd_decode_step`` over an arena (a live row, an inactive row,
    a pad row) against the Pallas step on the gathered state: the same y
    for the rows with a slot, the Pallas h' written to the active row's
    slot only."""
    B = 3
    x, dt, a_log, b, c, d_skip, dt_bias = _ssd_inputs(B, 1, H, P, N, seed=12)
    arena = np.random.default_rng(13).standard_normal((5, H, P, N)).astype(
        np.float32)
    slots = np.array([3, 0, -1], np.int32)
    active = np.array([True, False, False])
    step = (x[:, 0], dt[:, 0], a_log, b[:, 0], c[:, 0], d_skip, dt_bias)
    yj, hj = jops.ssd_decode_step(*map(jnp.asarray, step),
                                  jnp.asarray(arena[np.clip(slots, 0, None)]),
                                  interpret=True)
    st = torch.from_numpy(arena.copy())
    yt = ops.ssd_decode_step(*map(torch.from_numpy, step), st,
                             torch.from_numpy(slots),
                             torch.from_numpy(active))
    _close(yt[:2], np.asarray(yj)[:2])
    assert torch.all(yt[2] == 0)
    want = arena.copy()
    want[3] = np.asarray(hj)[0]
    _close(st, want)
    np.testing.assert_array_equal(st.numpy()[[0, 1, 2, 4]], arena[[0, 1, 2, 4]])
