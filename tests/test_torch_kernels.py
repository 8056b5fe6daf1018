"""The port's attention kernels held against the JAX package.

On the CPU the port's wrappers (``repro_torch.kernels.ops``) run the
plain PyTorch versions; these are compared with the Pallas kernels in
interpret mode (``repro.kernels.ops.*(interpret=True)``) and with the jnp
oracles, on the same numpy inputs. fp32 at atol 1e-5 (the repo's engine
contract). The CUDA kernels themselves run only on a card:
``tests/test_torch_cuda.py`` holds them against these plain versions.
"""
from __future__ import annotations

import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels import flash_prefill as fp_launch  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models.partitioning import merge_lse  # noqa: E402

ATOL = 1e-5


def _paged_inputs(Hq, Hkv, hd=32, psz=8, maxp=4, n_pages=16, seed=0):
    """Rows: a pad row (q_pos 0, table all -1), page-boundary positions
    (psz-1, psz), a full table, and a row with trailing -1 entries."""
    rng = np.random.default_rng(seed)
    q_pos = np.array([0, psz - 1, psz, maxp * psz - 1, 2 * psz + 3], np.int32)
    B = len(q_pos)
    pt = np.full((B, maxp), -1, np.int32)
    perm = list(rng.permutation(n_pages))
    for b in range(1, B):
        n = q_pos[b] // psz + 1
        pt[b, :n] = [perm.pop() for _ in range(n)]
    q = rng.standard_normal((B, Hq, hd)).astype(np.float32)
    kp = rng.standard_normal((n_pages, Hkv, psz, hd)).astype(np.float32)
    vp = rng.standard_normal((n_pages, Hkv, psz, hd)).astype(np.float32)
    return q, kp, vp, pt, q_pos


def _t(*arrs):
    return [torch.from_numpy(np.array(a)) for a in arrs]


def _j(*arrs):
    return [jnp.asarray(a) for a in arrs]


@pytest.mark.parametrize("Hq,Hkv", [(4, 2), (4, 1), (6, 3)])
def test_paged_decode_plain_matches_pallas(Hq, Hkv):
    """Live rows match the Pallas kernel; every row (the pad row, which
    both oracles average over page 0) matches the jnp oracle."""
    arrs = _paged_inputs(Hq, Hkv)
    got = ops.paged_decode_attention(*_t(*arrs)).numpy()
    kern = np.asarray(jops.paged_decode_attention(*_j(*arrs), interpret=True))
    oracle = np.asarray(jref.paged_decode_attention_ref(*_j(*arrs)))
    live = arrs[3].max(axis=1) >= 0
    np.testing.assert_allclose(got[live], kern[live], atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, oracle, atol=ATOL, rtol=0)
    assert np.all(kern[~live] == 0)       # the kernels' pad-row contract


def _verify_inputs(C, Hq, Hkv, hd=32, psz=8, maxp=5, n_pages=24, seed=0):
    """Verify windows of C queries: a pad row (table all -1), windows
    starting just before and at a page boundary, one ending at the table's
    last position, and one with trailing -1 entries (the table covers
    exactly its window)."""
    rng = np.random.default_rng(seed + C)
    q_start = np.array([0, psz - 1, psz, maxp * psz - C, 2 * psz + 3],
                       np.int32)
    B = len(q_start)
    pt = np.full((B, maxp), -1, np.int32)
    perm = list(rng.permutation(n_pages))
    for b in range(1, B):
        n = (q_start[b] + C - 1) // psz + 1
        pt[b, :n] = [perm.pop() for _ in range(n)]
    q = rng.standard_normal((B, C, Hq, hd)).astype(np.float32)
    kp = rng.standard_normal((n_pages, Hkv, psz, hd)).astype(np.float32)
    vp = rng.standard_normal((n_pages, Hkv, psz, hd)).astype(np.float32)
    return q, kp, vp, pt, q_start


@pytest.mark.parametrize("C", [1, 3, 5])
@pytest.mark.parametrize("Hq,Hkv", [(4, 2), (16, 1)])
def test_paged_verify_plain_matches_pallas(C, Hq, Hkv):
    """Live rows match the Pallas verify kernel in interpret mode (R =
    C*Hq/Hkv query rows per block, 80 at C=5 over 16 heads); every row
    matches the jnp oracle, the pad row included, and the port's layer."""
    arrs = _verify_inputs(C, Hq, Hkv)
    got = ops.paged_verify_attention(*_t(*arrs)).numpy()
    kern = np.asarray(jops.paged_verify_attention(*_j(*arrs),
                                                  interpret=True))
    oracle = np.asarray(JL.paged_verify_attention(*_j(*arrs)))
    live = arrs[3].max(axis=1) >= 0
    np.testing.assert_allclose(got[live], kern[live], atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, oracle, atol=ATOL, rtol=0)
    np.testing.assert_allclose(TL.paged_verify_attention(*_t(*arrs)).numpy(),
                               oracle, atol=ATOL, rtol=0)
    assert np.all(kern[~live] == 0)       # the kernels' pad-row contract
    if C == 1:                            # one query is a decode query
        q, kp, vp, pt, qs = arrs
        dec = ops.paged_decode_attention(*_t(q[:, 0], kp, vp, pt, qs))
        np.testing.assert_allclose(got[:, 0], dec.numpy(), atol=ATOL, rtol=0)


def _prefill_inputs(B, S, Hq, Hkv, hd=32, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(dtype)
            for s in ((B, S, Hq, hd), (B, S, Hkv, hd), (B, S, Hkv, hd))]


@pytest.mark.parametrize("causal,window", [(True, None), (True, 5),
                                           (False, None), (False, 6)])
@pytest.mark.parametrize("Hq,Hkv", [(4, 2), (4, 1), (6, 2), (10, 2)])
def test_flash_prefill_plain_matches_pallas(causal, window, Hq, Hkv):
    arrs = _prefill_inputs(2, 16, Hq, Hkv)
    got = ops.flash_prefill(*_t(*arrs), causal=causal, window=window).numpy()
    kern = np.asarray(jops.flash_prefill(*_j(*arrs), causal=causal,
                                         window=window, qblk=8, kblk=8,
                                         interpret=True))
    np.testing.assert_allclose(got, kern, atol=ATOL, rtol=0)


@pytest.mark.parametrize("S", [1, 7, 37])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 4),
                                           (False, None)])
def test_flash_prefill_ragged_matches_jnp(S, causal, window):
    """Any S (no block divisibility): against L.attention + band_mask."""
    arrs = _prefill_inputs(2, S, 6, 2, seed=S)
    got = ops.flash_prefill(*_t(*arrs), causal=causal, window=window).numpy()
    pos = jnp.arange(S)
    q, k, v = _j(*arrs)
    want = np.asarray(JL.attention(q, k, v,
                                   JL.band_mask(pos, pos, causal, window)))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("dtype,hd,want", [
    (torch.bfloat16, 64, "tensor_core"), (torch.bfloat16, 128, "tensor_core"),
    (torch.bfloat16, 32, "cuda_core"), (torch.bfloat16, 256, "cuda_core"),
    (torch.float32, 32, "cuda_core"), (torch.float32, 64, "cuda_core"),
    (torch.float32, 128, "cuda_core"), (torch.float32, 256, "cuda_core")])
def test_flash_prefill_body_rule(dtype, hd, want):
    """bf16 at hd 64 and 128 runs the tensor-core body, everything else the
    CUDA-core body; other types are refused."""
    assert fp_launch.body(dtype, hd) == want
    with pytest.raises(ValueError, match="type"):
        fp_launch.body(torch.float16, hd)


def test_bf16_inputs_match_jax_oracles():
    """bf16 inputs through both packages' plain versions. Both take the
    scores to fp32 but round the probabilities to bf16 before the PV
    product at framework-specific places, so the bound is bf16's: 2e-2 on
    outputs of magnitude <= ~3 (about 2^-6 relative)."""
    q, kp, vp, pt, qp = _paged_inputs(4, 2)
    tb = [x.to(torch.bfloat16) for x in _t(q, kp, vp)]
    got = ops.paged_decode_attention(*tb, *_t(pt, qp)).float().numpy()
    jb = [x.astype(jnp.bfloat16) for x in _j(q, kp, vp)]
    want = np.asarray(jref.paged_decode_attention_ref(*jb, *_j(pt, qp)),
                      np.float32)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=0)

    arrs = _prefill_inputs(1, 19, 4, 2, seed=3)
    tb = [x.to(torch.bfloat16) for x in _t(*arrs)]
    got = ops.flash_prefill(*tb, causal=True)
    assert got.dtype == torch.bfloat16
    jb = [x.astype(jnp.bfloat16) for x in _j(*arrs)]
    want = np.asarray(jref.flash_prefill_ref(*jb, causal=True), np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, atol=2e-2, rtol=0)


def test_layers_match_jax():
    """rms_norm (1 + w), half-split RoPE, gated MLP against their twins."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 5, 3, 32)).astype(np.float32)
    w = rng.standard_normal((32,)).astype(np.float32) * 0.1
    pos = np.array([0, 3, 17, 64, 1000], np.int32)
    np.testing.assert_allclose(
        TL.rms_norm(*_t(x, w)).numpy(),
        np.asarray(JL.rms_norm(*_j(x, w))), atol=ATOL, rtol=0)
    np.testing.assert_allclose(
        TL.apply_rope(*_t(x, pos), 1e6).numpy(),
        np.asarray(JL.apply_rope(*_j(x, pos), 1e6)), atol=ATOL, rtol=0)
    h = rng.standard_normal((3, 16)).astype(np.float32)
    wg, wu = (rng.standard_normal((16, 24)).astype(np.float32) * 0.2
              for _ in range(2))
    wd = rng.standard_normal((24, 16)).astype(np.float32) * 0.2
    np.testing.assert_allclose(
        TL.gated_mlp(*_t(h, wg, wu, wd)).numpy(),
        np.asarray(JL.gated_mlp(*_j(h, wg, wu, wd))), atol=ATOL, rtol=0)


def test_wrappers_reject_bad_window():
    arrs = _t(*_prefill_inputs(1, 4, 2, 1))
    with pytest.raises(ValueError, match="window"):
        ops.flash_prefill(*arrs, window=0)
    with pytest.raises(ValueError, match="window"):
        ops.flash_prefill_chunk(*arrs, torch.zeros(1, dtype=torch.int32),
                                window=0)
    with pytest.raises(ValueError, match="window"):
        ops.decode_attention(*_t(*_ring_inputs(2, 1)), window=-3)


# ------------------------------------------------ slot decode, prompt chunks

def _ring_inputs(Hq, Hkv, hd=32, S=32, seed=0):
    """Ring-cache decode inputs: rows with an empty cache (every kv_pos
    -1), a short append-only history with -1 tail slots, a wrapped ring
    (slot p % S holds position p, oldest overwritten), a row with -1 holes
    and future positions (kv_pos > q_pos), and a full ring at the start."""
    rng = np.random.default_rng(seed)
    q_pos = np.array([0, 5, 3 * S - 7, 40, S - 1], np.int32)
    kv_pos = np.full((len(q_pos), S), -1, np.int32)
    kv_pos[1, :6] = np.arange(6)
    for p in range(q_pos[2] - S + 1, q_pos[2] + 1):
        kv_pos[2, p % S] = p
    kv_pos[3] = rng.integers(0, 60, S)
    kv_pos[3, ::5] = -1
    kv_pos[4] = np.arange(S)
    B = len(q_pos)
    q = rng.standard_normal((B, Hq, hd)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, S, hd)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, S, hd)).astype(np.float32)
    return q, k, v, kv_pos, q_pos


@pytest.mark.parametrize("window", [None, 8, 24])
@pytest.mark.parametrize("Hq,Hkv", [(4, 2), (4, 1), (6, 3)])
def test_decode_attention_plain_matches_pallas(window, Hq, Hkv):
    """The port's ring-cache decode attention (plain version and
    ``layers.decode_attention``, with ``window``) against the JAX layer
    on every row and the Pallas kernel (interpret) on rows with a live
    slot: -1 slots, a wrapped ring, future positions, a sliding window."""
    arrs = _ring_inputs(Hq, Hkv)
    got = ops.decode_attention(*_t(*arrs), window=window).numpy()
    layer = TL.decode_attention(*_t(*arrs), window=window).numpy()
    want = np.asarray(JL.decode_attention(*_j(*arrs), window))
    kern = np.asarray(jops.decode_attention(*_j(*arrs), window=window,
                                            blk=16, interpret=True))
    q_pos, kv_pos = arrs[4], arrs[3]
    d = q_pos[:, None] - kv_pos
    keep = (kv_pos >= 0) & (d >= 0) & (d < (window or 10 ** 9))
    live = keep.any(axis=1)
    assert live.sum() >= 4 and not live[0]
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    np.testing.assert_array_equal(layer, got)
    np.testing.assert_allclose(got[live], kern[live], atol=ATOL, rtol=0)
    assert np.all(kern[~live] == 0)       # the kernels' empty-row contract


def _lse_numpy(q, k, kv_pos, q_pos, window):
    """Each query row's log-sum-exp of its kept scaled scores, summed in
    float64, [B,Hq] (-1e30 for a row that keeps nothing)."""
    B, Hq, hd = q.shape
    Hkv = k.shape[1]
    sc = np.einsum("bhgd,bhsd->bhgs", q.reshape(B, Hkv, Hq // Hkv, hd)
                   .astype(np.float64), k.astype(np.float64)) * hd ** -0.5
    d = q_pos[:, None] - kv_pos
    keep = (kv_pos >= 0) & (d >= 0) & (d < (window or 10 ** 9))
    sc = np.where(keep[:, None, None], sc, -np.inf)
    m = sc.max(-1, keepdims=True)
    lse = (np.log(np.exp(sc - np.where(np.isfinite(m), m, 0)).sum(-1))
           + np.where(np.isfinite(m), m, 0)[..., 0])
    return np.where(keep.any(-1)[:, None, None], lse, -1e30).reshape(B, Hq)


@pytest.mark.parametrize("window", [None, 8])
@pytest.mark.parametrize("Hq,Hkv", [(4, 2), (6, 3)])
def test_decode_attention_lse_matches_jax(window, Hq, Hkv):
    """``return_lse`` on the plain version and ``layers.decode_attention``:
    the output as JAX's ``layers.decode_attention``, and each row's
    log-sum-exp of its kept scaled scores (float64 in numpy); a row that
    keeps nothing (row 0) gets exactly -1e30."""
    arrs = _ring_inputs(Hq, Hkv)
    out, lse = ops.decode_attention(*_t(*arrs), window=window,
                                    return_lse=True)
    lout, llse = TL.decode_attention(*_t(*arrs), window=window,
                                     return_lse=True)
    want = np.asarray(JL.decode_attention(*_j(*arrs), window))
    np.testing.assert_allclose(out.numpy(), want, atol=ATOL, rtol=0)
    assert lse.dtype == torch.float32 and lse.shape == (5, Hq)
    q, k, _, kv_pos, q_pos = arrs
    want_lse = _lse_numpy(q, k, kv_pos, q_pos, window).astype(np.float32)
    np.testing.assert_allclose(lse.numpy(), want_lse, atol=ATOL, rtol=0)
    assert torch.all(lse[0] == -1e30) and torch.all(lse[1:] > -1e29)
    assert torch.equal(lout, out) and torch.equal(llse, lse)


@pytest.mark.parametrize("ways", [2, 4])
@pytest.mark.parametrize("window", [None, 8, 24])
def test_decode_attention_slices_combine_to_whole(ways, window):
    """The ring cut into ``ways`` slices of slots, each attended alone
    with ``return_lse`` and merged by the combine's arithmetic, gives the
    whole ring's output on every row that keeps a slot
    (``partitioning.merge_lse``, ``combine_model_lse``'s arithmetic in one
    process): a wrapped ring,
    holes, future positions, a window. A slice that keeps nothing for a
    row (lse -1e30) weighs nothing there."""
    q, k, v, kv_pos, q_pos = _t(*_ring_inputs(4, 2, S=32))
    n = 32 // ways
    parts = [ops.decode_attention(
        q, k[:, :, i * n:(i + 1) * n].contiguous(),
        v[:, :, i * n:(i + 1) * n].contiguous(),
        kv_pos[:, i * n:(i + 1) * n].contiguous(), q_pos, window=window,
        return_lse=True) for i in range(ways)]
    whole = ops.decode_attention(q, k, v, kv_pos, q_pos, window=window)
    live = slice(1, None)                 # row 0 keeps nothing at all
    np.testing.assert_allclose(merge_lse(parts)[live].numpy(),
                               whole[live].numpy(), atol=ATOL, rtol=0)
    # row 1 keeps slots 0..5 only: every other slice is empty for it
    empty = [p for p in parts[1:] if bool(torch.all(p[1][1] == -1e30))]
    assert len(empty) == ways - 1


def test_decode_attention_empty_slice_weighs_nothing():
    """A slice whose every slot is empty (kv_pos -1) merged with a live
    one gives the live slice's output, whatever the empty slice's out
    holds (the plain version averages its slots there, the kernel writes
    0)."""
    q, k, v, kv_pos, q_pos = _t(*_ring_inputs(4, 2, S=32))
    live = ops.decode_attention(q, k, v, kv_pos, q_pos, return_lse=True)
    none = torch.full_like(kv_pos, -1)
    empty = ops.decode_attention(q, k, v, none, q_pos, return_lse=True)
    assert torch.all(empty[1] == -1e30)
    rows = slice(1, None)
    for e in (empty, (torch.zeros_like(empty[0]), empty[1])):
        torch.testing.assert_close(merge_lse([live, e])[rows], live[0][rows],
                                   atol=0, rtol=0)


def _chunk_inputs(B, C, S, Hq, Hkv, hd=32, seed=0):
    """Chunk queries [B,C,Hq,hd] and a KV buffer laid out as the slot
    cache, [B,Hkv,S,hd], every slot filled (the tail past each chunk is
    stale data the causal mask must hide)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, C, Hq, hd)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, S, hd)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, S, hd)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("window", [None, 12])
@pytest.mark.parametrize("q_start", [(0, 0), (16, 40), (48, 5)])
@pytest.mark.parametrize("Hq,Hkv", [(2, 2), (6, 2), (16, 1)])
def test_flash_prefill_chunk_plain_matches_pallas(window, q_start, Hq, Hkv):
    """The chunk wrapper's plain version, given K/V as the strided view
    ``.transpose(1, 2)`` of a [B,Hkv,S,hd] buffer, against the Pallas
    chunk kernel (interpret) on the same data: q_start 0 and > 0, stale
    tail data, a window, GQA g in {1, 3, 16}."""
    q, k, v = _chunk_inputs(2, 16, 64, Hq, Hkv, seed=sum(q_start))
    qs = np.asarray(q_start, np.int32)
    kt, vt = (x.transpose(1, 2) for x in _t(k, v))
    got = ops.flash_prefill_chunk(*_t(q), kt, vt, *_t(qs),
                                  window=window).numpy()
    kj, vj = (jnp.asarray(x).swapaxes(1, 2) for x in (k, v))
    kern = np.asarray(jops.flash_prefill_chunk(
        jnp.asarray(q), kj, vj, jnp.asarray(qs), window=window, qblk=8,
        kblk=16, interpret=True))
    np.testing.assert_allclose(got, kern, atol=ATOL, rtol=0)
    want = np.asarray(jref.flash_prefill_chunk_ref(jnp.asarray(q), kj, vj,
                                                   jnp.asarray(qs),
                                                   window=window))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("C,S", [(1, 7), (37, 50), (5, 77)])
@pytest.mark.parametrize("window", [None, 9])
def test_chunk_decode_attention_ragged_matches_jnp(C, S, window):
    """Any C and S (no block divisibility), with -1 slots: the port's
    ``chunk_decode_attention`` against the JAX one, and the chunk
    wrapper's plain version against it where kv_pos is the slot index."""
    q, k, v = _chunk_inputs(2, C, S, 6, 2, seed=C * S)
    q_start = np.array([0, S - C], np.int32)
    q_pos = q_start[:, None] + np.arange(C, dtype=np.int32)
    kv_pos = np.tile(np.arange(S, dtype=np.int32), (2, 1))
    holes = kv_pos.copy()
    holes[:, 1::4] = -1
    for kp in (kv_pos, holes):
        got = TL.chunk_decode_attention(*_t(q, k, v, kp, q_pos), window)
        want = JL.chunk_decode_attention(*_j(q, k, v, kp, q_pos), window)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=0)
    kt, vt = (x.transpose(1, 2) for x in _t(k, v))
    chunk = ops.flash_prefill_chunk(*_t(q), kt, vt, *_t(q_start),
                                    window=window)
    want = JL.chunk_decode_attention(*_j(q, k, v, kv_pos, q_pos), window)
    np.testing.assert_allclose(chunk.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


def test_cpu_calls_do_not_count_launches():
    ops.reset_launches()
    ops.flash_prefill(*_t(*_prefill_inputs(1, 4, 2, 1)))
    ops.paged_decode_attention(*_t(*_paged_inputs(2, 1)))
    ops.decode_attention(*_t(*_ring_inputs(2, 1)), window=8)
    q, k, v = _t(*_prefill_inputs(2, 16, 2, 1))
    ops.flash_prefill_chunk(q[:, :4], k, v, torch.tensor([0, 3],
                                                         dtype=torch.int32))
    ops.paged_verify_attention(*_t(*_verify_inputs(3, 2, 1)))
    H, P, N = 2, 8, 4
    x, dt, b, c = (torch.randn(*s) for s in ((1, 5, H, P), (1, 5, H),
                                              (1, 5, N), (1, 5, N)))
    prm = (torch.zeros(H), torch.ones(H), torch.zeros(H))
    ops.ssd_scan(x, dt, prm[0], b, c, prm[1], prm[2])
    ops.ssd_decode_step(x[:, 0], dt[:, 0], prm[0], b[:, 0], c[:, 0], prm[1],
                        prm[2], torch.zeros(2, H, P, N),
                        torch.tensor([1], dtype=torch.int32),
                        torch.tensor([True]))
    ops.moe_grouped_ffn(torch.randn(4, 3, 8), torch.randn(2, 8, 6),
                        torch.randn(2, 8, 6), torch.randn(2, 6, 8))
    ops.add_rms_norm(torch.randn(2, 8), torch.randn(2, 8), torch.zeros(8),
                     1e-5)
    ops.rope_kv_write(torch.randn(1, 2, 8), torch.randn(1, 1, 8),
                      torch.randn(1, 1, 8), torch.tensor([5], dtype=torch.int32),
                      torch.ones(4), torch.zeros(3, 1, 4, 8),
                      torch.zeros(3, 1, 4, 8), torch.tensor([1]),
                      torch.tensor([2]))
    ops.silu_mul(torch.randn(2, 8), torch.randn(2, 8))
    assert ops.LAUNCHES == {"paged_decode_attention": 0, "flash_prefill": 0,
                            "flash_prefill_chunk": 0, "decode_attention": 0,
                            "paged_verify_attention": 0, "ssd_scan": 0,
                            "ssd_decode_step": 0, "moe_grouped_ffn": 0,
                            "add_rms_norm": 0, "rope_kv_write": 0,
                            "silu_mul": 0}


def test_failed_build_raises(tmp_path, monkeypatch):
    """A compiler failure surfaces as RuntimeError with its output; no
    library is left behind to be loaded."""
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "nvcc", lambda: sys.executable)
    with pytest.raises(RuntimeError, match="kernel build failed"):
        build.build_all(["flash_prefill"], force=True)
    assert not build.library("flash_prefill").exists()
    assert build.build_log("flash_prefill").read_text()


def test_stale_counts_shared_headers(tmp_path, monkeypatch):
    """A library is rebuilt when its source or any header under csrc/ is
    newer than it."""
    csrc, out = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    out.mkdir()
    monkeypatch.setattr(build, "CSRC", csrc)
    monkeypatch.setattr(build, "BUILD_DIR", out)
    src, hdr = csrc / "k.cu", csrc / "shared.cuh"
    src.write_text("")
    hdr.write_text("")
    assert build._stale("k")                      # no library yet
    lib = build.library("k")
    lib.write_text("")
    for p, t in ((src, 100), (hdr, 100), (lib, 200)):
        os.utime(p, (t, t))
    assert not build._stale("k")
    os.utime(hdr, (300, 300))                     # a touched header
    assert build._stale("k")
    os.utime(lib, (400, 400))
    assert not build._stale("k")
    os.utime(src, (500, 500))
    assert build._stale("k")
