"""The split and pass structure of the redesigned ring-cache decode
attention and SSD scan kernels, held on the CPU.

Decode attention: ``kernels.ref.decode_attention_split_ref``, the plain
form of the CUDA kernel's slot splits and their log-sum-exp combine (every
split read, l = 0 the flag of an empty one), equals the unsplit plain
version on rows with a live slot and JAX's Pallas
``decode_attention_kernel`` in interpret mode on every row, at 1e-5 in
fp32, for several split sizes: empty splits, a ring wrapped twice, -1
holes, positions past q_pos, windows None / 64, and empty rows (exact 0).
``kernels.decode_attention.plan`` covers the ring and keeps a block within
its limits.

SSD scan: ``kernels.ref.ssd_scan_passes_ref``, the kernel's three passes
(chunk states, state passing, chunk outputs) written plainly, equals JAX's
Pallas ``ssd_scan`` in interpret mode and the port's ``ssd_chunked`` on y
and the final state, fp32 at 1e-5 (``tests/helpers.py``), at T from 1 to
200 (ragged last chunks), B 1 and 2, hymba's state N = 16 and a head count
that is not a multiple of 8, with x, b and c read as strided splits of
one projection.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from helpers import assert_logits_close  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import decode_attention as da  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402

S_RING = 192


def _ring(Hq, Hkv, hd=16, S=S_RING, seed=0):
    """Rows: 0 empty (every slot -1); 1 append-only 100 tokens (later
    splits empty); 2 a ring wrapped twice (slot p % S holds p); 3 random
    positions with -1 holes, many past q_pos; 4 a full ring; 5 six live
    slots in the middle of the ring; 6 ten positions far behind q_pos
    (empty under a window of 64)."""
    rng = np.random.default_rng(seed)
    q_pos = np.array([0, 99, 2 * S + 50, 120, S - 1, 20, 500], np.int32)
    kv = np.full((len(q_pos), S), -1, np.int32)
    kv[1, :100] = np.arange(100)
    for p in range(q_pos[2] - S + 1, q_pos[2] + 1):
        kv[2, p % S] = p
    kv[3] = rng.integers(0, 150, S)
    kv[3, ::7] = -1
    kv[4] = np.arange(S)
    kv[5, 70:76] = np.arange(10, 16)
    kv[6, :10] = np.arange(10)
    B = len(q_pos)
    q = rng.standard_normal((B, Hq, hd)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, S, hd)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, S, hd)).astype(np.float32)
    return q, k, v, kv, q_pos


def _live(kv, q_pos, window):
    d = q_pos[:, None] - kv
    return ((kv >= 0) & (d >= 0) & (d < (window or 1 << 30))).any(axis=1)


@pytest.mark.parametrize("sps", [16, 32, 80, S_RING])
@pytest.mark.parametrize("window", [None, 64])
@pytest.mark.parametrize("Hq,Hkv", [(4, 2), (6, 3)])
def test_ring_split_combine_matches_unsplit_and_pallas(sps, window, Hq, Hkv):
    arrs = _ring(Hq, Hkv, seed=sps + Hq)
    q, k, v, kv, qp = (torch.from_numpy(a) for a in arrs)
    got = ref.decode_attention_split_ref(q, k, v, kv, qp, window, sps)
    live = _live(arrs[3], arrs[4], window)
    assert not live[0] and live[1:6].all() and live[6] == (window is None)
    assert torch.all(got[~torch.from_numpy(live)] == 0)    # exact 0
    want = ref.decode_attention_ref(q, k, v, kv, qp, window)
    torch.testing.assert_close(got[live], want[live], atol=1e-5, rtol=0)
    kern = np.asarray(jops.decode_attention(
        *(jnp.asarray(a) for a in arrs), window=window, blk=64,
        interpret=True))
    assert_logits_close(got.numpy(), kern)


@pytest.mark.parametrize("R,hd,S,dtype", [
    (16, 128, 1024, "bfloat16"),     # edge-6b slot engine
    (16, 128, 4096, "bfloat16"),     # a long ring
    (3, 64, 1024, "bfloat16"),       # granite-moe heads
    (5, 64, 4096, "float32"),        # hymba heads in fp32
    (100, 32, 77, "bfloat16"),       # two row tiles, ragged ring
    (64, 256, 5, "float32"),         # a tiny ring, widest head
    (16, 128, 256, "bfloat16"),      # a short ring
    (64, 256, 4096, "float32"),      # the smallest split cap
])
def test_ring_plan_covers_the_ring(R, hd, S, dtype):
    dt = getattr(torch, dtype)
    rows, sps, nsplit = da.plan(R, hd, S, dt)
    tiles = -(-R // rows)
    elt = 2 if dtype == "bfloat16" else 4
    assert rows <= da.MAX_ROWS and (tiles - 1) * rows < R <= tiles * rows
    assert sps % 16 == 0 and 16 <= sps <= da.MAX_SLOTS
    assert nsplit == -(-S // sps) and (nsplit - 1) * sps < S
    # at most MIN_SPLITS splits, unless a split 16 slots larger would
    # break one of its limits
    bigger = sps + 16
    assert nsplit <= da.MIN_SPLITS or bigger > da.MAX_SLOTS or (
        2 * bigger * hd * elt > da.SPLIT_KV_BYTES) or (
        pa.body(dt, hd) == pa.CUDA_CORE and rows * bigger > da.SPLIT_PAIRS)
    assert 2 * sps * hd * elt <= da.SPLIT_KV_BYTES
    # shared memory of csrc/split_attention.cuh's split bodies, beside the
    # ring's static keep flags
    if pa.body(dt, hd) == pa.TENSOR_CORE:
        smem = ((-(-rows // 16) * 16 + 2 * sps) * (hd + 8) * 2
                + 4 * 16 * (hd + 2) * 4)
    else:
        assert rows * sps <= da.SPLIT_PAIRS
        smem = (rows * hd * 4 + sps * (2 * hd + 16 // elt) * elt
                + rows * sps * 4)
    assert smem + 4 * (da.MAX_SLOTS + 1) <= 232448


def test_ring_plan_at_the_slot_engine_shape():
    """The timed shape (slot engine, edge-6b heads, a 1024-slot ring): 8
    splits of 128 slots (16 rows a tile), where one block per (sequence,
    KV head) ran before."""
    assert da.plan(16, 128, 1024, torch.bfloat16) == (16, 128, 8)


def _ssd(B, T, H, P, N, seed):
    """x, dt, b, c as strided splits of one [B,T,H*P+2N+H] projection (as
    the mixer passes them), scaled so outputs stay O(1), and the [H]
    parameters at the JAX init's values."""
    rng = np.random.default_rng(seed)
    W = H * P + 2 * N + H
    proj = rng.standard_normal((B, T, W)).astype(np.float32)
    proj[..., :H * P] *= 0.5
    proj[..., H * P:H * P + 2 * N] *= N ** -0.5
    proj[..., H * P + 2 * N:] *= 0.5
    x = proj[..., :H * P].reshape(B, T, H, P)
    b = proj[..., H * P:H * P + N]
    c = proj[..., H * P + N:H * P + 2 * N]
    dt = proj[..., H * P + 2 * N:]
    a_log = np.log(np.linspace(1.0, 16.0, H)).astype(np.float32)
    d_skip = np.ones((H,), np.float32)
    dt_bias = (rng.standard_normal(H) * 0.1).astype(np.float32)
    return proj, (x, dt, a_log, b, c, d_skip, dt_bias)


@pytest.mark.parametrize("T", [1, 63, 64, 65, 200])
@pytest.mark.parametrize("B", [1, 2])
def test_ssd_passes_match_pallas_and_chunked(T, B):
    H, P, N = 5, 8, 16
    proj, arrs = _ssd(B, T, H, P, N, seed=T + B)
    tp = torch.from_numpy(proj)
    x = tp[..., :H * P].reshape(B, T, H, P)
    b = tp[..., H * P:H * P + N]
    c = tp[..., H * P + N:H * P + 2 * N]
    dt = tp[..., H * P + 2 * N:]
    base = tp.untyped_storage().data_ptr()                  # views of it
    assert all(t.untyped_storage().data_ptr() == base for t in (x, b, c))
    prm = [torch.from_numpy(a) for a in (arrs[2], arrs[5], arrs[6])]
    y, h = ref.ssd_scan_passes_ref(x, dt, prm[0], b, c, prm[1], prm[2])
    assert y.shape == (B, T, H, P) and h.shape == (B, H, P, N)
    assert y.dtype == torch.float32 and h.dtype == torch.float32
    yj, hj = jops.ssd_scan(*(jnp.asarray(np.ascontiguousarray(a))
                             for a in arrs), chunk=64, interpret=True)
    assert_logits_close(y.numpy(), np.asarray(yj))
    assert_logits_close(h.numpy(), np.asarray(hj))
    yc, hc = TS.ssd_chunked(x, dt, prm[0], b, c, prm[1], prm[2], chunk=64)
    assert_logits_close(y.numpy(), yc.numpy())
    assert_logits_close(h.numpy(), hc.numpy())


@pytest.mark.parametrize("dtype,P,N,want", [
    ("bfloat16", 64, 128, "tensor_core"),   # mamba2-780m
    ("bfloat16", 64, 16, "tensor_core"),    # hymba-1.5b
    ("bfloat16", 32, 16, "tensor_core"),
    ("bfloat16", 64, 256, "cuda_core"),     # state wider than 128
    ("bfloat16", 48, 128, "cuda_core"),     # P not a multiple of 32
    ("bfloat16", 64, 24, "cuda_core"),      # N not a multiple of 16
    ("float32", 64, 128, "cuda_core")])
def test_ssd_body_rule(dtype, P, N, want):
    assert ssd.body(getattr(torch, dtype), P, N) == want
