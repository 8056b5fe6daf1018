"""The port's CUDA kernels against their plain versions, on a card.

Marked ``cuda``: each test skips without a CUDA card (the kernels have no
CPU mode). Imports no JAX, so it runs on a machine that has only the
port's dependencies:

  PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Inputs at edge-6b head shapes (Hq=32, Hkv=2, hd=128, page 16), with a pad
row, -1 table entries and ragged prompt lengths; verify windows of C = 1,
3 and 5 queries at and across page boundaries; for the slot-cache
kernels, -1 slots, a wrapped ring, a window, chunk offsets and K/V read
through the strides of a [B,Hkv,S,hd] buffer. The flash-prefill kernels
also at query groups g = 1, 3, 5 and 16, head_dim 64 and 128 (the
tensor-core body in bf16), over several 64-key tiles with ragged ends,
windows whose edge falls inside a tile, non-causal rows, and chunk rows
that see no key (exact zeros). The SSD scan and decode step at mamba2-780m and hymba-1.5b widths and a ragged T, with inputs as
strided splits of one projection, pad and inactive rows over a shuffled
state arena; the decode step also at every branch of its slab plan
(N = 12, P = 80, N = 256, the reduced configs' width), and twice on the
same inputs, bit for bit; the grouped-expert FFN at granite-moe-3b-a800m widths and a
ragged shape with zero rows, and with per-group live-row counts (empty
groups, full ones, counts that are not multiples of 8 or 16, per-example
buffers, NaN past each count); the paged kernels over contexts up to 1023
at edge-6b, granite-moe and hymba heads, so rows span many page splits;
the ring-cache kernel's two split bodies (hd 32 to 256, rings of 77 to
1024 slots, wrapped, with holes and windows, empty rows); the three-pass
SSD scan from 1 to 1024 steps at mamba2-780m and hymba-1.5b widths.
The paged decode step's fused chain (residual add + RMSNorm, RoPE +
K/V page write, silu * mul) at edge-6b, granite, hymba, a rank's slab
and the reduced configs' shapes, rows 1 to 32, to one ulp of the working
type (reasons at the tests), with a spare-page row and an inactive row,
every other page slot untouched; each paged decode step's fused launches
(2L+1, L, L), and the cells' configurations at full width (2 layers,
bf16) captured against eager.
Then the engines' captured steps against the same steps run eagerly
(the slot engine also on mamba2-780m and hymba-1.5b, the SSD state in its
slot cache), a traced engine's decode ``graph_ms`` against events timed
around its graph's replay, and a reduced two-tier fleet on the card.
Before a checked call that must write exact zeros, a block of the
output's size is filled with NaN and freed, so the wrapper's torch.empty
gets poisoned memory back. Tolerances: fp32 1e-4 (summation order over
up to a few hundred terms), bf16 1.6e-2 (output rounding to bf16 of
values below ~4: the SSD and MoE inputs are scaled so outputs stay
there), against the plain version on the same inputs in fp32; fp32
states to 1e-4 of their largest magnitude.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops  # noqa: E402

TOL = {"float32": 1e-4, "bfloat16": 1.6e-2}


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")


def _paged_inputs(seed=0, Hq=32, Hkv=2, hd=128, psz=16, maxp=8, n_pages=40):
    rng = np.random.default_rng(seed)
    q_pos = np.array([0, psz - 1, psz, maxp * psz - 1, 2 * psz + 3], np.int32)
    pt = np.full((len(q_pos), maxp), -1, np.int32)
    perm = list(rng.permutation(n_pages))
    for b in range(1, len(q_pos)):                 # row 0: pad row
        pt[b, :q_pos[b] // psz + 1] = [perm.pop()
                                       for _ in range(q_pos[b] // psz + 1)]
    f = [rng.standard_normal(s).astype(np.float32)
         for s in ((len(q_pos), Hq, hd), (n_pages, Hkv, psz, hd),
                   (n_pages, Hkv, psz, hd))]
    return [torch.from_numpy(a) for a in (*f, pt, q_pos)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_decode_kernel_matches_plain(dtype):
    _need_cuda()
    q, kp, vp, pt, qp = _paged_inputs()
    dt = getattr(torch, dtype)
    dev = [x.to(dt).cuda() for x in (q, kp, vp)] + [pt.cuda(), qp.cuda()]
    before = ops.LAUNCHES["paged_decode_attention"]
    got = ops.paged_decode_attention(*dev).float().cpu()
    assert ops.LAUNCHES["paged_decode_attention"] == before + 1
    want = ops.paged_decode_attention(*[x.cpu().float() for x in dev[:3]],
                                      pt, qp)
    live = pt.max(dim=1).values >= 0
    assert torch.all(got[~live] == 0)              # pad row: 0, as on the TPU
    torch.testing.assert_close(got[live], want[live], atol=TOL[dtype], rtol=0)


def _verify_inputs(C, seed=0, Hq=32, Hkv=2, hd=128, psz=16, maxp=8,
                   n_pages=40):
    """A pad row (table all -1), windows starting just before and at a
    page boundary, one ending at the table's last position, one with
    trailing -1 entries."""
    rng = np.random.default_rng(seed + C)
    q_start = np.array([0, psz - 1, psz, maxp * psz - C, 2 * psz + 3],
                       np.int32)
    pt = np.full((len(q_start), maxp), -1, np.int32)
    perm = list(rng.permutation(n_pages))
    for b in range(1, len(q_start)):
        n = (q_start[b] + C - 1) // psz + 1
        pt[b, :n] = [perm.pop() for _ in range(n)]
    f = [rng.standard_normal(s).astype(np.float32)
         for s in ((len(q_start), C, Hq, hd), (n_pages, Hkv, psz, hd),
                   (n_pages, Hkv, psz, hd))]
    return [torch.from_numpy(a) for a in (*f, pt, q_start)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("C", [1, 3, 5])
def test_paged_verify_kernel_matches_plain(dtype, C):
    """C verify queries over 16 heads per KV head: R = C*16 rows per
    block, 80 at C = 5, past one 64-row tile."""
    _need_cuda()
    q, kp, vp, pt, qs = _verify_inputs(C)
    dt = getattr(torch, dtype)
    dev = [x.to(dt).cuda() for x in (q, kp, vp)] + [pt.cuda(), qs.cuda()]
    before = ops.LAUNCHES["paged_verify_attention"]
    got = ops.paged_verify_attention(*dev).float().cpu()
    assert ops.LAUNCHES["paged_verify_attention"] == before + 1
    want = ops.paged_verify_attention(*[x.cpu().float() for x in dev[:3]],
                                      pt, qs)
    live = pt.max(dim=1).values >= 0
    assert torch.all(got[~live] == 0)              # pad row: 0, as on the TPU
    torch.testing.assert_close(got[live], want[live], atol=TOL[dtype], rtol=0)


# (B, S, Hq, Hkv, hd, causal, window): edge-6b heads at ragged S, then
# groups g = 1, 3, 5, 16 at hd 64 and 128 (the tensor-core body in bf16)
# over several 64-key tiles with a ragged end, windows whose edge falls
# inside a tile, and non-causal rows
PREFILL_CASES = [
    (2, 77, 32, 2, 128, True, None), (2, 300, 32, 2, 128, True, 64),
    (2, 77, 32, 2, 128, False, None), (2, 1, 32, 2, 128, True, None),
    (2, 77, 2, 2, 64, True, None), (2, 300, 2, 2, 128, True, 100),
    (2, 1000, 6, 2, 64, True, None), (2, 300, 6, 2, 128, False, None),
    (2, 77, 10, 2, 64, False, 37), (2, 1000, 10, 2, 128, True, 200),
    (2, 300, 16, 1, 64, True, None), (2, 1000, 32, 2, 128, True, None),
    (2, 77, 16, 1, 128, True, 50),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,Hq,Hkv,hd,causal,window", PREFILL_CASES)
def test_flash_prefill_kernel_matches_plain(dtype, B, S, Hq, Hkv, hd, causal,
                                            window):
    _need_cuda()
    # the edge-6b cases keep the seed they had before the other heads came
    rng = np.random.default_rng(S if (Hq, Hkv, hd) == (32, 2, 128)
                                else S + Hq + hd)
    arrs = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for s in ((B, S, Hq, hd), (B, S, Hkv, hd), (B, S, Hkv, hd))]
    dt = getattr(torch, dtype)
    dev = [x.to(dt).cuda() for x in arrs]
    before = ops.LAUNCHES["flash_prefill"]
    got = ops.flash_prefill(*dev, causal=causal, window=window)
    assert ops.LAUNCHES["flash_prefill"] == before + 1
    assert got.dtype == dt
    want = ops.flash_prefill(*[x.cpu().float() for x in dev], causal=causal,
                             window=window)
    torch.testing.assert_close(got.float().cpu(), want, atol=TOL[dtype],
                               rtol=0)


def _ring_inputs(seed=0, Hq=32, Hkv=2, hd=128, S=1024):
    """Rows: empty (all -1), 300 appended tokens, a ring wrapped twice
    (slot p % S holds p), and a random history with holes."""
    rng = np.random.default_rng(seed)
    q_pos = np.array([0, 299, 2 * S + 100, 700], np.int32)
    kv_pos = np.full((4, S), -1, np.int32)
    kv_pos[1, :300] = np.arange(300)
    for p in range(q_pos[2] - S + 1, q_pos[2] + 1):
        kv_pos[2, p % S] = p
    kv_pos[3] = rng.integers(0, 900, S)
    kv_pos[3, ::7] = -1
    f = [rng.standard_normal(s).astype(np.float32)
         for s in ((4, Hq, hd), (4, Hkv, S, hd), (4, Hkv, S, hd))]
    return [torch.from_numpy(a) for a in (*f, kv_pos, q_pos)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [None, 64, 8192])
def test_decode_attention_kernel_matches_plain(dtype, window):
    _need_cuda()
    q, k, v, kp, qp = _ring_inputs()
    dt = getattr(torch, dtype)
    dev = [x.to(dt).cuda() for x in (q, k, v)] + [kp.cuda(), qp.cuda()]
    before = ops.LAUNCHES["decode_attention"]
    got = ops.decode_attention(*dev, window=window).float().cpu()
    assert ops.LAUNCHES["decode_attention"] == before + 1
    want = ops.decode_attention(*[x.cpu().float() for x in dev[:3]], kp, qp,
                                window=window)
    d = qp[:, None] - kp
    live = ((kp >= 0) & (d >= 0) & (d < (window or 1 << 30))).any(dim=1)
    assert not live[0] and live[1:].all()
    assert torch.all(got[~live] == 0)              # empty row: 0
    torch.testing.assert_close(got[live], want[live], atol=TOL[dtype], rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [None, 64])
def test_decode_attention_kernel_lse_matches_plain(dtype, window):
    """``return_lse``: the kernel's output and each row's log-sum-exp
    against the plain version's on a 512-slot slice of a ring (a rank's
    half of 1024 slots), the empty row out 0 and lse -1e30; one launch."""
    _need_cuda()
    q, k, v, kp, qp = _ring_inputs(S=1024)
    k, v, kp = (x[..., 512:, :] if x.ndim == 4 else x[:, 512:]
                for x in (k, v, kp))
    dt = getattr(torch, dtype)
    dev = ([x.to(dt).contiguous().cuda() for x in (q, k, v)]
           + [kp.contiguous().cuda(), qp.cuda()])
    before = ops.LAUNCHES["decode_attention"]
    out, lse = ops.decode_attention(*dev, window=window, return_lse=True)
    assert ops.LAUNCHES["decode_attention"] == before + 1
    want, want_lse = ops.decode_attention(
        *[x.cpu().float() for x in dev[:3]], kp.contiguous(), qp,
        window=window, return_lse=True)
    empty = want_lse[:, 0] == -1e30
    assert empty[0] and not empty.all()
    assert torch.all(out[empty].float() == 0)
    assert torch.all(lse[empty].cpu() == -1e30)
    torch.testing.assert_close(out[~empty].float().cpu(), want[~empty],
                               atol=TOL[dtype], rtol=0)
    torch.testing.assert_close(lse[~empty].cpu(), want_lse[~empty],
                               atol=TOL[dtype], rtol=0)


# (C, q_start of row 0, window, Hq, Hkv, hd) over a 1024-slot buffer: the
# edge-6b cases, the serving run's chunk (C 64 at 192), then g = 1, 3, 5,
# 16 at hd 64 and 128 with chunks crossing several 64-key tiles, ragged
# ends, windows inside a tile and a chunk ending near the buffer's end
CHUNK_CASES = [
    (1, 0, None, 32, 2, 128), (37, 16, None, 32, 2, 128),
    (64, 300, 64, 32, 2, 128), (128, 0, None, 32, 2, 128),
    (64, 192, None, 32, 2, 128), (77, 0, None, 2, 2, 64),
    (300, 100, None, 6, 2, 128), (37, 500, 100, 10, 2, 64),
    (1000, 0, None, 16, 1, 128), (64, 900, 77, 6, 2, 64),
    (13, 1000, None, 10, 2, 128), (300, 33, 130, 2, 2, 128),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("C,q_start,window,Hq,Hkv,hd", CHUNK_CASES)
def test_flash_prefill_chunk_kernel_matches_plain(dtype, C, q_start, window,
                                                  Hq, Hkv, hd):
    """K/V as the strided view of a [B,Hkv,S,hd] buffer full of stale data
    past the chunk; row 1 starts 5 positions later than row 0."""
    _need_cuda()
    rng = np.random.default_rng(C if (Hq, Hkv, hd) == (32, 2, 128)
                                else C + q_start + hd)
    S = 1024
    arrs = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for s in ((2, C, Hq, hd), (2, Hkv, S, hd), (2, Hkv, S, hd))]
    dt = getattr(torch, dtype)
    q, k, v = (x.to(dt).cuda() for x in arrs)
    qs = torch.tensor([q_start, q_start + 5], dtype=torch.int32).cuda()
    before = ops.LAUNCHES["flash_prefill_chunk"]
    got = ops.flash_prefill_chunk(q, k.transpose(1, 2), v.transpose(1, 2), qs,
                                  window=window)
    assert ops.LAUNCHES["flash_prefill_chunk"] == before + 1
    assert got.dtype == dt
    want = ops.flash_prefill_chunk(
        q.float().cpu(), k.float().cpu().transpose(1, 2),
        v.float().cpu().transpose(1, 2), qs.cpu(), window=window)
    torch.testing.assert_close(got.float().cpu(), want, atol=TOL[dtype],
                               rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [64, 128])
def test_flash_prefill_chunk_rows_without_keys_give_zero(dtype, hd):
    """Chunks that start past the buffer's end, with a window: rows whose
    window holds no key write exact zeros, the others match the plain
    version (which averages over every key for a row with none)."""
    _need_cuda()
    rng = np.random.default_rng(hd)
    S, C, window = 1024, 64, 48
    arrs = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for s in ((2, C, 6, hd), (2, 2, S, hd), (2, 2, S, hd))]
    dt = getattr(torch, dtype)
    q, k, v = (x.to(dt).cuda() for x in arrs)
    qs = torch.tensor([S - 34, S + 36], dtype=torch.int32)
    got = ops.flash_prefill_chunk(q, k.transpose(1, 2), v.transpose(1, 2),
                                  qs.cuda(), window=window).float().cpu()
    want = ops.flash_prefill_chunk(
        q.float().cpu(), k.float().cpu().transpose(1, 2),
        v.float().cpu().transpose(1, 2), qs, window=window)
    seen = qs[:, None] + torch.arange(C) - window + 1 <= S - 1
    assert seen[0].all() and int(seen[1].sum()) == 11
    assert torch.all(got[~seen] == 0)
    torch.testing.assert_close(got[seen], want[seen], atol=TOL[dtype], rtol=0)


@pytest.mark.cuda
def test_wrappers_reject_what_the_kernels_do_not_take():
    _need_cuda()
    q, kp, vp, pt, qp = [x.cuda() for x in _paged_inputs()]
    with pytest.raises(ValueError, match="int32"):
        ops.paged_decode_attention(q, kp, vp, pt.long(), qp)
    with pytest.raises(ValueError, match="mixed devices"):
        ops.paged_decode_attention(q, kp.cpu(), vp, pt, qp)
    with pytest.raises(ValueError, match="contiguous"):
        ops.paged_decode_attention(q.transpose(0, 1).contiguous()
                                   .transpose(0, 1), kp, vp, pt, qp)
    with pytest.raises(ValueError, match="types"):
        ops.paged_decode_attention(q.half(), kp.half(), vp.half(), pt, qp)
    q, k, v, kv, qp = [x.cuda() for x in _ring_inputs()]
    k_cols = k.transpose(2, 3).contiguous().transpose(2, 3)   # hd strided
    with pytest.raises(ValueError, match="contiguous"):
        ops.decode_attention(q, k_cols, v, kv, qp)
    with pytest.raises(ValueError, match="last dimension"):
        ops.flash_prefill_chunk(q[:, None], k_cols.transpose(1, 2),
                                v.transpose(1, 2), qp)
    # the tensor-core body reads K/V by TMA: a position stride of 132
    # elements (264 bytes) is not a multiple of 16 bytes
    qb = q[:, None].to(torch.bfloat16)
    wide = torch.zeros(*k.shape[:3], 132, dtype=torch.bfloat16,
                       device="cuda")[..., :128]
    with pytest.raises(ValueError, match="16 bytes"):
        ops.flash_prefill_chunk(qb, wide.transpose(1, 2),
                                wide.transpose(1, 2), qp)
    # the fused decode chain: 16-byte vectors, one type, int64 slots
    x = torch.zeros(4, 1536, dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError, match="16-byte aligned"):
        ops.add_rms_norm(x.view(-1)[1:1 + 1535 * 4].view(4, 1535), None,
                         x[0, :1535], 1e-5)
    with pytest.raises(ValueError, match="types"):
        ops.add_rms_norm(x, None, x[0].float(), 1e-5)
    with pytest.raises(ValueError, match="mixed devices"):
        ops.silu_mul(x, x.cpu())
    with pytest.raises(ValueError, match="contiguous"):
        ops.silu_mul(x.T, x.T)
    rq, rk, rv, rqp, rfr, rkp, rvp, rwp, rwo = _fused_rope_inputs(
        "bfloat16", 32, 2, 128, 4)
    with pytest.raises(ValueError, match="int64"):
        ops.rope_kv_write(rq, rk, rv, rqp, rfr, rkp, rvp, rwp.int(), rwo)
    with pytest.raises(ValueError, match="head_dim 96"):
        ops.rope_kv_write(rq[..., :96].contiguous(), rk[..., :96].contiguous(),
                          rv[..., :96].contiguous(), rqp, rfr[:48],
                          rkp[..., :96].contiguous(),
                          rvp[..., :96].contiguous(), rwp, rwo)


def _ssd_inputs(B, T, H, P, N, seed=0):
    """x, dt, b, c as strided splits of one [B,T,H*P+H+2N] projection (as
    the mixer passes them), the [H] parameters at the JAX init's values;
    x scaled by 0.5 and b, c by N^-0.5 so outputs stay below 4."""
    rng = np.random.default_rng(seed)
    W = H * P + 2 * N + H
    proj = rng.standard_normal((B, T, W)).astype(np.float32)
    proj[..., :H * P] *= 0.5
    proj[..., H * P:H * P + 2 * N] *= N ** -0.5
    proj[..., H * P + 2 * N:] *= 0.5
    proj = torch.from_numpy(proj)
    params = [torch.log(torch.linspace(1.0, 16.0, H)), torch.ones(H),
              torch.from_numpy(rng.standard_normal(H).astype(np.float32)) * 0.1]
    return proj, params


def _ssd_split(proj, H, P, N):
    B, T = proj.shape[:2]
    x = proj[..., :H * P].reshape(B, T, H, P)
    b = proj[..., H * P:H * P + N]
    c = proj[..., H * P + N:H * P + 2 * N]
    dt = proj[..., H * P + 2 * N:]
    return x, dt, b, c


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,T,H,P,N", [(1, 256, 48, 64, 128),   # mamba2
                                       (1, 100, 50, 64, 16),    # hymba
                                       (2, 77, 4, 32, 16),      # ragged
                                       (1, 1, 2, 32, 16)])
def test_ssd_scan_kernel_matches_plain(dtype, B, T, H, P, N):
    _need_cuda()
    proj, (a_log, d_skip, dt_bias) = _ssd_inputs(B, T, H, P, N, seed=T)
    dt_ = getattr(torch, dtype)
    proj_d = proj.to(dt_).cuda()
    prm = [t.to(dt_).cuda() for t in (a_log, d_skip, dt_bias)]
    x, dt, b, c = _ssd_split(proj_d, H, P, N)
    before = ops.LAUNCHES["ssd_scan"]
    y, h = ops.ssd_scan(x, dt, prm[0], b, c, prm[1], prm[2])
    assert ops.LAUNCHES["ssd_scan"] == before + 1
    assert y.dtype == dt_ and h.dtype == torch.float32
    xc, dtc, bc, cc = _ssd_split(proj_d.float().cpu(), H, P, N)
    pc = [t.float().cpu() for t in prm]
    y_w, h_w = ops.ssd_scan(xc, dtc, pc[0], bc, cc, pc[1], pc[2])
    torch.testing.assert_close(y.float().cpu(), y_w, atol=TOL[dtype], rtol=0)
    torch.testing.assert_close(h.cpu(), h_w, rtol=0,
                               atol=TOL["float32"] * max(1.0, h_w.abs().max()))


# the slab plan's branches (kernels/ssd_decode.plan): mamba2-780m (slabs
# of 16 rows, shuffle sums), hymba-1.5b and the reduced configs (a whole
# tile a slab), N = 12 (N/4 = 3: sums in shared memory), P = 80 (a
# ragged last slab of 16 rows after two of 32), N = 256 (a 64 KB tile in
# slabs of 8 rows, N/4 = 64 past a warp)
SSD_DECODE_SHAPES = [(48, 64, 128), (50, 64, 16), (4, 32, 16), (4, 24, 12),
                     (4, 80, 64), (2, 64, 256)]


def _ssd_step_inputs(dtype, H, P, N, B=5, S=12):
    """Step inputs on the card as strided splits of one projection, the
    [H] parameters, and a random arena of S slots on the CPU."""
    proj, (a_log, d_skip, dt_bias) = _ssd_inputs(B, 1, H, P, N, seed=H)
    rng = np.random.default_rng(N)
    arena = torch.from_numpy(0.5 * rng.standard_normal((S, H, P, N))
                             .astype(np.float32))
    dt_ = getattr(torch, dtype)
    proj_d = proj[:, 0].to(dt_).cuda()
    prm = [t.to(dt_).cuda() for t in (a_log, d_skip, dt_bias)]
    return proj_d, prm, arena


def _ssd_step_split(pr, H, P, N):
    B = pr.shape[0]
    return (pr[:, :H * P].reshape(B, H, P), pr[:, H * P + 2 * N:],
            pr[:, H * P:H * P + N], pr[:, H * P + N:H * P + 2 * N])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("H,P,N", SSD_DECODE_SHAPES)
def test_ssd_decode_kernel_matches_plain(dtype, H, P, N):
    """Rows over a shuffled arena of 12 slots: a pad row (slot -1), an
    inactive row, three live rows. The arena after the step equals the
    plain version's bit for bit in every slot no live row writes."""
    _need_cuda()
    B, S = 5, 12
    proj_d, prm, arena = _ssd_step_inputs(dtype, H, P, N, B, S)
    slots = torch.tensor([7, -1, 2, 11, 0], dtype=torch.int32)
    active = torch.tensor([True, False, False, True, True])
    x, dt, b, c = _ssd_step_split(proj_d, H, P, N)
    st = arena.cuda()
    before = ops.LAUNCHES["ssd_decode_step"]
    y = ops.ssd_decode_step(x, dt, prm[0], b, c, prm[1], prm[2], st,
                            slots.cuda(), active.cuda())
    assert ops.LAUNCHES["ssd_decode_step"] == before + 1
    xc, dtc, bc, cc = _ssd_step_split(proj_d.float().cpu(), H, P, N)
    pc = [t.float().cpu() for t in prm]
    st_w = arena.clone()
    y_w = ops.ssd_decode_step(xc, dtc, pc[0], bc, cc, pc[1], pc[2], st_w,
                              slots, active)
    live = slots >= 0
    assert torch.all(y[~live.cuda()] == 0)
    torch.testing.assert_close(y.float().cpu()[live], y_w[live],
                               atol=TOL[dtype], rtol=0)
    written = [7, 11, 0]                 # the active rows' slots
    kept = [s for s in range(S) if s not in written]
    assert torch.equal(st.cpu()[kept], arena[kept])
    torch.testing.assert_close(st.cpu()[written], st_w[written], rtol=0,
                               atol=TOL["float32"] * max(1.0, st_w.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("H,P,N", [(48, 64, 128), (4, 24, 12)])
def test_ssd_decode_kernel_is_deterministic(H, P, N):
    """Two calls on the same inputs and the same arena give bit-identical
    y and arena, by shuffles (N = 128) and by shared-memory sums (N = 12):
    the captured steps are held bit for bit to the eager ones."""
    _need_cuda()
    proj_d, prm, arena = _ssd_step_inputs("bfloat16", H, P, N)
    x, dt, b, c = _ssd_step_split(proj_d, H, P, N)
    slots = torch.tensor([7, -1, 2, 11, 0], dtype=torch.int32).cuda()
    active = torch.tensor([True, False, False, True, True]).cuda()
    outs = []
    for _ in range(2):
        st = arena.cuda()
        y = ops.ssd_decode_step(x, dt, prm[0], b, c, prm[1], prm[2], st,
                                slots, active)
        outs.append((y, st))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])
    assert not torch.equal(outs[0][1], arena.cuda())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("G,E,C,D,F", [(40, 40, 64, 1536, 512),   # granite
                                       (8, 4, 37, 96, 80)])        # ragged
def test_moe_grouped_ffn_kernel_matches_plain(dtype, G, E, C, D, F):
    """Weights at the JAX init's scales; the buffer's second half of rows
    is zero (an expert's unused capacity) and must give zero rows."""
    _need_cuda()
    rng = np.random.default_rng(G + C)
    buf = rng.standard_normal((G, C, D)).astype(np.float32)
    buf[:, C // 2:] = 0.0
    ws = [rng.standard_normal(s).astype(np.float32) * sc for s, sc in
          (((E, D, F), D ** -0.5), ((E, D, F), D ** -0.5),
           ((E, F, D), F ** -0.5))]
    dt_ = getattr(torch, dtype)
    dev = [torch.from_numpy(a).to(dt_).cuda() for a in (buf, *ws)]
    before = ops.LAUNCHES["moe_grouped_ffn"]
    got = ops.moe_grouped_ffn(*dev)
    assert ops.LAUNCHES["moe_grouped_ffn"] == before + 1
    assert got.dtype == dt_ and got.shape == (G, C, D)
    want = ops.moe_grouped_ffn(*[t.float().cpu() for t in dev])
    assert torch.all(got[:, C // 2:] == 0)
    torch.testing.assert_close(got.float().cpu(), want, atol=TOL[dtype],
                               rtol=0)


def _poison(shape, dtype):
    """Fill a block of an output's size with NaN and free it, so that the
    wrapper's torch.empty most likely gets that memory back: a row the
    kernel fails to write then reads NaN, not a stale zero."""
    torch.cuda.empty_cache()
    torch.full(shape, float("nan"), dtype=dtype, device="cuda")


def _moe_counts(G, C, rule, rng):
    """Live rows per group: "skew" gives group 0 every row, most groups
    none and a few 1-3 (a skewed decode routing); "mixed" draws counts in
    [0, C] with every fifth group empty, one full and ones that are not
    multiples of 8 or 16."""
    if rule == "skew":
        c = np.zeros(G, np.int32)
        c[0] = C
        c[[3, 7, 11]] = [1, 2, 3]
        return c
    c = rng.integers(0, C + 1, G).astype(np.int32)
    c[::5] = 0
    c[1], c[2], c[3] = C, min(13, C), min(37, C)
    return c


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("G,E,C,D,F,rule", [
    (40, 40, 64, 1536, 512, "skew"),      # granite decode, empty experts
    (40, 40, 64, 1536, 512, "mixed"),
    (120, 40, 64, 1536, 512, "mixed"),    # per-example buffers G = B*E
    (8, 4, 37, 96, 80, "mixed"),          # ragged
    (4, 4, 130, 96, 80, "mixed")])        # more than 64 live rows a group
def test_moe_grouped_ffn_counts_match_plain(dtype, G, E, C, D, F, rule):
    """Rows at or past a group's count hold NaN in the buffer: the kernel
    never reads them and writes them as exact zeros into a poisoned
    output; live rows equal the plain version on the same inputs."""
    _need_cuda()
    rng = np.random.default_rng(G + C + D)
    counts = _moe_counts(G, C, rule, rng)
    buf = rng.standard_normal((G, C, D)).astype(np.float32)
    dead = np.arange(C)[None, :] >= counts[:, None]
    buf[dead] = np.nan
    ws = [rng.standard_normal(s).astype(np.float32) * sc for s, sc in
          (((E, D, F), D ** -0.5), ((E, D, F), D ** -0.5),
           ((E, F, D), F ** -0.5))]
    dt_ = getattr(torch, dtype)
    dev = [torch.from_numpy(a).to(dt_).cuda() for a in (buf, *ws)]
    cnt = torch.from_numpy(counts).cuda()
    _poison((G, C, D), dt_)
    before = ops.LAUNCHES["moe_grouped_ffn"]
    got = ops.moe_grouped_ffn(*dev, cnt)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["moe_grouped_ffn"] == before + 1
    got = got.float().cpu()
    dead = torch.from_numpy(dead)
    assert torch.all(got[dead] == 0)
    want = ops.moe_grouped_ffn(*[t.float().cpu() for t in dev],
                               torch.from_numpy(counts))
    torch.testing.assert_close(got[~dead], want[~dead], atol=TOL[dtype],
                               rtol=0)


def _split_inputs(C, Hq, Hkv, hd, seed, psz=16, maxp=64, n_pages=700):
    """Rows over a 64-page table (maxp x psz - 1 = 1023 the last
    position): a pad row, one page, page boundaries, a long row with -1
    entries inside its table, and windows ending at 1023."""
    rng = np.random.default_rng(seed)
    q_start = np.array([0, 0, psz - C, psz, 300, 517, 1000,
                        maxp * psz - C], np.int32)
    pt = np.full((len(q_start), maxp), -1, np.int32)
    perm = list(rng.permutation(n_pages))
    for b in range(1, len(q_start)):
        n = (q_start[b] + C - 1) // psz + 1
        pt[b, :n] = [perm.pop() for _ in range(n)]
    pt[5, [3, 10, 31]] = -1
    f = [rng.standard_normal(s).astype(np.float32)
         for s in ((len(q_start), C, Hq, hd), (n_pages, Hkv, psz, hd),
                   (n_pages, Hkv, psz, hd))]
    return [torch.from_numpy(a) for a in (*f, pt, q_start)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Hq,Hkv,hd,psz", [
    (32, 2, 128, 16), (24, 8, 64, 16), (25, 5, 64, 16),   # edge, granite,
    (32, 2, 128, 8),                                      # hymba; pages
    (8, 2, 32, 16), (16, 1, 256, 16)])                    # of 8; hd 32/256
@pytest.mark.parametrize("C", [1, 5])
def test_paged_split_kernels_match_plain(dtype, Hq, Hkv, hd, psz, C):
    """Decode (C = 1) and verify (C = 5) at edge-6b, granite-moe and hymba
    heads over contexts up to the table's last position, so rows span
    many page splits and later splits are empty; pages of 8 tokens (half
    a 16-key block of the tensor-core body) and hd 32 / 256 (bf16 on the
    CUDA cores); the pad row reads exact 0 from a poisoned output."""
    _need_cuda()
    q, kp, vp, pt, qs = _split_inputs(C, Hq, Hkv, hd, seed=Hq + C, psz=psz,
                                      maxp=1024 // psz, n_pages=1400)
    dt = getattr(torch, dtype)
    dev = [x.to(dt).cuda() for x in (q, kp, vp)] + [pt.cuda(), qs.cuda()]
    if C == 1:
        name, fn = "paged_decode_attention", ops.paged_decode_attention
        dev[0] = dev[0][:, 0].contiguous()
    else:
        name, fn = "paged_verify_attention", ops.paged_verify_attention
    _poison(dev[0].shape, dt)
    before = ops.LAUNCHES[name]
    got = fn(*dev)
    torch.cuda.synchronize()
    assert ops.LAUNCHES[name] == before + 1
    got = got.float().cpu()
    want = fn(*[x.cpu().float() for x in dev[:3]], pt, qs)
    live = pt.max(dim=1).values >= 0
    assert not live[0] and torch.all(got[0] == 0)
    torch.testing.assert_close(got[live], want[live], atol=TOL[dtype], rtol=0)


def _ring_split_inputs(Hq, Hkv, hd, S, seed):
    """Rows over an S-slot ring: an empty row (every slot -1), an
    append-only row (later slot splits empty), a ring wrapped twice (slot
    p % S holds p), random positions with -1 holes and many past q_pos,
    a full ring, and a few live slots past the first split."""
    rng = np.random.default_rng(seed)
    q_pos = np.array([0, S // 3, 2 * S + 17, 700, S - 1, 40], np.int32)
    kv = np.full((len(q_pos), S), -1, np.int32)
    kv[1, :S // 3 + 1] = np.arange(S // 3 + 1)
    for p in range(q_pos[2] - S + 1, q_pos[2] + 1):
        kv[2, p % S] = p
    kv[3] = rng.integers(0, 900, S)
    kv[3, ::7] = -1
    kv[3, 1] = 690                                # live under a window
    kv[4] = np.arange(S)
    kv[5, S // 2:S // 2 + 5] = np.arange(30, 35)
    f = [rng.standard_normal(s).astype(np.float32)
         for s in ((len(q_pos), Hq, hd), (len(q_pos), Hkv, S, hd),
                   (len(q_pos), Hkv, S, hd))]
    return [torch.from_numpy(a) for a in (*f, kv, q_pos)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Hq,Hkv,hd,S", [
    (32, 2, 128, 1024), (24, 8, 64, 1024), (25, 5, 64, 1000),  # edge,
    (8, 2, 32, 300), (16, 1, 256, 77)])           # granite, hymba; hd 32/256
@pytest.mark.parametrize("window", [None, 64])
def test_decode_attention_split_bodies_match_plain(dtype, Hq, Hkv, hd, S,
                                                   window):
    """Both split bodies of the ring-cache kernel (bf16 at hd 64/128 on
    the tensor cores, the rest on the CUDA cores) over rings of 77 to 1024
    slots, ragged last splits included: empty rows read exact 0 from a
    poisoned output, the wrapped ring and the holes equal the plain
    version, one launch a call."""
    _need_cuda()
    q, k, v, kv, qp = _ring_split_inputs(Hq, Hkv, hd, S, seed=Hq + S)
    dt = getattr(torch, dtype)
    dev = [x.to(dt).cuda() for x in (q, k, v)] + [kv.cuda(), qp.cuda()]
    _poison(dev[0].shape, dt)
    before = ops.LAUNCHES["decode_attention"]
    got = ops.decode_attention(*dev, window=window)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["decode_attention"] == before + 1
    got = got.float().cpu()
    want = ops.decode_attention(*[x.cpu().float() for x in dev[:3]], kv, qp,
                                window=window)
    d = qp[:, None] - kv
    live = ((kv >= 0) & (d >= 0) & (d < (window or 1 << 30))).any(dim=1)
    assert not live[0] and live[1:].all()
    assert torch.all(got[~live] == 0)
    torch.testing.assert_close(got[live], want[live], atol=TOL[dtype], rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("H,P,N", [(48, 64, 128), (50, 64, 16)])
@pytest.mark.parametrize("B,T", [(1, 1), (2, 63), (1, 64), (2, 65),
                                 (1, 200), (1, 1024)])
def test_ssd_scan_passes_match_plain(dtype, H, P, N, B, T):
    """The three-pass scan at mamba2-780m and hymba-1.5b widths, from one
    step to 16 chunks, inputs as strided splits of one projection: y into
    a poisoned output and the final state against the plain version (and
    its three-pass form), one launch a call."""
    _need_cuda()
    from repro_torch.kernels import ref
    proj, (a_log, d_skip, dt_bias) = _ssd_inputs(B, T, H, P, N, seed=T + N)
    dt_ = getattr(torch, dtype)
    proj_d = proj.to(dt_).cuda()
    prm = [t.to(dt_).cuda() for t in (a_log, d_skip, dt_bias)]
    x, dt, b, c = _ssd_split(proj_d, H, P, N)
    _poison((B, T, H, P), dt_)
    before = ops.LAUNCHES["ssd_scan"]
    y, h = ops.ssd_scan(x, dt, prm[0], b, c, prm[1], prm[2])
    torch.cuda.synchronize()
    assert ops.LAUNCHES["ssd_scan"] == before + 1
    xc, dtc, bc, cc = _ssd_split(proj_d.float().cpu(), H, P, N)
    pc = [t.float().cpu() for t in prm]
    y_w, h_w = ops.ssd_scan(xc, dtc, pc[0], bc, cc, pc[1], pc[2])
    y_p, h_p = ref.ssd_scan_passes_ref(xc, dtc, pc[0], bc, cc, pc[1], pc[2])
    atol_h = TOL["float32"] * max(1.0, h_w.abs().max())
    for yw, hw in ((y_w, h_w), (y_p, h_p)):
        torch.testing.assert_close(y.float().cpu(), yw, atol=TOL[dtype],
                                   rtol=0)
        torch.testing.assert_close(h.cpu(), hw, rtol=0, atol=atol_h)


# ------------------------------------------- captured decode-type steps

def _tasks(lens, base, out=40):
    from repro_torch.core.task import SLOSpec, Task
    return [Task(SLOSpec(tpot_ms=100.0), 1.0, prompt_len=n, output_len=out,
                 task_id=base + i) for i, n in enumerate(lens)]


def _eager_and_captured(arch, slot=False, self_draft=False, **kw):
    """Two reduced fp32 engines on the card over the same weights: the
    first runs its decode-type steps eagerly (``cuda_graphs=False``), the
    second captures them. ``self_draft``: speculative decoding with the
    target as its own draft."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.serving.executor import PagedTorchExecutor, TorchExecutor
    cfg = get_config(arch).reduced()
    params = M.init_params(cfg, seed=0, device="cuda")
    if self_draft:
        kw.update(spec_decode=True, draft_cfg=cfg, draft_params=params,
                  max_spec_depth=4)
    if slot:
        make = lambda g: TorchExecutor(cfg, params=params, max_slots=4,  # noqa: E731
                                       max_seq=128, device="cuda",
                                       cuda_graphs=g, **kw)
    else:
        make = lambda g: PagedTorchExecutor(  # noqa: E731
            cfg, params=params, n_pages=48, page_size=16, max_seq=128,
            max_batch=4, device="cuda", cuda_graphs=g, **kw)
    return cfg, make(False), make(True)


def _run_both(engines, tasks, batches, depths=None):
    """Prefill ``tasks`` on both engines, then the same decode calls on
    each (eager first), launches counted per engine from zero. Returns
    (per-step logits per engine, launches per engine, streams per
    engine)."""
    logits = ([], [])
    launches = []
    for e, ex in enumerate(engines):
        for t in tasks:
            ex.prefill(t)
        ops.reset_launches()
        for n, d in zip(batches, depths or [None] * len(batches)):
            ex.decode(tasks[:n], d)
            logits[e].append(ex.last_logits)
        torch.cuda.synchronize()
        launches.append(dict(ops.LAUNCHES))
    streams = [[ex.generated_tokens(t) for t in tasks] for ex in engines]
    return logits, launches, streams


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["edge-6b", "mamba2-780m",
                                  "granite-moe-3b-a800m", "hymba-1.5b"])
def test_captured_paged_decode_matches_eager(arch):
    """The paged engine's decode steps captured against the same steps
    run eagerly, over buckets 1, 2 and 4: dense, SSM and hybrid logits
    bit for bit (the same kernels on the same inputs) and streams
    identical; MoE logits within fp32's 1e-4 (its dispatch adds with
    atomics, so two eager runs differ in the last bits too); launch
    counts equal; every bucket captured once and replayed."""
    _need_cuda()
    cfg, eager, graphs = _eager_and_captured(arch)
    tasks = _tasks((5, 17, 40), 8100)
    batches = [3, 3, 2, 1, 3, 2, 1, 3]
    logits, launches, streams = _run_both((eager, graphs), tasks, batches)
    for a, b in zip(*logits):
        if cfg.block_kind == "moe":
            np.testing.assert_allclose(b, a, atol=TOL["float32"], rtol=0)
        else:
            np.testing.assert_array_equal(b, a)
    if cfg.block_kind != "moe":
        assert streams[0] == streams[1]
    assert launches[0] == launches[1] and sum(launches[1].values()) > 0
    steps = {k: s for k, s in graphs.graphs.steps.items() if k[0] == "decode"}
    assert set(steps) == {("decode", 1), ("decode", 2), ("decode", 4)}
    assert all(s.graph is not None and s.runs > 0 for s in steps.values())
    assert not any(s.graph is not None for s in eager.graphs.steps.values())


@pytest.mark.cuda
def test_traced_decode_graph_ms_matches_events_around_its_replay():
    """A traced engine's captured decode step: the ``graph_ms`` its ops
    report (``step_graphs.PhaseTimer``) against a CUDA-event pair timed
    here around replays of the same graph on the same inputs, medians of
    20 within 10%; every phase >= 0 and one graph an op. The stream is
    held busy (``torch.cuda._sleep``) while the pair's first event is
    recorded and the graph launched, so the pair times the graph's
    device work without the host's launch, as ``graph_ms`` must."""
    _need_cuda()
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.serving.executor import PagedTorchExecutor
    cfg = get_config("edge-6b").reduced()
    ex = PagedTorchExecutor(cfg, params=M.init_params(cfg, seed=0,
                                                      device="cuda"),
                            n_pages=48, page_size=16, max_seq=128,
                            max_batch=4, device="cuda")
    tasks = _tasks((5, 17, 40, 9), 8300)
    for t in tasks:
        ex.prefill(t)
    ex.decode(tasks)                          # captures the step
    ex.attach_trace()
    phases = []
    for _ in range(20):
        ex.decode(tasks)
        phases.append(ex.last_phases)
    assert all(p["graphs"] == 1 and p["captures"] == 0 and p["gaps_ms"] == 0
               and min(p["stage_ms"], p["graph_ms"], p["commit_ms"]) >= 0
               for p in phases)
    graph = ex.graphs.steps[("decode", 4)].graph
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    timed = []
    for _ in range(20):
        torch.cuda.synchronize()
        torch.cuda._sleep(2_000_000)          # ~1 ms: longer than a launch
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        timed.append(a.elapsed_time(b))
    got = float(np.median([p["graph_ms"] for p in phases]))
    want = float(np.median(timed))
    assert abs(got - want) <= 0.1 * want, (got, want)


@pytest.mark.cuda
def test_captured_verify_matches_eager():
    """Speculative decoding with a self-draft: the verify steps captured
    per (batch, depth) bucket against the same steps run eagerly: logits
    bit for bit, commits, streams and launch counts equal."""
    _need_cuda()
    _, eager, graphs = _eager_and_captured("edge-6b", self_draft=True)
    tasks = _tasks((5, 17, 40), 8200)
    batches = [3, 3, 2, 1, 3, 2]
    depths = [[4, 0, 2], [1, 3, 0], [2, 2], [3], [0, 4, 1], [1, 1]]
    logits, launches, streams = _run_both((eager, graphs), tasks, batches,
                                          depths)
    for a, b in zip(*logits):
        np.testing.assert_array_equal(b, a)
    assert streams[0] == streams[1]
    assert launches[0] == launches[1]
    assert launches[1]["paged_verify_attention"] > 0
    verify = [s for k, s in graphs.graphs.steps.items() if k[0] == "verify"]
    assert verify and all(s.graph is not None for s in verify)
    assert any(s.runs for s in verify)


@pytest.mark.cuda
@pytest.mark.parametrize("compact", [False, True], ids=["masked", "compact"])
def test_captured_slot_decode_matches_eager(compact):
    """The slot engine's masked step and compacted bucket steps captured
    against eager: logits bit for bit, streams and launch counts
    equal."""
    _need_cuda()
    _, eager, graphs = _eager_and_captured("edge-6b", slot=True,
                                           compact_buckets=compact)
    tasks = _tasks((5, 17, 40), 8300)
    logits, launches, streams = _run_both((eager, graphs), tasks,
                                          [3, 1, 2, 3, 2, 1])
    for a, b in zip(*logits):
        np.testing.assert_array_equal(b, a)
    assert streams[0] == streams[1]
    assert launches[0] == launches[1]
    assert launches[1]["decode_attention"] > 0
    want = ({("compact", 1), ("compact", 2), ("compact", 4)} if compact
            else {("masked", 4)})
    want |= {("prefill", 5), ("prefill", 17), ("prefill", 40)}
    assert set(graphs.graphs.steps) == want
    assert all(s.graph is not None and s.runs > 0
               for s in graphs.graphs.steps.values())


@pytest.mark.cuda
def test_refused_launch_under_capture_raises_without_fallback(monkeypatch):
    """A kernel launch refused while the step is captured raises out of
    decode, the launch counter is as it was, and the next decode raises
    again: nothing falls back to the eager step."""
    _need_cuda()
    from repro_torch.kernels import paged_attention as _pa
    _, _, ex = _eager_and_captured("edge-6b")
    tasks = _tasks((5, 17), 8400)
    for t in tasks:
        ex.prefill(t)
    launch = _pa.launch

    def refusing(*a, **k):
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("paged_decode_attention kernel launch "
                               "failed: refused under capture")
        return launch(*a, **k)

    monkeypatch.setattr(_pa, "launch", refusing)
    ops.reset_launches()
    for _ in range(2):
        with pytest.raises(RuntimeError, match="refused under capture"):
            ex.decode(tasks)
        assert sum(ops.LAUNCHES.values()) == 0
    assert ("decode", 2) not in ex.graphs.steps


@pytest.mark.cuda
def test_replay_on_a_rebound_arena_raises():
    """The captured step checks that the arena tensors it writes are still
    the engine's: rebinding one makes the next decode raise."""
    _need_cuda()
    _, _, ex = _eager_and_captured("edge-6b")
    tasks = _tasks((5, 17), 8500)
    for t in tasks:
        ex.prefill(t)
    ex.decode(tasks)
    ex.pages["k_pages"] = ex.pages["k_pages"].clone()
    with pytest.raises(RuntimeError, match="arena"):
        ex.decode(tasks)


# ------------------------------------------- captured prefill-type steps

def _prefill_both(engines, tasks, how):
    """``how(ex, task)`` each task on both engines (eager first), launches
    counted per engine from zero, then two decode steps of every task.
    Returns (prefill logits per engine, launches per engine, streams per
    engine)."""
    logits = ([], [])
    launches = []
    for e, ex in enumerate(engines):
        ops.reset_launches()
        for t in tasks:
            how(ex, t)
            logits[e].append(ex.last_prefill_logits)
        for _ in range(2):
            ex.decode(tasks)
        torch.cuda.synchronize()
        launches.append(dict(ops.LAUNCHES))
    streams = [[ex.generated_tokens(t) for t in tasks] for ex in engines]
    return logits, launches, streams


def _assert_same(cfg, logits, launches, streams):
    for a, b in zip(*logits):
        if cfg.block_kind == "moe":
            np.testing.assert_allclose(b, a, atol=TOL["float32"], rtol=0)
        else:
            np.testing.assert_array_equal(b, a)
    if cfg.block_kind != "moe":
        assert streams[0] == streams[1]
    assert launches[0] == launches[1] and sum(launches[1].values()) > 0


def _chunked(ex, t, n=16):
    while not ex.prefill_chunk(t, n)[1]:
        pass


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["edge-6b", "mamba2-780m",
                                  "granite-moe-3b-a800m", "hymba-1.5b"])
def test_captured_paged_prefill_matches_eager(arch):
    """The paged engine's whole-prompt steps (one per prompt length, the
    splice into pages and state slot inside) captured against the same
    steps run eagerly: prefill logits bit for bit (MoE within 1e-4),
    streams, launch counts and the pool's part of every arena equal; one
    graph per length, a second prompt of a length replaying it."""
    _need_cuda()
    cfg, eager, graphs = _eager_and_captured(arch)
    tasks = _tasks((5, 17, 40, 17), 8600)
    logits, launches, streams = _prefill_both(
        (eager, graphs), tasks, lambda ex, t: ex.prefill(t))
    _assert_same(cfg, logits, launches, streams)
    n = eager.n_pages
    for name, arena in eager.pages.items():
        cut = n if name.endswith("pages") else eager.n_state_slots
        if cfg.block_kind == "moe":
            torch.testing.assert_close(graphs.pages[name][:, :cut],
                                       arena[:, :cut], atol=TOL["float32"],
                                       rtol=0)
        else:
            assert torch.equal(graphs.pages[name][:, :cut], arena[:, :cut])
    steps = {k: s for k, s in graphs.graphs.steps.items() if k[0] == "prefill"}
    assert set(steps) == {("prefill", 5), ("prefill", 17), ("prefill", 40)}
    assert all(s.graph is not None for s in steps.values())
    assert steps[("prefill", 17)].runs == 2


@pytest.mark.cuda
def test_captured_paged_chunk_and_suffix_match_eager():
    """Prefix-cache engines with chunks of 16: a whole prompt, a prefix
    hit whose suffix runs in power-of-two pieces, a chunked prompt and a
    chunked prefix hit, captured against eager: logits bit for bit,
    streams, hits and launch counts equal; every chunk step a graph."""
    _need_cuda()
    cfg, eager, graphs = _eager_and_captured(
        "edge-6b", prefill_chunk_size=16, prefix_cache=True)
    tasks = _tasks((40, 45, 37, 43), 8700)
    for t, g in zip(tasks, (0, 0, None, 0)):
        t.prefix_group, t.prefix_len = g, (32 if g is not None else 0)

    def how(ex, t):
        if t.task_id in (8700, 8701):
            ex.prefill(t)
        else:
            _chunked(ex, t)

    logits, launches, streams = _prefill_both((eager, graphs), tasks, how)
    _assert_same(cfg, logits, launches, streams)
    assert launches[1]["flash_prefill_chunk"] > 0
    assert graphs.prefix_cache.hits == eager.prefix_cache.hits >= 2
    chunks = [s for k, s in graphs.graphs.steps.items() if k[0] == "chunk"]
    assert chunks and all(s.graph is not None and s.runs for s in chunks)


@pytest.mark.cuda
def test_captured_slot_prefill_and_chunk_match_eager():
    """The slot engine's whole-prompt and chunk steps (gather the row,
    chunk, scatter back) captured against eager: logits bit for bit,
    streams and launch counts equal, the slot rows of the cache equal."""
    _need_cuda()
    cfg, eager, graphs = _eager_and_captured("edge-6b", slot=True,
                                             prefill_chunk_size=16)
    tasks = _tasks((5, 40, 23), 8800)

    def how(ex, t):
        if t.prompt_len == 5:
            ex.prefill(t)
        else:
            _chunked(ex, t)

    logits, launches, streams = _prefill_both((eager, graphs), tasks, how)
    _assert_same(cfg, logits, launches, streams)
    S = eager.max_slots
    for k, v in eager.cache.items():
        rows = (slice(None), slice(0, S)) if k in ("k", "v") else (
            slice(0, S),)
        assert torch.equal(graphs.cache[k][rows], v[rows]), k
    assert all(s.graph is not None for s in graphs.graphs.steps.values())
    assert {k[0] for k in graphs.graphs.steps} == {"prefill", "chunk",
                                                   "masked"}


@pytest.mark.cuda
@pytest.mark.parametrize("compact", [False, True], ids=["masked", "compact"])
@pytest.mark.parametrize("arch", ["mamba2-780m", "hymba-1.5b"])
def test_captured_slot_ssm_steps_match_eager(arch, compact):
    """The slot engine on an SSM and a hybrid arch: its whole-prompt steps
    (the SSD state and conv tail spliced into the slot; one prompt shorter
    than the conv width) and its masked or compacted decode steps (the
    state stepped in place over the cache's rows) captured against eager,
    across a release and a slot reused: logits bit for bit, streams and
    launch counts equal, the slot rows of the cache (state included)
    equal, the SSD kernels launched."""
    _need_cuda()
    cfg, eager, graphs = _eager_and_captured(arch, slot=True,
                                             compact_buckets=compact)
    tasks = _tasks((2, 17, 40), 8850)
    logits, launches, streams = _run_both((eager, graphs), tasks,
                                          [3, 1, 2, 3, 2, 1])
    later = _tasks((9,), 8860)
    for ex in (eager, graphs):
        ex.release(tasks[0])
        ex.prefill(later[0])
        for _ in range(2):
            ex.decode([later[0]] + tasks[1:])
    torch.cuda.synchronize()
    for a, b in zip(*logits):
        np.testing.assert_array_equal(b, a)
    np.testing.assert_array_equal(graphs.last_logits, eager.last_logits)
    assert streams[0] == streams[1]
    assert (graphs.generated_tokens(later[0])
            == eager.generated_tokens(later[0]))
    assert launches[0] == launches[1]
    assert launches[1]["ssd_scan"] == 0          # the decode steps only
    assert launches[1]["ssd_decode_step"] > 0
    if cfg.has_attention:
        assert launches[1]["decode_attention"] > 0
    from repro_torch.models.model import LAYER_FIELDS
    S = eager.max_slots
    for k, v in eager.cache.items():
        rows = ((slice(None), slice(0, S)) if k in LAYER_FIELDS
                else (slice(0, S),))
        assert torch.equal(graphs.cache[k][rows], v[rows]), k
    assert {"ssm", "conv"} <= set(graphs.cache)
    assert all(s.graph is not None and s.runs > 0
               for s in graphs.graphs.steps.values())


def fleet_structural_gate(router, two_tier):
    """Serve the workload of ``benchmarks/fleet_routing.py``'s structural
    gate over ``router`` and hold its checks: every request served exactly
    once, no page or state slot left held. ``two_tier``: the two-tier
    fleet's mix (control, voice, QA), else the heterogeneous fleet's
    (control, QA). QA requests want tier 1. The SLOs get the benchmark's
    relaxation: scaled to the slower instance, the TPOT and deadline four
    times more, since the gate is structural. Returns the FleetResult."""
    from repro_torch.core.task import SLOSpec, control_task, qa_task, \
        voice_task
    from repro_torch.serving.fleet import run_fleet_loop
    scale = max(max(i.lat.decode_ms(2) for i in router.instances) / 50.0,
                0.02)
    tasks = []
    for k in range(3):
        tasks.append(control_task(arrival_ms=40.0 * k, prompt_len=10,
                                  output_len=8))
        if two_tier:
            tasks.append(voice_task(arrival_ms=60.0 * k, prompt_len=12,
                                    output_len=10))
        q = qa_task(arrival_ms=(80.0 if two_tier else 70.0) * k,
                    prompt_len=14, output_len=10)
        q.min_tier = 1
        tasks.append(q)
    for t in tasks:
        t.slo.tpot_ms *= scale * 4
        t.slo.ttft_ms *= max(scale, 1.0)
        if t.slo.deadline_ms:
            t.slo = SLOSpec.realtime_deadline(
                t.slo.deadline_ms * max(scale, 1.0) * 4, t.output_len)
    res = run_fleet_loop(router, tasks, max_ms=3e7)
    assert all(t.finished or t.dropped for t in res.tasks)
    assert sum(len(r.tasks) for r in res.per_instance.values()) == len(tasks)
    for inst in router.instances:
        inst.executor.pool.check()
        inst.executor.store.check()
        assert inst.executor.store.leaked() == 0, inst.name
        assert inst.executor.pool.used_pages == 0, inst.name
    return res


@pytest.mark.cuda
def test_reduced_fleet_on_the_card():
    """``engine_fleet`` of two reduced tiers (smollm-360m, edge-6b) on the
    card, fp32, steps captured, under the structural gate of
    ``benchmarks/fleet_routing.py``: every request served exactly once,
    no page left held, both instances' paged kernels launched."""
    _need_cuda()
    from repro_torch.serving.fleet import engine_fleet
    router = engine_fleet(["smollm-360m", "edge-6b"], n_pages=48,
                          page_size=8, max_seq=96, max_batch=4, seed=0,
                          device="cuda")
    ops.reset_launches()
    fleet_structural_gate(router, two_tier=True)
    launches = dict(ops.LAUNCHES)
    for inst in router.instances:
        assert all(s.graph is not None
                   for s in inst.executor.graphs.steps.values())
    assert launches["paged_decode_attention"] > 0
    assert launches["flash_prefill"] > 0


@pytest.mark.cuda
def test_captured_draft_steps_match_eager():
    """Speculative decoding with the default one-layer draft: its
    catch-up chunks and masked decode captured (made with the verify
    buckets, before the first iteration) against eager: drafted and
    accepted counts, logits bit for bit, streams and launches equal."""
    _need_cuda()
    _, eager, graphs = _eager_and_captured("edge-6b", spec_decode=True,
                                           max_spec_depth=4)
    tasks = _tasks((5, 17, 40), 8900)
    batches = [3, 2, 3, 1, 3]
    depths = [[4, 2, 1], [3, 3], [2, 4, 4], [4], [1, 1, 2]]
    logits, launches, streams = _run_both((eager, graphs), tasks, batches,
                                          depths)
    for a, b in zip(*logits):
        np.testing.assert_array_equal(b, a)
    assert streams[0] == streams[1]
    assert launches[0] == launches[1]
    assert graphs.drafted_tokens == eager.drafted_tokens > 0
    assert graphs.accepted_tokens == eager.accepted_tokens
    draft = graphs.draft.graphs.steps
    assert ("masked", 4) in draft and ("chunk", 64) in draft
    assert all(s.graph is not None for s in draft.values())
    assert draft[("masked", 4)].runs > 0
    assert not any(s.graph is not None
                   for s in eager.draft.graphs.steps.values())


@pytest.mark.cuda
def test_refused_prefill_capture_raises_without_fallback(monkeypatch):
    """A flash-prefill launch refused while a whole-prompt step is
    captured raises out of prefill with nothing left behind: no step, no
    page taken, the launch counter as it was; the next prefill of that
    length raises again (nothing falls back to the eager step), and one
    of another length is unaffected once the launch is allowed."""
    _need_cuda()
    from repro_torch.kernels import flash_prefill as _fp
    _, _, ex = _eager_and_captured("edge-6b")
    launch = _fp.launch

    def refusing(*a, **k):
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("flash_prefill kernel launch failed: "
                               "refused under capture")
        return launch(*a, **k)

    monkeypatch.setattr(_fp, "launch", refusing)
    ops.reset_launches()
    task = _tasks((17,), 9000)[0]
    for _ in range(2):
        with pytest.raises(RuntimeError, match="refused under capture"):
            ex.prefill(task)
        assert sum(ops.LAUNCHES.values()) == 0
        assert ("prefill", 17) not in ex.graphs.steps
        assert ex.pool.used_pages == 0 and not ex.pool.holds(task.task_id)
    monkeypatch.setattr(_fp, "launch", launch)
    ex.prefill(task)
    assert ex.graphs.steps[("prefill", 17)].graph is not None


# ------------------------------------------- the async pipelined engine

def _sync_and_async(arch, **kw):
    """Two reduced fp32 paged engines on the card over the same weights,
    both capturing their steps: one synchronous, one async."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.serving.executor import PagedTorchExecutor
    cfg = get_config(arch).reduced()
    params = M.init_params(cfg, seed=0, device="cuda")
    return [PagedTorchExecutor(cfg, params=params, n_pages=64, page_size=16,
                               max_seq=128, max_batch=4, device="cuda",
                               async_dispatch=a, **kw) for a in (False, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["edge-6b", "mamba2-780m"])
def test_async_engine_matches_sync_on_the_card(arch):
    """The async engine against the synchronous one on the card, both
    captured: prefill, a bucket change 3 -> 1 -> 3 with steps in flight,
    a suspend issued behind an in-flight decode and a resume; logits bit
    for bit and streams equal, no staging wait, the pool consistent and
    the ledger idle after drain()."""
    _need_cuda()
    engines = _sync_and_async(arch)
    tasks = _tasks((5, 17, 40), 8500)
    logits = ([], [])
    for e, ex in enumerate(engines):
        for t in tasks:
            ex.prefill(t)
        logits[e].append(ex.last_prefill_logits)
        for n in (3, 3, 1, 1, 3):
            ex.decode(tasks[:n])
        ex.suspend(tasks[2])
        for _ in range(2):
            ex.decode(tasks[:2])
        ex.resume(tasks[2])
        for _ in range(3):
            ex.decode(tasks)
        logits[e].append(ex.last_logits)
        ex.drain()
    for a, b in zip(*logits):
        np.testing.assert_array_equal(b, a)
    sync, asy = engines
    assert [sync.generated_tokens(t) for t in tasks] == \
        [asy.generated_tokens(t) for t in tasks]
    assert asy.gap_stats.stalls > 0 and asy.graphs.stage_waits == 0
    assert asy.ledger.outstanding() == 0 and asy.ledger.started == 1
    asy.ledger.check()
    asy.pool.check()


@pytest.mark.cuda
def test_async_hybrid_paged_matches_sync_on_the_card():
    """Reduced hymba-1.5b on the paged engine (attention over pages and
    the SSM mixer over the state arena in one step), async against sync
    on the card, both captured: prefill with a 2-token prompt, a bucket
    change with steps in flight, a suspend behind an in-flight decode,
    resume; logits bit for bit, streams equal, the resumed task's K/V
    pages and state slot bit for bit the synchronous twin's, nothing held
    after release."""
    _need_cuda()
    engines = _sync_and_async("hymba-1.5b")
    tasks = _tasks((5, 17, 2), 8900)
    tid = tasks[0].task_id
    logits, state = ([], []), []
    for e, ex in enumerate(engines):
        for t in tasks:
            ex.prefill(t)
        logits[e].append(ex.last_prefill_logits)
        for n in (3, 3, 1, 1, 3):
            ex.decode(tasks[:n])
        ex.suspend(tasks[0])
        for _ in range(2):
            ex.decode(tasks[1:])
        ex.resume(tasks[0])
        ex.drain()
        pages = torch.as_tensor(ex.pool.page_table(tid), device="cuda")
        slot = ex.states.slot_of(tid)
        state.append([ex.pages[n][:, pages] for n in ("k_pages", "v_pages")]
                     + [ex.pages[n][:, slot].clone()
                        for n in ("ssm_state", "conv_state")])
        for _ in range(3):
            ex.decode(tasks)
        logits[e].append(ex.last_logits)
        ex.drain()
    for a, b in zip(*logits):
        np.testing.assert_array_equal(b, a)
    for a, b in zip(*state):
        assert torch.equal(a, b)
    sync, asy = engines
    assert [sync.generated_tokens(t) for t in tasks] == \
        [asy.generated_tokens(t) for t in tasks]
    assert asy.graphs.stage_waits == 0 and asy.ledger.started == 1
    for ex in engines:
        for t in tasks:
            ex.release(t)
        ex.store.check()
        assert not ex.store.leaked()
    asy.ledger.check()


@pytest.mark.cuda
def test_async_suspend_copy_lands_before_resume():
    """An async suspension behind an in-flight decode, while later steps
    reuse the freed pages: once the ledger has retired the side-stream
    copy, the host blobs equal the synchronous twin's (which copied before
    returning), and after resume the task's pages are bit for bit the
    twin's."""
    _need_cuda()
    engines = _sync_and_async("edge-6b")
    tasks = _tasks((33, 20), 8600)
    tid = tasks[0].task_id
    blobs = []
    for ex in engines:
        for t in tasks:
            ex.prefill(t)
        for _ in range(4):
            ex.decode(tasks)
        ex.suspend(tasks[0])
        for _ in range(4):
            ex.decode(tasks[1:])
        ex.ledger.wait(tid)
        assert ex.ledger.outstanding(tid) == 0
        blobs.append([{k: v.clone() for k, v in blob.items()}
                      for _, blob in ex.arena._entries[tid]])
        ex.resume(tasks[0])
        ex.drain()
    assert len(blobs[1]) == len(blobs[0]) > 1
    for a, b in zip(*blobs):
        for k in ("k", "v"):
            assert torch.equal(a[k], b[k])
    pages = [[ex.pages[n][:, torch.as_tensor(ex.pool.page_table(tid),
                                                device="cuda")]
              for n in ("k_pages", "v_pages")] for ex in engines]
    for a, b in zip(*pages):
        assert torch.equal(a, b)
    assert engines[1].ledger.started == 1


@pytest.mark.cuda
def test_async_capture_while_a_transfer_is_outstanding():
    """A prompt length first seen right after an async suspension: its
    step is captured while the side-stream copy may still be in flight
    (the capture first waits out the ledger). Nothing raises, and the
    streams and the resumed task's pages equal the synchronous twin's."""
    _need_cuda()
    engines = _sync_and_async("edge-6b")
    tasks = _tasks((33, 20), 8700)
    late = _tasks((27,), 8750)[0]             # a length not yet captured
    for ex in engines:
        for t in tasks:
            ex.prefill(t)
        for _ in range(3):
            ex.decode(tasks)
        ex.suspend(tasks[0])
        ex.prefill(late)
        assert ("prefill", 27) in ex.graphs.steps
        for _ in range(2):
            ex.decode([tasks[1], late])
        ex.resume(tasks[0])
        ex.decode(tasks + [late])
        ex.drain()
    sync, asy = engines
    assert [sync.generated_tokens(t) for t in tasks + [late]] == \
        [asy.generated_tokens(t) for t in tasks + [late]]
    assert asy.ledger.started == 1 and asy.ledger.outstanding() == 0
    asy.pool.check()


def _fastserve_swap_run(device):
    """Reduced edge-6b on a pool that holds one task's peak (5 of 8
    pages), four tasks arriving at once, served by FastServe with
    proactive KV swap; returns the engine and the LoopResult."""
    from repro_torch.configs import get_config
    from repro_torch.core.schedulers import FastServeScheduler
    from repro_torch.models import model as M
    from repro_torch.serving.executor import PagedTorchExecutor
    from repro_torch.serving.loop import run_serving_loop
    cfg = get_config("edge-6b").reduced()
    ex = PagedTorchExecutor(cfg, params=M.init_params(cfg, seed=0,
                                                      device=device),
                            n_pages=8, page_size=16, max_seq=128,
                            max_batch=4, device=device)
    sched = FastServeScheduler(max_batch=4, page_budget=ex.page_budget(),
                               kv_swap=True)
    res = run_serving_loop(sched, ex, _tasks((40, 33, 47, 21), 8800),
                           max_ms=3e7)
    return ex, res


@pytest.mark.cuda
def test_fastserve_kv_swap_under_page_pressure():
    """FastServe with KV swap on the card, the pool too small for two
    tasks: arrivals suspend residents, every suspended task is resumed and
    finishes, the pool and the host arena end empty, the paged kernels
    ran."""
    _need_cuda()
    ops.reset_launches()
    ex, res = _fastserve_swap_run("cuda")
    assert res.suspends >= 1 and res.resumes == res.suspends
    assert res.swapped_bytes > 0
    assert all(t.finished for t in res.tasks)
    ex.pool.check()
    ex.arena.check()
    assert ex.pool.used_pages == 0 and not ex.pool.owners()
    assert ex.arena.bytes_held == 0 and ex.arena.owners_held == 0
    assert ops.LAUNCHES["paged_decode_attention"] > 0
    assert ops.LAUNCHES["flash_prefill"] > 0


# ------------------------------------------------ the fused decode chain
#
# Each kernel against its plain version on the same inputs in the working
# type, to one bf16 ulp of the output: the kernels round where the plain
# path rounds, but sum the squares in another order and call sincosf
# where PyTorch calls sinf and cosf, so a bf16 value can land on the
# other side of a rounding boundary, and an fp32 one a few fp32 ulps
# away (4 at D 4096 on an H100), far under a bf16 ulp. What
# the kernels only move (the residual sum, v, every page slot no row
# writes) is exact. Rows that meet on the spare page write it in no
# fixed order, 16 bytes at a time: each of its elements is one of theirs.

FUSED_HEADS = [(32, 2, 128), (24, 8, 64), (25, 5, 64), (16, 1, 128),
               (4, 1, 32)]      # edge-6b, granite, hymba, a slab, reduced


def _ulps_each(got, want):
    """|got - want| per element, in bf16 ulps of want's magnitude."""
    w = want.float()
    _, e = torch.frexp(w)
    ulp = torch.ldexp(torch.ones_like(w), (e - 8).clamp(min=-133))
    return (got.float() - w).abs() / ulp


def _ulps(got, want):
    """The largest of ``_ulps_each``."""
    return _ulps_each(got, want).max().item()


def _fused_rope_inputs(dtype, Hq, Hkv, hd, B, n_pages=80, psz=16, seed=0):
    """Rows at positions up to 1023 on distinct pages; rows 0 and 1 (row
    0 of one) sent to the spare page at offset 0, as an untabled and an
    inactive row are."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    dt = getattr(torch, dtype)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device="cuda").to(dt)
    q, k, v = rnd(B, Hq, hd), rnd(B, Hkv, hd), rnd(B, Hkv, hd)
    rng = np.random.default_rng(seed + B)
    q_pos = torch.from_numpy(rng.integers(0, 1024, B).astype(np.int32))
    w_page = torch.from_numpy(rng.permutation(n_pages - 1)[:B]).long()
    w_off = (q_pos % psz).long()
    w_page[:2], w_off[:2] = n_pages - 1, 0
    from repro_torch.models import layers as L
    freqs = L.rope_table(hd, 10000.0, torch.device("cuda", 0))
    kp, vp = rnd(n_pages, Hkv, psz, hd), rnd(n_pages, Hkv, psz, hd)
    return (q, k, v, q_pos.cuda(), freqs, kp, vp, w_page.cuda(),
            w_off.cuda())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,D", [(1, 4096), (8, 4096), (32, 4096),
                                 (8, 1536), (32, 1536), (8, 1600),
                                 (32, 256)])
@pytest.mark.parametrize("with_delta", [False, True])
def test_add_rms_norm_kernel_matches_plain(dtype, B, D, with_delta):
    _need_cuda()
    from repro_torch.kernels import ref
    g = torch.Generator(device="cuda").manual_seed(B + D)
    dt = getattr(torch, dtype)
    x = torch.randn(B, D, generator=g, device="cuda").to(dt)
    delta = (torch.randn(B, D, generator=g, device="cuda").to(dt)
             if with_delta else None)
    w = (0.1 * torch.randn(D, generator=g, device="cuda")).to(dt)
    want_x, want_h = ref.add_rms_norm_ref(x.clone(), delta, w, 1e-5)
    before = ops.LAUNCHES["add_rms_norm"]
    xin = x.clone()
    got_x, got_h = ops.add_rms_norm(xin, delta, w, 1e-5)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["add_rms_norm"] == before + 1
    assert got_x is xin
    assert torch.equal(got_x, want_x)            # the add rounds once
    assert _ulps(got_h, want_h) <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Hq,Hkv,hd", FUSED_HEADS)
@pytest.mark.parametrize("B", [1, 8, 32])
def test_rope_kv_write_kernel_matches_plain(dtype, Hq, Hkv, hd, B):
    _need_cuda()
    from repro_torch.kernels import ref
    q, k, v, qp, fr, kp, vp, wp, wo = _fused_rope_inputs(dtype, Hq, Hkv, hd,
                                                         B)
    kp_want, vp_want = kp.clone(), vp.clone()
    want_q = ref.rope_kv_write_ref(q, k, v, qp, fr, kp_want, vp_want, wp, wo)
    before = ops.LAUNCHES["rope_kv_write"]
    got_q = ops.rope_kv_write(q, k, v, qp, fr, kp, vp, wp, wo)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["rope_kv_write"] == before + 1
    assert _ulps(got_q, want_q) <= 1
    from repro_torch.models import layers as L
    want_k = L.rope_rotate(k[:, None], qp[:, None], fr)[:, 0]
    lo = min(B, 2)                                 # rows 0, 1: the spare
    if B > lo:
        assert _ulps(kp[wp[lo:], :, wo[lo:]], want_k[lo:]) <= 1
        assert torch.equal(vp[wp[lo:], :, wo[lo:]], v[lo:])
    spare_k, spare_v = kp[-1, :, 0], vp[-1, :, 0]
    assert torch.stack([_ulps_each(spare_k, want_k[r])
                        for r in range(lo)]).amin(0).max() <= 1
    assert torch.stack([spare_v == v[r] for r in range(lo)]).any(0).all()
    written = torch.zeros(kp.shape[0], kp.shape[2], dtype=torch.bool,
                          device="cuda")
    written[wp, wo] = True
    keep = ~written[:, None, :, None].expand_as(kp)
    assert torch.equal(kp[keep], kp_want[keep])    # nothing else touched
    assert torch.equal(vp[keep], vp_want[keep])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,F", [(1, 13696), (8, 13696), (32, 13696),
                                 (8, 5504), (32, 512)])
def test_silu_mul_kernel_matches_plain(dtype, B, F):
    _need_cuda()
    from repro_torch.kernels import ref
    g = torch.Generator(device="cuda").manual_seed(B + F)
    dt = getattr(torch, dtype)
    gate = (3 * torch.randn(B, F, generator=g, device="cuda")).to(dt)
    up = torch.randn(B, F, generator=g, device="cuda").to(dt)
    before = ops.LAUNCHES["silu_mul"]
    got = ops.silu_mul(gate, up)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["silu_mul"] == before + 1
    assert _ulps(got, ref.silu_mul_ref(gate, up)) <= 1


def _fused_per_step(cfg):
    """Launches of the fused chain in one paged decode step."""
    n = cfg.n_layers
    has_ffn = cfg.block_kind == "moe" or cfg.d_ff > 0
    return {"add_rms_norm": (2 if has_ffn else 1) * n + 1,
            "rope_kv_write": n if cfg.has_attention else 0,
            "silu_mul": n if cfg.block_kind != "moe" and cfg.d_ff > 0 else 0}


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["edge-6b", "granite-moe-3b-a800m",
                                  "hymba-1.5b", "mamba2-780m"])
def test_paged_decode_step_launches_the_fused_chain(arch):
    """Reduced fp32 engines, eager and captured: every decode step
    launches 2L+1 add_rms_norm, L rope_kv_write and L silu_mul (none
    for MoE blocks; L+1 and none for a block with neither attention nor
    FFN), in one step's record as in the replays' counts."""
    _need_cuda()
    cfg, eager, graphs = _eager_and_captured(arch)
    tasks = _tasks((5, 17, 40), 8300)
    batches = [3, 2, 3, 1]
    _, launches, _ = _run_both((eager, graphs), tasks, batches)
    per = _fused_per_step(cfg)
    for got in launches:
        assert {k: got[k] for k in per} == {k: n * len(batches)
                                            for k, n in per.items()}
    _, one = ops.recorded_launches(lambda: graphs.decode(tasks[:2]))
    assert {k: one[k] for k in per} == per


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["edge-6b", "granite-moe-3b-a800m"])
def test_captured_full_width_decode_matches_eager(arch):
    """The cells' configurations at full width, cut to 2 layers, in bf16:
    the paged engine's captured decode steps against the same steps run
    eagerly (the fused chain at edge-6b's hd 128, 32/2 heads and D 4096,
    granite's hd 64, 24/8 and D 1536): edge-6b's logits bit for bit,
    granite's within bf16's 1.6e-2 (its dispatch adds with atomics);
    launches equal and the fused chain's as ``_fused_per_step``."""
    _need_cuda()
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.serving.executor import PagedTorchExecutor
    cfg = dataclasses.replace(get_config(arch), n_layers=2)
    params = M.init_params(cfg, seed=0, dtype=torch.bfloat16, device="cuda")
    eager, graphs = (PagedTorchExecutor(
        cfg, params=params, n_pages=64, page_size=16, max_seq=256,
        max_batch=8, device="cuda", dtype=torch.bfloat16, cuda_graphs=c)
        for c in (False, True))
    tasks = _tasks((5, 17, 40, 100, 33, 64, 9, 120), 8400)
    batches = [8, 5, 8, 3, 8]
    logits, launches, streams = _run_both((eager, graphs), tasks, batches)
    for a, b in zip(*logits):
        if cfg.block_kind == "moe":
            np.testing.assert_allclose(b, a, atol=TOL["bfloat16"], rtol=0)
        else:
            np.testing.assert_array_equal(b, a)
    if cfg.block_kind != "moe":
        assert streams[0] == streams[1]
    assert launches[0] == launches[1]
    per = _fused_per_step(cfg)
    assert {k: launches[1][k] for k in per} == {k: n * len(batches)
                                                for k, n in per.items()}
