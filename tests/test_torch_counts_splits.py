"""The inputs that the redesigned MoE and paged-attention kernels take,
held on the CPU.

MoE: the per-group live-row counts that ``repro_torch.models.moe``
computes on the device equal the kept assignments of each group, for both
grouped paths, with capacity drops; every buffer row at or past its
group's count is zero; ``ops.moe_grouped_ffn`` with counts equals the call
without them and JAX's Pallas kernel in interpret mode (atol 1e-5,
``tests/helpers.py``), and gives exact zeros past a count.

Paged attention: ``kernels.ref.paged_attention_split_ref``, the plain form
of the CUDA kernel's page splits and log-sum-exp combine, equals the
unsplit plain version at 1e-5 (fp32, a few hundred terms) for every split
size, with empty splits, a single-page row, -1 entries inside the table
and a pad row (exact 0); ``kernels.paged_attention.plan`` covers the table
and keeps a block within its limits.

SSD decode step: ``kernels.ssd_decode.plan`` covers each state tile of
every SSM-carrying registry config (full and reduced) and of the odd
shapes with slabs, exactly once, within the card's limits.
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
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.kernels import ssd_decode as sd  # noqa: E402
from repro_torch.models import moe as TMOE  # noqa: E402

D, F, E, K = 16, 32, 5, 2


def _params(seed=0, skew=0.0):
    jp = JMOE.init_moe_params(jax.random.PRNGKey(seed), D, F, E)
    jp = jp._replace(router=jp.router.at[:, 0].add(skew * D ** -0.5))
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp._asdict().items()}
    return jp, tp


def _x(shape, seed, shift=0.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            + shift).astype(np.float32)


def _capture(monkeypatch):
    """Record (buf, counts) of every ops.moe_grouped_ffn call the model
    makes, and run it."""
    calls = []
    real = ops.moe_grouped_ffn

    def spy(buf, wg, wu, wd, counts=None):
        calls.append((buf.clone(), None if counts is None else counts.clone()))
        return real(buf, wg, wu, wd, counts)

    monkeypatch.setattr(ops, "moe_grouped_ffn", spy)
    return calls


def _check_counts(buf, counts, want):
    assert counts.dtype == torch.int32 and counts.shape == (buf.shape[0],)
    np.testing.assert_array_equal(counts.numpy(), want)
    rows = torch.arange(buf.shape[1])[None, :] >= counts[:, None]
    assert torch.all(buf[rows] == 0)
    # every counted row is a routed token's row (inputs have no zero row)
    assert torch.all(buf[~rows].abs().sum(-1) > 0)


@pytest.mark.parametrize("B,T,skew", [(2, 24, 2.0), (1, 7, 2.0), (3, 5, 0.0)])
def test_grouped_counts_are_kept_assignments(monkeypatch, B, T, skew):
    """Per-example capacity C: a group's count is its expert's assignments
    in that example, at most C (the rest are dropped)."""
    jp, tp = _params(1, skew=skew)
    x = _x((B, T, D), T)
    _, ids, _ = TMOE.route(tp["router"], torch.from_numpy(x).reshape(-1, D), K)
    C = max(int(T * K / E * 1.25 + 0.999), K)
    loads = np.stack([np.bincount(r, minlength=E) for r in
                      ids.numpy().reshape(B, T * K)])
    calls = _capture(monkeypatch)
    yt, _ = TMOE.moe_ffn_grouped(tp, torch.from_numpy(x), K)
    (buf, counts), = calls
    if skew:
        assert (loads > C).any()                  # drops happen
    _check_counts(buf, counts, np.minimum(loads, C).reshape(-1))
    yj, _ = JMOE.moe_ffn_grouped(jp, jnp.asarray(x), K)
    assert_logits_close(yt.numpy(), np.asarray(yj))


@pytest.mark.parametrize("shape,skew,shift", [((7, D), 0.0, 0.0),
                                              ((4, 1, D), 0.0, 0.0),
                                              ((12, D), 6.0, 2.0)])
def test_decode_counts_are_routed_rows(monkeypatch, shape, skew, shift):
    """Lossless decode dispatch: an expert's count is its routed rows,
    empty experts 0 (the skewed case sends every row to expert 0)."""
    jp, tp = _params(4, skew=skew)
    x = _x(shape, 5, shift=shift)
    _, ids, _ = TMOE.route(tp["router"], torch.from_numpy(x).reshape(-1, D), K)
    loads = np.bincount(ids.numpy().ravel(), minlength=E)
    calls = _capture(monkeypatch)
    yt, _ = TMOE.moe_ffn_grouped_decode(tp, torch.from_numpy(x), K)
    (buf, counts), = calls
    _check_counts(buf, counts, loads)
    if skew:
        assert loads[0] == shape[0] and (loads == 0).any()
    yj, _ = JMOE.moe_ffn_grouped_decode(jp, jnp.asarray(x), K)
    assert_logits_close(yt.numpy(), np.asarray(yj))


@pytest.mark.parametrize("G,counts", [(E, [0, 6, 3, 1, 0]),
                                      (3 * E, [6, 0, 2, 5, 1, 0, 0, 4, 6, 3,
                                               1, 2, 0, 6, 5])])
def test_grouped_ffn_counts_match_uncounted_and_pallas(G, counts):
    """Rows past each count zero in the buffer: the counted call equals
    the uncounted one exactly and JAX's kernel in interpret mode; empty
    groups (0) and full ones (C = 6) included."""
    jp, tp = _params(5)
    C = 6
    buf = _x((G, C, D), 6)
    cnt = torch.tensor(counts, dtype=torch.int32)
    buf[np.arange(C)[None, :] >= np.array(counts)[:, None]] = 0.0
    tb = torch.from_numpy(buf)
    got = ops.moe_grouped_ffn(tb, tp["wg"], tp["wu"], tp["wd"], cnt)
    assert torch.equal(got, ops.moe_grouped_ffn(tb, tp["wg"], tp["wu"],
                                                tp["wd"]))
    want = np.concatenate([np.asarray(jops.moe_grouped_ffn(
        jnp.asarray(buf[i:i + E]), jp.wg, jp.wu, jp.wd, interpret=True))
        for i in range(0, G, E)])
    assert_logits_close(got.numpy(), want)


def test_grouped_ffn_rows_past_count_are_exact_zeros():
    """Rows past a count hold data here: they come out exactly 0 and the
    rows before equal the uncounted call's."""
    _, tp = _params(6)
    buf = torch.from_numpy(_x((E, 7, D), 7))
    cnt = torch.tensor([0, 7, 3, 9, -2], dtype=torch.int32)  # clamped
    got = ops.moe_grouped_ffn(buf, tp["wg"], tp["wu"], tp["wd"], cnt)
    full = ops.moe_grouped_ffn(buf, tp["wg"], tp["wu"], tp["wd"])
    live = torch.arange(7)[None, :] < cnt.clamp(0, 7)[:, None]
    assert torch.all(got[~live] == 0)
    assert torch.equal(got[live], full[live])


def _paged(C, Hq, Hkv, hd=16, psz=4, maxp=9, n_pages=40, seed=0):
    """Row 0: pad row (table all -1); row 1: one page, position 2; row 2:
    -1 entries inside the table (pages 1 and 4) and a window ending on a
    page boundary; row 3: the table's last position; row 4: mid-table, so
    later splits are empty."""
    rng = np.random.default_rng(seed)
    q_start = np.array([0, 2, 5 * psz - C, maxp * psz - C, 3 * psz + 1],
                       np.int32)
    pt = np.full((len(q_start), maxp), -1, np.int32)
    perm = list(rng.permutation(n_pages))
    for b in range(1, len(q_start)):
        n = (q_start[b] + C - 1) // psz + 1
        pt[b, :n] = [perm.pop() for _ in range(n)]
    pt[2, [1, 4]] = -1
    f = [rng.standard_normal(s).astype(np.float32)
         for s in ((len(q_start), C, Hq, hd), (n_pages, Hkv, psz, hd),
                   (n_pages, Hkv, psz, hd))]
    return [torch.from_numpy(a) for a in (*f, pt, q_start)]


@pytest.mark.parametrize("pps", [1, 2, 3, 9])
@pytest.mark.parametrize("C,Hq,Hkv", [(1, 8, 2), (1, 6, 2), (3, 5, 5),
                                      (4, 4, 1)])
def test_paged_split_combine_matches_unsplit(pps, C, Hq, Hkv):
    q, kp, vp, pt, qs = _paged(C, Hq, Hkv, seed=pps + C)
    got = ref.paged_attention_split_ref(q, kp, vp, pt, qs, pps)
    want = ref.paged_verify_attention_ref(q, kp, vp, pt, qs)
    assert torch.all(got[0] == 0)                 # pad row: exact 0
    torch.testing.assert_close(got[1:], want[1:], atol=1e-5, rtol=0)
    if C == 1:                                    # the decode form
        dec = ref.paged_decode_attention_ref(q[:, 0], kp, vp, pt, qs)
        torch.testing.assert_close(got[1:, 0], dec[1:], atol=1e-5, rtol=0)


@pytest.mark.parametrize("B,R,Hkv,hd,psz,maxp,dtype", [
    (8, 16, 2, 128, 16, 64, "bfloat16"),     # edge-6b decode
    (8, 3, 8, 64, 16, 64, "bfloat16"),       # granite-moe decode
    (8, 80, 2, 128, 16, 64, "bfloat16"),     # edge-6b verify, C = 5
    (10, 125, 5, 64, 16, 64, "float32"),     # hymba verify in fp32
    (64, 16, 2, 128, 16, 64, "bfloat16"),    # a large batch
    (1, 1, 1, 256, 8, 3, "float32"),         # one short table
    (2, 40, 1, 32, 8, 100, "bfloat16"),      # CUDA-core bf16, small pages
])
def test_paged_plan_covers_the_table(B, R, Hkv, hd, psz, maxp, dtype):
    dt = getattr(torch, dtype)
    rows, pps, nsplit = pa.plan(B, R, Hkv, hd, psz, maxp, dt, sms=132)
    tiles = -(-R // rows)
    elt = 2 if dtype == "bfloat16" else 4
    assert rows <= pa.MAX_ROWS and (tiles - 1) * rows < R <= tiles * rows
    assert 1 <= pps <= pa.MAX_PAGES and nsplit == -(-maxp // pps)
    assert 2 * pps * psz * hd * elt <= max(pa.SPLIT_KV_BYTES,
                                           2 * psz * hd * elt)
    keys = pps * psz
    # shared memory of csrc/paged_decode_attention.cu's split bodies
    if pa.body(dt, hd) == pa.TENSOR_CORE:
        smem = (-(-rows // 16) * 16 + 2 * -(-keys // 16) * 16) * (hd + 8) * 2
    else:
        assert rows * keys <= max(pa.SPLIT_PAIRS, rows * psz)
        smem = (rows * hd * 4 + keys * (2 * hd + 16 // elt) * elt
                + rows * keys * 4)
    assert smem + 4 * pa.MAX_PAGES <= 232448


@pytest.mark.parametrize("dtype,hd,want", [
    ("bfloat16", 64, "tensor_core"), ("bfloat16", 128, "tensor_core"),
    ("bfloat16", 32, "cuda_core"), ("bfloat16", 256, "cuda_core"),
    ("float32", 64, "cuda_core"), ("float32", 128, "cuda_core")])
def test_paged_body_rule(dtype, hd, want):
    assert pa.body(getattr(torch, dtype), hd) == want


def _ssd_tile_shapes():
    """(P, N) of every SSM-carrying registry config, full and reduced."""
    from repro_torch.configs import registry
    shapes = []
    for name in registry.list_archs():
        for cfg in (registry.get_config(name),
                    registry.get_config(name + "-smoke")):
            if cfg.ssm_state:
                shapes.append((cfg.name, cfg.ssm_head_dim, cfg.ssm_state))
    return shapes


@pytest.mark.parametrize("name,P,N", _ssd_tile_shapes() + [
    ("N/4 = 3", 24, 12), ("ragged last slab", 80, 64),
    ("64 KB tile", 64, 256), ("a row a slab", 3, 4096),
    ("N = 4", 5, 4)])
def test_ssd_decode_plan_covers_the_tile(name, P, N):
    """Every state row in exactly one slab, every float4 of a slab with
    exactly one thread, slabs of whole 16-byte units, the block within
    the card's limits, and shuffle sums only where a row's float4s fill
    one aligned group of lanes."""
    p = sd.plan(P, N)
    covered = np.zeros(P, np.int64)
    for s in range(p.slabs):
        rows = range(s * p.rows, min(P, (s + 1) * p.rows))
        assert len(rows) > 0 and len(rows) * N * 4 % 16 == 0
        covered[rows.start:rows.stop] += 1
    assert (covered == 1).all()
    q = N // 4
    nf4 = p.rows * q
    steps = -(-nf4 // p.threads)
    owners = np.bincount([t + k * p.threads for t in range(p.threads)
                          for k in range(steps)], minlength=nf4)[:nf4]
    assert (owners == 1).all()
    assert p.threads % 32 == 0 and 32 <= p.threads <= sd.MAX_THREADS
    assert p.rows * N * 4 <= max(sd.SLAB_BYTES, N * 4)
    assert p.smem <= sd.SMEM_LIMIT
    if p.shuffle:
        assert 32 % q == 0 and p.threads % q == 0
