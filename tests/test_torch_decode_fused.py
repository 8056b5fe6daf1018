"""The paged decode step's fused elementwise chain on the CPU.

The three wrappers (``ops.add_rms_norm``, ``ops.rope_kv_write``,
``ops.silu_mul``) run their plain versions here: each must equal the
unfused ops it replaces bit for bit (in fp32 and bf16), and
``decode_step_paged``, which calls them, must equal the unfused chain
(norm, RoPE, two ``index_put_`` writes, residual adds, silu * mul) bit
for bit on dense, MoE, hybrid and SSM-only blocks, with the wrappers
called 2L+1, L and L times (L+1, 0, 0 for a block without attention or
FFN; no silu_mul for MoE). The kernels themselves are held to these
plain versions on the card (``tests/test_torch_cuda.py``). Also the
checks the CUDA route runs before a launch, on CPU tensors, and the
kept RoPE table.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.configs import get_config
from repro_torch.kernels import ops, ref
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models import ssm as SSM

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# (Hq, Hkv, hd): edge-6b, granite-moe, hymba-1.5b, a rank's slab of
# edge-6b over 2, the reduced configs
HEADS = [(32, 2, 128), (24, 8, 64), (25, 5, 64), (16, 1, 128), (4, 1, 32)]


def _rand(shape, dtype, seed, scale=1.0):
    g = torch.Generator().manual_seed(seed)
    return (scale * torch.randn(shape, generator=g)).to(dtype)


def _same(a, b):
    """Equal bit for bit (NaN nowhere)."""
    assert a.dtype == b.dtype and a.shape == b.shape
    assert torch.equal(a.view(torch.int16 if a.dtype == torch.bfloat16
                              else torch.int32),
                       b.view(torch.int16 if b.dtype == torch.bfloat16
                              else torch.int32))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("B,D", [(1, 4096), (8, 1536), (32, 256)])
@pytest.mark.parametrize("with_delta", [False, True])
def test_add_rms_norm_plain_is_the_unfused_chain(dtype, B, D, with_delta):
    dt = DTYPES[dtype]
    x, delta = _rand((B, D), dt, 1), _rand((B, D), dt, 2)
    w = _rand((D,), dt, 3, 0.1)
    want_x = x + delta if with_delta else x.clone()
    want_h = L.rms_norm(want_x, w, 1e-5)
    xin = x.clone()
    got_x, got_h = ops.add_rms_norm(xin, delta if with_delta else None, w,
                                    1e-5)
    assert got_x is xin                              # updated in place
    _same(got_x, want_x)
    _same(got_h, want_h)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("Hq,Hkv,hd", HEADS)
@pytest.mark.parametrize("B", [1, 8, 32])
def test_rope_kv_write_plain_is_the_unfused_chain(dtype, Hq, Hkv, hd, B):
    """Rows at positions up to 1023, one meant for the spare page (an
    inactive row, offset 0) beside the live rows' distinct slots."""
    dt = DTYPES[dtype]
    n_pages, psz, theta = 70, 16, 10000.0
    q, k, v = (_rand((B, h, hd), dt, s) for s, h in
               ((4, Hq), (5, Hkv), (6, Hkv)))
    rng = np.random.default_rng(B)
    q_pos = torch.from_numpy(rng.integers(0, 1024, B).astype(np.int32))
    w_page = torch.from_numpy(rng.permutation(n_pages - 1)[:B]).long()
    w_off = (q_pos % psz).long()
    w_page[0], w_off[0] = n_pages - 1, 0             # the spare page
    pages = [_rand((n_pages, Hkv, psz, hd), dt, s) for s in (7, 8)]
    want_pages = [p.clone() for p in pages]
    want_q = L.apply_rope(q[:, None], q_pos[:, None], theta)[:, 0]
    want_k = L.apply_rope(k[:, None], q_pos[:, None], theta)[:, 0]
    want_pages[0][w_page, :, w_off] = want_k
    want_pages[1][w_page, :, w_off] = v
    freqs = L.rope_table(hd, theta, torch.device("cpu"))
    got_q = ops.rope_kv_write(q, k, v, q_pos, freqs, *pages, w_page, w_off)
    _same(got_q, want_q)
    for got, want in zip(pages, want_pages):
        _same(got, want)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("B,F_", [(1, 13696), (8, 5504), (32, 512)])
def test_silu_mul_plain_is_the_unfused_chain(dtype, B, F_):
    dt = DTYPES[dtype]
    g, u = _rand((B, F_), dt, 9, 3.0), _rand((B, F_), dt, 10)
    _same(ops.silu_mul(g, u), F.silu(g) * u)


def test_rope_table_is_made_once_with_rope_freqs_values():
    a = L.rope_table(64, 10000.0, torch.device("cpu"))
    assert L.rope_table(64, 10000.0, torch.device("cpu")) is a
    assert torch.equal(a, L.rope_freqs(64, 10000.0))
    assert a.dtype == torch.float32 and a.shape == (32,)


# -------------------------------------------------- the decode step


def _unfused_step(cfg, params, pages, page_table, lengths, tokens, active,
                  state_slots=None):
    """``decode_step_paged``'s layer loop as it was before the fused
    wrappers (one process): norm, RoPE and K/V ``index_put_`` writes,
    residual adds, the FFN's own norm, the final norm."""
    B = tokens.shape[0]
    k_all, v_all = pages["k_pages"], pages["v_pages"]
    psz, maxp = k_all.shape[3], page_table.shape[1]
    q_pos = lengths
    if cfg.has_attention:
        rows = torch.arange(B)
        pt_row = page_table[rows, (q_pos // psz).clamp(max=maxp - 1).long()]
        writes = active & (pt_row >= 0)
        w_page = torch.where(writes, pt_row, M.spare_page(pages)).long()
        w_off = torch.where(writes, q_pos % psz, 0).long()
    x = M.embed_inputs(cfg, params, tokens)
    if cfg.has_ssm:
        s_write = SSM.write_slots(state_slots, active, M.spare_slot(pages))
    blk = params["blocks"]
    for layer in range(cfg.n_layers):
        h = L.rms_norm(x, blk["ln1"][layer], cfg.norm_eps)
        parts = []
        if cfg.has_attention:
            q, k, v = M._proj_qkv(cfg, blk, layer, h)
            q = L.apply_rope(q[:, None], q_pos[:, None], cfg.rope_theta)[:, 0]
            k = L.apply_rope(k[:, None], q_pos[:, None], cfg.rope_theta)[:, 0]
            k_all[layer, w_page, :, w_off] = k
            v_all[layer, w_page, :, w_off] = v
            a = ops.paged_decode_attention(q, k_all[layer], v_all[layer],
                                           page_table, q_pos)
            parts.append(M._attn_out(cfg, blk, layer, a))
        if cfg.has_ssm:
            parts.append(SSM.ssm_mixer_step(
                M._ssm_params(blk, layer), h, cfg.ssm_inner, cfg.ssm_state,
                cfg.ssm_head_dim, pages["ssm_state"][layer],
                pages["conv_state"][layer], state_slots, active, s_write))
        x = x + M._mix(parts)
        x = x + M._ffn(cfg, blk, layer, x)
    return M.unembed(cfg, params, x), pages


def _arena(cfg, dtype, n_pages=12, psz=4, seed=0):
    pages = M.init_paged_cache(cfg, n_pages, psz, dtype=dtype, device="cpu")
    for i, name in enumerate(("k_pages", "v_pages")):
        pages[name].copy_(_rand(pages[name].shape, dtype, seed + i))
    if cfg.has_ssm:
        pages.update(M.init_state_arena(cfg, 4, dtype=dtype, device="cpu"))
        pages["ssm_state"].copy_(_rand(pages["ssm_state"].shape,
                                       torch.float32, seed + 2, 0.5))
        pages["conv_state"].copy_(_rand(pages["conv_state"].shape, dtype,
                                        seed + 3, 0.5))
    return pages


@pytest.fixture
def wrapper_calls(monkeypatch):
    calls = {"add_rms_norm": 0, "rope_kv_write": 0, "silu_mul": 0}
    for name in calls:
        fn = getattr(ops, name)

        def counted(*a, _n=name, _f=fn, **kw):
            calls[_n] += 1
            return _f(*a, **kw)
        monkeypatch.setattr(ops, name, counted)
    return calls


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("arch", ["edge-6b", "granite-moe-3b-a800m",
                                  "hymba-1.5b", "mamba2-780m"])
def test_decode_step_paged_is_the_unfused_chain(arch, dtype, wrapper_calls):
    """Two steps over 4 rows: a row across a page boundary, an inactive
    row, a row whose page is untabled (both write the spare page) and a
    pad row of state slot -1. Logits and every arena bit for bit, the
    spare page and state slot aside (rows that collide there write in no
    fixed order)."""
    cfg = get_config(arch).reduced()
    dt = DTYPES[dtype]
    params = M.init_params(cfg, seed=1, dtype=dt, device="cpu")
    fused, plain = _arena(cfg, dt), _arena(cfg, dt)
    pt = torch.tensor([[3, 7, -1], [0, 9, 2], [5, -1, -1], [-1, -1, -1]],
                      dtype=torch.int32)
    lengths = torch.tensor([3, 9, 4, 0], dtype=torch.int32)
    kw = {}
    if cfg.has_ssm:
        kw["state_slots"] = torch.tensor([2, 0, 1, -1], dtype=torch.int32)
    toks = torch.tensor([11, 27, 5, 0], dtype=torch.int32)
    for act in ([True, True, True, False], [True, False, True, True]):
        active = torch.tensor(act)
        got, _ = M.decode_step_paged(cfg, params, fused, pt, lengths, toks,
                                     active, **kw)
        want, _ = _unfused_step(cfg, params, plain, pt, lengths, toks,
                                active, **kw)
        _same(got, want)
        for name in fused:                      # [L, page or slot, ...]
            _same(fused[name][:, :-1], plain[name][:, :-1])
        toks = got.argmax(-1).to(torch.int32)
        lengths = lengths + active.to(torch.int32)
    n = cfg.n_layers
    dense_ffn = cfg.block_kind != "moe" and cfg.d_ff > 0
    has_ffn = cfg.block_kind == "moe" or cfg.d_ff > 0
    assert wrapper_calls == {
        "add_rms_norm": 2 * ((2 if has_ffn else 1) * n + 1),
        "rope_kv_write": 2 * n if cfg.has_attention else 0,
        "silu_mul": 2 * n if dense_ffn else 0}


# -------------------------------------------------- the CUDA route's checks


def _rope_args(dtype=torch.float32, Hq=4, Hkv=2, hd=64, B=3):
    return [torch.zeros(B, Hq, hd, dtype=dtype),
            torch.zeros(B, Hkv, hd, dtype=dtype),
            torch.zeros(B, Hkv, hd, dtype=dtype),
            torch.zeros(B, dtype=torch.int32),
            torch.zeros(hd // 2, dtype=torch.float32),
            torch.zeros(5, Hkv, 16, hd, dtype=dtype),
            torch.zeros(5, Hkv, 16, hd, dtype=dtype),
            torch.zeros(B, dtype=torch.int64),
            torch.zeros(B, dtype=torch.int64)]


def _bad_rope(i, value):
    args = _rope_args()
    args[i] = value
    return args


REJECTED = [
    (lambda: ops.check_add_rms_norm(torch.zeros(2, 64), None,
                                    torch.zeros(32)), "w \\[D\\]"),
    (lambda: ops.check_add_rms_norm(torch.zeros(2, 64), torch.zeros(3, 64),
                                    torch.zeros(64)), "delta as x"),
    (lambda: ops.check_add_rms_norm(torch.zeros(2, 64).half(), None,
                                    torch.zeros(64).half()), "types"),
    (lambda: ops.check_add_rms_norm(torch.zeros(2, 64), None,
                                    torch.zeros(64).bfloat16()), "types"),
    (lambda: ops.check_add_rms_norm(torch.zeros(64, 2).T, None,
                                    torch.zeros(64)), "contiguous"),
    (lambda: ops.check_add_rms_norm(torch.zeros(2, 12).bfloat16(), None,
                                    torch.zeros(12).bfloat16()), "16 bytes"),
    (lambda: ops.check_add_rms_norm(torch.zeros(2, 65)[:, 1:], None,
                                    torch.zeros(64)), "contiguous"),
    (lambda: ops.check_add_rms_norm(torch.zeros(129)[1:].view(2, 64), None,
                                    torch.zeros(64)), "16-byte aligned"),
    (lambda: ops.check_rope_kv_write(*_bad_rope(0, torch.zeros(3, 4))),
     "q \\[B,Hq,hd\\]"),
    (lambda: ops.check_rope_kv_write(*_bad_rope(2, torch.zeros(3, 1, 64))),
     "disagree"),
    (lambda: ops.check_rope_kv_write(*_rope_args(hd=48)), "head_dim 48"),
    (lambda: ops.check_rope_kv_write(*_bad_rope(3, torch.zeros(3).long())),
     "q_pos"),
    (lambda: ops.check_rope_kv_write(*_bad_rope(7, torch.zeros(3).int())),
     "int64"),
    (lambda: ops.check_rope_kv_write(*_bad_rope(4, torch.zeros(16))),
     "freqs"),
    (lambda: ops.check_rope_kv_write(*_bad_rope(4, torch.zeros(32).double())),
     "freqs"),
    (lambda: ops.check_rope_kv_write(*_rope_args(dtype=torch.float16)),
     "types"),
    (lambda: ops.check_rope_kv_write(*_bad_rope(
        5, torch.zeros(5, 16, 2, 64).transpose(1, 2))), "contiguous"),
    (lambda: ops.check_silu_mul(torch.zeros(2, 8), torch.zeros(2, 16)),
     "one shape"),
    (lambda: ops.check_silu_mul(torch.zeros(2, 6), torch.zeros(2, 6)),
     "16 bytes"),
    (lambda: ops.check_silu_mul(torch.zeros(2, 8).double(),
                                torch.zeros(2, 8).double()), "types"),
    (lambda: ops.check_silu_mul(torch.zeros(8, 2).T, torch.zeros(2, 8)),
     "contiguous"),
]


@pytest.mark.parametrize("case", range(len(REJECTED)))
def test_fused_checks_reject_what_the_kernels_do_not_take(case):
    call, match = REJECTED[case]
    with pytest.raises(ValueError, match=match):
        call()


def test_fused_checks_take_the_decode_step_shapes():
    """What the paged decode step hands the kernels passes the checks."""
    for Hq, Hkv, hd in HEADS:
        for dt in DTYPES.values():
            ops.check_rope_kv_write(*_rope_args(dt, Hq, Hkv, hd, B=8))
            x = torch.zeros(8, 4096, dtype=dt)
            ops.check_add_rms_norm(x, x.clone(), torch.zeros(4096, dtype=dt))
            g = torch.zeros(8, 13696, dtype=dt)
            ops.check_silu_mul(g, g.clone())

