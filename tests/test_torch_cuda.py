"""The port's CUDA kernels against their plain versions, on a card.

Marked ``cuda``: each test skips without a CUDA card (the kernels have no
CPU mode). Imports no JAX, so it runs on a machine that has only the
port's dependencies:

  PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Inputs at edge-6b head shapes (Hq=32, Hkv=2, hd=128, page 16), with a pad
row, -1 table entries and ragged prompt lengths. Tolerances: fp32 1e-4
(summation order over up to a few hundred keys), bf16 1.6e-2 (output
rounding to bf16 of values below ~4), against the plain version on the
same inputs in fp32.
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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,causal,window", [(77, True, None), (300, True, 64),
                                             (77, False, None), (1, True, None)])
def test_flash_prefill_kernel_matches_plain(dtype, S, causal, window):
    _need_cuda()
    rng = np.random.default_rng(S)
    arrs = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for s in ((2, S, 32, 128), (2, S, 2, 128), (2, S, 2, 128))]
    dt = getattr(torch, dtype)
    dev = [x.to(dt).cuda() for x in arrs]
    got = ops.flash_prefill(*dev, causal=causal, window=window)
    assert got.dtype == dt
    want = ops.flash_prefill(*[x.cpu().float() for x in dev], causal=causal,
                             window=window)
    torch.testing.assert_close(got.float().cpu(), want, atol=TOL[dtype],
                               rtol=0)


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
