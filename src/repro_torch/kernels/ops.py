"""Public wrappers of the port's attention kernels.

A wrapper given CUDA tensors checks them (device, type, shape,
contiguity), allocates the output, launches the hand-written kernel on
the current stream and adds one to its launch count; a refused launch
raises. It never falls back to the plain version for a CUDA tensor. Given
CPU tensors it runs the plain version in ``kernels.ref`` (no launch, no
count) — the path the CPU tests take.

``LAUNCHES`` counts kernel launches per wrapper so a run can show that it
went through the kernels; ``reset_launches()`` zeroes it.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.kernels import flash_prefill as _fp
from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import ref

LAUNCHES: Dict[str, int] = {"paged_decode_attention": 0, "flash_prefill": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _on_cuda(name: str, *tensors: torch.Tensor) -> bool:
    """True when every tensor lies on one CUDA device, False when all lie
    on the CPU; raises on a mix."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return False
    if kinds != {"cuda"} or len({t.device for t in tensors}) != 1:
        raise ValueError(f"{name}: tensors on mixed devices "
                         f"{sorted(str(t.device) for t in tensors)}")
    return True


def _check(name: str, cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"{name}: {msg}")


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, page_table: torch.Tensor,
                           q_pos: torch.Tensor) -> torch.Tensor:
    """GQA flash-decode over the paged arena. q [B,Hq,hd]; k/v_pages
    [P,Hkv,psz,hd]; page_table [B,maxp] int32 (-1 unused); q_pos [B] int32.
    Returns [B,Hq,hd] in q's type. A row with no live page gives 0 on the
    card (the plain version averages page 0): callers ignore such rows."""
    name = "paged_decode_attention"
    if not _on_cuda(name, q, k_pages, v_pages, page_table, q_pos):
        return ref.paged_decode_attention_ref(q, k_pages, v_pages,
                                              page_table, q_pos)
    _check(name, q.ndim == 3 and k_pages.ndim == 4, "q [B,Hq,hd] and "
           "pages [P,Hkv,psz,hd] expected")
    B, Hq, hd = q.shape
    _, Hkv, psz, hd_k = k_pages.shape
    _check(name, v_pages.shape == k_pages.shape, "k/v pages differ in shape")
    _check(name, hd_k == hd and hd in _pa.HEAD_DIMS,
           f"head_dim {hd} (pages {hd_k}) not in {_pa.HEAD_DIMS}")
    _check(name, Hkv > 0 and Hq % Hkv == 0 and Hq // Hkv <= 64,
           f"Hq={Hq} not a multiple (<= 64x) of Hkv={Hkv}")
    _check(name, q.dtype in _pa.DTYPES and k_pages.dtype == q.dtype
           and v_pages.dtype == q.dtype,
           f"types {q.dtype}/{k_pages.dtype}/{v_pages.dtype}: one of fp32, "
           "bf16 expected")
    _check(name, page_table.dtype == torch.int32 and q_pos.dtype == torch.int32,
           "page_table and q_pos must be int32")
    _check(name, page_table.ndim == 2 and page_table.shape[0] == B
           and q_pos.shape == (B,), "page_table [B,maxp], q_pos [B] expected")
    _check(name, all(t.is_contiguous() for t in
                     (q, k_pages, v_pages, page_table, q_pos)),
           "tensors must be contiguous")
    out = torch.empty_like(q)
    if B == 0 or page_table.shape[1] == 0:
        return out.zero_()
    _pa.launch(q, k_pages, v_pages, page_table, q_pos, out)
    LAUNCHES[name] += 1
    return out


def flash_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True,
                  window: Optional[int] = None) -> torch.Tensor:
    """Blockwise flash attention for prefill, any S. q [B,S,Hq,hd]; k/v
    [B,S,Hkv,hd]; band mask over positions 0..S-1 (causal and/or window,
    or none). Returns [B,S,Hq,hd] in q's type."""
    name = "flash_prefill"
    if window is not None and window < 1:
        raise ValueError(f"{name}: window must be None or >= 1, got {window}")
    if not _on_cuda(name, q, k, v):
        return ref.flash_prefill_ref(q, k, v, causal=causal, window=window)
    _check(name, q.ndim == 4 and k.ndim == 4, "q [B,S,Hq,hd] and "
           "k/v [B,S,Hkv,hd] expected")
    B, S, Hq, hd = q.shape
    _check(name, v.shape == k.shape and k.shape[:2] == (B, S)
           and k.shape[3] == hd, f"shapes q {tuple(q.shape)} k "
           f"{tuple(k.shape)} v {tuple(v.shape)} disagree")
    Hkv = k.shape[2]
    _check(name, hd in _fp.HEAD_DIMS, f"head_dim {hd} not in {_fp.HEAD_DIMS}")
    _check(name, Hkv > 0 and Hq % Hkv == 0, f"Hq={Hq} not a multiple of "
           f"Hkv={Hkv}")
    _check(name, B <= 65535, f"batch {B} > 65535")
    _check(name, q.dtype in _fp.DTYPES and k.dtype == q.dtype
           and v.dtype == q.dtype,
           f"types {q.dtype}/{k.dtype}/{v.dtype}: one of fp32, bf16 expected")
    _check(name, q.is_contiguous() and k.is_contiguous() and v.is_contiguous(),
           "tensors must be contiguous")
    out = torch.empty_like(q)
    if B == 0 or S == 0:
        return out
    _fp.launch(q, k, v, out, causal, window)
    LAUNCHES[name] += 1
    return out
