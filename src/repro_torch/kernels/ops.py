"""Public wrappers of the port's attention kernels.

A wrapper given CUDA tensors checks them (device, type, shape,
contiguity, or strides where the kernel reads a view), allocates the
output, launches the hand-written kernel on the current stream and adds
one to its launch count; a refused launch raises. It never falls back to the plain version for a CUDA tensor. Given
CPU tensors it runs the plain version in ``kernels.ref`` (no launch, no
count) — the path the CPU tests take.

``LAUNCHES`` counts kernel launches per wrapper so a run can show that it
went through the kernels; ``reset_launches()`` zeroes it.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import flash_prefill as _fp
from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import ref

LAUNCHES: Dict[str, int] = {"paged_decode_attention": 0, "flash_prefill": 0,
                            "flash_prefill_chunk": 0, "decode_attention": 0,
                            "paged_verify_attention": 0}


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


def _check_paged(name: str, q: torch.Tensor, k_pages: torch.Tensor,
                 v_pages: torch.Tensor, page_table: torch.Tensor,
                 q_start: torch.Tensor) -> None:
    """Checks shared by the paged wrappers: q [B,...,Hq,hd]."""
    B, Hq, hd = q.shape[0], q.shape[-2], q.shape[-1]
    _, Hkv, psz, hd_k = k_pages.shape
    _check(name, v_pages.shape == k_pages.shape, "k/v pages differ in shape")
    _check(name, hd_k == hd and hd in _pa.HEAD_DIMS,
           f"head_dim {hd} (pages {hd_k}) not in {_pa.HEAD_DIMS}")
    _check(name, Hkv > 0 and Hq % Hkv == 0,
           f"Hq={Hq} not a multiple of Hkv={Hkv}")
    _check(name, q.dtype in _pa.DTYPES and k_pages.dtype == q.dtype
           and v_pages.dtype == q.dtype,
           f"types {q.dtype}/{k_pages.dtype}/{v_pages.dtype}: one of fp32, "
           "bf16 expected")
    _check(name, page_table.dtype == torch.int32
           and q_start.dtype == torch.int32,
           "page_table and q positions must be int32")
    _check(name, page_table.ndim == 2 and page_table.shape[0] == B
           and q_start.shape == (B,), "page_table [B,maxp] and q positions "
           "[B] expected")
    _check(name, B <= 65535 and Hkv <= 65535, f"batch {B} or Hkv {Hkv} "
           "> 65535")
    _check(name, all(t.is_contiguous() for t in
                     (q, k_pages, v_pages, page_table, q_start)),
           "tensors must be contiguous")


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
    _check_paged(name, q, k_pages, v_pages, page_table, q_pos)
    out = torch.empty_like(q)
    if q.shape[0] == 0 or page_table.shape[1] == 0:
        return out.zero_()
    _pa.launch(q, k_pages, v_pages, page_table, q_pos, out)
    LAUNCHES[name] += 1
    return out


def paged_verify_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, page_table: torch.Tensor,
                           q_start: torch.Tensor) -> torch.Tensor:
    """C verify queries per sequence over the paged arena, any C. q
    [B,C,Hq,hd] at positions q_start[b]+i (query i keeps keys at positions
    0..q_start[b]+i); k/v_pages [P,Hkv,psz,hd]; page_table [B,maxp] int32
    (-1 unused); q_start [B] int32. Returns [B,C,Hq,hd] in q's type. A row
    with no live page gives 0 on the card (the plain version averages
    page 0): callers ignore such rows."""
    name = "paged_verify_attention"
    if not _on_cuda(name, q, k_pages, v_pages, page_table, q_start):
        return ref.paged_verify_attention_ref(q, k_pages, v_pages,
                                              page_table, q_start)
    _check(name, q.ndim == 4 and k_pages.ndim == 4, "q [B,C,Hq,hd] and "
           "pages [P,Hkv,psz,hd] expected")
    _check_paged(name, q, k_pages, v_pages, page_table, q_start)
    out = torch.empty_like(q)
    if q.shape[0] == 0 or q.shape[1] == 0 or page_table.shape[1] == 0:
        return out.zero_()
    _pa.launch_verify(q, k_pages, v_pages, page_table, q_start, out)
    LAUNCHES[name] += 1
    return out


def _check_window(name: str, window: Optional[int]) -> None:
    if window is not None and window < 1:
        raise ValueError(f"{name}: window must be None or >= 1, got {window}")


def _check_heads(name: str, q: torch.Tensor, *kv: torch.Tensor,
                 hd: int, Hq: int, Hkv: int, head_dims, dtypes) -> None:
    _check(name, hd in head_dims, f"head_dim {hd} not in {head_dims}")
    _check(name, Hkv > 0 and Hq % Hkv == 0, f"Hq={Hq} not a multiple of "
           f"Hkv={Hkv}")
    _check(name, q.dtype in dtypes and all(t.dtype == q.dtype for t in kv),
           f"types {q.dtype}/{'/'.join(str(t.dtype) for t in kv)}: one of "
           "fp32, bf16 expected")


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, kv_pos: torch.Tensor,
                     q_pos: torch.Tensor, *,
                     window: Optional[int] = None) -> torch.Tensor:
    """GQA flash-decode over a slot (ring) cache, any S. q [B,Hq,hd];
    k/v_cache [B,Hkv,S,hd]; kv_pos [B,S] int32 (-1 empty); q_pos [B] int32;
    keeps 0 <= kv_pos <= q_pos (and q_pos - kv_pos < window). Returns
    [B,Hq,hd] in q's type. A row with nothing live gives 0 on the card
    (the plain version averages every slot): callers ignore such rows."""
    name = "decode_attention"
    _check_window(name, window)
    if not _on_cuda(name, q, k_cache, v_cache, kv_pos, q_pos):
        return ref.decode_attention_ref(q, k_cache, v_cache, kv_pos, q_pos,
                                        window)
    _check(name, q.ndim == 3 and k_cache.ndim == 4, "q [B,Hq,hd] and "
           "k/v_cache [B,Hkv,S,hd] expected")
    B, Hq, hd = q.shape
    Hkv, S = k_cache.shape[1], k_cache.shape[2]
    _check(name, v_cache.shape == k_cache.shape and k_cache.shape[0] == B
           and k_cache.shape[3] == hd, f"shapes q {tuple(q.shape)} k "
           f"{tuple(k_cache.shape)} v {tuple(v_cache.shape)} disagree")
    _check_heads(name, q, k_cache, v_cache, hd=hd, Hq=Hq, Hkv=Hkv,
                 head_dims=_da.HEAD_DIMS, dtypes=_da.DTYPES)
    _check(name, Hq // Hkv <= 64, f"Hq/Hkv={Hq // Hkv} > 64")
    _check(name, B <= 65535, f"batch {B} > 65535")
    _check(name, kv_pos.dtype == torch.int32 and q_pos.dtype == torch.int32,
           "kv_pos and q_pos must be int32")
    _check(name, kv_pos.shape == (B, S) and q_pos.shape == (B,),
           "kv_pos [B,S], q_pos [B] expected")
    _check(name, all(t.is_contiguous() for t in
                     (q, k_cache, v_cache, kv_pos, q_pos)),
           "tensors must be contiguous")
    out = torch.empty_like(q)
    if B == 0 or S == 0:
        return out.zero_()
    _da.launch(q, k_cache, v_cache, kv_pos, q_pos, out, window)
    LAUNCHES[name] += 1
    return out


def flash_prefill_chunk(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        q_start: torch.Tensor, *,
                        window: Optional[int] = None) -> torch.Tensor:
    """Causal flash attention for one prompt chunk, any C and S. q
    [B,C,Hq,hd] at absolute positions q_start[b]+i; k/v [B,S,Hkv,hd], key
    j at position j, any strides with a contiguous last dimension (the slot
    cache's [B,Hkv,S,hd] buffer passed as ``.transpose(1, 2)`` is read in
    place); q_start [B] int32. Keys past the chunk's end are masked, so a
    buffer with stale tail data is safe. Returns [B,C,Hq,hd] in q's type."""
    name = "flash_prefill_chunk"
    _check_window(name, window)
    if not _on_cuda(name, q, k, v, q_start):
        return ref.flash_prefill_chunk_ref(q, k, v, q_start, window)
    _check(name, q.ndim == 4 and k.ndim == 4, "q [B,C,Hq,hd] and "
           "k/v [B,S,Hkv,hd] expected")
    B, C, Hq, hd = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    _check(name, v.shape == k.shape and k.shape[0] == B and k.shape[3] == hd,
           f"shapes q {tuple(q.shape)} k {tuple(k.shape)} v "
           f"{tuple(v.shape)} disagree")
    _check_heads(name, q, k, v, hd=hd, Hq=Hq, Hkv=Hkv,
                 head_dims=_fp.HEAD_DIMS, dtypes=_fp.DTYPES)
    _check(name, B <= 65535, f"batch {B} > 65535")
    _check(name, q_start.dtype == torch.int32 and q_start.shape == (B,),
           "q_start must be int32 [B]")
    _check(name, q.is_contiguous() and q_start.is_contiguous(),
           "q and q_start must be contiguous")
    _check(name, k.stride(3) == 1 and v.stride(3) == 1
           and min(k.stride() + v.stride()) >= 0,
           "k/v need a contiguous last dimension")
    out = torch.empty_like(q)
    if B == 0 or C == 0 or S == 0:
        return out.zero_()
    _fp.launch_chunk(q, k, v, q_start, out, window)
    LAUNCHES[name] += 1
    return out


def flash_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True,
                  window: Optional[int] = None) -> torch.Tensor:
    """Blockwise flash attention for prefill, any S. q [B,S,Hq,hd]; k/v
    [B,S,Hkv,hd]; band mask over positions 0..S-1 (causal and/or window,
    or none). Returns [B,S,Hq,hd] in q's type."""
    name = "flash_prefill"
    _check_window(name, window)
    if not _on_cuda(name, q, k, v):
        return ref.flash_prefill_ref(q, k, v, causal=causal, window=window)
    _check(name, q.ndim == 4 and k.ndim == 4, "q [B,S,Hq,hd] and "
           "k/v [B,S,Hkv,hd] expected")
    B, S, Hq, hd = q.shape
    _check(name, v.shape == k.shape and k.shape[:2] == (B, S)
           and k.shape[3] == hd, f"shapes q {tuple(q.shape)} k "
           f"{tuple(k.shape)} v {tuple(v.shape)} disagree")
    _check_heads(name, q, k, v, hd=hd, Hq=Hq, Hkv=k.shape[2],
                 head_dims=_fp.HEAD_DIMS, dtypes=_fp.DTYPES)
    _check(name, B <= 65535, f"batch {B} > 65535")
    _check(name, q.is_contiguous() and k.is_contiguous() and v.is_contiguous(),
           "tensors must be contiguous")
    out = torch.empty_like(q)
    if B == 0 or S == 0:
        return out
    _fp.launch(q, k, v, out, causal, window)
    LAUNCHES[name] += 1
    return out
