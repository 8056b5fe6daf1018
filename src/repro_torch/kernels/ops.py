"""Public wrappers of the port's kernels: attention, the SSD scan and
decode step, and the grouped-expert FFN.

A wrapper given CUDA tensors checks them (device, type, shape,
contiguity, or strides where the kernel reads a view), allocates the
output, launches the hand-written kernel on the current stream and adds
one to its launch count; a refused launch raises. It never falls back to the plain version for a CUDA tensor. Given
CPU tensors it runs the plain version in ``kernels.ref`` (no launch, no
count) — the path the CPU tests take.

No kernel has a backward, as no Pallas kernel of the JAX package has
one: under autograd (``torch.is_grad_enabled()``) a wrapper given an
input that requires grad raises, on the CPU as on the card, where the
kernel's output would otherwise carry no ``grad_fn`` and the weights
behind it would get no gradient without a word. The training forward
(``models.model.forward``) computes in the model code; the engines serve
detached parameters.

``LAUNCHES`` counts kernel launches per wrapper so a run can show that it
went through the kernels; ``reset_launches()`` zeroes it. A CUDA graph's
replay bypasses the wrappers, so ``serving.step_graphs`` records what a
step's capture launched (``recorded_launches``: counted, then taken back
out) and adds it on every replay (``add_launches``): a replayed step
counts exactly as the eager step does.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple, TypeVar

import torch

from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import flash_prefill as _fp
from repro_torch.kernels import moe_dispatch as _moe
from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import ref
from repro_torch.kernels import ssd_decode as _ssdd
from repro_torch.kernels import ssd_scan as _ssd

LAUNCHES: Dict[str, int] = {"paged_decode_attention": 0, "flash_prefill": 0,
                            "flash_prefill_chunk": 0, "decode_attention": 0,
                            "paged_verify_attention": 0, "ssd_scan": 0,
                            "ssd_decode_step": 0, "moe_grouped_ffn": 0}
T = TypeVar("T")


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def recorded_launches(fn: Callable[[], T]) -> Tuple[T, Dict[str, int]]:
    """Run ``fn`` and return (its result, the launches it made per wrapper),
    leaving ``LAUNCHES`` as it was before the call, also if ``fn``
    raises."""
    before = dict(LAUNCHES)
    try:
        out = fn()
        delta = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
    finally:
        LAUNCHES.update(before)
    return out, delta


def add_launches(delta: Dict[str, int]) -> None:
    """Count the launches ``delta`` (from ``recorded_launches``) again."""
    for k, n in delta.items():
        LAUNCHES[k] += n


def _on_cuda(name: str, *tensors: torch.Tensor) -> bool:
    """True when every tensor lies on one CUDA device, False when all lie
    on the CPU; raises on a mix, or when autograd would need a backward
    the kernel does not have."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: an input requires grad, but the kernel has no backward "
            "(nor has the JAX package's); the training forward "
            "(models.model.forward) takes the model code, and serving "
            "runs on detached parameters or under torch.no_grad()")
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
    _check(name, all(t.data_ptr() % 16 == 0 for t in (q, k_pages, v_pages)),
           "q and k/v pages must be 16-byte aligned (the kernel copies 16 "
           "bytes at a time)")


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, page_table: torch.Tensor,
                           q_pos: torch.Tensor) -> torch.Tensor:
    """GQA flash-decode over the paged arena. q [B,Hq,hd]; k/v_pages
    [P,Hkv,psz,hd]; page_table [B,maxp] int32 (-1 unused); q_pos [B] int32.
    Returns [B,Hq,hd] in q's type. A row with no live page gives 0 on the
    card (the plain version averages page 0): callers ignore such rows.
    The kernel's two passes (page splits, combine) count as one launch."""
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
    page 0): callers ignore such rows. The kernel's two passes (page
    splits, combine) count as one launch."""
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


def _check_tensor_core(name: str, q: torch.Tensor, k: torch.Tensor,
                       v: torch.Tensor) -> None:
    """The flash-prefill tensor-core body reads q in 16-byte pieces and k/v
    by TMA: base addresses and k/v's (batch, position, head) strides must
    be multiples of 16 bytes."""
    if _fp.body(q.dtype, q.shape[-1]) != _fp.TENSOR_CORE:
        return
    esz = q.element_size()
    _check(name, all(t.data_ptr() % 16 == 0 for t in (q, k, v))
           and all(s * esz % 16 == 0 for t in (k, v) for s in t.stride()[:3]),
           "the tensor-core body needs 16-byte aligned q/k/v and k/v "
           f"strides in multiples of 16 bytes (k strides {k.stride()}, "
           f"v strides {v.stride()})")


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, kv_pos: torch.Tensor,
                     q_pos: torch.Tensor, *,
                     window: Optional[int] = None) -> torch.Tensor:
    """GQA flash-decode over a slot (ring) cache, any S. q [B,Hq,hd];
    k/v_cache [B,Hkv,S,hd]; kv_pos [B,S] int32 (-1 empty); q_pos [B] int32;
    keeps 0 <= kv_pos <= q_pos (and q_pos - kv_pos < window). Returns
    [B,Hq,hd] in q's type. A row with nothing live gives 0 on the card
    (the plain version averages every slot): callers ignore such rows.
    The kernel's two passes (slot splits, combine) count as one launch."""
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
    _check(name, all(t.data_ptr() % 16 == 0 for t in (q, k_cache, v_cache)),
           "q and k/v_cache must be 16-byte aligned (the kernel copies 16 "
           "bytes at a time)")
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
    _check_tensor_core(name, q, k, v)
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
    _check_tensor_core(name, q, k, v)
    out = torch.empty_like(q)
    if B == 0 or S == 0:
        return out
    _fp.launch(q, k, v, out, causal, window)
    LAUNCHES[name] += 1
    return out


def _check_ssd_params(name: str, H: int, dtype: torch.dtype,
                      *params: torch.Tensor) -> None:
    _check(name, all(t.shape == (H,) and t.is_contiguous() for t in params),
           f"a_log/d_skip/dt_bias must be contiguous [{H}]")
    _check(name, dtype in _ssd.DTYPES and all(t.dtype == dtype
                                               for t in params),
           f"type {dtype} (parameters "
           f"{'/'.join(str(t.dtype) for t in params)}): one of fp32, bf16, "
           "all alike, expected")


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor, d_skip: torch.Tensor,
             dt_bias: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mamba2 SSD scan from a zero state, any T. x [B,T,H,P]; dt [B,T,H];
    b,c [B,T,N]; a_log/d_skip/dt_bias [H]. x, dt, b and c may be strided
    views (the mixer passes splits of one projection) as long as their last
    dimension, and x's [H,P] block, are contiguous: the kernel reads them
    through their strides, nothing is copied. Returns (y [B,T,H,P]
    contiguous in x's type, final state [B,H,P,N] fp32). The kernel's
    three passes (chunk states, state passing, chunk outputs) count as
    one launch."""
    name = "ssd_scan"
    if not _on_cuda(name, x, dt, a_log, b, c, d_skip, dt_bias):
        return ref.ssd_scan_ref(x, dt, a_log, b, c, d_skip, dt_bias)
    _check(name, x.ndim == 4 and dt.ndim == 3 and b.ndim == 3
           and c.ndim == 3, "x [B,T,H,P], dt [B,T,H], b/c [B,T,N] expected")
    B, T, H, P = x.shape
    N = b.shape[-1]
    _check(name, dt.shape == (B, T, H) and b.shape == (B, T, N)
           and c.shape == b.shape, f"shapes x {tuple(x.shape)} dt "
           f"{tuple(dt.shape)} b {tuple(b.shape)} c {tuple(c.shape)} "
           "disagree")
    _check_ssd_params(name, H, x.dtype, a_log, d_skip, dt_bias)
    _check(name, all(t.dtype == x.dtype for t in (dt, b, c)),
           "x, dt, b, c must share one type")
    _check(name, x.stride(3) == 1 and x.stride(2) == P and dt.stride(2) == 1
           and b.stride(2) == 1 and c.stride(2) == 1,
           "x's [H,P] block and the last dimension of dt, b, c must be "
           "contiguous")
    _check(name, B <= 65535, f"batch {B} > 65535")
    y = torch.empty((B, T, H, P), dtype=x.dtype, device=x.device)
    h = torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
    if B == 0 or T == 0 or H == 0:
        return y, h.zero_()
    _ssd.launch(x, dt, a_log, b, c, d_skip, dt_bias, y, h)
    LAUNCHES[name] += 1
    return y, h


def ssd_decode_step(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                    b: torch.Tensor, c: torch.Tensor, d_skip: torch.Tensor,
                    dt_bias: torch.Tensor, state: torch.Tensor,
                    slots: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """One SSD recurrence step of B rows over a layer's state arena, in
    place. x [B,H,P]; dt [B,H]; b,c [B,N] (strided views with a contiguous
    last dimension, and x's P contiguous, are read in place);
    a_log/d_skip/dt_bias [H]; state [S,H,P,N] fp32; slots [B] int32, the
    arena slot of each row; active [B] bool. Row b steps state[slots[b]]
    and writes it back when active and slots[b] >= 0; live rows' slots
    must be distinct. Returns y [B,H,P] in x's type (0 for slot -1
    rows)."""
    name = "ssd_decode_step"
    if not _on_cuda(name, x, dt, a_log, b, c, d_skip, dt_bias, state, slots,
                    active):
        return ref.ssd_decode_step_ref(x, dt, a_log, b, c, d_skip, dt_bias,
                                       state, slots, active)
    _check(name, x.ndim == 3 and dt.ndim == 2 and b.ndim == 2
           and c.ndim == 2 and state.ndim == 4,
           "x [B,H,P], dt [B,H], b/c [B,N], state [S,H,P,N] expected")
    B, H, P = x.shape
    N = b.shape[-1]
    _check(name, dt.shape == (B, H) and b.shape == (B, N)
           and c.shape == b.shape and state.shape[1:] == (H, P, N),
           f"shapes x {tuple(x.shape)} dt {tuple(dt.shape)} b "
           f"{tuple(b.shape)} state {tuple(state.shape)} disagree")
    _check_ssd_params(name, H, x.dtype, a_log, d_skip, dt_bias)
    _check(name, all(t.dtype == x.dtype for t in (dt, b, c)),
           "x, dt, b, c must share one type")
    _check(name, state.dtype == torch.float32 and state.is_contiguous()
           and state.data_ptr() % 16 == 0 and N % 4 == 0,
           "state must be a contiguous, 16-byte aligned fp32 arena with "
           "N % 4 == 0")
    _check(name, x.stride(2) == 1 and dt.stride(1) == 1 and b.stride(1) == 1
           and c.stride(1) == 1, "the last dimension of x, dt, b, c must "
           "be contiguous")
    _check(name, slots.dtype == torch.int32 and slots.shape == (B,)
           and active.dtype == torch.bool and active.shape == (B,)
           and slots.is_contiguous() and active.is_contiguous(),
           "slots [B] int32 and active [B] bool expected")
    _check(name, B <= 65535, f"batch {B} > 65535")
    y = torch.empty((B, H, P), dtype=x.dtype, device=x.device)
    if B == 0 or H == 0:
        return y
    _ssdd.launch(x, dt, a_log, b, c, d_skip, dt_bias, state, slots, active, y)
    LAUNCHES[name] += 1
    return y


def moe_grouped_ffn(buf: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
                    wd: torch.Tensor,
                    counts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-group gated MLP silu(x Wg) * (x Wu) Wd over a dispatched buffer,
    fp32 inside. buf [G,C,D] with G a multiple of E, group g using expert
    g mod E (G = E for one dispatch group, B*E for per-example buffers);
    wg/wu [E,D,F]; wd [E,F,D]; counts [G] int32, the live rows of each
    group (rows 0..counts[g]-1, clamped to [0, C]), or None for every row
    live. Returns [G,C,D] in buf's type: rows at or past a group's count
    are exact zeros (and on the card are never read), so zero rows give
    zero rows either way. The kernel's two passes (gate/up, down) count
    as one launch."""
    name = "moe_grouped_ffn"
    tensors = (buf, wg, wu, wd) + (() if counts is None else (counts,))
    if not _on_cuda(name, *tensors):
        return ref.moe_grouped_ffn_ref(buf, wg, wu, wd, counts)
    _check(name, buf.ndim == 3 and wg.ndim == 3 and wu.ndim == 3
           and wd.ndim == 3, "buf [G,C,D], wg/wu [E,D,F], wd [E,F,D] "
           "expected")
    G, C, D = buf.shape
    E, _, F = wg.shape
    _check(name, wg.shape == (E, D, F) and wu.shape == wg.shape
           and wd.shape == (E, F, D) and E > 0 and G % E == 0,
           f"shapes buf {tuple(buf.shape)} wg {tuple(wg.shape)} wu "
           f"{tuple(wu.shape)} wd {tuple(wd.shape)} disagree")
    _check(name, buf.dtype in _moe.DTYPES
           and all(t.dtype == buf.dtype for t in (wg, wu, wd)),
           f"types {buf.dtype}/{wg.dtype}/{wu.dtype}/{wd.dtype}: one of "
           "fp32, bf16 expected")
    _check(name, all(t.is_contiguous() for t in tensors),
           "tensors must be contiguous")
    _check(name, counts is None or (counts.dtype == torch.int32
                                    and counts.shape == (G,)),
           f"counts must be int32 [{G}]")
    _check(name, G <= 65535, f"{G} groups > 65535")
    if _moe.body(buf.dtype) == _moe.TENSOR_CORE:
        _check(name, D % 8 == 0 and F % 8 == 0
               and all(t.data_ptr() % 16 == 0 for t in (buf, wg, wu, wd)),
               "the tensor-core body copies 16 bytes at a time: D and F "
               f"must be multiples of 8 (D={D}, F={F}) and buf/wg/wu/wd "
               "16-byte aligned")
    out = torch.empty_like(buf)
    if G == 0 or C == 0:
        return out
    hid = torch.empty((G, C, F), dtype=torch.float32, device=buf.device)
    _moe.launch(buf, wg, wu, wd, counts, hid, out)
    LAUNCHES[name] += 1
    return out
