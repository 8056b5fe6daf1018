"""Launchers of the paged-attention CUDA kernel
(csrc/paged_decode_attention.cu), the Hopper counterpart of the TPU kernels
``repro.kernels.paged_attention.paged_decode_attention_kernel``
(``launch``) and ``paged_verify_attention_kernel`` (``launch_verify``).

Each takes tensors already checked and allocated by its wrapper in
``kernels.ops``, allocates the fp32 partials of the page splits with
``torch.empty`` and enqueues the split and combine kernels on the current
CUDA stream; it raises if a launch returns an error. ``body`` is the one
rule that picks which of the source's two split bodies runs, ``plan`` the
one rule that cuts a call into row tiles and page splits, from shapes
alone.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from repro_torch.kernels import build

NAME = "paged_decode_attention"
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128, 256)
CUDA_CORE, TENSOR_CORE = "cuda_core", "tensor_core"
BODIES = {CUDA_CORE: 0, TENSOR_CORE: 1}
TENSOR_CORE_HEAD_DIMS = (64, 128)
MAX_ROWS = 64             # query rows a block holds (csrc kMaxRows)
MAX_PAGES = 64            # pages of one split (csrc kMaxPages)
SPLIT_KV_BYTES = 64 * 1024  # K and V of one split in shared memory
SPLIT_PAIRS = 2048        # (row, key) scores of a CUDA-core block
BLOCKS_PER_SM = 8         # blocks a call aims at, were every page live

_SM_COUNT: Dict[int, int] = {}


def body(dtype: torch.dtype, hd: int) -> str:
    """The split body for q/pages of ``dtype`` at head_dim ``hd``: bf16 at
    hd 64 and 128 (every served registry arch) on the tensor cores
    (mma.sync), fp32 at any hd and bf16 at other hds on the CUDA cores
    (fp32 has no tensor-core path that keeps 1e-4)."""
    if dtype not in DTYPES:
        raise ValueError(f"paged attention: type {dtype} not in "
                         f"{tuple(DTYPES)}")
    if dtype == torch.bfloat16 and hd in TENSOR_CORE_HEAD_DIMS:
        return TENSOR_CORE
    return CUDA_CORE


def plan(B: int, R: int, Hkv: int, hd: int, psz: int, maxp: int,
         dtype: torch.dtype, sms: int) -> Tuple[int, int, int]:
    """(rows a tile, pages a split, splits) for B sequences of R = C*g
    query rows per KV head over a [B, maxp] page table of psz-token pages
    in ``dtype``, on a card of ``sms`` SMs. Rows are cut into equal tiles
    of <= 64. A split holds as many pages as make about BLOCKS_PER_SM
    blocks an SM over the whole table, but at most what keeps its K/V in
    64 KB and its pages at 64, and on the CUDA cores its scores at 2048
    (row, key) pairs. Shapes only: the rows' lengths live on the device."""
    tiles = -(-R // MAX_ROWS)
    rows = -(-R // tiles)
    elt = 2 if dtype == torch.bfloat16 else 4
    cap = min(MAX_PAGES, max(1, SPLIT_KV_BYTES // (2 * psz * hd * elt)))
    if body(dtype, hd) == CUDA_CORE:
        cap = min(cap, max(1, SPLIT_PAIRS // (rows * psz)))
    want = min(maxp, -(-BLOCKS_PER_SM * sms // (B * Hkv * tiles)))
    pps = max(1, min(cap, -(-maxp // max(1, want))))
    return rows, pps, -(-maxp // pps)


def sm_count(device: torch.device) -> int:
    """SMs of the CUDA card ``device``, read once per card."""
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if idx not in _SM_COUNT:
        props = torch.cuda.get_device_properties(idx)
        _SM_COUNT[idx] = props.multi_processor_count
    return _SM_COUNT[idx]


def _lib() -> ctypes.CDLL:
    lib = build.load(NAME)
    fn = lib.paged_decode_attention
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P] * 7 + [I] * 9 + [ctypes.c_float, I, I, P]
        fn.restype = ctypes.c_int
        lib.paged_verify_attention.argtypes = ([P] * 7 + [I] * 10
                                               + [ctypes.c_float, I, I, P])
        lib.paged_verify_attention.restype = ctypes.c_int
    return lib


def _run(fn, q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
         page_table: torch.Tensor, q_start: torch.Tensor, out: torch.Tensor,
         C: int, lead) -> None:
    lib = _lib()
    B, Hq, hd = q.shape[0], q.shape[-2], q.shape[-1]
    _, Hkv, psz, _ = k_pages.shape
    maxp = page_table.shape[1]
    R = C * (Hq // Hkv)
    rows, pps, nsplit = plan(B, R, Hkv, hd, psz, maxp, q.dtype,
                             sm_count(q.device))
    part = torch.empty(B * Hkv * nsplit * R * (hd + 2), dtype=torch.float32,
                       device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = getattr(lib, fn)(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        page_table.data_ptr(), q_start.data_ptr(), out.data_ptr(),
        part.data_ptr(), *lead, Hq, Hkv, hd, psz, maxp, rows, pps, nsplit,
        float(hd ** -0.5), DTYPES[q.dtype], BODIES[body(q.dtype, hd)],
        stream)
    build.check(lib, NAME, rc)


def launch(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
           page_table: torch.Tensor, q_pos: torch.Tensor,
           out: torch.Tensor) -> None:
    """q/out [B,Hq,hd], k/v_pages [P,Hkv,psz,hd] (fp32 or bf16, one type),
    page_table [B,maxp] int32, q_pos [B] int32; all contiguous and 16-byte
    aligned on one CUDA device."""
    _run("paged_decode_attention", q, k_pages, v_pages, page_table, q_pos,
         out, 1, (q.shape[0],))


def launch_verify(q: torch.Tensor, k_pages: torch.Tensor,
                  v_pages: torch.Tensor, page_table: torch.Tensor,
                  q_start: torch.Tensor, out: torch.Tensor) -> None:
    """q/out [B,C,Hq,hd], k/v_pages [P,Hkv,psz,hd] (fp32 or bf16, one
    type), page_table [B,maxp] int32, q_start [B] int32; all contiguous and
    16-byte aligned on one CUDA device."""
    _run("paged_verify_attention", q, k_pages, v_pages, page_table, q_start,
         out, q.shape[1], (q.shape[0], q.shape[1]))
