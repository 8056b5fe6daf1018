"""Launcher of the decode-attention CUDA kernel (csrc/decode_attention.cu),
the Hopper counterpart of the TPU kernel
``repro.kernels.decode_attention.decode_attention_kernel``.

``launch`` takes tensors already checked and allocated by
``kernels.ops.decode_attention``, allocates the fp32 partials of the slot
splits with ``torch.empty`` and enqueues the split and combine kernels on
the current CUDA stream; it raises if a launch returns an error. The split
bodies are those of the paged kernel (``csrc/split_attention.cuh``), so
``kernels.paged_attention.body`` picks which one runs; ``plan`` is the one
rule that cuts a call into row tiles and slot splits, from shapes alone.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.paged_attention import BODIES, CUDA_CORE, body

NAME = "decode_attention"
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128, 256)
MAX_ROWS = 64             # query rows a block holds (csrc kMaxRows)
MAX_SLOTS = 256           # slots of one split (csrc RingKeys::kMeta)
SPLIT_KV_BYTES = 64 * 1024  # K and V of one split in shared memory
SPLIT_PAIRS = 2048        # (row, key) scores of a CUDA-core block
MIN_SPLITS = 4            # splits a row is cut into, where it is long


def plan(R: int, hd: int, S: int,
         dtype: torch.dtype) -> Tuple[int, int, int]:
    """(rows a tile, slots a split, splits) for R = Hq/Hkv query rows per
    KV head over an S-slot ring in ``dtype``. Rows are cut into equal
    tiles of <= 64. A split holds a multiple of 16 slots (the tensor-core
    body's key block): about S / MIN_SPLITS, but at most what keeps its
    K/V in 64 KB and its slots at 256, and on the CUDA cores its scores at
    2048 (row, key) pairs. Few large splits, unlike the paged ``plan``:
    the combine reads every split of a ring (its cost grows with their
    number) and a split's time is its dependent reads, nearly the same for
    16 slots as for 128 (``launch/time_decode_attention.py``, PERF.md), so
    the batch and the SM count do not enter."""
    tiles = -(-R // MAX_ROWS)
    rows = -(-R // tiles)
    elt = 2 if dtype == torch.bfloat16 else 4
    cap = min(MAX_SLOTS, SPLIT_KV_BYTES // (2 * hd * elt))
    if body(dtype, hd) == CUDA_CORE:
        cap = min(cap, SPLIT_PAIRS // rows)
    cap = max(16, cap // 16 * 16)
    sps = min(cap, -(-S // (16 * MIN_SPLITS)) * 16)
    return rows, sps, -(-S // sps)


def _lib() -> ctypes.CDLL:
    lib = build.load(NAME)
    fn = lib.decode_attention
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P] * 7 + [I] * 9 + [ctypes.c_float, I, I, P]
        fn.restype = ctypes.c_int
    return lib


def launch(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
           kv_pos: torch.Tensor, q_pos: torch.Tensor, out: torch.Tensor,
           window: Optional[int]) -> None:
    """q/out [B,Hq,hd], k/v_cache [B,Hkv,S,hd] (fp32 or bf16, one type),
    kv_pos [B,S] int32, q_pos [B] int32; all contiguous and q, k/v 16-byte
    aligned on one CUDA device; window None or >= 1."""
    lib = _lib()
    B, Hq, hd = q.shape
    Hkv, S = k_cache.shape[1], k_cache.shape[2]
    R = Hq // Hkv
    rows, sps, nsplit = plan(R, hd, S, q.dtype)
    part = torch.empty(B * Hkv * nsplit * R * (hd + 2), dtype=torch.float32,
                       device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.decode_attention(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        kv_pos.data_ptr(), q_pos.data_ptr(), out.data_ptr(), part.data_ptr(),
        B, Hq, Hkv, hd, S, -1 if window is None else int(window), rows, sps,
        nsplit, float(hd ** -0.5), DTYPES[q.dtype],
        BODIES[body(q.dtype, hd)], stream)
    build.check(lib, NAME, rc)
