"""Launchers of the paged-attention CUDA kernel
(csrc/paged_decode_attention.cu), the Hopper counterpart of the TPU kernels
``repro.kernels.paged_attention.paged_decode_attention_kernel``
(``launch``) and ``paged_verify_attention_kernel`` (``launch_verify``).

Each takes tensors already checked and allocated by its wrapper in
``kernels.ops`` and enqueues the kernel on the current CUDA stream; it
raises if the launch returns an error.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

NAME = "paged_decode_attention"
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128, 256)


def _lib() -> ctypes.CDLL:
    lib = build.load(NAME)
    fn = lib.paged_decode_attention
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P, P, P, P, I, I, I, I, I, I, ctypes.c_float,
                       I, P]
        fn.restype = ctypes.c_int
        lib.paged_verify_attention.argtypes = [P, P, P, P, P, P, I, I, I, I,
                                               I, I, I, ctypes.c_float, I, P]
        lib.paged_verify_attention.restype = ctypes.c_int
    return lib


def launch(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
           page_table: torch.Tensor, q_pos: torch.Tensor,
           out: torch.Tensor) -> None:
    """q/out [B,Hq,hd], k/v_pages [P,Hkv,psz,hd] (fp32 or bf16, one type),
    page_table [B,maxp] int32, q_pos [B] int32; all contiguous on one
    CUDA device."""
    lib = _lib()
    B, Hq, hd = q.shape
    _, Hkv, psz, _ = k_pages.shape
    maxp = page_table.shape[1]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.paged_decode_attention(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        page_table.data_ptr(), q_pos.data_ptr(), out.data_ptr(),
        B, Hq, Hkv, hd, psz, maxp, float(hd ** -0.5), DTYPES[q.dtype],
        stream)
    build.check(lib, NAME, rc)


def launch_verify(q: torch.Tensor, k_pages: torch.Tensor,
                  v_pages: torch.Tensor, page_table: torch.Tensor,
                  q_start: torch.Tensor, out: torch.Tensor) -> None:
    """q/out [B,C,Hq,hd], k/v_pages [P,Hkv,psz,hd] (fp32 or bf16, one
    type), page_table [B,maxp] int32, q_start [B] int32; all contiguous on
    one CUDA device."""
    lib = _lib()
    B, C, Hq, hd = q.shape
    _, Hkv, psz, _ = k_pages.shape
    maxp = page_table.shape[1]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.paged_verify_attention(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        page_table.data_ptr(), q_start.data_ptr(), out.data_ptr(),
        B, C, Hq, Hkv, hd, psz, maxp, float(hd ** -0.5), DTYPES[q.dtype],
        stream)
    build.check(lib, NAME, rc)
