"""Launcher of the decode-attention CUDA kernel (csrc/decode_attention.cu),
the Hopper counterpart of the TPU kernel
``repro.kernels.decode_attention.decode_attention_kernel``.

``launch`` takes tensors already checked and allocated by
``kernels.ops.decode_attention`` and enqueues the kernel on the current
CUDA stream; it raises if the launch returns an error.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build

NAME = "decode_attention"
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128, 256)


def _lib() -> ctypes.CDLL:
    lib = build.load(NAME)
    fn = lib.decode_attention
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P, P, P, P, I, I, I, I, I, I, ctypes.c_float,
                       I, P]
        fn.restype = ctypes.c_int
    return lib


def launch(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
           kv_pos: torch.Tensor, q_pos: torch.Tensor, out: torch.Tensor,
           window: Optional[int]) -> None:
    """q/out [B,Hq,hd], k/v_cache [B,Hkv,S,hd] (fp32 or bf16, one type),
    kv_pos [B,S] int32, q_pos [B] int32; all contiguous on one CUDA
    device; window None or >= 1."""
    lib = _lib()
    B, Hq, hd = q.shape
    Hkv, S = k_cache.shape[1], k_cache.shape[2]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.decode_attention(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        kv_pos.data_ptr(), q_pos.data_ptr(), out.data_ptr(),
        B, Hq, Hkv, hd, S, -1 if window is None else int(window),
        float(hd ** -0.5), DTYPES[q.dtype], stream)
    build.check(lib, NAME, rc)
