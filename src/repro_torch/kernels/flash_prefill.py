"""Launcher of the flash-prefill CUDA kernel (csrc/flash_prefill.cu), the
Hopper counterpart of the TPU kernel
``repro.kernels.flash_prefill.flash_prefill_kernel``.

``launch`` takes tensors already checked and allocated by
``kernels.ops.flash_prefill`` and enqueues the kernel on the current CUDA
stream; it raises if the launch returns an error.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build

NAME = "flash_prefill"
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128, 256)


def _lib() -> ctypes.CDLL:
    lib = build.load(NAME)
    fn = lib.flash_prefill
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P, P, I, I, I, I, I, I, I, ctypes.c_float, I, P]
        fn.restype = ctypes.c_int
    return lib


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           out: torch.Tensor, causal: bool, window: Optional[int]) -> None:
    """q/out [B,S,Hq,hd], k/v [B,S,Hkv,hd] (fp32 or bf16, one type), all
    contiguous on one CUDA device; window None or >= 1."""
    lib = _lib()
    B, S, Hq, hd = q.shape
    Hkv = k.shape[2]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.flash_prefill(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, S, Hq, Hkv, hd, int(bool(causal)),
        -1 if window is None else int(window), float(hd ** -0.5),
        DTYPES[q.dtype], stream)
    build.check(lib, NAME, rc)
