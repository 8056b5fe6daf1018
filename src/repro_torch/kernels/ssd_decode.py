"""Launcher of the SSD decode-step CUDA kernel (csrc/ssd_decode.cu), the
Hopper counterpart of the TPU kernel
``repro.kernels.ssd_decode.ssd_decode_step_kernel``.

Takes tensors already checked and allocated by
``kernels.ops.ssd_decode_step`` and enqueues the kernel on the current
CUDA stream; raises if the launch returns an error.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

NAME = "ssd_decode"
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib() -> ctypes.CDLL:
    lib = build.load(NAME)
    fn = lib.ssd_decode_step
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P] * 11 + [I] * 4 + [P, I, P]
        fn.restype = ctypes.c_int
    return lib


def launch(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
           b: torch.Tensor, c: torch.Tensor, d_skip: torch.Tensor,
           dt_bias: torch.Tensor, state: torch.Tensor, slots: torch.Tensor,
           active: torch.Tensor, y: torch.Tensor) -> None:
    """x [B,H,P], dt [B,H], b/c [B,N] (last dimension contiguous),
    a_log/d_skip/dt_bias [H] contiguous, one type; state [S,H,P,N] fp32
    contiguous (updated in place); slots [B] int32; active [B] bool; y
    [B,H,P] contiguous; all on one CUDA device."""
    lib = _lib()
    B, H, P = x.shape
    N = b.shape[-1]
    strides = (ctypes.c_longlong * 5)(x.stride(0), x.stride(1), dt.stride(0),
                                      b.stride(0), c.stride(0))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.ssd_decode_step(
        x.data_ptr(), dt.data_ptr(), a_log.data_ptr(), d_skip.data_ptr(),
        dt_bias.data_ptr(), b.data_ptr(), c.data_ptr(), state.data_ptr(),
        slots.data_ptr(), active.data_ptr(), y.data_ptr(), B, H, P, N,
        ctypes.addressof(strides), DTYPES[x.dtype], stream)
    build.check(lib, NAME, rc)
