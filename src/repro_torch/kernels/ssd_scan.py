"""Launcher of the SSD-scan CUDA kernel (csrc/ssd_scan.cu), the Hopper
counterpart of the TPU kernel ``repro.kernels.ssd_scan.ssd_scan_kernel``.

Takes tensors already checked and allocated by ``kernels.ops.ssd_scan``
and enqueues the kernel on the current CUDA stream; raises if the launch
returns an error.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

NAME = "ssd_scan"
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib() -> ctypes.CDLL:
    lib = build.load(NAME)
    fn = lib.ssd_scan
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P] * 9 + [I] * 5 + [P, I, P]
        fn.restype = ctypes.c_int
    return lib


def launch(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
           b: torch.Tensor, c: torch.Tensor, d_skip: torch.Tensor,
           dt_bias: torch.Tensor, y: torch.Tensor, h: torch.Tensor) -> None:
    """x [B,T,H,P], dt [B,T,H], b/c [B,T,N] (last dimension contiguous,
    other strides any), a_log/d_skip/dt_bias [H] contiguous, one type;
    y [B,T,H,P] and h [B,H,P,N] fp32 contiguous; all on one CUDA device."""
    lib = _lib()
    B, T, H, P = x.shape
    N = b.shape[-1]
    strides = (ctypes.c_longlong * 9)(
        x.stride(0), x.stride(1), x.stride(2), dt.stride(0), dt.stride(1),
        b.stride(0), b.stride(1), c.stride(0), c.stride(1))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.ssd_scan(
        x.data_ptr(), dt.data_ptr(), a_log.data_ptr(), d_skip.data_ptr(),
        dt_bias.data_ptr(), b.data_ptr(), c.data_ptr(), y.data_ptr(),
        h.data_ptr(), B, T, H, P, N, ctypes.addressof(strides),
        DTYPES[x.dtype], stream)
    build.check(lib, NAME, rc)
