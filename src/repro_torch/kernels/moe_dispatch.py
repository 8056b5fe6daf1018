"""Launcher of the grouped-expert FFN CUDA kernel (csrc/moe_grouped_ffn.cu),
the Hopper counterpart of the TPU kernel
``repro.kernels.moe_dispatch.moe_grouped_ffn_kernel``.

Takes tensors already checked and allocated by
``kernels.ops.moe_grouped_ffn`` and enqueues the kernel's two passes on
the current CUDA stream; raises if a launch returns an error.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

NAME = "moe_grouped_ffn"
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib() -> ctypes.CDLL:
    lib = build.load(NAME)
    fn = lib.moe_grouped_ffn
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P] * 6 + [I] * 6 + [P]
        fn.restype = ctypes.c_int
    return lib


def launch(buf: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
           wd: torch.Tensor, hid: torch.Tensor, out: torch.Tensor) -> None:
    """buf/out [G,C,D], wg/wu [E,D,F], wd [E,F,D] in one type, hid [G,C,F]
    fp32 scratch; all contiguous on one CUDA device; G a multiple of E."""
    lib = _lib()
    G, C, D = buf.shape
    E, _, F = wg.shape
    stream = torch.cuda.current_stream(buf.device).cuda_stream
    rc = lib.moe_grouped_ffn(
        buf.data_ptr(), wg.data_ptr(), wu.data_ptr(), wd.data_ptr(),
        hid.data_ptr(), out.data_ptr(), G, E, C, D, F, DTYPES[buf.dtype],
        stream)
    build.check(lib, NAME, rc)
