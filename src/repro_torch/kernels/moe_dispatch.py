"""Launcher of the grouped-expert FFN CUDA kernel (csrc/moe_grouped_ffn.cu),
the Hopper counterpart of the TPU kernel
``repro.kernels.moe_dispatch.moe_grouped_ffn_kernel``.

Takes tensors already checked and allocated by
``kernels.ops.moe_grouped_ffn`` and enqueues the kernel's two passes on
the current CUDA stream; raises if a launch returns an error. ``body`` is
the one rule that names which of the source's two kernel bodies runs.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build

NAME = "moe_grouped_ffn"
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
CUDA_CORE, TENSOR_CORE = "cuda_core", "tensor_core"


def body(dtype: torch.dtype) -> str:
    """The kernel body for a buffer of ``dtype``: bf16 (the serving type)
    runs on the tensor cores (mma.sync, weights streamed by cp.async),
    fp32 on the CUDA cores (no tensor-core path keeps 1e-4). The C entry
    point picks the same body from the type code."""
    if dtype not in DTYPES:
        raise ValueError(f"moe_grouped_ffn: type {dtype} not in "
                         f"{tuple(DTYPES)}")
    return TENSOR_CORE if dtype == torch.bfloat16 else CUDA_CORE


def _lib() -> ctypes.CDLL:
    lib = build.load(NAME)
    fn = lib.moe_grouped_ffn
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P] * 7 + [I] * 6 + [P]
        fn.restype = ctypes.c_int
    return lib


def launch(buf: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
           wd: torch.Tensor, counts: Optional[torch.Tensor],
           hid: torch.Tensor, out: torch.Tensor) -> None:
    """buf/out [G,C,D], wg/wu [E,D,F], wd [E,F,D] in one type, counts [G]
    int32 or None (every row live), hid [G,C,F] fp32 scratch; all
    contiguous on one CUDA device; G a multiple of E."""
    lib = _lib()
    G, C, D = buf.shape
    E, _, F = wg.shape
    stream = torch.cuda.current_stream(buf.device).cuda_stream
    rc = lib.moe_grouped_ffn(
        buf.data_ptr(), wg.data_ptr(), wu.data_ptr(), wd.data_ptr(),
        None if counts is None else counts.data_ptr(), hid.data_ptr(),
        out.data_ptr(), G, E, C, D, F, DTYPES[buf.dtype], stream)
    build.check(lib, NAME, rc)
