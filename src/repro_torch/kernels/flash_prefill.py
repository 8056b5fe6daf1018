"""Launchers of the flash-prefill CUDA kernel (csrc/flash_prefill.cu), the
Hopper counterpart of the TPU kernels
``repro.kernels.flash_prefill.flash_prefill_kernel`` (``launch``) and
``flash_prefill_chunk_kernel`` (``launch_chunk``).

Each takes tensors already checked and allocated by its wrapper in
``kernels.ops`` and enqueues the kernel on the current CUDA stream; it
raises if the launch returns an error. ``body`` is the one rule that picks
which of the source's two kernel bodies runs.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build

NAME = "flash_prefill"
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128, 256)
CUDA_CORE, TENSOR_CORE = "cuda_core", "tensor_core"
BODIES = {CUDA_CORE: 0, TENSOR_CORE: 1}
TENSOR_CORE_HEAD_DIMS = (64, 128)

def body(dtype: torch.dtype, hd: int) -> str:
    """The kernel body for q/k/v of ``dtype`` at head_dim ``hd``: bf16 at
    hd 64 and 128 (every served registry arch) runs on the tensor cores
    (wgmma, K/V by TMA); fp32 at any hd, and bf16 at other hds, on the
    CUDA cores (fp32 has no tensor-core path that keeps 1e-4)."""
    if dtype not in DTYPES:
        raise ValueError(f"flash_prefill: type {dtype} not in "
                         f"{tuple(DTYPES)}")
    if dtype == torch.bfloat16 and hd in TENSOR_CORE_HEAD_DIMS:
        return TENSOR_CORE
    return CUDA_CORE


def _lib() -> ctypes.CDLL:
    lib = build.load(NAME)
    fn = lib.flash_prefill
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P, P, I, I, I, I, I, I, I, ctypes.c_float, I, I,
                       P]
        fn.restype = ctypes.c_int
        L = ctypes.c_longlong
        lib.flash_prefill_chunk.argtypes = [P, P, P, P, P, I, I, I, I, I, I,
                                            L, L, L, L, L, L, I,
                                            ctypes.c_float, I, I, P]
        lib.flash_prefill_chunk.restype = ctypes.c_int
    return lib


def _body_args(q: torch.Tensor):
    return BODIES[body(q.dtype, q.shape[-1])], DTYPES[q.dtype]


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
        *_body_args(q), stream)
    build.check(lib, NAME, rc)


def launch_chunk(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 q_start: torch.Tensor, out: torch.Tensor,
                 window: Optional[int]) -> None:
    """q/out [B,C,Hq,hd] contiguous; k/v [B,S,Hkv,hd] views whose last
    dimension is contiguous (the kernel reads them through their strides);
    q_start [B] int32; one type (fp32 or bf16), one CUDA device."""
    lib = _lib()
    B, C, Hq, hd = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.flash_prefill_chunk(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        q_start.data_ptr(), B, C, S, Hq, Hkv, hd, *k.stride()[:3],
        *v.stride()[:3], -1 if window is None else int(window),
        float(hd ** -0.5), *_body_args(q), stream)
    build.check(lib, NAME, rc)
