"""Launcher of the SSD-scan CUDA kernel (csrc/ssd_scan.cu), the Hopper
counterpart of the TPU kernel ``repro.kernels.ssd_scan.ssd_scan_kernel``.

Takes tensors already checked and allocated by ``kernels.ops.ssd_scan``,
allocates the fp32 workspace of the chunk states with ``torch.empty`` and
enqueues the kernel's three passes (chunk states, state passing, chunk
outputs) on the current CUDA stream; raises if a launch returns an error.
``body`` is the one rule that picks which of the source's two bodies runs
passes 1 and 3.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

NAME = "ssd_scan"
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
CHUNK = 64                # steps of a chunk (csrc kQ)
CUDA_CORE, TENSOR_CORE = "cuda_core", "tensor_core"
BODIES = {CUDA_CORE: 0, TENSOR_CORE: 1}
P_TILE = 32               # P columns of a tensor-core block (csrc kPT)
MAX_N_TENSOR_CORE = 128   # widest state of the tensor-core body


def body(dtype: torch.dtype, P: int, N: int) -> str:
    """The body of passes 1 and 3 for inputs of ``dtype`` at head_dim P
    and state N: bf16 with P a multiple of 32 and N a multiple of 16 up
    to 128 (mamba2-780m and hymba-1.5b) on the tensor cores (mma.sync),
    everything else on the CUDA cores (fp32 has no tensor-core path that
    keeps 1e-4)."""
    if dtype not in DTYPES:
        raise ValueError(f"ssd scan: type {dtype} not in {tuple(DTYPES)}")
    if (dtype == torch.bfloat16 and P % P_TILE == 0 and N % 16 == 0
            and N <= MAX_N_TENSOR_CORE):
        return TENSOR_CORE
    return CUDA_CORE


def chunks(T: int) -> int:
    """Chunks of a T-step sequence (the last one ragged)."""
    return -(-T // CHUNK)


def _lib() -> ctypes.CDLL:
    lib = build.load(NAME)
    fn = lib.ssd_scan
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P] * 11 + [I] * 5 + [P, I, I, I, P]
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
    nc = chunks(T)
    ws = torch.empty(B * H * nc * P * N, dtype=torch.float32,
                     device=x.device)
    decay = torch.empty(B * H * nc, dtype=torch.float32, device=x.device)
    st = (x.stride(0), x.stride(1), x.stride(2), dt.stride(0), dt.stride(1),
          b.stride(0), b.stride(1), c.stride(0), c.stride(1))
    strides = (ctypes.c_longlong * 9)(*st)
    esz = x.element_size()
    # 16-byte loads of x, b, c rows: bases and (batch, step) strides
    vec = int(all(t.data_ptr() % 16 == 0 for t in (x, b, c))
              and all(s * esz % 16 == 0 for s in (st[0], st[1], st[5], st[6],
                                                   st[7], st[8])))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.ssd_scan(
        x.data_ptr(), dt.data_ptr(), a_log.data_ptr(), d_skip.data_ptr(),
        dt_bias.data_ptr(), b.data_ptr(), c.data_ptr(), y.data_ptr(),
        h.data_ptr(), ws.data_ptr(), decay.data_ptr(), B, T, H, P, N,
        ctypes.addressof(strides), vec, DTYPES[x.dtype],
        BODIES[body(x.dtype, P, N)], stream)
    build.check(lib, NAME, rc)
