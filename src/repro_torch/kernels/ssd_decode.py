"""Launcher of the SSD decode-step CUDA kernel (csrc/ssd_decode.cu), the
Hopper counterpart of the TPU kernel
``repro.kernels.ssd_decode.ssd_decode_step_kernel``.

Takes tensors already checked and allocated by
``kernels.ops.ssd_decode_step`` and enqueues the kernel on the current
CUDA stream; raises if the launch returns an error. ``plan`` is the one
rule that cuts a (slot, head) state tile into the slabs the kernel's
blocks take; ``launch_empty`` launches an empty kernel on the same grid,
the launch floor that the step's time is read against.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import build

NAME = "ssd_decode"
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SLAB_BYTES = 8 * 1024       # target bytes of a slab
MAX_THREADS = 128           # csrc kMaxThreads
BAR_BYTES = 16              # csrc kBarBytes: the mbarrier ahead of the slab
SMEM_LIMIT = 232448         # shared memory a block can have on the H100


class Plan(NamedTuple):
    rows: int        # state rows of a slab (the last slab of a tile ragged)
    slabs: int       # slabs of a (slot, head) tile: blocks of a (row, head)
    threads: int     # threads of a block
    smem: int        # dynamic shared memory of a block, bytes
    shuffle: bool    # y's row sums by shuffles (else in shared memory)


def plan(P: int, N: int) -> Plan:
    """The slab plan of a [P, N] fp32 state tile: as many whole rows as
    fit SLAB_BYTES (at least one, at most the tile), one thread per
    float4 of a slab up to MAX_THREADS, and the kernel's shared memory
    (barrier, slab, B, C, x, and the partial sums when a row's N/4
    float4s are not a power of two <= 32)."""
    if P <= 0 or N <= 0 or N % 4:
        raise ValueError(f"ssd decode: P {P} and N {N} must be positive "
                         "with N % 4 == 0")
    rows = max(1, min(P, SLAB_BYTES // (4 * N)))
    q = N // 4
    shuffle = q <= 32 and q & (q - 1) == 0
    threads = min(MAX_THREADS, -(-rows * q // 32) * 32)
    smem = BAR_BYTES + 4 * (rows * N + 2 * N + rows
                            + (0 if shuffle else rows * q))
    if smem > SMEM_LIMIT:
        raise ValueError(f"ssd decode: a slab of one row at N {N} needs "
                         f"{smem} B of shared memory, over {SMEM_LIMIT}")
    return Plan(rows, -(-P // rows), threads, smem, shuffle)


def body(P: int, N: int) -> str:
    """The plan of a [P, N] tile as a label for timings and checks."""
    p = plan(P, N)
    return (f"slabs of {p.rows}x{N} ({p.rows * N * 4} B), {p.slabs} a tile, "
            f"{p.threads} threads, {'shuffle' if p.shuffle else 'shared'} "
            "row sums")


def _lib() -> ctypes.CDLL:
    lib = build.load(NAME)
    fn = lib.ssd_decode_step
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P] * 11 + [I] * 6 + [P, I, P]
        fn.restype = ctypes.c_int
        lib.ssd_decode_empty.argtypes = [I, I, P]
        lib.ssd_decode_empty.restype = ctypes.c_int
    return lib


def launch(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
           b: torch.Tensor, c: torch.Tensor, d_skip: torch.Tensor,
           dt_bias: torch.Tensor, state: torch.Tensor, slots: torch.Tensor,
           active: torch.Tensor, y: torch.Tensor) -> None:
    """x [B,H,P], dt [B,H], b/c [B,N] (last dimension contiguous),
    a_log/d_skip/dt_bias [H] contiguous, one type; state [S,H,P,N] fp32
    contiguous (updated in place); slots [B] int32; active [B] bool; y
    [B,H,P] contiguous; all on one CUDA device."""
    B, H, P = x.shape
    N = b.shape[-1]
    p = plan(P, N)
    lib = _lib()
    strides = (ctypes.c_longlong * 5)(x.stride(0), x.stride(1), dt.stride(0),
                                      b.stride(0), c.stride(0))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.ssd_decode_step(
        x.data_ptr(), dt.data_ptr(), a_log.data_ptr(), d_skip.data_ptr(),
        dt_bias.data_ptr(), b.data_ptr(), c.data_ptr(), state.data_ptr(),
        slots.data_ptr(), active.data_ptr(), y.data_ptr(), B, H, P, N,
        p.rows, p.threads, ctypes.addressof(strides), DTYPES[x.dtype], stream)
    build.check(lib, NAME, rc)


def launch_empty(B: int, H: int, P: int, N: int,
                 device: torch.device) -> None:
    """An empty kernel on the grid and block that ``launch`` gives B rows
    of H heads of [P, N] tiles, through the same host path (no launch is
    counted: it computes nothing)."""
    p = plan(P, N)
    lib = _lib()
    stream = torch.cuda.current_stream(device).cuda_stream
    build.check(lib, NAME, lib.ssd_decode_empty(B * H * p.slabs, p.threads,
                                                stream))
