"""Launchers of the paged decode step's fused elementwise kernels
(csrc/decode_fused.cu): residual add + RMSNorm, RoPE + the new token's
K/V page write, and silu(g) * u. They replace no TPU kernel (the JAX
package leaves these chains to XLA's fusion); the note at the top of the
source says why they exist and what bounds them.

Each takes tensors already checked and allocated by its wrapper in
``kernels.ops`` and enqueues the kernel on the current CUDA stream;
raises if the launch returns an error.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

NAME = "decode_fused"
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128, 256)


def vector(dtype: torch.dtype) -> int:
    """Elements of ``dtype`` in the kernels' 16-byte loads: a row's width
    (D, d_ff, half a head) must be a multiple of it."""
    return 16 // torch.empty((), dtype=dtype).element_size()


def _lib() -> ctypes.CDLL:
    lib = build.load(NAME)
    if lib.add_rms_norm.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.add_rms_norm.argtypes = [P, P, P, P, I, I, ctypes.c_float, I, P]
        lib.rope_kv_write.argtypes = [P] * 10 + [I] * 6 + [P]
        lib.silu_mul.argtypes = [P, P, P, ctypes.c_longlong, I, P]
        for fn in (lib.add_rms_norm, lib.rope_kv_write, lib.silu_mul):
            fn.restype = ctypes.c_int
    return lib


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def launch_add_rms_norm(x: torch.Tensor, delta, w: torch.Tensor,
                        h: torch.Tensor, eps: float) -> None:
    """x, h [..., D] contiguous (x updated in place); delta x's shape or
    None; w [D]; one type."""
    D = x.shape[-1]
    lib = _lib()
    rc = lib.add_rms_norm(x.data_ptr(),
                          None if delta is None else delta.data_ptr(),
                          w.data_ptr(), h.data_ptr(), x.numel() // D, D,
                          float(eps), DTYPES[x.dtype], _stream(x))
    build.check(lib, NAME, rc)


def launch_rope_kv_write(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         q_pos: torch.Tensor, freqs: torch.Tensor,
                         k_pages: torch.Tensor, v_pages: torch.Tensor,
                         w_page: torch.Tensor, w_off: torch.Tensor,
                         q_out: torch.Tensor) -> None:
    """q, q_out [B,Hq,hd]; k, v [B,Hkv,hd]; q_pos [B] int32; freqs [hd/2]
    fp32; k/v_pages [P,Hkv,psz,hd] (written in place); w_page, w_off [B]
    int64; all contiguous."""
    B, Hq, hd = q.shape
    Hkv, psz = k_pages.shape[1], k_pages.shape[2]
    lib = _lib()
    rc = lib.rope_kv_write(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                           q_pos.data_ptr(), freqs.data_ptr(),
                           k_pages.data_ptr(), v_pages.data_ptr(),
                           w_page.data_ptr(), w_off.data_ptr(),
                           q_out.data_ptr(), B, Hq, Hkv, hd, psz,
                           DTYPES[q.dtype], _stream(q))
    build.check(lib, NAME, rc)


def launch_silu_mul(g: torch.Tensor, u: torch.Tensor,
                    out: torch.Tensor) -> None:
    """g, u, out of one shape and type, contiguous."""
    lib = _lib()
    rc = lib.silu_mul(g.data_ptr(), u.data_ptr(), out.data_ptr(), g.numel(),
                      DTYPES[g.dtype], _stream(g))
    build.check(lib, NAME, rc)
