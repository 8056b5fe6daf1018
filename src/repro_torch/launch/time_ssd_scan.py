"""Time the SSD-scan kernel on the card across prompt lengths, each of its
three passes apart.

For each width (H heads of P, state N; mamba2-780m's 48, 64, 128 by
default) and prompt length T, one sequence with x, dt, b and c as strided
splits of one projection, as the mixer passes them: the kernel's device
time (CUDA events over calls queued behind a spin kernel,
``launch.timing.time_ms``), the device time of its chunk-state,
state-passing and chunk-output passes (torch.profiler), the plain
version's time and the byte bound (x, dt, b, c and the [H] parameters
read, y and the fp32 final state written, over 3.35 TB/s). Each
configuration is first checked against the plain version (y at bf16's
1.6e-2, the state at 1e-4 of its magnitude, as chip_smoke.py's).

  PYTHONPATH=src python -m repro_torch.launch.time_ssd_scan \\
      --widths 48,64,128 --widths 50,64,16 --lengths 64,256,1024
"""
from __future__ import annotations

import argparse
import subprocess
from typing import Optional, Sequence

import torch

from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.launch.timing import SSD_PASSES, passes_us, time_ms

TOL_BF16 = 1.6e-2
HBM_BYTES_PER_S = 3.35e12                       # H100 SXM data sheet


def _inputs(T, H, P, N, seed):
    """x, dt, b, c as splits of one bf16 [1,T,H*P+2N+H] projection, x
    scaled by 0.5 and b, c by N^-0.5 (outputs below ~4); the [H]
    parameters at the JAX init's values."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    W = H * P + 2 * N + H
    proj = torch.randn(1, T, W, generator=g, device="cuda")
    proj[..., :H * P] *= 0.5
    proj[..., H * P:H * P + 2 * N] *= N ** -0.5
    proj[..., H * P + 2 * N:] *= 0.5
    proj = proj.to(torch.bfloat16)
    x = proj[..., :H * P].reshape(1, T, H, P)
    b = proj[..., H * P:H * P + N]
    c = proj[..., H * P + N:H * P + 2 * N]
    dt = proj[..., H * P + 2 * N:]
    a_log = torch.log(torch.linspace(1.0, 16.0, H, device="cuda"))
    d_skip = torch.ones(H, device="cuda")
    bias = 0.1 * torch.randn(H, generator=g, device="cuda")
    prm = [t.to(torch.bfloat16) for t in (a_log, d_skip, bias)]
    return (x, dt, prm[0], b, c, prm[1], prm[2])


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--widths", action="append", default=None,
                    help="H,P,N (repeatable; default mamba2-780m's)")
    ap.add_argument("--lengths", default="64,256,1024")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    widths = [tuple(int(x) for x in w.split(","))
              for w in (args.widths or ["48,64,128"])]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(f"{card}; bf16, B=1; ms per call (each pass in us)")
    for H, P, N in widths:
        for T in (int(x) for x in args.lengths.split(",")):
            a = _inputs(T, H, P, N, seed=T + N)
            y, h = ops.ssd_scan(*a)
            yw, hw = ref.ssd_scan_ref(*[t.float() for t in a])
            err = (y.float() - yw).abs().max().item()
            herr = ((h - hw).abs().max().item()
                    / max(1.0, hw.abs().max().item()))
            case = f"H={H} P={P} N={N} T={T}"
            if not (err <= TOL_BF16 and herr <= 1e-4):
                raise SystemExit(f"{case} disagrees (y {err:.3e}, state "
                                 f"{herr:.3e})")
            ms = time_ms(lambda: ops.ssd_scan(*a))
            us = passes_us(lambda: ops.ssd_scan(*a), SSD_PASSES)
            plain_ms = time_ms(lambda: ref.ssd_scan_ref(*a))
            nbytes = ((2 * T * H * P + T * H + 2 * T * N + 3 * H) * 2
                      + H * P * N * 4)
            print(f"{case} ({ssd.body(torch.bfloat16, P, N)} body, "
                  f"{ssd.chunks(T)} chunks): {ms:.4f} ms ("
                  + ", ".join(f"{k} {v:.1f} us" for k, v in us.items())
                  + f"), plain {plain_ms:.4f} ms, bound "
                  f"{nbytes / HBM_BYTES_PER_S * 1e3:.5f} ms (bytes); y err "
                  f"{err:.2e}, state err {herr:.2e}", flush=True)


if __name__ == "__main__":
    main()
