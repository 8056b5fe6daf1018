"""Time the SSD decode-step kernel on the card, cold, beside its launch
floor.

For each shape (B rows, H heads of P, state N) and arena layout (``paged``:
2B slots, row b at slot 2b, as the paged engine's state arena; ``slot``:
B + 1 slots, row b at slot b and a spare row, as a layer of the slot
engine's cache), every row active and bf16 inputs as strided splits of
one projection: the kernel's device time (CUDA events over calls queued
behind a spin kernel, ``launch.timing.time_ms``), each call stepping the
next of as many arena copies as make twice the 50 MB L2, as every layer
steps its own arena in serving; an empty kernel on the same grid timed
the same way (the launch floor); one device copy of the live state's
bytes, cold the same way (a yardstick); the plain version's time; the byte
bound (the live rows' fp32 state read and written, the inputs read once,
y written, over 3.35 TB/s) and the kernel's share of it. Each shape is
first checked against the plain version (y at bf16's 1.6e-2, the arena
at 1e-4 of its magnitude, as chip_smoke.py's) and run twice, bit for bit.
``--slab-bytes`` times the same shapes under other slab sizes of the
plan (``kernels.ssd_decode.SLAB_BYTES``). Run as a file with an older
checkout's ``src`` on PYTHONPATH, it times that checkout's kernel.

  PYTHONPATH=src python -m repro_torch.launch.time_ssd_decode \\
      --shape 8,48,64,128,paged --shape 16,48,64,128,slot \\
      --shape 16,50,64,16,slot --slab-bytes 4096,8192,16384
"""
from __future__ import annotations

import argparse
import subprocess
from typing import Optional, Sequence

import torch

from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssd_decode as sd
from repro_torch.launch.timing import time_ms

TOL_BF16 = 1.6e-2
HBM_BYTES_PER_S = 3.35e12                       # H100 SXM data sheet
L2_BYTES = 50 * 2 ** 20
DEFAULT_SHAPES = ("8,48,64,128,paged", "16,48,64,128,slot",
                  "16,50,64,16,slot")


def _inputs(B, H, P, N, seed):
    """x, dt, b, c as splits of one bf16 [B,H*P+2N+H] projection, x
    scaled by 0.5 and b, c by N^-0.5 (outputs below ~4); the [H]
    parameters at the JAX init's values."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    W = H * P + 2 * N + H
    proj = torch.randn(B, W, generator=g, device="cuda")
    proj[:, :H * P] *= 0.5
    proj[:, H * P:H * P + 2 * N] *= N ** -0.5
    proj[:, H * P + 2 * N:] *= 0.5
    proj = proj.to(torch.bfloat16)
    x = proj[:, :H * P].reshape(B, H, P)
    b = proj[:, H * P:H * P + N]
    c = proj[:, H * P + N:H * P + 2 * N]
    dt = proj[:, H * P + 2 * N:]
    a_log = torch.log(torch.linspace(1.0, 16.0, H, device="cuda"))
    d_skip = torch.ones(H, device="cuda")
    bias = 0.1 * torch.randn(H, generator=g, device="cuda")
    prm = [t.to(torch.bfloat16) for t in (a_log, d_skip, bias)]
    return (x, dt, prm[0], b, c, prm[1], prm[2])


def time_shape(B, H, P, N, layout, seed=0):
    """Check, then time one shape cold; returns the printed line."""
    a = _inputs(B, H, P, N, seed)
    if layout == "paged":
        n_arena = 2 * B
        slots = torch.arange(0, 2 * B, 2, dtype=torch.int32, device="cuda")
    else:
        n_arena = B + 1
        slots = torch.arange(B, dtype=torch.int32, device="cuda")
    act = torch.ones(B, dtype=torch.bool, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    base = 0.5 * torch.randn(n_arena, H, P, N, generator=g, device="cuda")
    st_k, st_2, st_p = base.clone(), base.clone(), base.clone()
    y = ops.ssd_decode_step(*a, st_k, slots, act)
    y2 = ops.ssd_decode_step(*a, st_2, slots, act)
    yw = ref.ssd_decode_step_ref(*[t.float() for t in a], st_p, slots, act)
    err = (y.float() - yw).abs().max().item()
    serr = (st_k - st_p).abs().max().item() / max(1.0,
                                                  st_p.abs().max().item())
    case = f"B={B} H={H} P={P} N={N} {layout}"
    if not (err <= TOL_BF16 and serr <= 1e-4):
        raise SystemExit(f"{case} disagrees (y {err:.3e}, arena {serr:.3e})")
    if not (torch.equal(y, y2) and torch.equal(st_k, st_2)):
        raise SystemExit(f"{case}: two calls on the same inputs differ")
    n = max(2, -(-2 * L2_BYTES // (B * H * P * N * 4)))
    arenas = [base.clone() for _ in range(n)]
    calls = [0]

    def step():
        arena = arenas[calls[0] % n]
        calls[0] += 1
        return ops.ssd_decode_step(*a, arena, slots, act)

    ms = time_ms(step)
    # the package of an older checkout (its src on PYTHONPATH, this file
    # run as a script) has no slab plan and no empty kernel
    planned = hasattr(sd, "launch_empty")
    floor_ms = (time_ms(lambda: sd.launch_empty(B, H, P, N, slots.device))
                if planned else float("nan"))
    label = sd.body(P, N) if planned else "no slab plan"
    plain_ms = time_ms(lambda: ref.ssd_decode_step_ref(*a, base, slots, act))
    # a yardstick of what moving the live state costs: one device copy of
    # its bytes, read once and written once, cold as the step
    live = B * H * P * N
    bufs = [torch.empty(2 * live, device="cuda") for _ in range(n)]

    def copy():
        buf = bufs[calls[0] % n]
        calls[0] += 1
        buf[live:].copy_(buf[:live])

    copy_ms = time_ms(copy)
    nbytes = (2 * B * H * P * N * 4
              + (2 * B * H * P + B * H + 2 * B * N + 3 * H) * 2 + 5 * B)
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    return (f"{case} ({label}), {n} arenas in turn: {ms:.4f} ms, "
            f"empty kernel on its grid {floor_ms:.4f} ms, copy of the live "
            f"state {copy_ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, bound {bound:.5f} ms (bytes), "
            f"{100 * bound / ms:.0f}% of it; y err {err:.2e}, arena err "
            f"{serr:.2e}")


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shape", action="append", default=None,
                    help="B,H,P,N,paged|slot (repeatable; default the "
                    "serving runs' three)")
    ap.add_argument("--slab-bytes", default="",
                    help="comma-separated slab sizes of the plan to time "
                    "(default: the plan's own)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    shapes = []
    for s in args.shape or DEFAULT_SHAPES:
        *dims, layout = s.split(",")
        if layout not in ("paged", "slot"):
            raise SystemExit(f"layout {layout!r}: paged or slot")
        shapes.append((*(int(d) for d in dims), layout))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(f"{card}; bf16, every row active; ms per call", flush=True)
    slabs = [int(x) for x in args.slab_bytes.split(",") if x]
    for slab in slabs or [None]:
        if slab is not None:
            sd.SLAB_BYTES = slab
        print(f"slab target {getattr(sd, 'SLAB_BYTES', None)} B", flush=True)
        for i, (B, H, P, N, layout) in enumerate(shapes):
            print("  " + time_shape(B, H, P, N, layout, seed=7 + i),
                  flush=True)


if __name__ == "__main__":
    main()
