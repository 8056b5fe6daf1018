"""Time the paged decode and verify kernels on the card across context
lengths and split sizes.

For each head shape, window C (1: decode, >1: verify) and context length,
a batch of B rows whose windows end at that length, over a maxp-page
table: the kernel's device time (CUDA events over calls queued behind a
spin kernel, ``launch.timing.time_ms``), the split and combine passes'
device time apart (torch.profiler), and the plan (rows a tile, pages a
split, splits), once for each value of ``kernels.paged_attention.
BLOCKS_PER_SM`` given (the constant the plan sizes splits by); then the
plain version's time. Each configuration is first checked against the
plain version into a NaN-filled output (bf16 tolerance 1.6e-2, as
chip_smoke.py's).

  PYTHONPATH=src python -m repro_torch.launch.time_paged_attention \\
      --heads 32,2,128 --heads 24,8,64 --windows 1,5
"""
from __future__ import annotations

import argparse
import subprocess
from typing import Optional, Sequence

import torch

from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import ref
from repro_torch.launch.timing import ATTENTION_PASSES, passes_us, time_ms

TOL_BF16 = 1.6e-2


def _inputs(B, C, L, Hq, Hkv, hd, psz, maxp, seed):
    """Rows whose windows of C queries end at position L-1 (less a few
    per row, so lengths differ), pages drawn from a shuffled arena."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    n_pages = B * maxp + 1
    bf = torch.bfloat16
    q = torch.randn(B, C, Hq, hd, generator=g, device="cuda").to(bf)
    kp = torch.randn(n_pages, Hkv, psz, hd, generator=g, device="cuda").to(bf)
    vp = torch.randn(n_pages, Hkv, psz, hd, generator=g, device="cuda").to(bf)
    perm = torch.randperm(n_pages, generator=g, device="cuda").tolist()
    qs = [max(0, L - C - 3 * b) for b in range(B)]
    pt = torch.full((B, maxp), -1, dtype=torch.int32)
    for b, s0 in enumerate(qs):
        n = (s0 + C - 1) // psz + 1
        pt[b, :n] = torch.tensor([perm.pop() for _ in range(n)])
    return (q, kp, vp, pt.cuda(),
            torch.tensor(qs, dtype=torch.int32, device="cuda"))


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--heads", action="append", default=None,
                    help="Hq,Hkv,hd (repeatable; default edge-6b's and "
                         "granite-moe's)")
    ap.add_argument("--windows", default="1,5")
    ap.add_argument("--lengths", default="128,256,512,1024")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--maxp", type=int, default=64)
    ap.add_argument("--blocks-per-sm", default=str(pa.BLOCKS_PER_SM))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    heads = [tuple(int(x) for x in h.split(","))
             for h in (args.heads or ["32,2,128", "24,8,64"])]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(f"{card}; bf16, B={args.batch}, page {args.page_size}, maxp "
          f"{args.maxp}; ms per call (split + combine us apart)")
    default = pa.BLOCKS_PER_SM
    B, psz, maxp = args.batch, args.page_size, args.maxp
    for Hq, Hkv, hd in heads:
        for C in (int(x) for x in args.windows.split(",")):
            for L in (int(x) for x in args.lengths.split(",")):
                L = min(L, maxp * psz)
                q, kp, vp, pt, qs = _inputs(B, C, L, Hq, Hkv, hd, psz, maxp,
                                            seed=L + C)
                if C == 1:
                    q = q[:, 0].contiguous()
                    launch, plain = pa.launch, ref.paged_decode_attention_ref
                else:
                    launch, plain = (pa.launch_verify,
                                     ref.paged_verify_attention_ref)
                out = torch.empty_like(q)
                want = plain(q.float(), kp.float(), vp.float(), pt, qs)
                case = f"Hq={Hq} Hkv={Hkv} hd={hd} C={C} L={L}"
                for bps in (int(x) for x in args.blocks_per_sm.split(",")):
                    pa.BLOCKS_PER_SM = bps
                    try:
                        out.fill_(float("nan"))
                        launch(q, kp, vp, pt, qs, out)
                        err = (out.float() - want).abs().max().item()
                        if not err <= TOL_BF16:
                            raise SystemExit(f"{case} blocks/SM {bps} "
                                             f"disagrees ({err:.3e})")
                        ms = time_ms(lambda: launch(q, kp, vp, pt, qs, out))
                        us = passes_us(lambda: launch(q, kp, vp, pt, qs,
                                                      out), ATTENTION_PASSES)
                        rows, pps, ns = pa.plan(B, C * Hq // Hkv, Hkv, hd,
                                                psz, maxp, torch.bfloat16,
                                                pa.sm_count(q.device))
                    finally:
                        pa.BLOCKS_PER_SM = default
                    print(f"{case} {pa.body(q.dtype, hd)} body, blocks/SM "
                          f"{bps} ({rows} rows a tile, "
                          f"{ns} splits of {pps} pages): {ms:.4f} ms "
                          f"(split {us['split']:.1f} us, combine "
                          f"{us['combine']:.1f} us)", flush=True)
                plain_ms = time_ms(lambda: plain(q, kp, vp, pt, qs))
                print(f"{case} plain: {plain_ms:.4f} ms", flush=True)


if __name__ == "__main__":
    main()
