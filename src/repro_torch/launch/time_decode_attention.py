"""Time the ring-cache decode-attention kernel on the card across ring
sizes, batches and split sizes.

For each ring of S slots and batch B (edge-6b's heads by default), rows
whose append-only caches hold ``--fill`` of the ring (the slot engine's
serving run holds about a quarter of its 1024 slots), their lengths a few
apart: the kernel's device time (CUDA events over calls queued behind a
spin kernel, ``launch.timing.time_ms``) and its split and combine passes'
device time apart (torch.profiler), once for each value of
``kernels.decode_attention.MIN_SPLITS`` given (the constant the plan sizes
splits by: a split holds about S / MIN_SPLITS slots, at most 128 at
edge-6b's heads); then the plain version's time and the byte bound (the
kept slots' K/V, q, out, kv_pos and q_pos, over 3.35 TB/s). Each
configuration is first checked against the plain version into a
NaN-filled output (bf16 tolerance 1.6e-2, as chip_smoke.py's).

  PYTHONPATH=src python -m repro_torch.launch.time_decode_attention \\
      --rings 256,1024,4096 --batches 1,8,16 --min-splits 2,4,8,16,32
"""
from __future__ import annotations

import argparse
import subprocess
from typing import Optional, Sequence

import torch

from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import ref
from repro_torch.launch.timing import ATTENTION_PASSES, passes_us, time_ms

TOL_BF16 = 1.6e-2
HBM_BYTES_PER_S = 3.35e12                       # H100 SXM data sheet


def _inputs(B, S, fill, Hq, Hkv, hd, seed):
    """Append-only rows holding fill*S slots less 3 per row (at least
    one), bf16 K/V in every slot."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    bf = torch.bfloat16
    q = torch.randn(B, Hq, hd, generator=g, device="cuda").to(bf)
    k = torch.randn(B, Hkv, S, hd, generator=g, device="cuda").to(bf)
    v = torch.randn(B, Hkv, S, hd, generator=g, device="cuda").to(bf)
    lengths = [max(1, int(fill * S) - 3 * b) for b in range(B)]
    kv = torch.full((B, S), -1, dtype=torch.int32)
    for b, n in enumerate(lengths):
        kv[b, :n] = torch.arange(n, dtype=torch.int32)
    q_pos = torch.tensor([n - 1 for n in lengths], dtype=torch.int32)
    return q, k, v, kv.cuda(), q_pos.cuda(), lengths


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--heads", default="32,2,128", help="Hq,Hkv,hd")
    ap.add_argument("--rings", default="256,1024,4096")
    ap.add_argument("--batches", default="1,8,16")
    ap.add_argument("--fill", default="0.25,1.0",
                    help="shares of the ring each row holds")
    ap.add_argument("--min-splits", default="2,4,8,16,32,64")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    Hq, Hkv, hd = (int(x) for x in args.heads.split(","))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    body = pa.body(torch.bfloat16, hd)
    print(f"{card}; bf16, Hq={Hq} Hkv={Hkv} hd={hd}, {body} body; ms per "
          "call (split + combine us apart)")
    default = da.MIN_SPLITS
    for S in (int(x) for x in args.rings.split(",")):
        for B in (int(x) for x in args.batches.split(",")):
            for fill in (float(x) for x in args.fill.split(",")):
                q, k, v, kv, qp, lengths = _inputs(B, S, fill, Hq, Hkv, hd,
                                                   seed=S + B)
                out = torch.empty_like(q)
                want = ref.decode_attention_ref(q.float(), k.float(),
                                                v.float(), kv, qp)
                live = sum(lengths)
                nbytes = (2 * live * Hkv * hd * 2 + 2 * B * Hq * hd * 2
                          + B * S * 4 + B * 4)
                case = (f"S={S} B={B} fill={fill} (lengths "
                        f"{min(lengths)}-{max(lengths)})")

                def call():
                    da.launch(q, k, v, kv, qp, out, None)

                for mins in (int(x) for x in args.min_splits.split(",")):
                    da.MIN_SPLITS = mins
                    try:
                        out.fill_(float("nan"))
                        call()
                        err = (out.float() - want).abs().max().item()
                        if not err <= TOL_BF16:
                            raise SystemExit(f"{case} MIN_SPLITS {mins} "
                                             f"disagrees ({err:.3e})")
                        ms = time_ms(call)
                        us = passes_us(call, ATTENTION_PASSES)
                        _, sps, ns = da.plan(Hq // Hkv, hd, S,
                                             torch.bfloat16)
                    finally:
                        da.MIN_SPLITS = default
                    print(f"{case}: MIN_SPLITS {mins}, {ns} splits of {sps} "
                          f"slots: {ms:.4f} ms (split {us['split']:.1f} "
                          f"us, combine {us['combine']:.1f} us)", flush=True)
                plain_ms = time_ms(lambda: ref.decode_attention_ref(
                    q, k, v, kv, qp))
                print(f"{case}: plain {plain_ms:.4f} ms, bound "
                      f"{nbytes / HBM_BYTES_PER_S * 1e3:.5f} ms (bytes)",
                      flush=True)


if __name__ == "__main__":
    main()
