"""Time the flash-prefill kernel on the card across prompt lengths.

For each prompt length, the whole-prompt kernel (causal, B=1) beside one
PyTorch scaled_dot_product_attention call on the same inputs (K/V
repeated to Hq); then one 64-row chunk over a 1024-slot strided buffer at
growing offsets. Device time from CUDA events over calls queued behind a
spin kernel (``launch.timing.time_ms``), bf16. Each call is first checked
against the plain version (bf16 tolerance 1.6e-2, as chip_smoke.py's).

  PYTHONPATH=src python -m repro_torch.launch.time_flash_prefill \\
      --heads 32,2,128 --heads 24,8,64
"""
from __future__ import annotations

import argparse
import subprocess
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from repro_torch.kernels import flash_prefill as fp
from repro_torch.kernels import ref
from repro_torch.launch.timing import time_ms

TOL_BF16 = 1.6e-2


def _randn(*shape: int, seed: int) -> torch.Tensor:
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(*shape, generator=g, device="cuda").to(torch.bfloat16)


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--heads", action="append", default=None,
                    help="Hq,Hkv,hd (repeatable; default edge-6b's and "
                         "granite-moe's)")
    ap.add_argument("--lengths", default="64,128,256,512,1024,2048")
    ap.add_argument("--offsets", default="0,64,192,448,960",
                    help="chunk q_start values (64-row chunks, S=1024)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    heads = [tuple(int(x) for x in h.split(","))
             for h in (args.heads or ["32,2,128", "24,8,64"])]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(f"{card}; ms per call, bf16; columns: kernel, sdpa")

    def checked(fn, out, want, what):
        out.fill_(float("nan"))            # a call that writes nothing fails
        fn()
        err = (out.float() - want).abs().max().item()
        if err > TOL_BF16:
            raise SystemExit(f"{what} disagrees with its plain version "
                             f"({err:.3e})")
        return time_ms(fn)

    for Hq, Hkv, hd in heads:
        for S in (int(x) for x in args.lengths.split(",")):
            q, k, v = (_randn(1, S, H, hd, seed=S + i)
                       for i, H in enumerate((Hq, Hkv, Hkv)))
            out = torch.empty_like(q)
            want = ref.flash_prefill_ref(q.float(), k.float(), v.float(),
                                         causal=True)
            ms = checked(lambda: fp.launch(q, k, v, out, True, None), out,
                         want, f"S={S}")
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            kr, vr = (x.repeat_interleave(Hq // Hkv, dim=1) for x in (kt, vt))
            sdpa = time_ms(lambda: F.scaled_dot_product_attention(
                qt, kr, vr, is_causal=True))
            print(f"prefill Hq={Hq} Hkv={Hkv} hd={hd} S={S}: {ms:.4f} "
                  f"{sdpa:.4f}")
        for q0 in (int(x) for x in args.offsets.split(",")):
            # K/V as the slot cache lays them out, read through strides
            q = _randn(1, 64, Hq, hd, seed=q0)
            k, v = (_randn(1, Hkv, 1024, hd, seed=q0 + i).transpose(1, 2)
                    for i in (1, 2))
            qs = torch.tensor([q0], dtype=torch.int32, device="cuda")
            out = torch.empty_like(q)
            want = ref.flash_prefill_chunk_ref(q.float(), k.float(),
                                               v.float(), qs)
            ms = checked(lambda: fp.launch_chunk(q, k, v, qs, out, None),
                         out, want, f"q_start={q0}")
            keep = (torch.arange(1024, device="cuda")[None, :]
                    <= q0 + torch.arange(64, device="cuda")[:, None])
            g = Hq // Hkv
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            kr, vr = (x.repeat_interleave(g, dim=1) for x in (kt, vt))
            sdpa = time_ms(lambda: F.scaled_dot_product_attention(
                qt, kr, vr, attn_mask=keep))
            print(f"chunk Hq={Hq} Hkv={Hkv} hd={hd} C=64 q_start={q0} "
                  f"S=1024: {ms:.4f} {sdpa:.4f}")


if __name__ == "__main__":
    main()
