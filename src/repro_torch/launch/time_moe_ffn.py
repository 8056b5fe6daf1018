"""Time the grouped-expert FFN kernel on the card at granite-moe's decode
and prefill shapes.

For each case, a dispatched buffer filled as a top-k routing fills it
(decode: the batch's tokens in one group of C = batch * top_k rows per
expert; prefill: one prompt's tokens, C = max(T*K/E*1.25, K) per expert,
assignments past C dropped) with the routing's live-row counts: the
kernel's device time (CUDA events over calls queued behind a spin kernel,
``launch.timing.time_ms``), its gate/up and down passes apart
(torch.profiler), the bound (the weights of experts with rows and the
live rows in and out, over 3.35 TB/s), and the bmm/silu/bmm/bmm chain over
the same buffer as a yardstick. Each case is first checked against the
plain version into a NaN-filled output (bf16 tolerance 1.6e-2, as
chip_smoke.py's).

  PYTHONPATH=src python -m repro_torch.launch.time_moe_ffn
"""
from __future__ import annotations

import argparse
import subprocess
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_config
from repro_torch.kernels import ops, ref
from repro_torch.launch.timing import time_ms

TOL_BF16 = 1.6e-2
HBM_BYTES_PER_S = 3.35e12                       # H100 SXM data sheet


def _case(tokens, C, E, D, Fd, K, seed):
    """A [E,C,D] bf16 buffer routed from ``tokens`` random top-K picks
    (kept while an expert has room), its counts, and granite-scaled
    weights."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    picks = torch.rand(tokens, E, generator=g, device="cuda").topk(K).indices
    counts = torch.bincount(picks.flatten(), minlength=E).clamp(max=C)
    bf = torch.bfloat16
    live = torch.arange(C, device="cuda")[None, :] < counts[:, None]
    buf = torch.randn(E, C, D, generator=g, device="cuda") * live[..., None]
    ws = [torch.randn(*s, generator=g, device="cuda") * sc for s, sc in
          (((E, D, Fd), D ** -0.5), ((E, D, Fd), D ** -0.5),
           ((E, Fd, D), Fd ** -0.5))]
    return [buf.to(bf)] + [w.to(bf) for w in ws], counts.to(torch.int32)


def _passes_us(fn, n=20):
    """Device microseconds a call of the gate/up and of the down pass."""
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    us = {"gate_up": 0.0, "down": 0.0}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", None)
        t = float(t if t is not None else getattr(e, "self_cuda_time_total", 0))
        for k in us:
            if f"::{k}(" in e.key:
                us[k] += t / n
    return us


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="granite-moe-3b-a800m")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt", type=int, default=256)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    cfg = get_config(args.arch)
    E, D, Fd, K = cfg.n_experts, cfg.d_model, cfg.d_ff, cfg.top_k
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(f"{card}; {args.arch} E={E} D={D} F={Fd} top-{K}, bf16")
    T = args.prompt
    for what, tokens, C in (
            ("decode", args.batch, args.batch * K),
            ("prefill", T, max(int(T * K / E * 1.25 + 0.999), K))):
        (buf, wg, wu, wd), counts = _case(tokens, C, E, D, Fd, K, seed=C)
        want = ref.moe_grouped_ffn_ref(buf.float(), wg.float(), wu.float(),
                                       wd.float(), counts)
        torch.full(buf.shape, float("nan"), dtype=buf.dtype, device="cuda")
        got = ops.moe_grouped_ffn(buf, wg, wu, wd, counts)
        err = (got.float() - want).abs().max().item()
        if not err <= TOL_BF16:
            raise SystemExit(f"{what} disagrees with its plain version "
                             f"({err:.3e})")
        used, rows = int((counts > 0).sum()), int(counts.sum())
        nbytes = 3 * used * D * Fd * 2 + 2 * rows * D * 2 + E * 4
        ms = time_ms(lambda: ops.moe_grouped_ffn(buf, wg, wu, wd, counts))
        us = _passes_us(lambda: ops.moe_grouped_ffn(buf, wg, wu, wd, counts))
        chain = time_ms(lambda: torch.bmm(
            F.silu(torch.bmm(buf, wg)) * torch.bmm(buf, wu), wd))
        print(f"{what} C={C}, {rows} live rows on {used} experts: kernel "
              f"{ms:.4f} ms (gate/up {us['gate_up']:.1f} us, down "
              f"{us['down']:.1f} us), bound "
              f"{nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms, bmm chain "
              f"{chain:.4f} ms, max_abs_err {err:.2e}", flush=True)


if __name__ == "__main__":
    main()
