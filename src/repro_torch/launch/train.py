"""Training launcher of the PyTorch port (CLI over ``training.trainer``),
the counterpart of ``repro.launch.train``.

Trains the FULL-width config by default (``--reduced`` opts in to the
small one; the JAX launcher's ``--reduced`` cannot be switched off), on
the CUDA card by default (``--device cpu`` runs on the CPU):

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
      --steps 20

  # tiny CPU run
  PYTHONPATH=src python -m repro_torch.launch.train --reduced --device cpu \\
      --steps 3

Each step takes a fresh batch of random tokens (random [B,S,D] frames for
embedding-input archs, labels random tokens) from a seeded
``torch.Generator`` on the device. Prints the JAX launcher's
``step i loss=...`` lines, then the median ms a step (the steps after the
first, each ended by a device sync), tokens/s and the peak device memory.
"""
from __future__ import annotations

import argparse
import dataclasses
import statistics
import time
from typing import List, Optional, Sequence

import torch

from repro_torch.configs import get_config
from repro_torch.models import model as M
from repro_torch.training.trainer import make_train_step

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass
class TrainRun:
    losses: List[float]
    step_ms: List[float]         # host clock around each step, synced
    median_ms: float             # over the steps after the first
    tokens_per_s: float
    peak_bytes: Optional[int]    # torch.cuda.max_memory_allocated; None on the CPU


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dtype", default="float32", choices=sorted(DTYPES))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true",
                    help="train the reduced (CPU-feasible) config instead "
                         "of the full-width one")
    return ap.parse_args(argv)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(args: argparse.Namespace) -> TrainRun:
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    dev = M.resolve_device(args.device)
    print(f"{cfg.name}: ~{cfg.n_params() / 1e6:.1f}M params "
          f"({args.dtype}, {dev})", flush=True)
    init_state, train_step = make_train_step(cfg, M.ModelOptions(remat=True),
                                             peak_lr=args.lr, warmup=10,
                                             total=args.steps, device=dev)
    state = init_state(args.seed, DTYPES[args.dtype])
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed + 1)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    shape = (args.batch, args.seq)
    losses, step_ms = [], []
    t0 = time.perf_counter()
    for i in range(args.steps):
        ts = time.perf_counter()
        toks = torch.randint(0, cfg.vocab_size, shape, generator=gen,
                             device=dev)
        if cfg.embedding_inputs:
            inputs = (torch.randn(shape + (cfg.d_model,), generator=gen,
                                  device=dev) * 0.02).to(DTYPES[args.dtype])
        else:
            inputs = toks
        state, m = train_step(state, {"inputs": inputs, "labels": toks})
        _sync(dev)
        step_ms.append((time.perf_counter() - ts) * 1000.0)
        losses.append(float(m["loss"]))
        if i % 10 == 0 or i == args.steps - 1:
            print(f"step {i:4d} loss={losses[-1]:.4f} "
                  f"({time.perf_counter() - t0:.1f}s)", flush=True)
    median = statistics.median(step_ms[1:] or step_ms)
    tps = args.batch * args.seq / (median / 1000.0)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
    mem = "n/a (cpu)" if peak is None else f"{peak / 2**30:.2f} GiB"
    print(f"median {median:.2f} ms/step over {len(step_ms[1:] or step_ms)} "
          f"steps, {tps:.0f} tokens/s, peak memory {mem}", flush=True)
    return TrainRun(losses=losses, step_ms=step_ms, median_ms=median,
                    tokens_per_s=tps, peak_bytes=peak)


def main(argv: Optional[Sequence[str]] = None) -> None:
    run(parse_args(argv))


if __name__ == "__main__":
    main()
