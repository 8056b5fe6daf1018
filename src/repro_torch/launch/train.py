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

  # FSDP over 'data' x tensor parallelism over 'model': 4 ranks, each
  # holding its shards of the params and AdamW moments and its rows of
  # each batch (gloo on the CPU or on ranks sharing one card, NCCL with a
  # card a rank; under torchrun, RANK and WORLD_SIZE set, no spawning)
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
      --batch 8 --mesh-shape 2,2

  # JAX's multi-pod shape ('pod', 'data', 'model'): FSDP over 'data'
  # inside a pod, the weights and moments replicated over 'pod', each
  # batch over ('pod', 'data') and the gradients summed over both
  PYTHONPATH=src python -m repro_torch.launch.train --reduced --device cpu \\
      --steps 3 --mesh-shape 2,1,2

Each step takes a fresh batch of random tokens (random [B,S,D] frames for
embedding-input archs, labels random tokens) from a seeded
``torch.Generator`` on the device. Prints the JAX launcher's
``step i loss=...`` lines, then the median ms a step (the steps after the
first, each ended by a device sync), tokens/s and the peak device memory.
With ``--mesh-shape`` every rank draws the same weights and batches and
keeps its shards and rows (``training.trainer``); the first line names
the mesh's axes and its backend, rank 0 prints the step lines, the
median of the agreed ms a step (each step's slowest rank's), and a last
line whether every rank's losses are equal and each rank's peak memory.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import math
import os
import statistics
import sys
import time
from typing import List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.launch.mesh import (backend_for, make_serving_mesh,
                                     rank_device, spawn_ranks)
from repro_torch.models import model as M
from repro_torch.training.trainer import local_batch, make_train_step

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# seconds the ranks of --mesh-shape may run before they are ended and the
# command fails (a hung collective never returns)
MESH_TIMEOUT_S = 1800.0


@dataclasses.dataclass
class TrainRun:
    losses: List[float]
    step_ms: List[float]         # host clock around each step, synced
    median_ms: float             # over the steps after the first
    tokens_per_s: float
    peak_bytes: Optional[int]    # torch.cuda.max_memory_allocated; None on the CPU


@dataclasses.dataclass
class MeshTrainRun:
    shape: Tuple[int, ...]       # (data, model) or (pod, data, model)
    backend: str
    ranks: List[dict]            # each rank's summary, in rank order


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
    ap.add_argument("--mesh-shape", default=None,
                    help="'data,model' or 'pod,data,model': FSDP over "
                         "data x tensor parallelism over model (the weights "
                         "replicated over pod), one process a rank (the "
                         "batch must divide over pod x data)")
    return ap.parse_args(argv)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _config(args: argparse.Namespace):
    cfg = get_config(args.arch)
    return cfg.reduced() if args.reduced else cfg


def run(args: argparse.Namespace) -> Union[TrainRun, MeshTrainRun]:
    if args.mesh_shape:
        return run_mesh(args, _mesh_shape(args))
    return _train(args, _config(args), M.resolve_device(args.device))


def _train(args: argparse.Namespace, cfg, dev: torch.device,
           mesh=None) -> TrainRun:
    """The training loop, on one device or as one rank of ``mesh``."""
    print(f"{cfg.name}: ~{cfg.n_params() / 1e6:.1f}M params "
          f"({args.dtype}, {dev})", flush=True)
    init_state, train_step = make_train_step(cfg, M.ModelOptions(remat=True),
                                             peak_lr=args.lr, warmup=10,
                                             total=args.steps, device=dev,
                                             mesh=mesh)
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
        batch = {"inputs": inputs, "labels": toks}
        if mesh is not None:
            batch = local_batch(batch, mesh)
        state, m = train_step(state, batch)
        _sync(dev)
        ms = (time.perf_counter() - ts) * 1000.0
        step_ms.append(ms if mesh is None else mesh.agree(ms))
        losses.append(float(m["loss"]))
        if i % 10 == 0 or i == args.steps - 1:
            print(f"step {i:4d} loss={losses[-1]:.4f} "
                  f"({time.perf_counter() - t0:.1f}s)", flush=True)
    median = statistics.median(step_ms[1:] or step_ms)
    tps = args.batch * args.seq / (median / 1000.0)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
    mem = "n/a (cpu)" if peak is None else f"{peak / 2**30:.2f} GiB"
    agreed = "" if mesh is None else " (each step the slowest rank's)"
    print(f"median {median:.2f} ms/step{agreed} over "
          f"{len(step_ms[1:] or step_ms)} steps, {tps:.0f} tokens/s, peak "
          f"memory {mem}", flush=True)
    return TrainRun(losses=losses, step_ms=step_ms, median_ms=median,
                    tokens_per_s=tps, peak_bytes=peak)


def _mesh_shape(args: argparse.Namespace) -> Tuple[int, ...]:
    try:
        shape = tuple(int(v) for v in args.mesh_shape.split(","))
    except ValueError:
        shape = ()
    if len(shape) not in (2, 3):
        raise SystemExit(f"--mesh-shape {args.mesh_shape!r}: expected "
                         "'data,model' or 'pod,data,model', e.g. 2,2 or "
                         "2,1,2")
    if min(shape) < 1:
        raise SystemExit("--mesh-shape: every axis must be >= 1")
    groups = math.prod(shape[:-1])
    if args.batch % groups:
        raise SystemExit(f"--batch {args.batch} does not split over "
                         f"{groups} data groups")
    if dist.is_initialized():
        raise SystemExit("--mesh-shape starts its own process group")
    return shape


def _axes(mesh_shape: Tuple[int, ...]) -> str:
    """'data=D model=M', or 'pod=P data=D model=M'."""
    names = ("pod", "data", "model")[-len(mesh_shape):]
    return " ".join(f"{a}={n}" for a, n in zip(names, mesh_shape))


def _make_mesh(mesh_shape: Tuple[int, ...], device: torch.device):
    *pod, data, model = mesh_shape
    return make_serving_mesh(pod=pod[0] if pod else 1, data=data,
                             model=model, device=device)


def run_mesh(args: argparse.Namespace,
             mesh_shape: Tuple[int, ...]) -> MeshTrainRun:
    """Train on a (data, model) or (pod, data, model) mesh, one process a
    rank: the ranks are spawned here and rendezvous through a FileStore
    in a temporary directory, or, under torchrun (RANK and WORLD_SIZE
    set), this process is its rank. Returns the ranks' summaries (under
    torchrun, this rank's)."""
    ways = math.prod(mesh_shape)
    backend = backend_for(args.device, ways)
    torchrun = "RANK" in os.environ and "WORLD_SIZE" in os.environ
    if not torchrun or os.environ["RANK"] == "0":
        where = ("each on its own card" if backend == "nccl"
                 else f"sharing {rank_device(args.device, backend, 0)}")
        print(f"mesh {_axes(mesh_shape)}: {ways} ranks over {backend}, "
              f"{where}", flush=True)
    if torchrun:
        rank = int(os.environ["RANK"])
        dist.init_process_group(backend)
        try:
            return MeshTrainRun(mesh_shape, backend, [
                _train_rank(rank, args, mesh_shape, backend)])
        finally:
            dist.destroy_process_group()
    return MeshTrainRun(mesh_shape, backend, spawn_ranks(
        _train_rank, ways, (args, mesh_shape, backend), backend=backend,
        timeout=MESH_TIMEOUT_S))


def _train_rank(rank: int, args: argparse.Namespace,
                mesh_shape: Tuple[int, ...], backend: str) -> dict:
    """One rank of ``run_mesh``: train on this rank's shards and rows
    (only rank 0 prints), then gather the ranks' losses and peak memory;
    rank 0 prints them. Returns the rank's summary."""
    ways = math.prod(mesh_shape)
    device = rank_device(args.device, backend, rank)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    else:       # ranks on one host's CPU: threads of their own, not shared
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // ways))
    mesh = _make_mesh(mesh_shape, device)
    quiet = (contextlib.nullcontext() if rank == 0
             else contextlib.redirect_stdout(io.StringIO()))
    with quiet:
        tr = _train(args, _config(args), device, mesh)
    losses = mesh.gather(tr.losses)
    peaks = mesh.gather(tr.peak_bytes)
    if rank == 0:
        same = all(v == losses[0] for v in losses)
        mem = ("n/a (cpu)" if peaks[0] is None else
               "[" + ", ".join(f"{p / 2**30:.2f}" for p in peaks) + "] GiB")
        print(f"mesh {_axes(mesh_shape)} backend={backend}: losses "
              f"{'equal on every rank' if same else 'DIFFER'}, peak memory "
              f"a rank {mem}", flush=True)
    return {"rank": rank, "device": str(device), "losses": tr.losses,
            "step_ms": tr.step_ms, "median_ms": tr.median_ms,
            "peak_bytes": tr.peak_bytes,
            "jax_modules": sorted(m for m in sys.modules if m == "jax"
                                  or m.startswith(("jax.", "repro.")))}


def main(argv: Optional[Sequence[str]] = None) -> None:
    run(parse_args(argv))


if __name__ == "__main__":
    main()
