"""Serving mesh of the port over ``torch.distributed`` (the counterpart of
``repro.launch.mesh``).

The JAX engine shards one program over the devices of a ``jax.sharding.
Mesh``. The port runs SPMD instead: one process per rank, each the same
control plane in lockstep on its own copy of the host state, computing on
its slab of the weights and of the KV arena, meeting the other ranks only
at the collectives of ``models.partitioning``. ``make_serving_mesh``
describes this rank's place in a ('data', 'model') mesh over an
initialised process group; ``spawn_ranks`` starts such a group on one host.

A FUNCTION, not a module-level constant: importing this module touches no
process group. ``make_production_mesh`` (the 256- and 512-chip meshes of
the dry-run) is still to port (ROADMAP.md).
"""
from __future__ import annotations

import hashlib
import math
import multiprocessing as mp
import os
import queue
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

AXES = ("data", "model")


class ServingMesh:
    """This rank's view of a (data, model) serving mesh.

    ``shape`` maps each axis to its size and ``axis_names`` is ('data',
    'model'), all that the sharding rules read. ``coords`` is this rank's
    place on each axis (rank = data * model_size + model). ``model_group``
    is the process group of the ranks that share this rank's data index
    (the model's collectives), ``data_group`` that of the ranks that share
    its model index (the gathers of a batch split over 'data'), and
    ``data_cpu_group`` a gloo twin of it for host tensors (the group
    itself under gloo). ``world_cpu_group`` is a gloo group of every rank:
    every rank runs the same control plane, so ``agree``, ``check_same``
    and ``gather`` span the whole mesh, one loop clock and one digest
    across the data groups. ``device`` is the rank's device and
    ``backend`` the model group's."""

    axis_names = AXES

    def __init__(self, data: int, model: int, rank: int, model_group,
                 data_group, data_cpu_group, world_cpu_group,
                 device: torch.device, backend: str):
        self.shape = {"data": data, "model": model}
        self.coords = {"data": rank // model, "model": rank % model}
        self.rank = rank
        self.model_group = model_group
        self.data_group = data_group
        self.data_cpu_group = data_cpu_group
        self.world_cpu_group = world_cpu_group
        self.device = torch.device(device)
        self.backend = backend

    def agree(self, ms: float) -> float:
        """The largest of the ranks' ``ms``, on every rank: the honest time
        of a step of a tensor-parallel engine is its slowest rank's, and
        the serving loop's clock must be one clock on every rank."""
        t = torch.tensor([float(ms)], dtype=torch.float64)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.world_cpu_group)
        return float(t[0])

    def check_same(self, digest: int, what: str) -> None:
        """Raise on every rank unless every rank passed the same
        ``digest`` (an int below 2**62)."""
        t = torch.tensor([digest, -digest], dtype=torch.int64)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.world_cpu_group)
        if int(t[0]) != -int(t[1]):
            raise RuntimeError(
                f"ranks diverged at {what}: host inputs differ between the "
                f"ranks of the mesh (rank {self.rank} digest "
                f"{digest:#x}); the control planes must run in lockstep")

    def gather(self, obj) -> List[Any]:
        """Every rank's ``obj`` (picklable), in rank order, on every rank."""
        out: List[Any] = [None] * (self.shape["data"] * self.shape["model"])
        dist.all_gather_object(out, obj, group=self.world_cpu_group)
        return out


def make_serving_mesh(*, model: int, data: int = 1,
                      device: Optional[torch.device] = None) -> ServingMesh:
    """Tensor-parallel serving mesh (data, model) over the initialised
    default process group, whose world must hold data * model ranks. Every
    rank must call it, in the same order as any other group it makes.
    ``device``: the rank's device; by default its own card under NCCL
    (rank modulo the cards), else the CPU."""
    if not dist.is_initialized():
        raise RuntimeError("make_serving_mesh needs an initialised process "
                           "group (torch.distributed.init_process_group, or "
                           "spawn_ranks)")
    n = data * model
    world = dist.get_world_size()
    if world != n:
        raise ValueError(f"serving mesh ({data}, {model}) needs {n} ranks, "
                         f"the process group has {world}")
    rank = dist.get_rank()
    backend = dist.get_backend()

    def groups(blocks, twin):
        """(group, its gloo twin or None) of the block holding this rank;
        every rank makes every block's groups, in the same order. One
        block is the world itself."""
        mine = None
        for ranks in blocks:
            g = dist.new_group(ranks) if len(blocks) > 1 else dist.group.WORLD
            c = (g if backend == "gloo" else
                 dist.new_group(ranks, backend="gloo") if twin else None)
            if rank in ranks:
                mine = (g, c)
        return mine

    model_group, _ = groups([list(range(d * model, (d + 1) * model))
                             for d in range(data)], twin=False)
    data_group, data_cpu_group = groups([list(range(m, n, model))
                                         for m in range(model)], twin=True)
    world_cpu_group = (dist.group.WORLD if backend == "gloo"
                       else dist.new_group(list(range(n)), backend="gloo"))
    if device is None:
        device = (torch.device("cuda", rank % torch.cuda.device_count())
                  if backend == "nccl" else torch.device("cpu"))
    return ServingMesh(data, model, rank, model_group, data_group,
                       data_cpu_group, world_cpu_group, device, backend)


def batch_axes(mesh) -> tuple:
    """Axes over which the global batch is sharded."""
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def batch_ways(mesh) -> int:
    return math.prod(mesh.shape[a] for a in batch_axes(mesh))


def digest(*parts) -> int:
    """A 62-bit digest of strings, ints and numpy arrays (their type, shape
    and bytes), for ``ServingMesh.check_same``."""
    h = hashlib.blake2b(digest_size=8)
    for p in parts:
        if isinstance(p, np.ndarray):
            h.update(f"{p.dtype}{p.shape}".encode())
            h.update(np.ascontiguousarray(p).tobytes())
        else:
            h.update(repr(p).encode())
        h.update(b"|")
    return int.from_bytes(h.digest(), "little") >> 2


# ------------------------------------------------------------- spawning

def backend_for(device: str, ranks: int) -> str:
    """NCCL when each rank has a card of its own, gloo otherwise (the CPU,
    or ranks sharing one card)."""
    if (torch.device(device).type == "cuda" and torch.cuda.is_available()
            and torch.cuda.device_count() >= ranks):
        return "nccl"
    return "gloo"


def rank_device(device: str, backend: str, rank: int) -> torch.device:
    """A rank's device: its own card under NCCL, the one asked for
    otherwise (ranks over gloo share it; card 0 when none is named)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    if backend == "nccl":
        return torch.device("cuda", rank)
    return torch.device("cuda", 0 if dev.index is None else dev.index)


def _rank_entry(rank: int, world: int, backend: str, store_path: str,
                fn: Callable, args: tuple, results) -> None:
    """A spawned rank: join the group through the FileStore, run
    ``fn(rank, *args)``, put (rank, "ok", result) or (rank, "error",
    traceback) on ``results``, leave the group."""
    try:
        store = dist.FileStore(store_path, world)
        dist.init_process_group(backend, store=store, rank=rank,
                                world_size=world)
        try:
            out = fn(rank, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, "ok", out))
    except BaseException:                            # noqa: BLE001
        results.put((rank, "error", traceback.format_exc()))
        raise SystemExit(1)


def spawn_ranks(fn: Callable, world: int, args: Sequence = (), *,
                backend: str = "gloo", timeout: float = 600.0,
                store_dir: Optional[str] = None) -> List[Any]:
    """Run ``fn(rank, *args)`` in ``world`` fresh processes joined in one
    process group (``backend``), rendezvousing through a FileStore in
    ``store_dir`` (a temporary directory by default); ``fn`` must be
    importable from its module. Returns the ranks' results in rank order.
    A rank that raises or dies, or a group that outlives ``timeout``
    seconds (a hung collective), ends every rank and raises here."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(dir=store_dir) as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_entry, daemon=True,
                             args=(r, world, backend, store, fn, tuple(args),
                                   results))
                 for r in range(world)]
        for p in procs:
            p.start()
        out: List[Any] = [None] * world
        done: set = set()
        deadline = time.monotonic() + timeout
        try:
            while len(done) < world:
                try:
                    rank, status, value = results.get(timeout=0.5)
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if r not in done and p.exitcode is not None]
                    if dead:
                        raise RuntimeError(f"ranks {dead} of {world} died "
                                           "without a result (exit codes "
                                           f"{[procs[r].exitcode for r in dead]})")
                    if time.monotonic() > deadline:
                        raise TimeoutError(
                            f"{world} ranks still running after {timeout:.0f}"
                            f" s (ranks {sorted(set(range(world)) - done)} "
                            "have not finished): ended")
                    continue
                if status == "error":
                    raise RuntimeError(f"rank {rank} of {world} failed:\n"
                                       f"{value}")
                out[rank] = value
                done.add(rank)
            for p in procs:
                p.join(timeout=max(1.0, deadline - time.monotonic()))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join(timeout=5)
            results.close()
    return out
