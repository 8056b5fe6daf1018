"""Serving mesh of the port over ``torch.distributed`` (the counterpart of
``repro.launch.mesh``).

The JAX engine shards one program over the devices of a ``jax.sharding.
Mesh``. The port runs SPMD instead: one process per rank, each the same
control plane in lockstep on its own copy of the host state, computing on
its slab of the weights and of the KV arena, meeting the other ranks only
at the collectives of ``models.partitioning``. ``make_serving_mesh``
describes this rank's place in a ('data', 'model') mesh, or a ('pod',
'data', 'model') one, over an initialised process group;
``spawn_ranks`` starts such a group on one host.

``make_production_mesh`` (the 256- and 512-device meshes of the dry-run)
and ``make_stand_in_mesh`` describe rank 0 of a mesh that is counted, not
run (``launch.dryrun``), over a "fake" process group.

A FUNCTION, not a module-level constant: importing this module touches no
process group.
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
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

AXES = ("data", "model")
POD_AXES = ("pod", "data", "model")


class ServingMesh:
    """This rank's view of a ('data', 'model') mesh, or of a ('pod',
    'data', 'model') one (JAX's multi-pod shape).

    ``shape`` maps each axis to its size and ``axis_names`` is the axes
    in order, 'model' last, all that the sharding rules read. ``coords``
    is this rank's place on each axis (ranks row-major, 'model' last:
    rank = (pod * data + d) * model + m). ``model_group`` is the process
    group of the ranks that share this rank's place on every other axis
    (the model's collectives); ``data_group`` that of the ranks that
    share its model index, over ('pod', 'data') folded, pod-major (the
    gathers of a batch split over the data groups, JAX's ``batch_axes``);
    ``fsdp_group`` that of those over 'data' alone (FSDP's shards of a
    training step: the weights and moments are replicated over 'pod', as
    ``param_specs(train=True)`` puts them), the data group itself without
    a 'pod' axis; with one, ``pod_group`` that of those over 'pod' alone.
    ``data_cpu_group``, ``fsdp_cpu_group`` and ``pod_cpu_group`` are gloo
    twins of them for host tensors (the groups themselves under gloo).
    ``world_cpu_group`` is a gloo group of every rank: every rank runs
    the same control plane, so ``agree``, ``check_same`` and ``gather``
    span the whole mesh, one loop clock and one digest across the data
    groups and pods. ``device`` is the rank's device and ``backend`` the
    model group's."""

    def __init__(self, shape: Dict[str, int], rank: int,
                 groups: Dict[str, Any], device: torch.device, backend: str):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)
        self.coords = mesh_coords(self.shape, rank)
        self.rank = rank
        self.model_group = groups["model"]
        self.data_group, self.data_cpu_group = groups["data"]
        self.fsdp_group, self.fsdp_cpu_group = groups["fsdp"]
        if "pod" in shape:
            self.pod_group, self.pod_cpu_group = groups["pod"]
        self.world_cpu_group = groups["world_cpu"]
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
        out: List[Any] = [None] * math.prod(self.shape.values())
        dist.all_gather_object(out, obj, group=self.world_cpu_group)
        return out


def mesh_coords(shape: Dict[str, int], rank: int) -> Dict[str, int]:
    """A rank's place on each axis of a mesh of ``shape`` (ordered axes,
    'model' last; ranks row-major, the last axis fastest)."""
    return dict(zip(shape, map(int, np.unravel_index(rank, tuple(
        shape.values())))))


def make_serving_mesh(*, model: int, data: int = 1, pod: int = 1,
                      device: Optional[torch.device] = None) -> ServingMesh:
    """Tensor-parallel mesh ('data', 'model'), or with ``pod`` > 1 ('pod',
    'data', 'model'), over the initialised default process group, whose
    world must hold pod * data * model ranks. Every rank must call it, in
    the same order as any other group it makes. ``device``: the rank's
    device; by default its own card under NCCL (rank modulo the cards),
    else the CPU. The serving engines take ('data', 'model') meshes only,
    as JAX's; a 'pod' axis serves a training step."""
    if not dist.is_initialized():
        raise RuntimeError("make_serving_mesh needs an initialised process "
                           "group (torch.distributed.init_process_group, or "
                           "spawn_ranks)")
    shape = ({"pod": pod} if pod > 1 else {})
    shape.update(data=data, model=model)
    n = math.prod(shape.values())
    world = dist.get_world_size()
    if world != n:
        raise ValueError(f"mesh {tuple(shape.values())} needs {n} ranks, "
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

    grid = np.arange(n).reshape(pod, data, model)
    made = {
        "model": groups([list(map(int, grid[p, d])) for p in range(pod)
                         for d in range(data)], twin=False)[0],
        "data": groups([list(map(int, grid[:, :, m].reshape(-1)))
                        for m in range(model)], twin=True)}
    if pod > 1:
        made["fsdp"] = groups([list(map(int, grid[p, :, m]))
                               for p in range(pod) for m in range(model)],
                              twin=True)
        made["pod"] = groups([list(map(int, grid[:, d, m]))
                              for d in range(data) for m in range(model)],
                             twin=True)
    else:
        made["fsdp"] = made["data"]
    made["world_cpu"] = (dist.group.WORLD if backend == "gloo"
                         else dist.new_group(list(range(n)), backend="gloo"))
    if device is None:
        device = (torch.device("cuda", rank % torch.cuda.device_count())
                  if backend == "nccl" else torch.device("cpu"))
    return ServingMesh(shape, rank, made, device, backend)


class StandInMesh:
    """Rank 0 of a mesh that is counted, not run: ``shape`` (axis -> size),
    ``axis_names`` and ``coords`` as a ``ServingMesh`` has them, so the
    sharding rules and ``models.partitioning`` read it as they read a
    serving mesh. ``model_group`` (the ranks of rank 0's 'model' row) and
    ``data_group`` (the ranks of its model index over ('pod', 'data'),
    which ``models.partitioning`` folds into one data axis, pod-major)
    are groups of a process group of the "fake" backend
    (``torch.testing._internal.distributed.fake_pg``, which ships with
    PyTorch): its collectives return at once and move nothing, which is
    what a dry-run on meta tensors needs. ``fsdp_group`` (rank 0's ranks
    over 'data' alone, FSDP's shards) and, with a 'pod' axis,
    ``pod_group`` (over 'pod' alone) serve a training step. The mesh inits that group when
    it is made and destroys it at ``close()`` (or the end of a ``with``
    block)."""

    def __init__(self, shape: Dict[str, int]):
        from torch.testing._internal.distributed.fake_pg import FakeStore
        if dist.is_initialized():
            raise RuntimeError("a stand-in mesh needs a process with no "
                               "process group of its own (it inits a fake "
                               "one)")
        self.shape = dict(shape)
        self.axis_names = tuple(shape)
        self.coords = {a: 0 for a in shape}
        n = math.prod(shape.values())
        model = shape["model"]
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=n)
        self.model_group = dist.new_group(list(range(model)))
        self.data_group = dist.new_group(list(range(0, n, model)))
        self.fsdp_group = self.data_group
        if "pod" in shape:
            pod_size = n // shape["pod"]
            self.fsdp_group = dist.new_group(list(range(0, pod_size, model)))
            self.pod_group = dist.new_group(list(range(0, n, pod_size)))

    def close(self) -> None:
        if dist.is_initialized():
            dist.destroy_process_group()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def make_stand_in_mesh(shape: Dict[str, int]) -> StandInMesh:
    """A ``StandInMesh`` of ``shape`` (ordered axes, e.g. {"data": 1,
    "model": 1}; 'model' last)."""
    if list(shape)[-1] != "model":
        raise ValueError(f"mesh axes {list(shape)}: 'model' must come last")
    return StandInMesh(shape)


def make_production_mesh(*, multi_pod: bool = False) -> StandInMesh:
    """Single pod: (data=16, model=16), 256 devices. Multi-pod: (pod=2,
    data=16, model=16), 512 devices. The shapes of
    ``repro.launch.mesh.make_production_mesh``, as a stand-in for rank 0
    (``StandInMesh``); the batch splits over ('pod', 'data') together."""
    if multi_pod:
        return make_stand_in_mesh({"pod": 2, "data": 16, "model": 16})
    return make_stand_in_mesh({"data": 16, "model": 16})


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
