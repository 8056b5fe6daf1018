"""Flat-npz checkpoints of the port's trees, in the key scheme of
``repro.training.checkpoint``, so a file written by either package
restores in the other.

A key is the leaf's path joined by "|": a dict key as itself, a
tuple/list index as its number, and a NamedTuple field with a leading
dot, as ``jax.tree_util`` prints a ``GetAttrKey``. The SSM and MoE
parameter groups are NamedTuples in the JAX pytree (``SSMParams``,
``MoEParams``) and dicts here, so their fields take the dot as well:
``blocks|moe|.wg``, ``blocks|ssm|.in_proj``. bf16 leaves are saved as
fp32 (numpy has no bf16 of its own); ``restore`` casts every leaf back to
the reference's type.

A state sharded over a mesh (``training.trainer.make_train_step(mesh=
...)``) is saved as the whole state: ``save(..., cfg=, mesh=)`` gathers
the ranks' shards leaf by leaf and rank 0 writes the file one process
would write; ``restore(..., cfg=, mesh=)`` cuts each whole leaf to the
rank's shard on whatever mesh it runs, as ``jax.device_put`` of JAX's
``restore`` puts a file onto any mesh.
"""
from __future__ import annotations

import math
import os
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

_SEP = "|"
# parameter groups that the JAX pytree holds as NamedTuples
NAMEDTUPLE_GROUPS = ("ssm", "moe")


def _items(tree: Any, key=(), path=(), fields: bool = False):
    """(key in the JAX scheme, path of plain names, leaf) of each leaf;
    ``fields`` marks a dict that stands for a NamedTuple."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = [(f".{k}", k, v, False) for k, v in zip(tree._fields, tree)]
    elif isinstance(tree, dict):
        items = [(f".{k}" if fields else str(k), str(k), v,
                  k in NAMEDTUPLE_GROUPS) for k, v in tree.items()]
    elif isinstance(tree, (tuple, list)):
        items = [(str(i), str(i), v, False) for i, v in enumerate(tree)]
    else:
        yield _SEP.join(key), path, tree
        return
    for k, name, v, f in items:
        yield from _items(v, key + (k,), path + (name,), f)


def _flatten(tree: Any) -> Dict[str, Any]:
    """{key: leaf} in the JAX key scheme."""
    return {k: v for k, _, v in _items(tree)}


def _unflatten(like: Any, read, key=(), path=(), fields: bool = False) -> Any:
    """The tree of ``like`` with ``read(key, path, leaf of like)`` in place
    of each leaf."""
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*[_unflatten(v, read, key + (f".{k}",),
                                       path + (k,))
                            for k, v in zip(like._fields, like)])
    if isinstance(like, dict):
        return {k: _unflatten(v, read, key + (f".{k}" if fields else str(k),),
                              path + (str(k),), k in NAMEDTUPLE_GROUPS)
                for k, v in like.items()}
    if isinstance(like, (tuple, list)):
        return type(like)(_unflatten(v, read, key + (str(i),),
                                     path + (str(i),))
                          for i, v in enumerate(like))
    return read(_SEP.join(key), path, like)


def _numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _param_path(path: tuple, cuts) -> Optional[str]:
    """The dotted parameter path ("blocks.wq") that a leaf's path ends
    in (after the container's indices: a (params, AdamWState) tree's
    "0", "1.mu", "1.nu"), or None for a leaf that is not a parameter's
    (the step)."""
    for i in range(len(path)):
        name = ".".join(path[i:])
        if name in cuts:
            return name
    return None


def _write(path: str, flat: Dict[str, np.ndarray]) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **flat)


def save(path: str, tree: Any, *, cfg=None, mesh=None) -> None:
    """Write every tensor leaf of ``tree`` to ``path`` (``np.savez``: a
    path without the .npz suffix gets it).

    With ``mesh`` (and the arch's ``cfg``), ``tree`` is this rank's state
    in the training layout (``make_train_step(mesh=...)``'s params, or
    (params, AdamWState)), and every rank of the mesh must call it: each
    leaf's shards are gathered to rank 0 in turn (host copies, over the
    mesh's gloo group of every rank) and put together
    (``launch.sharding.train_gatherer``), so rank 0 holds the file's
    arrays and one leaf's shards at most, and writes the file one process
    holding the whole state would write; a leaf that is no parameter's
    (the step) is rank 0's. Every rank returns once the file is written,
    and raises if rank 0 could not write it."""
    if mesh is None:
        _write(path, {k: _numpy(v) for k, v in _flatten(tree).items()})
        return
    from repro_torch.launch import sharding as SH
    group = mesh.world_cpu_group
    n = math.prod(mesh.shape.values())
    cuts = SH.train_layout(cfg, mesh).cuts
    whole = SH.train_gatherer(cfg, mesh.shape)
    flat: Dict[str, np.ndarray] = {}
    for key, names, leaf in _items(tree):
        at = _param_path(names, cuts)
        if at is None:
            if mesh.rank == 0:
                flat[key] = _numpy(leaf)
            continue
        mine = leaf.detach().cpu()
        if mine.dtype == torch.bfloat16:
            mine = mine.float()
        mine = mine.contiguous()
        shards = ([torch.empty_like(mine) for _ in range(n)]
                  if mesh.rank == 0 else None)
        dist.gather(mine, shards, dst=0, group=group)
        if mesh.rank == 0:
            flat[key] = _numpy(whole(at, shards))
    ok = torch.ones(1)
    if mesh.rank == 0:
        try:
            _write(path, flat)
        except BaseException:
            ok.zero_()
            dist.all_reduce(ok, op=dist.ReduceOp.MIN, group=group)
            raise
    dist.all_reduce(ok, op=dist.ReduceOp.MIN, group=group)
    if not ok[0]:
        raise RuntimeError(f"rank 0 could not write the checkpoint {path}")


def restore(path: str, like: Any, *, cfg=None, mesh=None) -> Any:
    """The tree of ``like`` read from ``path``: every leaf shape-checked
    (a mismatch raises ValueError) and cast to the type and device of
    ``like``'s leaf.

    With ``mesh`` (and the arch's ``cfg``), ``like`` is this rank's state
    in the training layout: each rank reads each whole leaf and keeps its
    shard of it on the mesh it is on (``launch.sharding.train_cutter``),
    so a file from any mesh, from one process or from JAX's ``save``
    restores onto any mesh."""
    cut = cuts = None
    if mesh is not None:
        from repro_torch.launch import sharding as SH
        cut = SH.train_cutter(cfg, mesh)
        cuts = SH.train_layout(cfg, mesh).cuts

    def read(key: str, names: tuple, ref: torch.Tensor) -> torch.Tensor:
        t = torch.from_numpy(np.array(data[key]))
        at = None if cut is None else _param_path(names, cuts)
        if at is not None:
            t = cut(at, t)
        if tuple(t.shape) != tuple(ref.shape):
            raise ValueError(f"ckpt mismatch at {key}: {tuple(t.shape)} vs "
                             f"{tuple(ref.shape)}")
        return t.to(ref.device, ref.dtype)

    with np.load(path) as data:
        return _unflatten(like, read)
