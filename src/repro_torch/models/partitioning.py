"""Tensor-parallel collectives of the model (the counterpart of
``repro.models.partitioning``).

In JAX, ``shard(x, dims)`` is a layout hint and GSPMD places the
collectives. In the port every rank runs its own program on its slab of
the weights (``launch.sharding.local_params``), so the hints become the
collectives themselves, Megatron-style:

- ``reduce_model(x)`` sums a partial product over the 'model' axis (after
  wo's and wd's row-parallel products, an MoE slab's share of the
  combine, and the vocabulary-sharded embedding lookup);
- ``gather_model(x, dim)`` puts the ranks' slabs of ``dim`` side by side
  (the vocabulary-sharded logits);
- ``embed_model(table, ids)`` looks ids up in a vocabulary slab.

The model asks ``cut(name)`` whether a leaf ("wo", "wd", "embed",
"lm_head", the MoE group's "moe.wg", ...) is cut over 'model' on this
engine, and calls these only where it is; ``model_index()`` is the rank's
place on 'model' (which experts an expert-parallel slab holds).

The batch over 'data' (JAX's ``batch_spec``): a decode or verify step of
B rows is cut into ``data`` row blocks when B divides, and
``batch_rows(B)`` is then this rank's block (None: every data group
computes every row, as JAX's ``bshard = None``); ``gather_data(*xs)``
puts the blocks side by side on every rank, on ``mesh.data_group``.

Without a context installed (``with activation_partitioning(mesh, cut):
...``, around a tensor-parallel engine's steps) nothing is cut and no
batch is split, so every model function is exactly the single-device
function. With one, the model's collectives run on ``mesh.model_group``
even over a single rank: a one-rank mesh cuts every leaf into one slab
and takes the collective path too.

A gather is an all-reduce of a zero-filled full-width buffer in which
each rank has written its slab: exact (x + 0 = x), and the one collective
gloo also runs on CUDA tensors.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist

_CTX = None     # the installed activation_partitioning


class activation_partitioning:
    """Context manager: ``with activation_partitioning(mesh, cut): ...``
    installs ``mesh`` (a ``launch.mesh.ServingMesh``) for the collectives
    below and ``cut``, the names of the leaves cut over 'model'
    (``launch.sharding.cut_leaves``)."""

    def __init__(self, mesh, cut=()):
        self.mesh = mesh
        self.cut = frozenset(cut)
        self._prev = None

    def __enter__(self):
        global _CTX
        self._prev, _CTX = _CTX, self
        return self

    def __exit__(self, *exc):
        global _CTX
        _CTX = self._prev
        return False


def cut(name: str) -> bool:
    """Whether the leaf ``name`` is cut over 'model' (never without a
    context)."""
    return _CTX is not None and name in _CTX.cut


def model_index() -> int:
    """This rank's place on the 'model' axis (0 without a context)."""
    return 0 if _CTX is None else _CTX.mesh.coords["model"]


def batch_rows(batch: int):
    """This rank's rows of a batch of ``batch`` rows split over 'data' (a
    slice), or None where the batch is not split: without a context, with
    one data group, or when the groups do not divide it."""
    if _CTX is None:
        return None
    ways = _CTX.mesh.shape["data"]
    if ways == 1 or batch % ways:
        return None
    n = batch // ways
    d = _CTX.mesh.coords["data"]
    return slice(d * n, (d + 1) * n)


def reduce_model(x: torch.Tensor) -> torch.Tensor:
    """Sum of x over the 'model' axis (in place); x itself without a
    context."""
    if _CTX is None:
        return x
    dist.all_reduce(x, group=_CTX.mesh.model_group)
    return x


def _gather(x: torch.Tensor, dim: int, axis: str, group) -> torch.Tensor:
    """The slabs of ``dim`` over ``axis`` side by side, in axis order."""
    mesh = _CTX.mesh
    n = x.shape[dim]
    shape = list(x.shape)
    shape[dim] = n * mesh.shape[axis]
    full = x.new_zeros(shape)
    full.narrow(dim, mesh.coords[axis] * n, n).copy_(x)
    dist.all_reduce(full, group=group)
    return full


def gather_model(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The ranks' slabs of ``dim`` side by side, in rank order; x itself
    without a context."""
    if _CTX is None:
        return x
    return _gather(x, dim, "model", _CTX.mesh.model_group)


def gather_data(*xs: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Each of ``xs`` (one type; rows on dim 0, this data group's
    ``batch_rows``) with every data group's rows, in data order, all in
    one collective; ``xs`` themselves without a context."""
    if _CTX is None:
        return xs
    n = xs[0].shape[0]
    full = _gather(torch.cat([x.reshape(n, -1) for x in xs], 1), 0, "data",
                   _CTX.mesh.data_group)
    out, at = [], 0
    for x in xs:
        w = x[0].numel()
        out.append(full[:, at:at + w].reshape(-1, *x.shape[1:]))
        at += w
    return tuple(out)


def embed_model(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Rows ``ids`` of an embedding whose vocabulary is cut over 'model':
    this rank's slab ``table`` holds ids [r*n, (r+1)*n); ids outside it
    look up zeros, and the sum over the axis puts every row together
    exactly. Without a context, a plain lookup."""
    if _CTX is None:
        return table[ids.long()]
    n = table.shape[0]
    local = ids.long() - _CTX.mesh.coords["model"] * n
    hit = (local >= 0) & (local < n)
    x = table[local.clamp(0, n - 1)].masked_fill(~hit[..., None], 0)
    return reduce_model(x)
