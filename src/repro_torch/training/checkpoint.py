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
"""
from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np
import torch

_SEP = "|"
# parameter groups that the JAX pytree holds as NamedTuples
NAMEDTUPLE_GROUPS = ("ssm", "moe")


def _flatten(tree: Any, prefix=(), fields: bool = False) -> Dict[str, Any]:
    """{key: leaf} in the JAX key scheme; ``fields`` marks a dict that
    stands for a NamedTuple."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = [(f".{k}", v, False) for k, v in zip(tree._fields, tree)]
    elif isinstance(tree, dict):
        items = [(f".{k}" if fields else str(k), v,
                  k in NAMEDTUPLE_GROUPS) for k, v in tree.items()]
    elif isinstance(tree, (tuple, list)):
        items = [(str(i), v, False) for i, v in enumerate(tree)]
    else:
        return {_SEP.join(prefix): tree}
    flat: Dict[str, Any] = {}
    for k, v, f in items:
        flat.update(_flatten(v, prefix + (k,), f))
    return flat


def _unflatten(like: Any, data, prefix=(), fields: bool = False) -> Any:
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*[_unflatten(v, data, prefix + (f".{k}",))
                            for k, v in zip(like._fields, like)])
    if isinstance(like, dict):
        return {k: _unflatten(v, data, prefix + (f".{k}" if fields
                                                 else str(k),),
                              k in NAMEDTUPLE_GROUPS)
                for k, v in like.items()}
    if isinstance(like, (tuple, list)):
        return type(like)(_unflatten(v, data, prefix + (str(i),))
                          for i, v in enumerate(like))
    key = _SEP.join(prefix)
    arr = data[key]
    if tuple(arr.shape) != tuple(like.shape):
        raise ValueError(f"ckpt mismatch at {key}: {arr.shape} vs "
                         f"{tuple(like.shape)}")
    return torch.from_numpy(np.array(arr)).to(like.device, like.dtype)


def _numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def save(path: str, tree: Any) -> None:
    """Write every tensor leaf of ``tree`` to ``path`` (``np.savez``: a
    path without the .npz suffix gets it)."""
    flat = {k: _numpy(v) for k, v in _flatten(tree).items()}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **flat)


def restore(path: str, like: Any) -> Any:
    """The tree of ``like`` read from ``path``: every leaf shape-checked
    (a mismatch raises ValueError) and cast to the type and device of
    ``like``'s leaf."""
    with np.load(path) as data:
        return _unflatten(like, data)
