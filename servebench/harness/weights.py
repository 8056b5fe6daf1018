"""Random weights from the run's seed, made on the device in one draw.

Which leaves a model has, their shapes, scales and order, is its
layout's to say (the ``layouts/<name>.py`` that serves its
``block_kind``): the tree the port's engines take
(``PagedTorchExecutor(params=...)``). One ``torch.randn`` over a flat
buffer in the served type makes every leaf; each leaf is a view of it,
scaled in place. The same seed gives the same weights on every call, so
the reference remakes them after the program is gone instead of taking
the program's.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from servebench.harness import registry

NORM_SCALE = 0.1


def padded_vocab(vocab: int) -> int:
    """The port's padding of an odd vocabulary to a multiple of 2048
    (``ArchConfig.padded_vocab``); the pad rows are never read."""
    return vocab if vocab % 16 == 0 else -(-vocab // 2048) * 2048


def leaves(m: Dict) -> List[Tuple[str, Tuple[int, ...], float]]:
    """(path, shape, scale) of every weight of the model dims ``m``, in
    draw order: its layout's (``registry.layout_of``)."""
    return registry.layout_of(m).leaves(m)


def n_params(m: Dict) -> int:
    return sum(int(torch.Size(s).numel()) for _, s, _ in leaves(m))


def make(m: Dict, seed: int, device, dtype=torch.bfloat16) -> Dict:
    """The weights of seed ``seed``: a nested dict of views of one flat
    buffer drawn by a generator on ``device``."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    specs = leaves(m)
    flat = torch.randn(sum(int(torch.Size(s).numel()) for _, s, _ in specs),
                       generator=gen, device=device, dtype=dtype)
    params: Dict = {}
    at = 0
    for path, shape, scale in specs:
        n = int(torch.Size(shape).numel())
        leaf = flat[at:at + n].view(shape)
        leaf.mul_(scale)
        at += n
        node = params
        *heads, last = path.split(".")
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = leaf
    return params
