"""AdamW and the cosine and WSD learning-rate schedules over the port's
parameter dicts: the port of ``repro.training.optimizer``.

The update is the JAX module's formula, op for op and in its order, in
fp32: m = b1 m + (1-b1) g; v = b2 v + (1-b2) g g; bc = 1 - b^step;
u = (m/bc1) / (sqrt(v/bc2) + eps) + wd p; p <- p - lr u, cast back to
p's type. ``torch.optim.AdamW`` orders the arithmetic differently (bias
corrections folded into the step size, decay applied first), so it is not
used. The step, the learning rate and the bias corrections are 0-d
tensors on the parameters' device: an update never syncs with the host.
Unlike the functional JAX update, ``update`` writes the parameters and
the moments in place.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, NamedTuple, Tuple, Union

import torch

Tree = Dict[str, Any]
Schedule = Callable[[torch.Tensor], torch.Tensor]


class AdamWState(NamedTuple):
    step: torch.Tensor      # int32, 0-d
    mu: Tree                # fp32, the parameters' structure
    nu: Tree


def leaves(tree: Tree):
    """The tensors of a nested dict, in key order at every level."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from leaves(v)
        else:
            yield v


def _zeros_like(tree: Tree) -> Tree:
    return {k: _zeros_like(v) if isinstance(v, dict)
            else torch.zeros_like(v, dtype=torch.float32)
            for k, v in tree.items()}


def adamw(lr: Union[Schedule, float], b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.1):
    """Returns (init(params) -> AdamWState, update(grads, state, params) ->
    (params, state)), as the JAX ``adamw``. ``lr`` is a schedule of the
    step (an int32 0-d tensor, 1 at the first update) or a constant."""

    def lr_fn(step: torch.Tensor) -> torch.Tensor:
        if callable(lr):
            return lr(step)
        return torch.tensor(lr, dtype=torch.float32, device=step.device)

    def init(params: Tree) -> AdamWState:
        dev = next(leaves(params)).device
        return AdamWState(torch.zeros((), dtype=torch.int32, device=dev),
                          _zeros_like(params), _zeros_like(params))

    @torch.no_grad()
    def update(grads: Tree, state: AdamWState,
               params: Tree) -> Tuple[Tree, AdamWState]:
        step = state.step + 1
        lr_t = lr_fn(step)
        s = step.float()
        bc1 = 1.0 - torch.pow(torch.tensor(b1, device=s.device), s)
        bc2 = 1.0 - torch.pow(torch.tensor(b2, device=s.device), s)
        for g, m, v, p in zip(leaves(grads), leaves(state.mu),
                              leaves(state.nu), leaves(params)):
            g = g.float()
            m.copy_(b1 * m + (1 - b1) * g)
            v.copy_(b2 * v + (1 - b2) * g * g)
            u = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            u = u + weight_decay * p.float()
            p.copy_((p.float() - lr_t * u).to(p.dtype))
        return params, AdamWState(step, state.mu, state.nu)

    return init, update


def wsd_schedule(peak_lr: float, warmup: int, stable: int,
                 decay: int) -> Schedule:
    """Warmup-Stable-Decay (MiniCPM) schedule."""
    def lr(step: torch.Tensor) -> torch.Tensor:
        s = step.float()
        warm = peak_lr * s / max(warmup, 1)
        dec = peak_lr * torch.clamp(
            1.0 - (s - warmup - stable) / max(decay, 1), min=0.0)
        return torch.where(s < warmup, warm,
                           torch.where(s < warmup + stable,
                                       torch.full_like(s, peak_lr), dec))
    return lr


def cosine_schedule(peak_lr: float, warmup: int, total: int,
                    floor: float = 0.1) -> Schedule:
    """Linear warmup to ``peak_lr``, then a cosine down to
    ``floor * peak_lr`` at ``total``."""
    def lr(step: torch.Tensor) -> torch.Tensor:
        s = step.float()
        warm = peak_lr * s / max(warmup, 1)
        t = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = peak_lr * (floor + (1 - floor) * 0.5
                         * (1 + torch.cos(math.pi * t)))
        return torch.where(s < warmup, warm, cos)
    return lr
