"""The training step: loss, gradients by autograd and an AdamW update,
the port of ``repro.training.trainer``.

The forward is ``models.model.forward``: the JAX training path's math in
plain torch (no kernel, as the JAX training path reaches no Pallas
kernel), with each layer recomputed in the backward by default
(``ModelOptions(remat=True)``, as in JAX).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import model as M
from repro_torch.training.optimizer import (AdamWState, adamw,
                                            cosine_schedule, leaves)

Params = Dict[str, Any]
State = Tuple[Params, AdamWState]


def _rebuild(like: Params, flat) -> Params:
    return {k: _rebuild(like[k], flat) if isinstance(like[k], dict)
            else next(flat) for k in sorted(like)}


def loss_and_grads(cfg: ArchConfig, params: Params,
                   batch: Dict[str, torch.Tensor],
                   opts: M.ModelOptions) -> Tuple[torch.Tensor, Params]:
    """(loss, gradients in the parameters' structure) of ``loss_fn`` on
    ``batch`` ({"inputs", "labels"}), as ``jax.value_and_grad``: a
    parameter the loss does not read (``embed`` of an embedding-input arch
    with an untied head) gets zeros, as JAX gives it."""
    ps = list(leaves(params))
    with torch.enable_grad():
        loss = M.loss_fn(cfg, params, batch["inputs"], batch["labels"], opts)
        gs = torch.autograd.grad(loss, ps, allow_unused=True)
    gs = [torch.zeros_like(p) if g is None else g for g, p in zip(gs, ps)]
    return loss.detach(), _rebuild(params, iter(gs))


def make_train_step(cfg: ArchConfig, opts: Optional[M.ModelOptions] = None,
                    peak_lr: float = 3e-4, warmup: int = 100,
                    total: int = 10_000, device="cuda"):
    """Returns (init_state(seed_or_params, dtype) -> (params, opt_state),
    train_step(state, batch) -> (state, {"loss", "grad_norm"})), as the
    JAX factory. ``batch`` = {"inputs": ids [B,S] (or [B,S,D]
    embeddings), "labels": [B,S], negative = ignored}, on ``device``.
    ``init_state`` draws the weights from a seed (``init_params``) or copies
    a parameter dict (from ``load_params``, ``checkpoint.restore``). The
    update is in place: the state returned is the state given, updated;
    grad_norm = sqrt(sum of <g, g>) over every gradient."""
    opts = opts or M.ModelOptions(remat=True)
    dev = M.resolve_device(device)
    opt_init, opt_update = adamw(cosine_schedule(peak_lr, warmup, total))

    def init_state(seed_or_params: Union[int, Params] = 0,
                   dtype=torch.float32) -> State:
        if isinstance(seed_or_params, dict):
            params = _rebuild(seed_or_params,
                              (p.detach().to(dev, dtype, copy=True)
                               for p in leaves(seed_or_params)))
        else:
            params = M.init_params(cfg, seed_or_params, dtype, dev)
        for p in leaves(params):
            p.requires_grad_(True)
        return params, opt_init(params)

    def train_step(state: State, batch: Dict[str, torch.Tensor]
                   ) -> Tuple[State, Dict[str, torch.Tensor]]:
        params, opt_state = state
        loss, grads = loss_and_grads(cfg, params, batch, opts)
        gnorm = torch.sqrt(sum(torch.dot(g.reshape(-1), g.reshape(-1))
                               for g in leaves(grads)))
        params, opt_state = opt_update(grads, opt_state, params)
        return (params, opt_state), {"loss": loss, "grad_norm": gnorm}

    return init_state, train_step
