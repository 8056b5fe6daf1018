"""The training step: loss, gradients by autograd and an AdamW update,
the port of ``repro.training.trainer``.

The forward is ``models.model.forward``: the JAX training path's math in
plain torch (no kernel, as the JAX training path reaches no Pallas
kernel), with each layer recomputed in the backward by default
(``ModelOptions(remat=True)``, as in JAX).

With a mesh (``launch.mesh.ServingMesh``, or a stand-in for the
dry-run) each rank holds its shards of the params and of the AdamW
moments in the layout of JAX's ``param_specs(train=True)`` and
``opt_state_specs`` (``launch.sharding.train_cuts``: FSDP over 'data'
where the spec cuts a dim over it, the serving layout's slabs over
'model') and its rows of the batch (``batch_spec``), and runs the step
under ``models.partitioning.activation_partitioning``: each layer's
'data' shards gathered inside its checkpoint, the tensor-parallel
regions entered and left through Megatron's conjugate collectives, the
loss the whole batch's. The backward gives each rank its shards'
gradients (FSDP's reduce-scatter); ``launch.sharding.reduce_train_grads``
completes the parts other ranks hold copies of, and AdamW updates the
rank's shards as it updates whole leaves.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.launch import sharding as SH
from repro_torch.models import model as M
from repro_torch.models import partitioning as P
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


def local_batch(batch: Dict[str, torch.Tensor],
                mesh) -> Dict[str, torch.Tensor]:
    """This rank's rows of a whole batch split over the data groups
    (('pod', 'data'), JAX's ``batch_spec``), which must divide it."""
    B = batch["labels"].shape[0]
    ways, index = P.data_axis(mesh)
    if B % ways:
        raise ValueError(f"a batch of {B} rows does not split over "
                         f"{ways} data groups")
    n = B // ways
    return {k: v[index * n:(index + 1) * n] for k, v in batch.items()}


def step_grads(cfg: ArchConfig, params: Params,
               batch: Dict[str, torch.Tensor], opts: M.ModelOptions,
               mesh=None, layout: Optional[SH.TrainLayout] = None
               ) -> Tuple[torch.Tensor, Params, torch.Tensor]:
    """(loss, gradients, grad_norm) of one training step. With ``mesh``:
    on this rank's shards and rows, the gradients of its shards,
    completed (``launch.sharding.reduce_train_grads``); the loss and the
    norm the whole batch's and gradient's, on every rank. ``layout``:
    the mesh's ``launch.sharding.train_layout``, made here if not
    given."""
    if mesh is None:
        loss, grads = loss_and_grads(cfg, params, batch, opts)
        return loss, grads, torch.sqrt(sum(
            torch.dot(g.reshape(-1), g.reshape(-1)) for g in leaves(grads)))
    layout = layout or SH.train_layout(cfg, mesh)
    with P.activation_partitioning(mesh, layout.model, fsdp=layout.fsdp,
                                   split_batch=True):
        loss, grads = loss_and_grads(cfg, params, batch, opts)
        SH.reduce_train_grads(cfg, mesh, layout, grads)
        sq = torch.zeros(1, dtype=torch.float32, device=loss.device)
        for g in SH.counted_parts(cfg, mesh, layout, grads):
            sq += torch.dot(g.reshape(-1), g.reshape(-1)).float()
        P.sum_grads([sq], "model")
        P.sum_grads([sq], "data")
    return loss, grads, torch.sqrt(sq[0])


def make_train_step(cfg: ArchConfig, opts: Optional[M.ModelOptions] = None,
                    peak_lr: float = 3e-4, warmup: int = 100,
                    total: int = 10_000, device="cuda", mesh=None):
    """Returns (init_state(seed_or_params, dtype) -> (params, opt_state),
    train_step(state, batch) -> (state, {"loss", "grad_norm"})), as the
    JAX factory. ``batch`` = {"inputs": ids [B,S] (or [B,S,D]
    embeddings), "labels": [B,S], negative = ignored}, on ``device``.
    ``init_state`` draws the weights from a seed (``init_params``) or copies
    a parameter dict (from ``load_params``, ``checkpoint.restore``). The
    update is in place: the state returned is the state given, updated;
    grad_norm = sqrt(sum of <g, g>) over every gradient.

    With ``mesh``, ``init_state`` cuts the whole weights (drawn a layer at
    a time, or given) to this rank's shards (``launch.sharding.
    local_train_params``), ``batch`` is the rank's rows (``local_batch``),
    and ``train_step`` returns the same loss and grad_norm on every rank:
    the whole batch's loss and the exact norm of the whole gradient,
    every block counted once (``launch.sharding.counted_parts``).

    A state saved with ``checkpoint.save`` (on a mesh: ``save(path,
    state, cfg=cfg, mesh=mesh)``, the whole state in one file) comes back
    as ``checkpoint.restore(path, init_state(0), cfg=cfg, mesh=mesh)``
    on any mesh, or in one process, and ``train_step`` takes it as it
    is."""
    opts = opts or M.ModelOptions(remat=True)
    dev = M.resolve_device(device)
    opt_init, opt_update = adamw(cosine_schedule(peak_lr, warmup, total))
    layout = None if mesh is None else SH.train_layout(cfg, mesh)

    def init_state(seed_or_params: Union[int, Params] = 0,
                   dtype=torch.float32) -> State:
        if isinstance(seed_or_params, dict):
            params = _rebuild(seed_or_params,
                              (p.detach().to(dev, dtype, copy=True)
                               for p in leaves(seed_or_params)))
            if mesh is not None:
                params = SH.local_train_params(cfg, params, mesh)
        else:
            params = M.init_params(
                cfg, seed_or_params, dtype, dev,
                cut=None if mesh is None else SH.train_cutter(cfg, mesh))
        for p in leaves(params):
            p.requires_grad_(True)
        return params, opt_init(params)

    def train_step(state: State, batch: Dict[str, torch.Tensor]
                   ) -> Tuple[State, Dict[str, torch.Tensor]]:
        params, opt_state = state
        for p in leaves(params):         # a state from checkpoint.restore
            p.requires_grad_(True)
        loss, grads, gnorm = step_grads(cfg, params, batch, opts, mesh,
                                        layout)
        params, opt_state = opt_update(grads, opt_state, params)
        return (params, opt_state), {"loss": loss, "grad_norm": gnorm}

    return init_state, train_step
