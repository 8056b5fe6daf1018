"""Meta-tensor stand-ins for every (arch x input-shape) dry-run cell (the
counterpart of ``repro.launch.specs``): the JAX module's names and shapes,
as tensors on the ``meta`` device, which have a shape and a type and hold
no data (bf16 parameters, int32 tokens and labels).

One difference: JAX's ``decode_buf_len`` asserts when a shape needs
sub-quadratic attention and the arch has no sliding window, so its
dry-run records an error for ``long_500k`` there. ``skip_reason`` names
that cell (and an encoder-only arch's decode) as a skip, with the reason
of DESIGN.md §4, and ``decode_buf_len`` raises ``ValueError`` with it.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ArchConfig, InputShape
from repro_torch.launch import sharding as SH
from repro_torch.launch.mesh import batch_ways
from repro_torch.models import model as M

PARAM_DTYPE = torch.bfloat16
META = torch.device("meta")


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def param_specs_struct(cfg: ArchConfig, dtype=PARAM_DTYPE) -> M.Params:
    """Every parameter of ``init_params``' tree as a meta tensor (built
    from ``param_shapes``: ``init_params`` draws from a generator, which
    has no meta device)."""
    def walk(node):
        return {k: walk(v) if isinstance(v, dict) else _meta(v, dtype)
                for k, v in node.items()}
    return walk(M.param_shapes(cfg))


def skip_reason(cfg: ArchConfig, shape: InputShape) -> Optional[str]:
    """Why a cell has no step (DESIGN.md §4), or None."""
    if shape.kind == "decode" and cfg.is_encoder_only:
        return "encoder-only: no decode step (DESIGN.md §4)"
    if (shape.kind == "decode" and shape.sub_quadratic_required
            and cfg.has_attention and not cfg.sliding_window):
        return (f"{cfg.name} has no sub-quadratic attention variant; "
                f"{shape.name} must be skipped (DESIGN.md §4)")
    return None


def decode_buf_len(cfg: ArchConfig, shape: InputShape) -> int:
    """KV buffer for decode shapes: ring of window size when sub-quadratic
    attention is required; else the full context."""
    if not cfg.has_attention:
        return 0
    if shape.sub_quadratic_required:
        if not cfg.sliding_window:
            raise ValueError(skip_reason(cfg, shape))
        return cfg.sliding_window
    return shape.seq_len


def cache_struct(cfg: ArchConfig, shape: InputShape, dtype=PARAM_DTYPE,
                 mesh=None) -> M.Cache:
    """The slot cache of a decode shape, on meta; with ``mesh``, the part
    of it that the rank at ``mesh.coords`` holds (``launch.sharding.
    local_cache``: its rows and slots, every KV head, its SSM heads)."""
    buf = decode_buf_len(cfg, shape)
    cache = M.init_cache(cfg, shape.global_batch, max(buf, 1), dtype,
                         device=META)
    return cache if mesh is None else SH.local_cache(cfg, cache, mesh)


def input_specs(cfg: ArchConfig, shape: InputShape, dtype=PARAM_DTYPE,
                mesh=None) -> Dict[str, Any]:
    """Model inputs for the step function of this shape's kind; with
    ``mesh``, the rank's part of them: its rows where ('pod', 'data')
    divides the batch (``batch_spec``) and its part of the cache."""
    B, S = shape.global_batch, shape.seq_len
    b = B if mesh is None or B % batch_ways(mesh) else B // batch_ways(mesh)
    if shape.kind == "train":
        if cfg.embedding_inputs:
            inputs = _meta((b, S, cfg.d_model), dtype)
        else:
            inputs = _meta((b, S), torch.int32)
        return {"inputs": inputs, "labels": _meta((b, S), torch.int32)}
    if shape.kind == "prefill":
        if cfg.embedding_inputs:
            return {"inputs": _meta((b, S, cfg.d_model), dtype)}
        return {"inputs": _meta((b, S), torch.int32)}
    if shape.kind == "decode":
        if cfg.is_encoder_only:
            raise ValueError("encoder-only archs have no decode")
        return {"cache": cache_struct(cfg, shape, dtype, mesh),
                "tokens": _meta((b,), torch.int32)}
    raise ValueError(shape.kind)
