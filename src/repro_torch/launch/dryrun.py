"""Dry-run of the port (the counterpart of ``repro.launch.dryrun``): every
(architecture x input-shape x mesh) cell's step is run once, on meta
tensors, as rank 0 of a stand-in production mesh, and its per-device
FLOPs, bytes, collectives and argument bytes are recorded for the
roofline report (``launch.roofline``).

JAX lowers and compiles each cell for 256 or 512 placeholder devices and
reads XLA's cost and memory analyses. The port runs SPMD, one program a
rank, so a cell is rank 0's program: its slab of the weights
(``launch.sharding.local_params``, the serving layout), its part of the
cache and inputs (``launch.sharding.local_cache``: the rows of a batch
split over ('pod', 'data'), the slots of a ring cut over 'model'; JAX's
``cache_specs`` and ``batch_spec``), in a train cell its shards of the
params and AdamW moments (``launch.sharding.local_train_params``: FSDP
over 'data' as ``param_specs(train=True)``, the serving slabs over
'model') and its rows of the batch, and the step run under
``models.partitioning``'s ``activation_partitioning`` over
``launch.mesh.make_production_mesh``, whose collectives are a fake
process group's. Meta tensors hold no data, so a cell takes seconds
whatever its size; the kernel wrappers take their plain versions on them
(``kernels.ops``), so the FLOPs and bytes are those of the plain
versions' ops, not of the CUDA kernels.

A record has JAX's keys where the port has a meaning for them:

- ``mesh_shape``, ``status`` ("ok", "skip" with ``reason``, or "error");
- ``flops_per_device``: ``torch.utils.flop_counter.FlopCounterMode``'s
  count (matrix products, attention and convolutions; elementwise ops
  count nothing, where XLA's cost analysis counts them too);
- ``bytes_per_device``: operand plus result bytes of every aten op that
  moves data, views excluded: eager PyTorch, no fusion;
- ``bytes_floor_per_device``: the arguments read once plus the outputs
  written once (an argument updated in place, the slot cache or the
  AdamW state, counts once, as read);
- ``collectives`` (``launch.collective_stats``: ``collective_bytes``'
  keys) and ``collectives_by_axis``;
- ``argument_size_in_bytes``: the rank's own slab, cache and inputs (and
  AdamW state); ``output_size_in_bytes``: the outputs that are new
  tensors;
- ``argument_size_in_bytes_spec``: the per-device bytes the copied JAX
  rules (``param_specs``, ``cache_specs``, ``batch_spec``,
  ``opt_state_specs``) give each leaf: what ties the record to JAX's
  ``argument_size_in_bytes``;
- ``departures``: where the port's rank holds or computes otherwise than
  the specs say (the whole-head layouts of ``launch.sharding``: attention
  weights where the spec splits inside a head, the SSM's in_proj, conv
  weights and conv tail by the rank's heads with B and C whole, every SSM
  leaf where 'model' does not divide the heads; in a train cell the same
  leaves of the params and of mu and nu, and a leaf whose model slab
  does not divide over 'data' where the spec cuts it);
- ``run_s``, in place of ``lower_s`` and ``compile_s``. JAX's
  ``generated_code_size_in_bytes``, ``temp_size_in_bytes`` and
  ``hlo_bytes`` have no counterpart and are left out.

Pod cells also carry ``cost_extrapolate``'s fields. The cells are JAX's:
``ASSIGNED_ARCHS`` x ``SHAPES`` x {pod, multipod}; ``build_cell`` and
``count_cell`` take any config, ``InputShape`` and mesh.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-6b --shape decode_32k --mesh pod
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Any, Callable, Dict, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ASSIGNED_ARCHS, SHAPES, get_config, get_shape
from repro_torch.configs.base import ArchConfig, InputShape
from repro_torch.launch import sharding as SH
from repro_torch.launch import specs as SP
from repro_torch.launch.collective_stats import CollectiveRecorder
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import model as M
from repro_torch.models.partitioning import activation_partitioning

# aten ops that allocate or reinterpret without moving data (views are
# told apart by OpOverload.is_view)
_NO_DATA = frozenset({"empty", "empty_strided", "empty_like", "new_empty",
                      "new_empty_strided", "_unsafe_view", "lift_fresh"})


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_flatten(tree)[0]
               if isinstance(t, torch.Tensor))


class ByteCounter(TorchDispatchMode):
    """Operand plus result bytes of every aten op that moves data."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if (func.namespace == "aten" and not func.is_view
                and func.overloadpacket.__name__ not in _NO_DATA):
            self.bytes += _nbytes((args, kwargs)) + _nbytes(out)
        return out


@dataclasses.dataclass
class Cell:
    """A cell's step ``fn(*args)`` on meta tensors. ``cut``: the leaves cut
    over 'model' (what ``activation_partitioning`` installs: the
    counterpart of JAX's in_shardings). ``tree``: the arguments by name,
    as the rank holds them; ``whole``: the same leaves whole; ``specs``:
    the JAX rules' spec of each leaf. ``notes``: departures of the step
    itself."""
    fn: Callable
    args: tuple
    cut: frozenset
    grad: bool
    tree: Dict[str, Any]
    whole: Dict[str, Any]
    specs: Dict[str, Any]
    notes: List[str]


def build_cell(cfg: ArchConfig, shape: InputShape, mesh,
               opts: Optional[M.ModelOptions] = None) -> Cell:
    """The step of this shape's kind for rank 0 of ``mesh``: train
    (``make_train_step(mesh=mesh)`` with AdamW, one step, on the rank's
    shards of the params and moments, ``param_specs(train=True)``'s and
    ``opt_state_specs``' layout, and its rows of the batch), prefill
    (``prefill``, or ``forward`` for encoder-only archs, on the rank's
    slab and rows) or slot ``decode_step``."""
    opts = opts or M.ModelOptions(remat=(shape.kind == "train"))
    B = shape.global_batch
    whole = SP.param_specs_struct(cfg)
    train = shape.kind == "train"
    p_spec = SH.param_specs(cfg, mesh, train=train)
    ins = whole_ins = SP.input_specs(cfg, shape)

    if train:
        from repro_torch.training.trainer import make_train_step
        init_state, train_step = make_train_step(cfg, opts, device="meta",
                                                 mesh=mesh)
        params, opt = init_state(whole, dtype=SP.PARAM_DTYPE)
        ins = SP.input_specs(cfg, shape, mesh=mesh)
        batch = {"inputs": ins["inputs"], "labels": ins["labels"]}
        o_spec = SH.opt_state_specs(p_spec)
        opt_tree = {"step": opt.step, "mu": opt.mu, "nu": opt.nu}
        tree = {"params": params, "opt": opt_tree, **batch}
        moments = SP.param_specs_struct(cfg, torch.float32)
        full = {"params": whole, "opt": {"step": opt.step, "mu": moments,
                                         "nu": moments},
                "inputs": whole_ins["inputs"], "labels": whole_ins["labels"]}
        specs = {"params": p_spec, "opt": {"step": o_spec.step,
                                           "mu": o_spec.mu, "nu": o_spec.nu},
                 "inputs": SH.batch_spec(mesh, B, batch["inputs"].ndim),
                 "labels": SH.batch_spec(mesh, B, 2)}
        return Cell(train_step, ((params, opt), batch),
                    SH.cut_leaves(cfg, mesh.shape["model"]), True, tree,
                    full, specs, [])

    ways = mesh.shape["model"]
    if shape.kind == "prefill":
        x_spec = SH.batch_spec(mesh, B, ins["inputs"].ndim)
        params = SH.local_params(cfg, whole, mesh)
        ins = SP.input_specs(cfg, shape, mesh=mesh)
        if cfg.is_encoder_only:
            fn = lambda p, x: M.forward(cfg, p, x, opts)[0]  # noqa: E731
        else:
            fn = lambda p, x: M.prefill(  # noqa: E731
                cfg, p, x, buf_len=shape.seq_len, batch=B)
        return Cell(fn, (params, ins["inputs"]), SH.cut_leaves(cfg, ways),
                    False, {"params": params, "inputs": ins["inputs"]},
                    {"params": whole, "inputs": whole_ins["inputs"]},
                    {"params": p_spec, "inputs": x_spec}, [])

    if shape.kind == "decode":
        buf = SP.decode_buf_len(cfg, shape)
        ins = SP.input_specs(cfg, shape, mesh=mesh)
        params = SH.local_params(cfg, whole, mesh)
        fn = lambda p, c, t: M.decode_step(  # noqa: E731
            cfg, p, c, t, buf_len=buf, batch=B)
        c_spec = SH.cache_specs(cfg, mesh, B, buf_len=buf)
        return Cell(fn, (params, ins["cache"], ins["tokens"]),
                    SH.cut_leaves(cfg, ways), False,
                    {"params": params, "cache": ins["cache"],
                     "tokens": ins["tokens"]},
                    {"params": whole, "cache": whole_ins["cache"],
                     "tokens": whole_ins["tokens"]},
                    {"params": p_spec, "cache": c_spec,
                     "tokens": SH.batch_spec(mesh, B, 1)}, [])
    raise ValueError(shape.kind)


# ------------------------------------------------------------ accounting

def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _ways(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        return mesh.shape[axes]
    return math.prod(mesh.shape[a] for a in axes)


def spec_shape(shape, spec, mesh) -> tuple:
    """A leaf's per-device shape under ``spec`` (a tuple of axis names per
    dim, missing dims unsplit, as a PartitionSpec pads them)."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(d // _ways(mesh, s) for d, s in zip(shape, spec))


def spec_leaf_bytes(cell: Cell, mesh) -> Dict[str, int]:
    """Per leaf, the bytes a device holds under the JAX rules' spec."""
    specs = dict(_leaves(cell.specs))
    return {path: math.prod(spec_shape(t.shape, specs[path], mesh))
            * t.element_size() for path, t in _leaves(cell.whole)}


def departures(cell: Cell, mesh) -> List[str]:
    """The step's own departures, then each leaf whose per-device shape
    on the port differs from its spec's."""
    specs, mine = dict(_leaves(cell.specs)), dict(_leaves(cell.tree))
    out = list(cell.notes)
    for path, t in _leaves(cell.whole):
        want = spec_shape(t.shape, specs[path], mesh)
        have = tuple(mine[path].shape)
        if want != have:
            out.append(f"{path}: spec {tuple(specs[path])} holds "
                       f"{list(want)} a device, the port {list(have)}")
    return out


def measure(cell: Cell, mesh) -> Dict[str, Any]:
    """Run the cell's step once under the counters: FLOPs, eager bytes,
    collectives, argument and output bytes, seconds."""
    rec = CollectiveRecorder()
    flops = FlopCounterMode(display=False)
    moved = ByteCounter()
    t0 = time.perf_counter()
    with activation_partitioning(mesh, cell.cut), rec, \
            torch.set_grad_enabled(cell.grad), flops, moved:
        out = cell.fn(*cell.args)
    run_s = time.perf_counter() - t0
    arg_ids = {id(t) for t in tree_flatten(cell.args)[0]}
    args = _nbytes(cell.args)
    outs = _nbytes([t for t in tree_flatten(out)[0]
                    if isinstance(t, torch.Tensor) and id(t) not in arg_ids])
    return {"flops_per_device": float(flops.get_total_flops()),
            "bytes_per_device": float(moved.bytes),
            "bytes_floor_per_device": float(args + outs),
            "collectives": rec.stats(),
            "collectives_by_axis": rec.by_axis(),
            "argument_size_in_bytes": args,
            "output_size_in_bytes": outs,
            "run_s": round(run_s, 2)}


def count_cell(cfg: ArchConfig, shape: InputShape, mesh,
               opts: Optional[M.ModelOptions] = None) -> Dict[str, Any]:
    """``build_cell`` and ``measure``, with the spec bytes and the
    departures."""
    cell = build_cell(cfg, shape, mesh, opts)
    out = measure(cell, mesh)
    out["argument_size_in_bytes_spec"] = sum(
        spec_leaf_bytes(cell, mesh).values())
    out["departures"] = departures(cell, mesh)
    return out


def cost_extrapolate(cfg: ArchConfig, shape: InputShape, mesh,
                     opts: Optional[M.ModelOptions] = None) -> Dict[str, Any]:
    """JAX's loop-free cost model, from 1- and 2-layer variants:
        total = f(1) + (n_layers - 1) * (f(2) - f(1)).
    XLA counts a scan body once, so JAX needs it; the port runs a Python
    loop over the layers, so for archs whose layers are all alike the
    extrapolation equals the direct count, a self-check of the counters."""
    vals = {}
    for k in (1, 2):
        m = measure(build_cell(dataclasses.replace(cfg, n_layers=k), shape,
                               mesh, opts), mesh)
        vals[k] = (m["flops_per_device"], m["bytes_per_device"],
                   float(m["collectives"]["total"]))
    L = cfg.n_layers
    f1, b1, c1 = vals[1]
    f2, b2, c2 = vals[2]
    return {
        "flops_per_device_extrap": f1 + (L - 1) * (f2 - f1),
        "bytes_per_device_extrap": b1 + (L - 1) * (b2 - b1),
        "collective_bytes_extrap": c1 + (L - 1) * (c2 - c1),
        "flops_per_layer": f2 - f1,
        "flops_nonlayer": 2 * f1 - f2,
    }


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             opts: Optional[M.ModelOptions] = None) -> Dict[str, Any]:
    cfg = get_config(arch)
    shape = get_shape(shape_name)
    rec: Dict[str, Any] = {"arch": arch, "shape": shape_name,
                           "mesh": mesh_kind, "status": "ok"}
    reason = SP.skip_reason(cfg, shape)
    if reason:
        rec["status"] = "skip"
        rec["reason"] = reason
        return rec
    with make_production_mesh(multi_pod=mesh_kind == "multipod") as mesh:
        rec["mesh_shape"] = dict(mesh.shape)
        rec.update(count_cell(cfg, shape, mesh, opts))
        if mesh_kind == "pod":   # the roofline table is single-pod only
            rec.update(cost_extrapolate(cfg, shape, mesh, opts))
    return rec


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="pod", choices=["pod", "multipod", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/torch_dryrun")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args()

    archs = list(ASSIGNED_ARCHS) if (args.all or not args.arch) else [args.arch]
    shapes = [s.name for s in SHAPES] if (args.all or not args.shape) else [args.shape]
    meshes = ["pod", "multipod"] if args.mesh == "both" else [args.mesh]
    os.makedirs(args.out, exist_ok=True)

    for arch in archs:
        for shape in shapes:
            for mk in meshes:
                path = os.path.join(args.out, f"{arch}__{shape}__{mk}.json")
                if args.skip_existing and os.path.exists(path):
                    print(f"[skip existing] {path}")
                    continue
                try:
                    rec = run_cell(arch, shape, mk)
                except Exception as e:  # noqa: BLE001 — record the failure
                    rec = {"arch": arch, "shape": shape, "mesh": mk,
                           "status": "error", "error": f"{type(e).__name__}: {e}",
                           "trace": traceback.format_exc()[-2000:]}
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1)
                flop = rec.get("flops_per_device")
                print(f"[{rec['status']}] {arch} x {shape} x {mk}"
                      + (f" flops/dev={flop:.3g}"
                         f" coll={rec['collectives']['total']:.3g}B"
                         f" run={rec['run_s']}s"
                         if rec["status"] == "ok" else
                         f" {rec.get('reason', rec.get('error', ''))}"),
                      flush=True)


if __name__ == "__main__":
    main()
