"""Roofline of the port's dry-run records on the H100 (the counterpart of
``repro.launch.roofline``).

Per record, each term is a per-device quantity over a per-GPU rate:

    compute term          = flops_per_device / PEAK_FLOPS
    memory term           = bytes_floor_per_device / HBM_BW
    memory term, unfused  = bytes_per_device / HBM_BW
    collective term       = sum over mesh axes of the axis's collective
                            bytes / the axis's link rate

The dominant term is the largest of compute, memory (the floor) and
collective; the unfused memory term (every eager op's operands and
results) is printed beside it. The collective term divides the bytes the
port all-reduces by the link rate, as JAX's does, with no ring factor.

Rates (NVIDIA H100 SXM data sheet):
- PEAK_FLOPS = 989e12 FLOP/s, dense bf16 on the tensor cores;
- HBM_BW = 3.35e12 B/s;
- NVLINK_BW = 450e9 B/s a GPU, one way, NVLink 4 (18 links of 25 GB/s),
  for a mesh axis whose ranks lie in one node of GPUS_PER_NODE = 8;
- IB_BW = 50e9 B/s a GPU, InfiniBand NDR (400 Gb/s), for an axis that
  spans nodes: the production meshes' 16-way 'model' axis spans two
  nodes, 'data' and 'pod' span sixteen or more.

Ranks are laid out as ``launch.mesh`` numbers them, the last axis
fastest, so an axis of size n whose inner axes hold s ranks spans n * s
consecutive ranks, one node when n * s <= 8. The number of devices comes
from the record's ``mesh_shape``.

Usage: PYTHONPATH=src python -m repro_torch.launch.roofline [--dir results/torch_dryrun]
"""
from __future__ import annotations

import argparse
import glob
import json
import math
import os
from typing import Any, Dict, List, Optional

from repro_torch.configs import get_config, get_shape

PEAK_FLOPS = 989e12       # bf16 dense / GPU (H100 SXM)
HBM_BW = 3.35e12          # B/s / GPU
NVLINK_BW = 450e9         # B/s / GPU, one way, inside a node
IB_BW = 50e9              # B/s / GPU, across nodes (InfiniBand NDR)
GPUS_PER_NODE = 8


def link_bw(mesh_shape: Dict[str, int], axis: str) -> float:
    """The link rate of ``axis`` of a mesh (axes ordered, last fastest):
    NVLink when the axis's ranks lie in one node, else InfiniBand."""
    names = list(mesh_shape)
    inner = math.prod(mesh_shape[a] for a in names[names.index(axis) + 1:])
    if mesh_shape[axis] * inner <= GPUS_PER_NODE:
        return NVLINK_BW
    return IB_BW


def model_flops_global(arch: str, shape_name: str) -> float:
    cfg = get_config(arch)
    shape = get_shape(shape_name)
    n = cfg.n_active_params()
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch          # decode: one token per slot


def _suggest(dom: str, shape_kind: str, ratio: float) -> str:
    if dom == "collective":
        return ("cut the bytes each collective moves (gather slabs, not "
                "zero-filled full buffers) or keep the axis inside a node")
    if dom == "memory":
        if shape_kind == "decode":
            return ("decode is weight/KV-streaming bound: split the batch "
                    "and the cache over 'data' and the sequence over "
                    "'model', grow the decode batch, quantize KV")
        return "fuse producer-consumer chains / cast activations to bf16"
    if ratio < 0.5:
        return ("compute-bound but <50% useful FLOPs: split the batch over "
                "'data', cut remat recompute or replicated compute")
    return "near compute roofline — only algorithmic savings remain"


def terms(rec: Dict[str, Any]) -> Dict[str, Any]:
    """The roofline terms of an ``ok`` record, in seconds, and the
    dominant one. The port's layer loop makes the direct counts exact, so
    no extrapolated field is read."""
    mesh = rec["mesh_shape"]
    t_coll = sum((float(b) / link_bw(mesh, a)
                  for a, b in rec["collectives_by_axis"].items()
                  if mesh[a] > 1), 0.0)
    out = {"compute_s": rec["flops_per_device"] / PEAK_FLOPS,
           "memory_s": rec["bytes_floor_per_device"] / HBM_BW,
           "memory_unfused_s": rec["bytes_per_device"] / HBM_BW,
           "collective_s": t_coll}
    main = {"compute": out["compute_s"], "memory": out["memory_s"],
            "collective": t_coll}
    out["dominant"] = max(main, key=main.get)
    out["bound_s"] = main[out["dominant"]]
    return out


def analyze_record(rec: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    if rec.get("status") != "ok":
        return None
    arch, shape_name = rec["arch"], rec["shape"]
    t = terms(rec)
    chips = math.prod(rec["mesh_shape"].values())
    mf = model_flops_global(arch, shape_name)
    flops_global = rec["flops_per_device"] * chips
    ratio = mf / flops_global if flops_global else 0.0
    return {
        "arch": arch, "shape": shape_name, "chips": chips, **t,
        "model_flops_global": mf,
        "flops_global": flops_global,
        "useful_ratio": ratio,
        "arg_bytes_per_device": rec.get("argument_size_in_bytes", 0),
        "arg_bytes_per_device_spec": rec.get("argument_size_in_bytes_spec", 0),
        "departures": len(rec.get("departures", ())),
        "suggestion": _suggest(t["dominant"], get_shape(shape_name).kind,
                               ratio),
    }


def load_all(dirname: str, mesh: str = "pod") -> List[Dict[str, Any]]:
    rows = []
    for path in sorted(glob.glob(os.path.join(dirname, f"*__{mesh}.json"))):
        with open(path) as f:
            rec = json.load(f)
        row = analyze_record(rec)
        if row:
            rows.append(row)
        elif rec.get("status") == "skip":
            rows.append({"arch": rec["arch"], "shape": rec["shape"],
                         "skip": rec["reason"]})
    return rows


def fmt_s(x: float) -> str:
    if x >= 1.0:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x * 1e3:.2f}ms"
    return f"{x * 1e6:.1f}us"


def to_markdown(rows: List[Dict[str, Any]]) -> str:
    out = ["| arch | shape | compute | memory | memory unfused | collective "
           "| dominant | useful FLOPs | departures | next lever |",
           "|---|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        if "skip" in r:
            out.append(f"| {r['arch']} | {r['shape']} | — | — | — | — | "
                       f"skipped | — | — | {r['skip']} |")
            continue
        out.append(
            f"| {r['arch']} | {r['shape']} | {fmt_s(r['compute_s'])} | "
            f"{fmt_s(r['memory_s'])} | {fmt_s(r['memory_unfused_s'])} | "
            f"{fmt_s(r['collective_s'])} | **{r['dominant']}** | "
            f"{r['useful_ratio'] * 100:.0f}% | {r['departures']} | "
            f"{r['suggestion']} |")
    return "\n".join(out)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="results/torch_dryrun")
    ap.add_argument("--out", default="results/torch_roofline")
    ap.add_argument("--mesh", default="pod", choices=["pod", "multipod"])
    args = ap.parse_args()
    rows = load_all(args.dir, args.mesh)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out + ".json", "w") as f:
        json.dump(rows, f, indent=1)
    md = to_markdown(rows)
    with open(args.out + ".md", "w") as f:
        f.write(md + "\n")
    print(md)


if __name__ == "__main__":
    main()
