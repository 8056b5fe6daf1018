"""How far a slot mesh's fp32 logits land from one process's, and why.

The slot ``prefill`` and ``decode_step`` in JAX's cache layout
(``models.partitioning.activation_partitioning`` over a gloo mesh of
spawned ranks, ``launch.sharding.local_params``), held against one
process on the whole cache: greedy decode steps under a fixed active
pattern, each rank's largest logits distance from the single process's
printed, prefill and active decode rows apart. Two ways to read it:

- ``--variants``: cut only some leaves over 'model' (``all`` the serving
  layout, ``ssm`` the SSM group's, ``mlp`` wg/wu/wd, ``none``: every
  weight whole; the ring's slots stay cut over 'model' in each), which
  names the partial sums a distance comes from;
- ``--reorder``: the single process against itself, with the SSM
  mixer's out_proj product cut at ``--reorder`` rows of d_inner and the
  two parts added: one valid fp32 order for another, the size of
  distance any reordering of a sum gives at that depth.

Every depth of ``--layers`` is run; the ranks share the device, so no
clock here is tensor-parallel speed.

  PYTHONPATH=src python -m repro_torch.launch.slot_mesh_margins \\
      --arch hymba-1.5b --mesh 1,2 --layers 16,32 --batch 4 --prompt 1100 \\
      --buf 1024 --steps 16 --variants all,ssm,mlp,none --reorder 1000
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import os
import tempfile
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs import get_config
from repro_torch.launch import sharding as S
from repro_torch.launch.mesh import make_serving_mesh, spawn_ranks
from repro_torch.models import model as M
from repro_torch.models import ssm as SSM
from repro_torch.models.layers import rms_norm
from repro_torch.models.partitioning import activation_partitioning

VARIANTS = ("all", "ssm", "mlp", "none")


def _keeps(variant: str, name: str) -> bool:
    """Whether ``variant`` cuts the leaf named ``name`` (``cut_leaves``)."""
    return {"all": True, "ssm": name.startswith("ssm."),
            "mlp": name in ("wg", "wu", "wd"), "none": False}[variant]


def _config(args, layers: int):
    cfg = get_config(args.arch)
    cfg = cfg.reduced() if args.reduced else cfg
    return dataclasses.replace(cfg, n_layers=layers)


def _inputs(cfg, args):
    """Prompts [batch, prompt] and the active pattern [steps, batch], from
    a seeded generator on the host (``chip_smoke.py``'s slot-mesh draw)."""
    g = torch.Generator().manual_seed(27)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt),
                            generator=g, dtype=torch.int32)
    active = torch.tensor([[(b + t) % 4 != 3 for b in range(args.batch)]
                           for t in range(args.steps)])
    return prompts, active


def _ops(cfg, params, args, dev) -> Dict[str, object]:
    """Prefill, then the greedy decode steps (an inactive row keeps its
    token): the logits as numpy arrays."""
    prompts, active = _inputs(cfg, args)
    logits, cache = M.prefill(cfg, params, prompts.to(dev), args.buf)
    out = {"pre": logits.float().cpu().numpy(), "dec": []}
    tokens = logits.argmax(-1).to(torch.int32)
    for act in active.to(dev):
        logits, cache = M.decode_step(cfg, params, cache, tokens, act,
                                      buf_len=args.buf)
        out["dec"].append(logits.float().cpu().numpy())
        tokens = torch.where(act, logits.argmax(-1).to(torch.int32), tokens)
    out["streams"] = tokens.cpu().numpy()
    return out


def _distance(a, b, active) -> str:
    pre = float(np.abs(a["pre"] - b["pre"]).max())
    dec = max(float(np.abs(x - y)[act].max())
              for x, y, act in zip(a["dec"], b["dec"], active.numpy()))
    same = np.array_equal(a["streams"], b["streams"])
    return (f"max_abs_err={max(pre, dec):.3e} (prefill {pre:.3e}, steps "
            f"{dec:.3e}), final tokens {'identical' if same else 'DIFFER'}")


@contextlib.contextmanager
def _reordered(at: int):
    """The SSM mixer with out_proj's product over d_inner[:at] and
    d_inner[at:] added, in place of one product."""
    plain = SSM._gated_out

    def gated_out(p, y, z, d_inner):
        n = rms_norm(y * F.silu(z), p["norm_w"])
        w = p["out_proj"]
        return n[..., :at] @ w[:at] + n[..., at:] @ w[at:]

    SSM._gated_out = gated_out
    try:
        yield
    finally:
        SSM._gated_out = plain


def _device(args) -> torch.device:
    return torch.device("cpu") if args.device == "cpu" else \
        torch.device("cuda", 0)


def _rank(rank: int, args, shape) -> List[Dict[str, object]]:
    """A rank: every (depth, variant) in order, on its slab of the
    weights the single process draws."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = _device(args)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // (shape[0]
                                                            * shape[1])))
    mesh = make_serving_mesh(data=shape[0], model=shape[1], device=dev)
    out = []
    for layers in args.layers:
        cfg = _config(args, layers)
        cutter = S.cutter(cfg, mesh)
        names = S.cut_leaves(cfg, shape[1])
        for v in args.variants:
            sub = frozenset(n for n in names if _keeps(v, n))

            def cut(path, x):
                name = path.split(".", 1)[1] if path.startswith(
                    "blocks.") else path
                return cutter(path, x) if name in sub else x

            params = M.init_params(cfg, seed=0, dtype=torch.float32,
                                   device=dev, cut=cut)
            with activation_partitioning(mesh, sub):
                out.append(_ops(cfg, params, args, dev))
            del params
            gc.collect()
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="hymba-1.5b")
    ap.add_argument("--mesh", default="1,2", help="data,model")
    ap.add_argument("--layers", default="16")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt", type=int, default=1100)
    ap.add_argument("--buf", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--variants", default="all")
    ap.add_argument("--reorder", type=int, default=0,
                    help="also the single process with out_proj's product "
                         "cut at this many rows (0: not run)")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    args.layers = [int(x) for x in args.layers.split(",")]
    args.variants = args.variants.split(",")
    if set(args.variants) - set(VARIANTS):
        ap.error(f"--variants: each of {', '.join(VARIANTS)}")
    shape = tuple(int(x) for x in args.mesh.split(","))
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = _device(args)
    where = (torch.cuda.get_device_name(0) if dev.type == "cuda"
             else "the CPU")
    print(f"{args.arch}{' reduced' if args.reduced else ''} fp32 on "
          f"{where}: a ({shape[0]}, {shape[1]}) gloo mesh sharing it "
          f"against one process, {args.batch} prompts of {args.prompt} "
          f"into {args.buf} slots, {args.steps} steps", flush=True)
    ones = {}
    for layers in args.layers:
        cfg = _config(args, layers)
        params = M.init_params(cfg, seed=0, dtype=torch.float32, device=dev)
        ones[layers] = _ops(cfg, params, args, dev)
        if args.reorder and cfg.has_ssm:
            with _reordered(args.reorder):
                two = _ops(cfg, params, args, dev)
            _, active = _inputs(cfg, args)
            print(f"{layers} layers, one process, out_proj's product cut at "
                  f"{args.reorder} of {cfg.ssm_inner} rows and added: "
                  + _distance(two, ones[layers], active), flush=True)
        del params
        gc.collect()
    with tempfile.TemporaryDirectory() as store:
        ranks = spawn_ranks(_rank, shape[0] * shape[1], (args, shape),
                            backend="gloo", timeout=1800, store_dir=store)
    at = 0
    for layers in args.layers:
        _, active = _inputs(_config(args, layers), args)
        for v in args.variants:
            print(f"{layers} layers, mesh, cut {v}: rank 0 "
                  + _distance(ranks[0][at], ones[layers], active)
                  + (", every rank alike" if all(
                      np.array_equal(r[at]["pre"], ranks[0][at]["pre"])
                      for r in ranks) else ""), flush=True)
            at += 1


if __name__ == "__main__":
    main()
