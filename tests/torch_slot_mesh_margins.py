"""How far the slot mesh's logits land from JAX's and from the port's
single process, case by case (not a test: a measurement behind the
tolerance notes of ``test_torch_slot_mesh.py``).

For each case of ``test_torch_slot_mesh.CASES`` named, at the case's
batch and prompt length or at ``--at B:S`` instead, it runs the case's
ranks (gloo, on the CPU) on the JAX weights of the test, JAX's
single-device prefill + decode steps and the port's single process, and
prints rank 0's largest distance, prefill and active decode rows apart:
mesh to JAX, mesh to the single process, single process to JAX.

  PYTHONPATH=src:tests python tests/torch_slot_mesh_margins.py \\
      mamba2-1x4 hymba-1x4 --at 4:20 --at 4:16
"""
import argparse
import tempfile

import numpy as np
import torch

import test_torch_slot_mesh as T


def _ranks(rank, world, cases, trees, over):
    torch.set_num_threads(1)
    T.CASES.update(over)
    from repro_torch.launch.mesh import make_serving_mesh
    meshes, out = {}, {}
    for case in cases:
        shape = T.CASES[case][1]
        if shape not in meshes:
            meshes[shape] = make_serving_mesh(data=shape[0], model=shape[1])
        out[case] = T._run_case(meshes[shape], case, trees[T.CASES[case][2]])
    return out


def _single(case, tree):
    """The port's single process on the case's inputs, no context."""
    from repro_torch.models import model as TM
    _, _, name, _, _, buf_len = T.CASES[case]
    cfg = T._cfg(name, "repro_torch")
    params = TM.load_params(cfg, tree, device="cpu")
    prompts, active = T._inputs(case)
    logits, cache = TM.prefill(cfg, params, torch.from_numpy(prompts),
                               buf_len)
    seen = {"prefill": logits.numpy(), "logits": []}
    tokens = logits.numpy().argmax(-1).astype(np.int32)
    for t in range(T.STEPS):
        logits, cache = TM.decode_step(cfg, params, cache,
                                       torch.from_numpy(tokens),
                                       torch.from_numpy(active[t]))
        seen["logits"].append(logits.numpy())
        tokens = T._next(tokens, seen["logits"][-1], active[t])
    return seen


def _dist(a, b, active):
    pre = float(np.abs(a["prefill"] - b["prefill"]).max())
    dec = max(float(np.abs(x - y)[act].max())
              for x, y, act in zip(a["logits"], b["logits"], active))
    return f"prefill {pre:.3e} steps {dec:.3e}"


def main():
    import jax
    from repro.models import model as JM
    from repro_torch.launch.mesh import spawn_ranks
    ap = argparse.ArgumentParser()
    ap.add_argument("cases", nargs="+")
    ap.add_argument("--at", action="append", default=[],
                    help="B:S, a batch and prompt length in place of the "
                         "case's (repeatable)")
    args = ap.parse_args()
    torch.set_num_threads(1)
    weights = {}
    for case in args.cases:
        name = T.CASES[case][2]
        if name not in weights:
            cfg = T._cfg(name, "repro")
            params = JM.init_params(cfg, jax.random.PRNGKey(4))
            weights[name] = (cfg, params, T._numpy(params))
    trees = {k: v[2] for k, v in weights.items()}
    base = dict(T.CASES)
    for at in args.at or [None]:
        over = {}
        for case in args.cases:
            world, shape, name, B, S, buf_len = base[case]
            if at is not None:
                B, S = map(int, at.split(":"))
            over[case] = (world, shape, name, B, S, buf_len)
        T.CASES.update(over)
        for world in sorted({over[c][0] for c in args.cases}):
            cases = [c for c in args.cases if over[c][0] == world]
            ranks = spawn_ranks(_ranks, world, (world, cases, trees,
                                                {c: over[c] for c in cases}),
                                timeout=600, store_dir=tempfile.mkdtemp())
            for case in cases:
                _, active = T._inputs(case)
                jax_run = T._jax_run(weights, case)
                one = _single(case, trees[over[case][2]])
                mesh = ranks[0][case]
                print(f"{case} B={over[case][3]} S={over[case][4]}: mesh to "
                      f"JAX {_dist(mesh, jax_run, active)}; mesh to the "
                      f"single process {_dist(mesh, one, active)}; single "
                      f"process to JAX {_dist(one, jax_run, active)}",
                      flush=True)


if __name__ == "__main__":
    main()
