"""End-to-end training on the PyTorch port: train a ~100M-param
SmolLM-family model for a few hundred steps on synthetic data, with
checkpointing (``training.trainer`` and ``training.checkpoint``).

  PYTHONPATH=src python examples/torch_train_tiny.py [--steps 300] [--arch smollm-360m] [--device cpu]
"""
import argparse
import dataclasses
import time

import torch

from repro_torch.configs import get_config
from repro_torch.models import model as M
from repro_torch.training import checkpoint
from repro_torch.training.optimizer import leaves
from repro_torch.training.trainer import make_train_step


def synthetic_batches(vocab: int, batch: int, seq: int, device,
                      seed: int = 0):
    """Markov-ish synthetic LM data (learnable structure, not pure noise)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    while True:
        base = torch.randint(0, vocab, (batch, seq), generator=gen,
                             device=device)
        shifted = torch.roll(base, 1, dims=1) * 31 % vocab  # deterministic successor
        mask = torch.rand((batch, seq), generator=gen, device=device) < 0.8
        toks = torch.where(mask, shifted, base).to(torch.int32)
        yield {"inputs": toks, "labels": toks}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--d-model", type=int, default=512,
                    help="width override (~100M params at 512 for smollm)")
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--ckpt", default="results/torch_train_tiny.npz")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    dev = M.resolve_device(args.device)
    cfg = get_config(args.arch)
    cfg = dataclasses.replace(
        cfg, d_model=args.d_model, n_layers=args.layers, n_heads=8,
        n_kv_heads=4, head_dim=64, d_ff=4 * args.d_model, vocab_size=8192)
    print(f"training {cfg.name}: L={cfg.n_layers} d={cfg.d_model} "
          f"params~{cfg.n_params() / 1e6:.1f}M on {dev}")

    init_state, train_step = make_train_step(
        cfg, M.ModelOptions(), peak_lr=3e-4, warmup=20, total=args.steps,
        device=dev)
    state = init_state(0)
    data = synthetic_batches(cfg.vocab_size, args.batch, args.seq, dev)
    t0 = time.time()
    loss0 = None
    for i in range(args.steps):
        state, m = train_step(state, next(data))
        if i == 0:
            loss0 = float(m["loss"])
        if i % 20 == 0 or i == args.steps - 1:
            print(f"step {i:4d} loss={float(m['loss']):.4f} "
                  f"gnorm={float(m['grad_norm']):.3f} "
                  f"({(time.time() - t0):.1f}s)")
    final = float(m["loss"])
    print(f"\nloss {loss0:.3f} -> {final:.3f} "
          f"({'improved' if final < loss0 else 'NO IMPROVEMENT'})")
    params = state[0]
    checkpoint.save(args.ckpt, params)
    restored = checkpoint.restore(args.ckpt, params)
    assert all(torch.equal(a, b)
               for a, b in zip(leaves(params), leaves(restored)))
    print(f"checkpoint round-trip OK -> {args.ckpt}")


if __name__ == "__main__":
    main()
