"""Multi-SLO serving on the PyTorch port: three SLO classes share a tiny
Mamba2 (attention-free) slot engine — the scheduler is
architecture-agnostic (SSM decode state instead of a KV cache) and the
decode-mask column maps onto the engine's per-slot active mask. On the
card its prompts run in the ssd_scan kernel and its decode steps in the
ssd_decode_step kernel.

  PYTHONPATH=src python examples/torch_multi_slo_serving.py [--arch mamba2-780m] [--device cpu]
"""
import argparse

from repro_torch.configs import get_config
from repro_torch.core.schedulers import SliceScheduler, sjf_decay_adaptor
from repro_torch.core.task import SLOSpec, Task
from repro_torch.kernels import ops
from repro_torch.serving.executor import TorchExecutor
from repro_torch.serving.loop import run_serving_loop
from repro_torch.serving.metrics import per_kind_tpot


def _num(x) -> str:
    return "-" if x is None else f"{x:.2f}"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-780m")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args()
    cfg = get_config(args.arch).reduced()
    print(f"engine: {cfg.name} (family={cfg.family}) on {args.device}")
    ex = TorchExecutor(cfg, max_slots=8, max_seq=128, device=args.device)
    lat = ex.latency_model()

    # three SLO classes, Table-II style, scaled to saturate the tiny engine
    # (contention is what makes differentiated rate allocation visible)
    base = max(lat.decode_ms(b) for b in (2, 4, 8))
    tasks = []
    for kind, tpot_scale, utility, n in [("strict", 3.0, 20.0, 2),
                                         ("medium", 6.0, 1.0, 2),
                                         ("lax", 20.0, 1.0, 3)]:
        for _ in range(n):
            tasks.append(Task(SLOSpec(tpot_ms=base * tpot_scale,
                                      ttft_ms=60_000.0),
                              utility=utility, prompt_len=12, output_len=300,
                              kind=kind))
    sched = SliceScheduler(lat, utility_adaptor=sjf_decay_adaptor())
    ops.reset_launches()
    res = run_serving_loop(sched, ex, tasks)
    print(f"\n{'class':8s} {'n':>2s} {'slo_ms':>8s} {'actual_ms':>10s} "
          f"{'rate t/s':>9s} {'ok':>3s}")
    for kind, r in per_kind_tpot(res.tasks).items():
        # a class none of whose tasks finished has no TPOT or rate
        print(f"{kind:8s} {r['n']:2d} {r['tpot_slo_ms']:8.1f} "
              f"{_num(r['actual_tpot_ms']):>10s} "
              f"{_num(r['decode_rate_tps']):>9s} "
              f"{'Y' if r['tpot_satisfied'] else 'N':>3s}")
    print("\nSLICE delivered DIFFERENT decode rates per class on one engine "
          "(Fig. 6's differentiation) — strict < medium < lax actual TPOT.")
    print("kernel launches: " + (" ".join(
        f"{k}={v}" for k, v in ops.LAUNCHES.items() if v)
        or "none (the plain versions, on the CPU)"))


if __name__ == "__main__":
    main()
