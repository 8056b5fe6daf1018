"""Paper-scale reproduction on the PyTorch port's control plane: the full
§VI evaluation on the discrete-event simulator calibrated to the paper's
testbed (ChatGLM2-6B-INT4 on RTX 4060 Ti).

  PYTHONPATH=src python examples/torch_edge_serving_sim.py [--rate 1.0] [--ratio 0.7]
"""
import argparse

from repro_torch.core.latency_model import paper_fig1_model
from repro_torch.core.schedulers import (FastServeScheduler, OrcaScheduler,
                                   SliceScheduler)
from repro_torch.data.workload import poisson_workload
from repro_torch.serving.executor import SimExecutor
from repro_torch.serving.loop import run_serving_loop
from repro_torch.serving.metrics import summarize


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rate", type=float, default=1.0, help="tasks/s")
    ap.add_argument("--ratio", type=float, default=0.7, help="RT share")
    ap.add_argument("--duration", type=float, default=150.0, help="seconds")
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args()

    lat = paper_fig1_model()
    print(f"workload: rate={args.rate}/s RT:{args.ratio:.0%} "
          f"duration={args.duration}s\n")
    print(f"{'scheduler':12s} {'SLO':>7s} {'RT-SLO':>7s} {'nRT-SLO':>8s} "
          f"{'RT compl':>9s} {'nRT compl':>10s}")
    for name, mk in [("SLICE", lambda: SliceScheduler(lat)),
                     ("Orca", OrcaScheduler),
                     ("FastServe", FastServeScheduler)]:
        tasks = poisson_workload(args.rate, args.duration,
                                 realtime_frac=args.ratio, seed=args.seed)
        res = run_serving_loop(mk(), SimExecutor(lat), tasks, max_ms=3e7)
        s = summarize(res.tasks)
        rt_c = s["realtime"].mean_completion_ms
        nrt_c = s["non_realtime"].mean_completion_ms
        print(f"{name:12s} {s['all'].slo:7.1%} {s['realtime'].slo:7.1%} "
              f"{s['non_realtime'].slo:8.1%} "
              f"{(rt_c or 0) / 1000:8.2f}s {(nrt_c or 0) / 1000:9.2f}s")


if __name__ == "__main__":
    main()
