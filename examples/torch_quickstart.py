"""Quickstart on the PyTorch port: serve a real (tiny) model with SLICE.

Builds a reduced smollm engine (``TorchExecutor``, the slot engine; on the
card its prompts run in the flash_prefill kernel and its decode steps in
the decode_attention kernel), measures its l(b) curve, and runs a mixed
real-time + interactive workload through the SLICE scheduler — printing
per-task SLO outcomes and the kernel launches.

  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse

from repro_torch.configs import get_config
from repro_torch.core.schedulers import SliceScheduler
from repro_torch.core.task import control_task, qa_task, voice_task
from repro_torch.kernels import ops
from repro_torch.serving.executor import TorchExecutor
from repro_torch.serving.loop import run_serving_loop
from repro_torch.serving.metrics import summarize


def _ms(x, digits: int) -> str:
    return "-" if x is None else f"{x:.{digits}f}"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args()
    cfg = get_config("smollm-360m").reduced()
    print(f"engine: {cfg.name} ({cfg.n_layers}L d={cfg.d_model}) on "
          f"{args.device}")
    ex = TorchExecutor(cfg, max_slots=8, max_seq=256, device=args.device)
    lat = ex.latency_model()
    print("measured l(b):",
          {b: round(lat.decode_ms(b), 2) for b in (1, 2, 4, 8)}, "ms")

    tasks = [
        control_task(arrival_ms=0, output_len=8, prompt_len=16,
                     deadline_ms=1500),
        voice_task(arrival_ms=5, output_len=24, prompt_len=24),
        qa_task(arrival_ms=10, output_len=32, prompt_len=32),
        control_task(arrival_ms=200, output_len=8, prompt_len=16,
                     deadline_ms=1500),
    ]
    ops.reset_launches()
    res = run_serving_loop(SliceScheduler(lat), ex, tasks)
    print(f"\n{'kind':10s} {'ttft_ms':>8s} {'tpot_ms':>8s} {'slo':>5s}")
    for t in res.tasks:     # a task never served has no TTFT or TPOT
        print(f"{t.kind:10s} {_ms(t.ttft_ms, 1):>8s} "
              f"{_ms(t.tpot_measured_ms, 2):>8s} "
              f"{'MET' if t.slo_met() else 'MISS':>5s}")
    s = summarize(res.tasks)["all"]
    print(f"\nSLO attainment: {s.slo * 100:.0f}%  "
          f"({res.decode_iterations} decode iterations, "
          f"{res.prefills} prefills)")
    print("kernel launches: " + (" ".join(
        f"{k}={v}" for k, v in ops.LAUNCHES.items() if v)
        or "none (the plain versions, on the CPU)"))


if __name__ == "__main__":
    main()
