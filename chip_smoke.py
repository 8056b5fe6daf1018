"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

  python3 chip_smoke.py            # from the repository root, one CUDA card

Phases, each printing its own lines; any failed check exits non-zero:

1. build  — compile both CUDA kernels from csrc/ (one nvcc per source,
            started together) and print ptxas's register/shared-memory
            report.
2. check  — hold each kernel against its plain PyTorch version on the card
            at edge-6b head shapes (Hq=32, Hkv=2, hd=128, page 16), fp32 and
            bf16: -1 page-table entries, a pad row, page-boundary positions,
            ragged prompt lengths, causal / window / non-causal. Then a
            reduced engine on the card against the same engine on the CPU
            (prefill + decode logits, greedy streams).
3. serve  — SLICE over the paged engine, edge-6b at full width in bf16,
            through the serve entry point: measured l(b), a few Poisson
            voice/QA requests; every task must finish and the pool must
            end empty.
            Kernel launch counts are zeroed just before and read just after.
4. time   — each kernel, its plain version and (prefill) the library's
            scaled_dot_product_attention as a yardstick, at the shapes the
            serving run used; the bound is the larger of bytes over 3.35 TB/s
            and flops over the type's peak (H100 SXM data sheet).

The last lines are the kernels JSON, the card's name and power limit, and
{"ok": true, "device": {...}}. Exits non-zero, printing no result, when
CUDA is not available or the repository's sources are not beside it.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12                       # H100 SXM data sheet
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
TOL = {"float32": 1e-4, "bfloat16": 1.6e-2}     # max |kernel - plain|
# Non-realtime traffic only (--ratio 0): SLICE paces a realtime task at
# exactly its SLO rate and drops it once it falls behind its deadline, and
# this host-bound engine's steps vary around the probed l(b), so whether a
# realtime task survives is timing noise; voice/QA tasks always finish.
# The realtime policy is held against the JAX package on a priced clock in
# tests/test_torch_serving.py.
SERVE_ARGS = ["--arch", "edge-6b", "--dtype", "bfloat16", "--device", "cuda",
              "--scheduler", "slice", "--slots", "8", "--max-seq", "1024",
              "--rate", "2.0", "--duration", "4", "--ratio", "0",
              "--seed", "0"]
KERNELS = {
    "paged_decode_attention": {
        "source": "src/repro_torch/csrc/paged_decode_attention.cu",
        "replaces": "src/repro/kernels/paged_attention.py:171"},
    "flash_prefill": {
        "source": "src/repro_torch/csrc/flash_prefill.cu",
        "replaces": "src/repro/kernels/flash_prefill.py:73"},
}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def time_ms(fn, iters: int = 30, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


# ----------------------------------------------------------------- inputs

def decode_inputs(lengths, dtype, n_pages=600, Hq=32, Hkv=2, hd=128, psz=16,
                  maxp=64, seed=0):
    """Paged-decode inputs on the card: rows with q_pos = lengths[b] (a
    length < 0 gives a pad row: q_pos 0, every table entry -1), each live
    row's pages drawn without replacement from a shuffled arena, -1 past
    its last page."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    B = len(lengths)
    q = torch.randn(B, Hq, hd, generator=g, device="cuda").to(dtype)
    kp = torch.randn(n_pages, Hkv, psz, hd, generator=g, device="cuda").to(dtype)
    vp = torch.randn(n_pages, Hkv, psz, hd, generator=g, device="cuda").to(dtype)
    perm = torch.randperm(n_pages, generator=g, device="cuda").tolist()
    pt = torch.full((B, maxp), -1, dtype=torch.int32)
    qpos = torch.zeros(B, dtype=torch.int32)
    for b, ln in enumerate(lengths):
        if ln < 0:
            continue
        n = ln // psz + 1
        pt[b, :n] = torch.tensor([perm.pop() for _ in range(n)])
        qpos[b] = ln
    return q, kp, vp, pt.cuda(), qpos.cuda()


def prefill_inputs(B, S, dtype, Hq=32, Hkv=2, hd=128, seed=0):
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(B, S, Hq, hd, generator=g, device="cuda").to(dtype)
    k = torch.randn(B, S, Hkv, hd, generator=g, device="cuda").to(dtype)
    v = torch.randn(B, S, Hkv, hd, generator=g, device="cuda").to(dtype)
    return q, k, v


# ----------------------------------------------------------------- phases

def build_phase():
    from repro_torch.kernels import build
    phase("build")
    took = build.build_all(force=True)
    for name in build.KERNELS:
        print(f"built {name} in {took[name]:.1f}s -> {build.library(name)}")
        for line in build.build_log(name).read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")


def check_kernels():
    """Kernel against plain version on the same inputs; returns the worst
    error per kernel, each case printed against its tolerance."""
    import torch
    from repro_torch.kernels import ops, ref
    phase("check kernels against their plain versions")
    worst = {k: 0.0 for k in KERNELS}

    def report(name, case, dtype, err):
        tol = TOL[dtype]
        ok = err <= tol
        print(f"{name} {case} {dtype}: max_abs_err={err:.3e} tol={tol:g} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            fail(f"{name} {case} {dtype} disagrees with its plain version")
        worst[name] = max(worst[name], err)

    # decode: pad row (-1), page-boundary positions (15, 16, 31, 32), short
    # and long rows, trailing -1 entries on every live row
    lengths = [-1, 0, 15, 16, 31, 32, 100, 517, 1000, 1023]
    for dt in ("float32", "bfloat16"):
        q, kp, vp, pt, qp = decode_inputs(lengths, getattr(torch, dt))
        out = ops.paged_decode_attention(q, kp, vp, pt, qp)
        torch.cuda.synchronize()
        want = ref.paged_decode_attention_ref(q.float(), kp.float(),
                                              vp.float(), pt, qp)
        live = torch.tensor([ln >= 0 for ln in lengths], device="cuda")
        err = (out.float() - want)[live].abs().max().item()
        pad = out[~live].float()
        if not (torch.isfinite(out.float()).all() and (pad == 0).all()):
            fail("paged_decode_attention: pad rows must give finite zeros")
        report("paged_decode_attention", f"B={len(lengths)} lengths={lengths}",
               dt, err)
    for dt in ("float32", "bfloat16"):
        for B, S, causal, window in ((2, 77, True, None), (1, 1000, True, None),
                                     (2, 300, True, 128), (2, 77, False, None),
                                     (1, 1, True, None)):
            q, k, v = prefill_inputs(B, S, getattr(torch, dt))
            out = ops.flash_prefill(q, k, v, causal=causal, window=window)
            torch.cuda.synchronize()
            want = ref.flash_prefill_ref(q.float(), k.float(), v.float(),
                                         causal=causal, window=window)
            if not torch.isfinite(out.float()).all():
                fail("flash_prefill: non-finite output")
            report("flash_prefill", f"B={B} S={S} causal={causal} "
                   f"window={window}", dt, (out.float() - want).abs().max().item())
    return worst


def check_engine():
    """Reduced edge-6b engine on the card against the same engine (same
    weights, same tasks) on the CPU: prefill and decode logits in fp32 and
    identical greedy streams."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core.task import SLOSpec, Task
    from repro_torch.models import model as M
    from repro_torch.serving.executor import PagedTorchExecutor
    phase("check reduced engine on the card against the CPU")
    cfg = get_config("edge-6b").reduced()
    params = M.init_params(cfg, seed=0, device="cpu")
    on = {}
    for dev in ("cpu", "cuda"):
        p = {k: ({kk: vv.to(dev) for kk, vv in v.items()} if k == "blocks"
                 else v.to(dev)) for k, v in params.items()}
        on[dev] = PagedTorchExecutor(cfg, params=p, n_pages=32, page_size=16,
                                     max_seq=128, max_batch=4, device=dev)
    tasks = [Task(SLOSpec(tpot_ms=100.0), 1.0, prompt_len=n, output_len=8,
                  task_id=7000 + i) for i, n in enumerate((5, 17, 40))]
    worst = 0.0
    for t in tasks:
        for ex in on.values():
            ex.prefill(t)
        worst = max(worst, float(np.abs(on["cuda"].last_prefill_logits
                                        - on["cpu"].last_prefill_logits).max()))
    for _ in range(3):
        for ex in on.values():
            ex.decode(tasks)
        got = on["cuda"].last_logits
        if got.shape != (len(tasks), cfg.vocab_size) or not np.isfinite(got).all():
            fail(f"engine logits shape {got.shape} or non-finite values")
        worst = max(worst, float(np.abs(got - on["cpu"].last_logits).max()))
    streams = {d: [ex.generated_tokens(t) for t in tasks] for d, ex in on.items()}
    print(f"engine cuda vs cpu: max |logit diff|={worst:.3e} tol=1e-4 "
          f"streams_equal={streams['cuda'] == streams['cpu']}")
    if worst > 1e-4 or streams["cuda"] != streams["cpu"]:
        fail("reduced engine on the card disagrees with the CPU engine")


def serve_phase():
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    phase("serve edge-6b at full width (bf16) under SLICE")
    args = serve.parse_args(SERVE_ARGS)
    print("serve args:", " ".join(SERVE_ARGS))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ops.reset_launches()
    run = serve.run(args)
    launches = dict(ops.LAUNCHES)
    wall = time.perf_counter() - t0
    ex, res = run.executor, run.result
    peak = torch.cuda.max_memory_allocated()
    print("l(b) curve: " + " ".join(f"l({b})={ms:.3f}ms" for b, ms in run.probes))
    print(f"served n={len(res.tasks)} prefills={res.prefills} "
          f"decode_iters={res.decode_iterations} loop_clock={res.end_ms:.1f}ms "
          f"wall={wall:.1f}s max_memory_allocated={peak} "
          f"({peak / 2**30:.2f} GiB)")
    print(f"launches in the serving run: {launches}")
    unfinished = [t.task_id for t in res.tasks if t.dropped or not t.finished]
    if not res.tasks or unfinished:
        fail(f"tasks not finished: {unfinished} of {len(res.tasks)}")
    ex.pool.check()
    if ex.pool.used_pages != 0 or ex.pool.owners():
        fail(f"page leak: {ex.pool.used_pages} pages held by {ex.pool.owners()}")
    logits = ex.last_logits
    if (logits is None or logits.shape[1] != ex.cfg.vocab_size
            or not np.isfinite(logits).all()):
        fail("last decode logits missing, misshapen or non-finite")
    for name, n in launches.items():
        if n <= 0:
            fail(f"kernel {name} was not launched on the main path")
    return run, launches


def time_phase(run, launches, worst):
    """Time each kernel, its plain version and the library yardstick at the
    serving run's shapes; bound from this run's inputs."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    phase("time kernels at the serving run's shapes")
    ex = run.executor
    cfg = ex.cfg
    dt = "bfloat16"
    dtype = torch.bfloat16
    elt = 2
    Hq, Hkv, hd, psz = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, ex.page_size
    tasks = run.result.tasks                     # in arrival order
    eff = [min(t.prompt_len, ex.max_seq // 2) for t in tasks]
    rows = []

    # decode: a full bucket of the engine over the workload's first
    # requests, each mid-way through its output (prompt + half its output
    # cached)
    B = ex.max_batch
    lengths = [eff[i % len(tasks)] + tasks[i % len(tasks)].output_len // 2
               for i in range(B)]
    q, kp, vp, pt, qp = decode_inputs(lengths, dtype, n_pages=ex.n_pages,
                                      Hq=Hq, Hkv=Hkv, hd=hd, psz=psz,
                                      maxp=ex.max_pages_per_seq, seed=1)
    live = sum(ln + 1 for ln in lengths)
    nbytes = (2 * live * Hkv * hd * elt + 2 * B * Hq * hd * elt
              + pt.numel() * 4 + B * 4)
    flops = 4 * live * Hq * hd
    rows.append(("paged_decode_attention",
                 f"B={B} q_pos={lengths} maxp={ex.max_pages_per_seq}",
                 lambda: ops.paged_decode_attention(q, kp, vp, pt, qp),
                 lambda: ref.paged_decode_attention_ref(q, kp, vp, pt, qp),
                 lambda: ref.paged_decode_attention_ref(
                     q.float(), kp.float(), vp.float(), pt, qp),
                 None, nbytes, flops))

    # prefill: one prompt at the median effective length of the workload
    S = sorted(eff)[len(eff) // 2]
    qf, kf, vf = prefill_inputs(1, S, dtype, Hq=Hq, Hkv=Hkv, hd=hd, seed=2)
    qt, kt, vt = (x.transpose(1, 2) for x in (qf, kf, vf))
    kr, vr = (x.repeat_interleave(Hq // Hkv, dim=1) for x in (kt, vt))

    def sdpa():
        return F.scaled_dot_product_attention(qt, kr, vr, is_causal=True)

    pairs = S * (S + 1) // 2
    rows.append(("flash_prefill", f"B=1 S={S} causal",
                 lambda: ops.flash_prefill(qf, kf, vf, causal=True),
                 lambda: ref.flash_prefill_ref(qf, kf, vf, causal=True),
                 lambda: ref.flash_prefill_ref(qf.float(), kf.float(),
                                               vf.float(), causal=True),
                 sdpa, (2 * S * Hq + 2 * S * Hkv) * hd * elt,
                 4 * pairs * Hq * hd))

    out = []
    for name, shape, kern, plain, plain_fp32, lib, nbytes, flops in rows:
        # held against the plain version at these shapes too
        err = (kern().float() - plain_fp32()).abs().max().item()
        print(f"{name} [{shape}, {dt}]: max_abs_err={err:.3e} tol={TOL[dt]:g}")
        if err > TOL[dt]:
            fail(f"{name} disagrees with its plain version at the timed shapes")
        worst[name] = max(worst[name], err)
        ms = time_ms(kern)
        plain_ms = time_ms(plain)
        lib_ms = time_ms(lib) if lib is not None else None
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOPS[dt] * 1e3
        bound, by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops,
                                                                 "operations")
        print(f"{name} [{shape}, {dt}]: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, library "
              f"{'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'}, bound "
              f"{bound:.5f} ms by {by} ({nbytes} B, {flops} flop)")
        out.append({"name": name, "route": "cuda",
                    "source": KERNELS[name]["source"],
                    "replaces": KERNELS[name]["replaces"],
                    "launches": launches[name], "max_abs_err": worst[name],
                    "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                    "bound_by": by, "library_ms": lib_ms})
    return out


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        print("FAIL: CUDA is not available: chip_smoke.py needs one CUDA card",
              file=sys.stderr)
        raise SystemExit(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import repro_torch  # noqa: F401  (fails outside the repository)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}",
          flush=True)
    t0 = time.perf_counter()
    build_phase()
    worst = check_kernels()
    check_engine()
    run, launches = serve_phase()
    kernels = time_phase(run, launches, worst)
    leaked = sorted(m for m in sys.modules
                    if m == "jax" or m.startswith(("jax.", "repro.")))
    if leaked:
        fail(f"JAX or the JAX package was imported: {leaked[:5]}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()
    if smi.returncode != 0 or not card:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    print(f"total {time.perf_counter() - t0:.1f}s")
    print(json.dumps({"kernels": kernels}))
    print(card[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
