"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

  python3 chip_smoke.py            # from the repository root, one CUDA card

Phases, each printing its own lines; any failed check exits non-zero:

1. build  — compile every CUDA source in csrc/ (one nvcc per source,
            started together) and print ptxas's register and spill report
            for each kernel instantiation.
2. check  — hold each of the eight kernels against its plain PyTorch
            version on the card, fp32 and bf16. At edge-6b head shapes
            (Hq=32, Hkv=2, hd=128, page 16): paged decode with -1 table
            entries (inside a row's table too), a pad row and
            page-boundary positions up to 1023; paged verify
            windows of C = 1, 3, 5 queries (16 to 80 rows per KV head) at
            and across page boundaries, with -1 entries and a pad row;
            flash prefill
            at ragged lengths, causal / window / non-causal; ring-cache
            decode with -1 slots, a pad row, wrapped kv_pos, window 64 and
            8192; prompt chunks at q_start 0/16/300, C 1/37/64/128, over a
            1024-slot buffer with stale data past the chunk, K/V read
            through the strides of a [B,Hkv,S,hd] buffer, with a window,
            and chunks past the buffer's end whose rows that see no key
            must give exact zeros. Each flash case names the body it ran
            (bf16 at hd 64 and 128: the tensor-core body).
            The five attention kernels again at granite-moe (Hq=24, Hkv=8,
            hd=64), hymba (Hq=25, Hkv=5, hd=64) and smollm-360m (Hq=15,
            Hkv=5, hd=64) head shapes (the ring over a ragged 1000-slot
            ring). The SSD scan at mamba2-780m
            (H=48, P=64, N=128) and hymba (H=50, N=16) widths, T=1, 65,
            77 and 256, inputs as strided splits of one projection; the SSD decode step over a shuffled state arena
            with a pad and an inactive row (arena after the step compared
            too), at both widths and at every other branch of its slab
            plan (H/P/N 4/32/16, 4/24/12, 4/80/64, 2/64/256), each called
            twice on the same inputs, bit for bit; the grouped-expert FFN at granite-moe widths (E=40,
            D=1536, F=512) for one decode group (C=64) and two per-example
            prefill groups, with zero rows, then with live-row counts (a
            skewed decode routing that leaves experts empty; per-example
            groups empty, full and ragged) and NaN in every row past a
            count. Before each checked call that must write exact zeros
            (pad rows, empty ring rows, rows past a count) and before each
            SSD scan, a block of the output's size is filled with NaN and
            freed, so the wrapper's torch.empty gets poisoned memory back.
            Each paged, ring, SSD-scan and MoE case names its body.
            Then reduced engines on the card against the same engines on
            the CPU (prefill + decode logits, greedy streams): paged atomic,
            paged chunked, slot chunked (masked decode), slot compacted;
            paged speculative decoding with a self-draft (streams also equal
            to depth-0 decode), prefix-shared prefill and decode, and a
            suspend/resume (restored K/V bit for bit, logits after resume
            equal to the never-suspended engine's); mamba2-780m, hymba-1.5b
            and granite-moe-3b-a800m (reduced) paged engines with prefill,
            decode steps and a suspend/resume that restores the SSM state,
            the conv tail and the K/V pages bit for bit; mamba2-780m and
            hymba-1.5b (reduced) slot engines, masked and compacted,
            with a 2-token prompt (shorter than the conv width) and a
            slot reused after a release; the ring prefill (a prompt of
            100 or 200 tokens into the reduced configs' 64-slot window)
            of hymba-1.5b and smollm-360m and four decode steps after it
            (K/V within 1e-4, kv_pos exact); a reduced heterogeneous
            fleet (mamba2-780m, granite-moe-3b-a800m) through
            engine_fleet under the structural gate of
            benchmarks/fleet_routing.py. The SSD decode step also over
            the slot engine's layout (row b at slot b, a spare row,
            inactive rows) at the same shapes. Every reduced engine on
            the card runs its steps captured as CUDA graphs (the
            engines' default).
3. graphs — each step the engines capture, at full width in bf16, run
            by an eager engine (cuda_graphs=False) and a captured one on
            the same weights and tasks. Decode-type: edge-6b's paged
            decode at b = 1, 2, 4, 8, its speculative iteration at b = 4,
            K = 4 (verify step and the draft's catch-up and masked decode),
            the slot engine's masked and compacted steps (16 slots) of
            edge-6b, mamba2-780m and hymba-1.5b, and the paged decode of
            mamba2-780m and granite-moe-3b-a800m; 16 steps each.
            Prefill-type: the whole prompt at 64, 128 and 256 tokens
            (edge-6b, mamba2-780m, granite-moe-3b-a800m on the paged
            engine; mamba2-780m and hymba-1.5b on the slot engine;
            edge-6b's slot engine at 256), a 256-token
            prompt in chunks of 64 on the paged and the slot engine, and
            a prefix hit's suffix in power-of-two pieces; 5 prompts a
            length, then 4 decode steps. Logits within the bf16
            tolerance, greedy streams identical, launch counts equal.
            Prints both engines' l(b) and prefill engine clock, the
            spread of 20 steps at the largest batch and the peak memory
            with and without graphs.
4. serve  — SLICE through the serve entry point, edge-6b at full width in
            bf16, every step captured: measured l(b), a few Poisson
            requests, in seven runs: (a) the paged engine with atomic
            prefill, (a') the same with realtime tasks beside voice/QA
            (--ratio 0.5, the CLI's default mix; every other run but (c')
            serves voice/QA only), (b) the slot engine with
            --prefill-chunk 64, (c) the paged engine with --prefill-chunk
            64, (c') the same with --ratio 0.5, (d) the paged engine with
            --spec-decode --spec-depth 4 --prefix-cache
            --shared-prefix-frac 0.7 at 4 requests/s (SLICE grants depth
            only to lagging tasks), (d') the same at 8 requests/s, more
            prefilled tasks than the draft has slots. Every task must
            finish (none dropped, realtime ones included; realtime and
            non-realtime attainment printed), a paged pool must end empty
            (after the radix index is cleared), runs (d) and (d') must run
            verify steps and hit the prefix cache, and each run must
            launch the kernels of its path.
            Then (e) mamba2-780m and (f) granite-moe-3b-a800m at full width
            in bf16 on the paged engine, with the same workload: every task
            finishes, no page or state slot is left held, (e) launches the
            SSD scan and decode-step kernels, (f) the grouped-expert FFN,
            paged decode and flash prefill at head_dim 64, group 3.
            Then (h) the fleet (--fleet smollm-360m,edge-6b, --ratio 0.5,
            traced): every task finishes, the per-instance results
            partition the tasks, both pools end empty, each QA task is
            served on tier 1 or counted among the degraded routings, the
            event stream replays the merged result and each instance's
            track its own; (i) mamba2-780m and (j) hymba-1.5b on the slot
            engine (16 slots): every task finishes, every slot is free,
            (i) launches the SSD kernels, (j) those and the ring-cache
            decode and flash prefill at hymba's heads.
            Kernel launch counts are zeroed just before each run and read
            just after; the engine is freed before the next run. In run
            (h) the launches are also tallied by the instance whose engine
            made them, and the tallies must sum to the run's. Run (d)
            also prints a speculative iteration's engine clock beside a
            plain decode step's at the same batch.
5. sharded — tensor-parallel paged serving (--mesh-shape) over
            torch.distributed. (a) The four paged-path kernels (paged
            decode and verify, flash prefill and chunk) against their
            plain versions at the heads a rank of edge-6b holds over 2
            ranks (16 query heads, 1 KV head) and over 4 (8 and the one
            KV head they read), fp32 and bf16, with the check phase's
            cases (pad rows, -1 entries, page boundaries, C = 1, 3, 5,
            q_start 0/16/300), each naming its body. (b) edge-6b at full
            width in fp32 (TF32 off): the single-process paged engine
            prefills 3 prompts of 37, 100 and 201 tokens and decodes 16
            greedy steps; then 2 ranks over gloo sharing the card (eager
            steps: gloo collectives cannot be captured) run the same ops
            on their slabs: streams identical, logits within MESH_TOL,
            equal launches, digests and loop clocks on the ranks. (e)
            The grouped-expert FFN against its plain version at a rank's
            slab of granite-moe, fp32 and bf16: 20 and 10 of its 40
            experts (expert-parallel over 2 and 4 ranks) and all 40 with
            256 and 128 of their 512 d_ff columns (inside each expert),
            in the decode layout (C = 64) and the per-example layout (2
            examples, C = 50), live-row counts with 0 and C and NaN past
            each count; each case timed beside its bound and the chain of
            batched matmuls (JSON key "rank_slabs" of the kernel's
            entry). (f) granite-moe the way of (b) on a (2, 2) mesh, 4
            ranks: the decode bucket of 4 split 2 + 2 over the data
            groups, each rank on 20 experts, the grouped FFN launched on
            every rank, equal digests and loop clocks. (c) A one-rank
            mesh over NCCL (what --mesh-shape 1,1 builds) with every step
            captured, the collectives inside the graphs, bit for bit the
            engine without a mesh and the same mesh engine with eager
            steps, on reduced edge-6b and granite-moe: whole and chunked
            prefill, decode, speculative verify. (d) The CLI with
            --mesh-shape 1,2 (run paged-mesh): edge-6b at full width in
            bf16 on the serve phase's workload, 2 ranks over gloo on the
            card; every task finishes, every rank's pool ends empty, the
            ranks' digests are equal, each rank launches paged decode and
            flash prefill at its 16 query heads and 1 KV head. (d') The
            same with --arch granite-moe-3b-a800m --mesh-shape 2,2 (run
            paged-mesh-moe), 4 ranks: each rank on 12 query heads, 4 KV
            heads and 20 experts launches the grouped FFN too. The ranks
            import no JAX. Prints each rank's l(b) and engine clock,
            labelled as ranks sharing one H100 over gloo: no
            tensor-parallel speed.
6. time   — each kernel (device time: CUDA events over 30 calls queued
            behind a spin kernel, so the calls run back to back; the
            kernel's time launched at the host's pace is printed beside
            it), its plain version and the library's
            scaled_dot_product_attention as a yardstick (explicit boolean
            mask, K/V repeated to Hq, where the kernel masks by position;
            none for the paged kernels, which no single PyTorch call
            gathers), at the shapes its serving run used (the paged
            kernels over a full batch of the run's first requests, each
            mid-way through its output; verify windows of depth+1
            queries; paged decode and flash prefill also at granite-moe's
            heads over run (f)'s batch and median prompt and at
            smollm-360m's over run (h)'s smollm instance's; each paged row
            names its page splits); ring-cache decode over run (b)'s slot
            array and over run (j)'s at hymba's heads and window; the SSD
            scan over one median prompt of run (e) and of run (j); the SSD
            step over the full decode batch of runs (e), (i) and (j), each
            on its own arena layout and timed cold (the next of as many
            arena copies as fill twice the L2 each call), beside an empty
            kernel on the same grid timed the same way, its launch floor
            (JSON key "floor_ms"), each naming its slab plan; flash prefill also at hymba's heads
            over run (j)'s median prompt; the
            grouped-expert FFN over run (f)'s full decode batch with its
            routing's live-row counts passed and the bound counting only
            live rows (C = batch * top_k; no single
            PyTorch call computes these three: the MoE FFN's chain of
            batched matmuls is printed as a yardstick, and its
            library_ms stays null); the bound is the
            larger of bytes over 3.35 TB/s and flops over the type's peak
            (H100 SXM data sheet). The paged-path kernels are timed again
            at a rank's heads (16 query heads, 1 KV head): paged decode
            and flash prefill over run paged-mesh's batch and prompts
            (its launches, both ranks', under these rows), verify and
            chunk over runs paged-spec's and slot-chunked's shapes; at a
            rank of run paged-mesh-moe (12 query heads, 4 KV heads, 20
            experts), paged decode, flash prefill and the grouped FFN
            over its rows of a full decode batch (4 of 8) and its
            prompts. The
            multi-pass kernels' rows also print
            each pass's device time (torch.profiler): the ring-cache
            decode's split and combine, the SSD scan's chunk states, state
            passing and chunk outputs (JSON key "passes_us").
7. train  — the training path (forward, loss_fn, AdamW, train_step,
            fp32, TF32 off; it reaches no kernel, as JAX's training path
            reaches no Pallas kernel). (a) Every registry arch, reduced
            (embedding-input and encoder-only archs included): forward
            logits, the loss, every leaf's gradient and two train_steps'
            loss and grad_norm on the card against the port on the CPU
            from the same weights and batch (logits to 1e-4 of their
            magnitude, loss 1e-5, each gradient to 1e-4 of its leaf's
            largest, the steps 1e-4); every leaf forward reads has a
            nonzero gradient on the card (embed of an embedding-input arch
            with an untied head excepted, as in JAX); no kernel launched.
            Forward with use_ssd_kernel (mamba2, no autograd) launches the
            SSD scan once a layer and matches the default forward; under
            autograd it raises. (b) smollm-360m at full width and depth:
            10 steps at B=8, S=1024 on one batch, the loss must fall; then
            at B=1, S=4096 a step with the chunked attention resolve_attn
            picks, its loss and grad_norm against a dense-attention
            loss_and_grads on the same weights. (c) mamba2-780m,
            hymba-1.5b, hubert-xlarge at full width, granite-moe-3b-a800m
            at full width with 8 of its 32 layers (its fp32 AdamW state
            at 32 layers, ~53 GB, would not leave room), 3 steps each at
            B=4, S=1024. Each run prints ms a step (host clock, synced;
            median of the steps after the first), tokens/s, the dense
            FLOPs a token (8x the weights a token's matmuls read: forward,
            remat's second forward and a backward of twice the forward;
            no attention scores) and their rate against the fp32 peak,
            peak memory and the card's name and power limit; a JSON line
            {"train": [...]} collects them. (d) python -m
            repro_torch.launch.train --arch smollm-360m --steps 20 in a
            subprocess must exit 0.

The kernels JSON has one entry per kernel; each also names its shape and
the kernel body it ran ("tensor_core" or "cuda_core"), and a kernel timed
at a second shape lists it under "other_shapes" (its launches then sum
over every serving run). Each run's launches of a kernel stand under the
one row timed at that run's shapes (heads, state widths, arena layout):
the script fails if a run's launches stand under no row or under two.
The last lines are the kernels JSON, the card's name and power limit, and
{"ok": true, "device": {...}}. Exits non-zero, printing no result, when
CUDA is not available or the repository's sources are not beside it.
"""
from __future__ import annotations

import contextlib
import functools
import inspect
import json
import math
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12                       # H100 SXM data sheet
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
TOL = {"float32": 1e-4, "bfloat16": 1.6e-2}     # max |kernel - plain|
L2_BYTES = 50 * 2**20                           # H100 SXM data sheet
# Non-realtime traffic (--ratio 0) in every run but paged-realtime, so the
# runs stay comparable with earlier ones. SLICE paces a realtime task at
# exactly its SLO rate and drops it once it falls behind its deadline, so
# a realtime task survives only if the steps run as the probed l(b) says:
# with the decode steps captured as CUDA graphs they do, and
# paged-realtime serves the CLI's default mix (--ratio 0.5), every task to
# the end. The realtime policy is also held against the JAX package on a
# priced clock in tests/test_torch_serving.py.
SERVE_ARGS = ["--arch", "edge-6b", "--dtype", "bfloat16", "--device", "cuda",
              "--scheduler", "slice", "--slots", "8", "--max-seq", "1024",
              "--rate", "2.0", "--duration", "4", "--ratio", "0",
              "--seed", "0"]
# (run, extra serve arguments, kernels the run's path must launch). The
# slot engine has no page budget, so SLICE admits against its slots only:
# 16 slots hold every request of this workload at once.
SERVE_RUNS = (
    ("paged-atomic", ["--executor", "paged"],
     ("paged_decode_attention", "flash_prefill")),
    # realtime beside voice/QA, the CLI's default mix
    ("paged-realtime", ["--executor", "paged", "--ratio", "0.5"],
     ("paged_decode_attention", "flash_prefill")),
    ("slot-chunked", ["--executor", "slot", "--prefill-chunk", "64",
                      "--slots", "16"],
     ("decode_attention", "flash_prefill_chunk")),
    ("paged-chunked", ["--executor", "paged", "--prefill-chunk", "64"],
     ("paged_decode_attention", "flash_prefill_chunk")),
    # realtime beside voice/QA with chunked prefill: every chunk step
    # captured, so a prompt's pieces cost near what the whole prompt does
    ("paged-chunked-realtime", ["--executor", "paged", "--prefill-chunk",
                                "64", "--ratio", "0.5"],
     ("paged_decode_attention", "flash_prefill_chunk")),
    # verify steps, plain decode steps, prefix-hit suffixes and the draft
    # model's catch-up chunks and slot decode. SLICE grants depth only to
    # tasks that lag their SLO; with captured steps the probed l(b) holds
    # and at 2 requests/s none lags, so this run serves 4/s, where the
    # prefills' stalls make tasks lag
    ("paged-spec", ["--executor", "paged", "--spec-decode", "--spec-depth",
                    "4", "--prefix-cache", "--shared-prefix-frac", "0.7",
                    "--rate", "4"],
     ("paged_verify_attention", "paged_decode_attention",
      "flash_prefill_chunk", "decode_attention")),
    # the same at 8 requests/s: more prefilled tasks than the draft's 8
    # slots, each drafted in turn (the draft reclaims the slot of the task
    # it drafted least recently; the JAX draft raises here)
    ("paged-spec-rate8", ["--executor", "paged", "--spec-decode",
                          "--spec-depth", "4", "--prefix-cache",
                          "--shared-prefix-frac", "0.7", "--rate", "8"],
     ("paged_verify_attention", "paged_decode_attention",
      "flash_prefill_chunk", "decode_attention")),
    # the async pipelined engine (DESIGN.md §10), traced (DESIGN.md §13),
    # on the CLI's default mix: realtime beside voice/QA
    ("paged-async-traced", ["--executor", "paged", "--ratio", "0.5",
                            "--async-pipeline", "--trace", "{trace}",
                            "--metrics-every", "16"],
     ("paged_decode_attention", "flash_prefill")),
    # SSM and MoE serving (DESIGN.md §12): the later --arch overrides
    # SERVE_ARGS's
    ("paged-ssm", ["--executor", "paged", "--arch", "mamba2-780m"],
     ("ssd_scan", "ssd_decode_step")),
    ("paged-moe", ["--executor", "paged", "--arch", "granite-moe-3b-a800m"],
     ("moe_grouped_ffn", "paged_decode_attention", "flash_prefill")),
    # the fleet tier (DESIGN.md §11): smollm-360m (tier 0) and edge-6b
    # (tier 1) behind one router on the CLI's default mix, traced; QA
    # traffic wants tier 1
    ("fleet-traced", ["--fleet", "smollm-360m,edge-6b", "--ratio", "0.5",
                      "--trace", "{trace}", "--metrics-every", "16"],
     ("paged_decode_attention", "flash_prefill")),
    # SSM and hybrid archs on the slot engine: the state in the slot cache
    ("slot-ssm", ["--executor", "slot", "--slots", "16", "--arch",
                  "mamba2-780m"],
     ("ssd_scan", "ssd_decode_step")),
    ("slot-hybrid", ["--executor", "slot", "--slots", "16", "--arch",
                     "hymba-1.5b"],
     ("decode_attention", "flash_prefill", "ssd_scan", "ssd_decode_step")),
)
KERNELS = {
    "paged_decode_attention": {
        "source": "src/repro_torch/csrc/paged_decode_attention.cu",
        "replaces": "src/repro/kernels/paged_attention.py:171"},
    "flash_prefill": {
        "source": "src/repro_torch/csrc/flash_prefill.cu",
        "replaces": "src/repro/kernels/flash_prefill.py:73"},
    "flash_prefill_chunk": {
        "source": "src/repro_torch/csrc/flash_prefill.cu",
        "replaces": "src/repro/kernels/flash_prefill.py:161"},
    "decode_attention": {
        "source": "src/repro_torch/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention.py:69"},
    "paged_verify_attention": {
        "source": "src/repro_torch/csrc/paged_decode_attention.cu",
        "replaces": "src/repro/kernels/paged_attention.py:126"},
    "ssd_scan": {
        "source": "src/repro_torch/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:75"},
    "ssd_decode_step": {
        "source": "src/repro_torch/csrc/ssd_decode.cu",
        "replaces": "src/repro/kernels/ssd_decode.py:34"},
    "moe_grouped_ffn": {
        "source": "src/repro_torch/csrc/moe_grouped_ffn.cu",
        "replaces": "src/repro/kernels/moe_dispatch.py:32"},
}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


_START = time.perf_counter()


def phase(name: str) -> None:
    """A phase's header line, with the seconds since the script started."""
    print(f"== {name} (at {time.perf_counter() - _START:.1f}s)", flush=True)


def poison(shape, dtype):
    """Fill a block of a kernel output's size with NaN and free it, so the
    wrapper's torch.empty most likely gets that memory back: a row the
    kernel fails to write reads NaN, not a stale zero."""
    import torch
    torch.cuda.empty_cache()
    torch.full(shape, float("nan"), dtype=dtype, device="cuda")


# ----------------------------------------------------------------- inputs

def decode_inputs(lengths, dtype, n_pages=600, Hq=32, Hkv=2, hd=128, psz=16,
                  maxp=64, seed=0, holes=()):
    """Paged-decode inputs on the card: rows with q_pos = lengths[b] (a
    length < 0 gives a pad row: q_pos 0, every table entry -1), each live
    row's pages drawn without replacement from a shuffled arena, -1 past
    its last page; the table entries ``holes`` of rows that reach past
    them are -1 too (keys masked inside a row)."""
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
        pt[b, [j for j in holes if j < n - 1]] = -1
        qpos[b] = ln
    return q, kp, vp, pt.cuda(), qpos.cuda()


def verify_inputs(q_start, C, dtype, n_pages=600, Hq=32, Hkv=2, hd=128,
                  psz=16, maxp=64, seed=0):
    """Paged-verify inputs on the card: row b's window of C queries starts
    at q_start[b] (< 0 gives a pad row: q_start 0, every table entry -1);
    each live row's table covers its window with pages drawn without
    replacement from a shuffled arena, -1 after."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    B = len(q_start)
    q = torch.randn(B, C, Hq, hd, generator=g, device="cuda").to(dtype)
    kp = torch.randn(n_pages, Hkv, psz, hd, generator=g, device="cuda").to(dtype)
    vp = torch.randn(n_pages, Hkv, psz, hd, generator=g, device="cuda").to(dtype)
    perm = torch.randperm(n_pages, generator=g, device="cuda").tolist()
    pt = torch.full((B, maxp), -1, dtype=torch.int32)
    qs = torch.zeros(B, dtype=torch.int32)
    for b, s0 in enumerate(q_start):
        if s0 < 0:
            continue
        n = (s0 + C - 1) // psz + 1
        pt[b, :n] = torch.tensor([perm.pop() for _ in range(n)])
        qs[b] = s0
    return q, kp, vp, pt.cuda(), qs.cuda()


def prefill_inputs(B, S, dtype, Hq=32, Hkv=2, hd=128, seed=0):
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(B, S, Hq, hd, generator=g, device="cuda").to(dtype)
    k = torch.randn(B, S, Hkv, hd, generator=g, device="cuda").to(dtype)
    v = torch.randn(B, S, Hkv, hd, generator=g, device="cuda").to(dtype)
    return q, k, v


def ring_inputs(q_pos, kv_pos, dtype, S, Hq=32, Hkv=2, hd=128, seed=0):
    """Slot-cache decode inputs on the card: q [B,Hq,hd], k/v [B,Hkv,S,hd]
    filled with random data in every slot, the given kv_pos [B,S] and
    q_pos [B]."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    B = len(q_pos)
    q = torch.randn(B, Hq, hd, generator=g, device="cuda").to(dtype)
    k = torch.randn(B, Hkv, S, hd, generator=g, device="cuda").to(dtype)
    v = torch.randn(B, Hkv, S, hd, generator=g, device="cuda").to(dtype)
    return (q, k, v, torch.as_tensor(kv_pos, dtype=torch.int32).cuda(),
            torch.as_tensor(q_pos, dtype=torch.int32).cuda())


def appended_kv_pos(lengths, S):
    """kv_pos of an append-only slot cache: row b holds positions
    0..lengths[b]-1 in slots 0..lengths[b]-1, -1 after (length 0: an empty
    row)."""
    import numpy as np
    kv = np.full((len(lengths), S), -1, np.int32)
    for b, n in enumerate(lengths):
        kv[b, :n] = np.arange(n)
    return kv


def chunk_inputs(B, C, S, dtype, Hq=32, Hkv=2, hd=128, seed=0):
    """Chunk queries [B,C,Hq,hd] and K/V as the slot cache lays them out,
    [B,Hkv,S,hd], every slot filled; returned as the strided [B,S,Hkv,hd]
    views the engines pass."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(B, C, Hq, hd, generator=g, device="cuda").to(dtype)
    k = torch.randn(B, Hkv, S, hd, generator=g, device="cuda").to(dtype)
    v = torch.randn(B, Hkv, S, hd, generator=g, device="cuda").to(dtype)
    return q, k.transpose(1, 2), v.transpose(1, 2)


def ssd_inputs(B, T, H, P, N, dtype, seed=0):
    """SSD inputs on the card as the mixer passes them: x [B,T,H,P], dt
    [B,T,H], b and c [B,T,N] as strided splits of one [B,T,H*P+2N+H]
    projection, x scaled by 0.5 and b, c by N^-0.5 so outputs stay below
    4 (the range the bf16 tolerance is set for); the [H]
    parameters at the JAX init's values (a_log = log(linspace(1, 16)),
    d_skip = 1, dt_bias ~ 0.1 N(0,1))."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    W = H * P + 2 * N + H
    proj = torch.randn(B, T, W, generator=g, device="cuda")
    proj[..., :H * P] *= 0.5
    proj[..., H * P:H * P + 2 * N] *= N ** -0.5
    proj[..., H * P + 2 * N:] *= 0.5
    proj = proj.to(dtype)
    x = proj[..., :H * P].reshape(B, T, H, P)
    b = proj[..., H * P:H * P + N]
    c = proj[..., H * P + N:H * P + 2 * N]
    dt = proj[..., H * P + 2 * N:]
    params = (torch.log(torch.linspace(1.0, 16.0, H, device="cuda")).to(dtype),
              torch.ones(H, device="cuda", dtype=dtype),
              (0.1 * torch.randn(H, generator=g, device="cuda")).to(dtype))
    return x, dt, b, c, params


def moe_inputs(G, C, dtype, E=40, D=1536, F=512, seed=0):
    """A dispatched buffer [G,C,D] whose second half of rows is zero (an
    expert's unused capacity) and expert weights at the JAX init's scales
    (wg/wu by D^-0.5, wd by F^-0.5), granite-moe widths by default."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    buf = torch.randn(G, C, D, generator=g, device="cuda")
    buf[:, C // 2:] = 0.0
    wg = torch.randn(E, D, F, generator=g, device="cuda") * D ** -0.5
    wu = torch.randn(E, D, F, generator=g, device="cuda") * D ** -0.5
    wd = torch.randn(E, F, D, generator=g, device="cuda") * F ** -0.5
    return [t.to(dtype) for t in (buf, wg, wu, wd)]


def to_device(tree, dev):
    """A parameter tree (nested dicts of tensors) on ``dev``."""
    if isinstance(tree, dict):
        return {k: to_device(v, dev) for k, v in tree.items()}
    return tree.to(dev)


# ----------------------------------------------------------------- phases

def demangle(names):
    """C++ names of the given mangled symbols (cu++filt from the CUDA
    toolkit beside nvcc), or the symbols themselves."""
    from repro_torch.kernels import build
    tool = os.path.join(os.path.dirname(build.nvcc()), "cu++filt")
    if not names or not os.path.isfile(tool):
        return names
    res = subprocess.run([tool], input="\n".join(names), capture_output=True,
                         text=True, timeout=60)
    out = res.stdout.splitlines()
    return out if res.returncode == 0 and len(out) == len(names) else names


def build_phase():
    import re
    from repro_torch.kernels import build
    phase("build")
    took = build.build_all(force=True)
    for name in build.KERNELS:
        print(f"built {name} in {took[name]:.1f}s -> {build.library(name)}")
        lines = build.build_log(name).read_text().splitlines()
        entries = [m.group(1) for m in (re.search(
            r"Compiling entry function '([^']+)'", ln) for ln in lines) if m]
        names = dict(zip(entries, demangle(entries)))
        fn = "?"
        for line in lines:
            m = re.search(r"Function properties for (\S+)", line)
            if m:
                # "void (anonymous namespace)::tc::kernel<(int)128>(...)"
                # -> "tc::kernel<128>"
                fn = re.sub(r"\((int|unsigned int|bool)\)|^void |"
                            r"\(anonymous namespace\)::|<unnamed>::", "",
                            names.get(m.group(1), m.group(1))).split("(")[0]
            elif "registers" in line or "spill" in line:
                print(f"  ptxas {name} {fn}: {line.strip()}")


def check_kernels():
    """Kernel against plain version on the same inputs; returns the worst
    error per kernel, each case printed against its tolerance."""
    import torch
    from repro_torch.kernels import flash_prefill as _fp
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import paged_attention as _pa
    phase("check kernels against their plain versions")
    worst = {k: 0.0 for k in KERNELS}

    def report(name, case, dtype, err, absolute=True):
        """``absolute=False``: a state error relative to its magnitude,
        checked but kept out of the kernel's max_abs_err."""
        tol = TOL[dtype]
        ok = err <= tol
        what = "max_abs_err" if absolute else "max_rel_err"
        print(f"{name} {case} {dtype}: {what}={err:.3e} tol={tol:g} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            fail(f"{name} {case} {dtype} disagrees with its plain version")
        if absolute:
            worst[name] = max(worst[name], err)

    # decode: pad row (-1), page-boundary positions (15, 16, 31, 32), short
    # and long rows, trailing -1 entries on every live row
    lengths = [-1, 0, 15, 16, 31, 32, 100, 517, 1000, 1023]
    for dt in ("float32", "bfloat16"):
        q, kp, vp, pt, qp = decode_inputs(lengths, getattr(torch, dt),
                                          holes=(3, 10, 31))
        poison(q.shape, q.dtype)
        out = ops.paged_decode_attention(q, kp, vp, pt, qp)
        torch.cuda.synchronize()
        want = ref.paged_decode_attention_ref(q.float(), kp.float(),
                                              vp.float(), pt, qp)
        live = torch.tensor([ln >= 0 for ln in lengths], device="cuda")
        err = (out.float() - want)[live].abs().max().item()
        pad = out[~live].float()
        if not (torch.isfinite(out.float()).all() and (pad == 0).all()):
            fail("paged_decode_attention: pad rows must give finite zeros")
        report("paged_decode_attention", f"B={len(lengths)} lengths={lengths}"
               f" table holes 3,10,31 ({_pa.body(q.dtype, 128)} body)", dt,
               err)
    # verify windows: a pad row, starts just before / at / past page
    # boundaries, a window ending at the table's last position (maxp 64)
    for dt in ("float32", "bfloat16"):
        for C in (1, 3, 5):
            starts = [-1, 0, 15, 16, 30, 517, 1024 - C]
            q, kp, vp, pt, qs = verify_inputs(starts, C, getattr(torch, dt),
                                              seed=C)
            poison(q.shape, q.dtype)
            out = ops.paged_verify_attention(q, kp, vp, pt, qs)
            torch.cuda.synchronize()
            want = ref.paged_verify_attention_ref(q.float(), kp.float(),
                                                  vp.float(), pt, qs)
            live = torch.tensor([s0 >= 0 for s0 in starts], device="cuda")
            if not (torch.isfinite(out.float()).all()
                    and (out[~live].float() == 0).all()):
                fail("paged_verify_attention: pad rows must give finite "
                     "zeros")
            report("paged_verify_attention",
                   f"B={len(starts)} C={C} R={C * 16} q_start={starts} "
                   f"({_pa.body(q.dtype, 128)} body)", dt,
                   (out.float() - want)[live].abs().max().item())
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
                   f"window={window} ({_fp.body(q.dtype, 128)} body)", dt,
                   (out.float() - want).abs().max().item())

    # ring-cache decode: an empty row and a pad row (every kv_pos -1), an
    # append-only row, a ring wrapped twice (slot p % S holds p), a row
    # with -1 holes and positions past q_pos, a full ring
    import numpy as np
    S = 1024
    rng = np.random.default_rng(0)
    q_pos = [0, 0, 299, 2 * S + 100, 700, S - 1]
    kv_pos = np.full((len(q_pos), S), -1, np.int32)
    kv_pos[2, :300] = np.arange(300)
    for p in range(q_pos[3] - S + 1, q_pos[3] + 1):
        kv_pos[3, p % S] = p
    kv_pos[4] = rng.integers(0, 900, S)
    kv_pos[4, ::7] = -1
    kv_pos[5] = np.arange(S)
    for dt in ("float32", "bfloat16"):
        check_ring(report, q_pos, kv_pos, getattr(torch, dt), S,
                   (None, 64, 8192))

    # prompt chunks over a 1024-slot buffer holding stale data past every
    # chunk; row 1 starts 3 positions after row 0
    fp_body = {dt: _fp.body(getattr(torch, dt), 128)
               for dt in ("float32", "bfloat16")}
    for dt in ("float32", "bfloat16"):
        for q0 in (0, 16, 300):
            for C in (1, 37, 64, 128):
                for window in ((None, 64) if C == 64 else (None,)):
                    q, k, v = chunk_inputs(2, C, S, getattr(torch, dt),
                                           seed=q0 + C)
                    qs = torch.tensor([q0, q0 + 3], dtype=torch.int32,
                                      device="cuda")
                    out = ops.flash_prefill_chunk(q, k, v, qs, window=window)
                    torch.cuda.synchronize()
                    want = ref.flash_prefill_chunk_ref(q.float(), k.float(),
                                                       v.float(), qs, window)
                    if not torch.isfinite(out.float()).all():
                        fail("flash_prefill_chunk: non-finite output")
                    report("flash_prefill_chunk",
                           f"B=2 C={C} q_start={q0},{q0 + 3} S={S} strided "
                           f"window={window} ({fp_body[dt]} body)", dt,
                           (out.float() - want).abs().max().item())
        # rows that see no key: chunks starting past the buffer's end with
        # a window; row 0's rows all see keys, row 1's first 11 rows do
        q, k, v = chunk_inputs(2, 64, S, getattr(torch, dt), seed=7)
        qs = torch.tensor([S - 34, S + 36], dtype=torch.int32, device="cuda")
        out = ops.flash_prefill_chunk(q, k, v, qs, window=48)
        torch.cuda.synchronize()
        want = ref.flash_prefill_chunk_ref(q.float(), k.float(), v.float(),
                                           qs, 48)
        pos = qs[:, None] + torch.arange(64, device="cuda")
        seen = pos - 47 <= S - 1                       # [B, C]
        if not (torch.isfinite(out.float()).all() and seen[0].all()
                and int(seen[1].sum()) == 11 and (out[~seen] == 0).all()):
            fail("flash_prefill_chunk: rows that see no key must give zeros")
        report("flash_prefill_chunk", f"B=2 C=64 q_start={S - 34},{S + 36} "
               f"S={S} strided window=48, 53 rows without keys exact 0 "
               f"({fp_body[dt]} body)", dt,
               (out.float() - want)[seen].abs().max().item())
    check_hetero_kernels(report)
    return worst


def check_ring(report, q_pos, kv_pos, dtype, S, windows, Hq=32, Hkv=2,
               hd=128):
    """Ring-cache decode attention against its plain version for each
    window, into a NaN-poisoned output: rows that keep no slot must give
    exact zeros, and rows 2.. must keep some."""
    import torch
    from repro_torch.kernels import decode_attention as _da
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import paged_attention as _pa
    q, k, v, kp, qp = ring_inputs(q_pos, kv_pos, dtype, S, Hq=Hq, Hkv=Hkv,
                                  hd=hd)
    _, sps, nsplit = _da.plan(Hq // Hkv, hd, S, dtype)
    for window in windows:
        poison(q.shape, q.dtype)
        out = ops.decode_attention(q, k, v, kp, qp, window=window)
        torch.cuda.synchronize()
        want = ref.decode_attention_ref(q.float(), k.float(), v.float(), kp,
                                        qp, window)
        d = qp[:, None] - kp
        live = ((kp >= 0) & (d >= 0) & (d < (window or 1 << 30))).any(dim=1)
        if not (torch.isfinite(out.float()).all()
                and (out[~live].float() == 0).all() and live[2:].all()):
            fail("decode_attention: empty rows must give finite zeros")
        report("decode_attention", f"Hq={Hq} Hkv={Hkv} hd={hd} "
               f"B={len(q_pos)} S={S} q_pos={list(q_pos)} window={window} "
               f"({_pa.body(dtype, hd)} body, {nsplit} splits of {sps} "
               "slots)", str(dtype).split(".")[-1],
               (out.float() - want)[live].abs().max().item())


def check_hetero_kernels(report):
    """The attention kernels at granite-moe, hymba and smollm head shapes
    (Hq/Hkv 24/8, 25/5, 15/5 at hd 64), and the
    SSD scan, SSD decode step and grouped-expert FFN at the serving runs'
    widths, each against its plain version on the same inputs; the SSD
    decode step also at every other branch of its slab plan, and twice on
    the same inputs, bit for bit."""
    import torch
    from repro_torch.kernels import flash_prefill as _fp
    from repro_torch.kernels import moe_dispatch as _moe
    from repro_torch.kernels import paged_attention as _pa
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import ssd_decode as _ssdd
    from repro_torch.kernels import ssd_scan as _ssd
    import numpy as np
    lengths = [-1, 0, 15, 16, 100, 517, 1023]
    # ring rows as in check_kernels, over a ragged 1000-slot ring
    S = 1000
    q_pos = [0, 0, 299, 2 * S + 100, 700, S - 1]
    kv_pos = np.full((len(q_pos), S), -1, np.int32)
    kv_pos[2, :300] = np.arange(300)
    for p in range(q_pos[3] - S + 1, q_pos[3] + 1):
        kv_pos[3, p % S] = p
    kv_pos[4] = np.random.default_rng(1).integers(0, 900, S)
    kv_pos[4, ::7] = -1
    kv_pos[4, 1] = 690
    kv_pos[5] = np.arange(S)
    for Hq, Hkv in ((24, 8), (25, 5), (15, 5)):
        heads = dict(Hq=Hq, Hkv=Hkv, hd=64)
        for dt in ("float32", "bfloat16"):
            dtype = getattr(torch, dt)
            check_ring(report, q_pos, kv_pos, dtype, S, (None, 64), **heads)
            q, kp, vp, pt, qp = decode_inputs(lengths, dtype, holes=(3, 10),
                                              **heads)
            poison(q.shape, q.dtype)
            out = ops.paged_decode_attention(q, kp, vp, pt, qp)
            want = ref.paged_decode_attention_ref(q.float(), kp.float(),
                                                  vp.float(), pt, qp)
            live = torch.tensor([ln >= 0 for ln in lengths], device="cuda")
            if not (torch.isfinite(out.float()).all()
                    and (out[~live].float() == 0).all()):
                fail("paged_decode_attention: pad rows must give finite zeros")
            report("paged_decode_attention", f"Hq={Hq} Hkv={Hkv} hd=64 "
                   f"lengths={lengths} table holes 3,10 "
                   f"({_pa.body(dtype, 64)} body)", dt,
                   (out.float() - want)[live].abs().max().item())
            starts = [-1, 0, 15, 30, 517, 1024 - 5]
            q, kp, vp, pt, qs = verify_inputs(starts, 5, dtype, **heads)
            poison(q.shape, q.dtype)
            out = ops.paged_verify_attention(q, kp, vp, pt, qs)
            want = ref.paged_verify_attention_ref(q.float(), kp.float(),
                                                  vp.float(), pt, qs)
            live = torch.tensor([s0 >= 0 for s0 in starts], device="cuda")
            if not (torch.isfinite(out.float()).all()
                    and (out[~live].float() == 0).all()):
                fail("paged_verify_attention: pad rows must give finite "
                     "zeros")
            report("paged_verify_attention", f"Hq={Hq} Hkv={Hkv} hd=64 C=5 "
                   f"q_start={starts} ({_pa.body(dtype, 64)} body)", dt,
                   (out.float() - want)[live].abs().max().item())
            q, k, v = prefill_inputs(2, 300, dtype, **heads)
            out = ops.flash_prefill(q, k, v, causal=True)
            want = ref.flash_prefill_ref(q.float(), k.float(), v.float(),
                                         causal=True)
            report("flash_prefill", f"Hq={Hq} Hkv={Hkv} hd=64 B=2 S=300 "
                   f"causal ({_fp.body(dtype, 64)} body)", dt,
                   (out.float() - want).abs().max().item())
            q, k, v = chunk_inputs(2, 37, 1024, dtype, **heads)
            qs = torch.tensor([16, 19], dtype=torch.int32, device="cuda")
            out = ops.flash_prefill_chunk(q, k, v, qs)
            want = ref.flash_prefill_chunk_ref(q.float(), k.float(),
                                               v.float(), qs)
            report("flash_prefill_chunk", f"Hq={Hq} Hkv={Hkv} hd=64 B=2 C=37 "
                   f"q_start=16,19 S=1024 strided ({_fp.body(dtype, 64)} "
                   "body)", dt,
                   (out.float() - want).abs().max().item())
    torch.cuda.synchronize()

    def f32(ts):
        return [t.float() for t in ts]

    for dt in ("float32", "bfloat16"):
        dtype = getattr(torch, dt)
        for B, T, H, P, N in ((1, 256, 48, 64, 128), (2, 77, 48, 64, 128),
                              (1, 1, 48, 64, 128), (1, 256, 50, 64, 16),
                              (2, 65, 50, 64, 16)):
            x, dtr, b, c, (a_log, d_skip, bias) = ssd_inputs(B, T, H, P, N,
                                                             dtype, seed=T)
            poison((B, T, H, P), dtype)
            y, h = ops.ssd_scan(x, dtr, a_log, b, c, d_skip, bias)
            torch.cuda.synchronize()
            yw, hw = ref.ssd_scan_ref(*f32((x, dtr, a_log, b, c, d_skip,
                                            bias)))
            if not (torch.isfinite(y.float()).all() and torch.isfinite(h).all()
                    and y.shape == x.shape and h.shape == (B, H, P, N)):
                fail("ssd_scan: non-finite or misshapen output")
            case = (f"B={B} T={T} H={H} P={P} N={N} strided "
                    f"({_ssd.body(dtype, P, N)} body)")
            report("ssd_scan", case + f" y (max |y| "
                   f"{yw.abs().max().item():.2f})", dt,
                   (y.float() - yw).abs().max().item())
            scale = max(1.0, hw.abs().max().item())
            report("ssd_scan", case + " final state, fp32, over max(1, |h|)",
                   "float32", (h - hw).abs().max().item() / scale, False)
        # mamba2-780m's and hymba-1.5b's widths, then every other branch
        # of the slab plan: the reduced configs' width, N/4 = 3 (row sums
        # in shared memory), P = 80 (a ragged last slab), N = 256 (a 64 KB
        # tile, N/4 past a warp)
        for H, P, N in ((48, 64, 128), (50, 64, 16), (4, 32, 16),
                        (4, 24, 12), (4, 80, 64), (2, 64, 256)):
            B, S = 8, 16
            x, dtr, b, c, (a_log, d_skip, bias) = ssd_inputs(B, 1, H, P, N,
                                                             dtype, seed=H)
            args = (x[:, 0], dtr[:, 0], a_log, b[:, 0], c[:, 0], d_skip, bias)
            g = torch.Generator(device="cuda").manual_seed(N)
            arena = 0.5 * torch.randn(S, H, P, N, generator=g, device="cuda")
            slots = torch.tensor([5, 0, -1, 9, 3, 12, 7, 15], dtype=torch.int32,
                                 device="cuda")
            active = torch.tensor([1, 1, 0, 1, 0, 1, 1, 1], dtype=torch.bool,
                                  device="cuda")
            st_k, st_p, st_2 = arena.clone(), arena.clone(), arena.clone()
            y = ops.ssd_decode_step(*args, st_k, slots, active)
            y2 = ops.ssd_decode_step(*args, st_2, slots, active)
            torch.cuda.synchronize()
            if not (torch.equal(y, y2) and torch.equal(st_k, st_2)):
                fail("ssd_decode_step: two calls on the same inputs differ")
            yw = ref.ssd_decode_step_ref(*f32(args), st_p, slots, active)
            live = slots >= 0
            untouched = [s_ for s_ in range(S) if s_ not in (5, 0, 9, 12, 7, 15)]
            if not ((y[~live] == 0).all() and torch.equal(st_k[untouched],
                                                          arena[untouched])):
                fail("ssd_decode_step: a pad row gave output or an unwritten "
                     "slot changed")
            case = (f"B={B} H={H} P={P} N={N} arena={S} pad+inactive rows, "
                    f"two calls bit for bit ({_ssdd.body(P, N)})")
            report("ssd_decode_step", case + " y", dt,
                   (y.float() - yw)[live].abs().max().item())
            scale = max(1.0, st_p.abs().max().item())
            report("ssd_decode_step", case + " arena after, fp32, over "
                   "max(1, |h|)", "float32",
                   (st_k - st_p).abs().max().item() / scale, False)
            # the slot engine's layout: the arena is one layer of its slot
            # cache, row b at slot b, the spare row past them untouched,
            # some rows inactive
            B = 16
            x, dtr, b, c, _ = ssd_inputs(B, 1, H, P, N, dtype, seed=H + 1)
            args = (x[:, 0], dtr[:, 0], a_log, b[:, 0], c[:, 0], d_skip, bias)
            arena = 0.5 * torch.randn(B + 1, H, P, N, generator=g,
                                      device="cuda")
            slots = torch.arange(B, dtype=torch.int32, device="cuda")
            active = torch.ones(B, dtype=torch.bool, device="cuda")
            active[1::3] = False
            st_k, st_p = arena.clone(), arena.clone()
            y = ops.ssd_decode_step(*args, st_k, slots, active)
            torch.cuda.synchronize()
            yw = ref.ssd_decode_step_ref(*f32(args), st_p, slots, active)
            keep = torch.cat([~active, torch.ones(1, dtype=torch.bool,
                                                  device="cuda")])
            if not torch.equal(st_k[keep], arena[keep]):
                fail("ssd_decode_step: an inactive row or the spare row of "
                     "the slot layout changed")
            case = (f"B={B} H={H} P={P} N={N} slot-cache layout (row b at "
                    f"slot b, spare row) {int((~active).sum())} inactive rows "
                    f"({_ssdd.body(P, N)})")
            report("ssd_decode_step", case + " y", dt,
                   (y.float() - yw).abs().max().item())
            scale = max(1.0, st_p.abs().max().item())
            report("ssd_decode_step", case + " arena after, fp32, over "
                   "max(1, |h|)", "float32",
                   (st_k - st_p).abs().max().item() / scale, False)
        for G, C in ((40, 64), (80, 37)):
            buf, wg, wu, wd = moe_inputs(G, C, dtype, seed=C)
            poison(buf.shape, dtype)
            out = ops.moe_grouped_ffn(buf, wg, wu, wd)
            torch.cuda.synchronize()
            want = ref.moe_grouped_ffn_ref(*f32((buf, wg, wu, wd)))
            if not (torch.isfinite(out.float()).all()
                    and (out[:, C // 2:] == 0).all()):
                fail("moe_grouped_ffn: zero rows must give zero rows")
            report("moe_grouped_ffn", f"G={G} E=40 C={C} D=1536 F=512 "
                   f"zero rows, no counts ({_moe.body(dtype)} body)", dt,
                   (out.float() - want).abs().max().item())
            # live-row counts: a skewed decode routing of 8 tokens (top-8
            # of 40, five experts favoured: most experts empty), and
            # per-example buffers with empty, full and ragged groups; rows
            # past a count hold NaN (never read) and must come out 0
            g = torch.Generator(device="cuda").manual_seed(G + C)
            if G == 40:
                logits = torch.randn(8, 40, generator=g, device="cuda")
                logits[:, :5] += 3.0
                picks = logits.topk(8).indices.flatten()
                counts = torch.bincount(picks, minlength=40).int()
                what = "skewed decode routing"
            else:
                counts = torch.randint(0, C + 1, (G,), generator=g,
                                       device="cuda", dtype=torch.int32)
                counts[::5] = 0
                counts[1], counts[2] = C, 13
                what = "per-example groups"
            dead = (torch.arange(C, device="cuda")[None, :]
                    >= counts[:, None])
            buf = buf.masked_fill(dead[..., None], float("nan"))
            poison(buf.shape, dtype)
            out = ops.moe_grouped_ffn(buf, wg, wu, wd, counts)
            torch.cuda.synchronize()
            want = ref.moe_grouped_ffn_ref(*f32((buf, wg, wu, wd)), counts)
            if not (torch.isfinite(out.float()).all()
                    and (out[dead] == 0).all()):
                fail("moe_grouped_ffn: rows past a count must give exact "
                     "zeros")
            report("moe_grouped_ffn", f"G={G} E=40 C={C} D=1536 F=512 "
                   f"{what}: {int((counts == 0).sum())} empty groups, "
                   f"{int(counts.sum())} live rows, NaN past each count "
                   f"({_moe.body(dtype)} body)", dt,
                   (out.float() - want)[~dead].abs().max().item())
            del buf, wg, wu, wd, out, want


def check_engine():
    """Reduced edge-6b engines on the card against the same engines (same
    weights, same tasks) on the CPU: prefill and decode logits in fp32 and
    identical greedy streams. Paged with atomic and with chunked prefill,
    slot with chunked prefill (masked decode) and slot with compacted
    decode."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core.task import SLOSpec, Task
    from repro_torch.models import model as M
    from repro_torch.serving.executor import PagedTorchExecutor, TorchExecutor
    phase("check reduced engines on the card against the CPU")
    cfg = get_config("edge-6b").reduced()
    params = M.init_params(cfg, seed=0, device="cpu")
    engines = {
        "paged": lambda p, d: PagedTorchExecutor(
            cfg, params=p, n_pages=32, page_size=16, max_seq=128,
            max_batch=4, device=d),
        "paged chunked": lambda p, d: PagedTorchExecutor(
            cfg, params=p, n_pages=32, page_size=16, max_seq=128,
            max_batch=4, device=d, prefill_chunk_size=16),
        "slot chunked": lambda p, d: TorchExecutor(
            cfg, params=p, max_slots=4, max_seq=128, device=d,
            prefill_chunk_size=16),
        "slot compact": lambda p, d: TorchExecutor(
            cfg, params=p, max_slots=4, max_seq=128, device=d,
            compact_buckets=True),
    }
    for name, make in engines.items():
        on = {}
        for dev in ("cpu", "cuda"):
            p = to_device(params, dev)
            on[dev] = make(p, dev)
        tasks = [Task(SLOSpec(tpot_ms=100.0), 1.0, prompt_len=n, output_len=8,
                      task_id=7000 + i) for i, n in enumerate((5, 17, 40))]
        worst = 0.0
        for t in tasks:
            for ex in on.values():
                if ex.prefill_chunk_size is None:
                    ex.prefill(t)
                else:
                    while not ex.prefill_chunk(t, 16)[1]:
                        pass
            worst = max(worst, float(np.abs(
                on["cuda"].last_prefill_logits
                - on["cpu"].last_prefill_logits).max()))
        for step in range(3):
            batch = tasks if step != 1 else tasks[1:]
            for ex in on.values():
                ex.decode(batch)
            got = on["cuda"].last_logits
            if (got.shape != (len(batch), cfg.vocab_size)
                    or not np.isfinite(got).all()):
                fail(f"{name}: logits shape {got.shape} or non-finite values")
            worst = max(worst, float(np.abs(got - on["cpu"].last_logits).max()))
        streams = {d: [ex.generated_tokens(t) for t in tasks]
                   for d, ex in on.items()}
        print(f"engine {name} cuda vs cpu: max |logit diff|={worst:.3e} "
              f"tol=1e-4 streams_equal={streams['cuda'] == streams['cpu']}")
        if worst > 1e-4 or streams["cuda"] != streams["cpu"]:
            fail(f"reduced {name} engine on the card disagrees with the CPU")


def check_engine_features():
    """Speculative decoding, prefix sharing and KV swap on reduced edge-6b
    engines on the card against the same engines on the CPU (fp32, same
    weights, same tasks): logits within 1e-4 and identical greedy streams.
    The spec streams must also equal depth-0 decode on the card, and a
    swapped task's K/V must come back bit for bit."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.task import SLOSpec, Task
    from repro_torch.models import model as M
    from repro_torch.serving.executor import PagedTorchExecutor
    phase("check spec, prefix and swap engines on the card against the CPU")
    cfg = get_config("edge-6b").reduced()
    params = M.init_params(cfg, seed=0, device="cpu")
    base = dict(n_pages=48, page_size=16, max_seq=128, max_batch=4)

    def on(dev, **kw):
        p = to_device(params, dev)
        if kw.pop("self_draft", False):
            kw.update(draft_cfg=cfg, draft_params=p)
        return PagedTorchExecutor(cfg, params=p, device=dev, **base, **kw)

    def tasks_of(base_id, prompts, out, group=None, prefix=0):
        ts = [Task(SLOSpec(tpot_ms=100.0), 1.0, prompt_len=n, output_len=out,
                   task_id=base_id + i) for i, n in enumerate(prompts)]
        for t in ts:
            t.prefix_group, t.prefix_len = group, prefix
        return ts

    def compare(name, pair, tasks, worst):
        streams = {d: [ex.generated_tokens(t) for t in tasks]
                   for d, ex in pair.items()}
        print(f"engine {name} cuda vs cpu: max |logit diff|={worst:.3e} "
              f"tol=1e-4 streams_equal={streams['cuda'] == streams['cpu']}")
        if worst > 1e-4 or streams["cuda"] != streams["cpu"]:
            fail(f"reduced {name} engine on the card disagrees with the CPU")
        return streams["cuda"]

    def diff(pair, attr):
        return float(np.abs(getattr(pair["cuda"], attr)
                            - getattr(pair["cpu"], attr)).max())

    # speculative decoding, self-draft, depths across the K buckets
    pair = {d: on(d, spec_decode=True, self_draft=True, max_spec_depth=4)
            for d in ("cpu", "cuda")}
    tasks = tasks_of(7100, (5, 17, 40), 40)
    worst = 0.0
    for t in tasks:
        for ex in pair.values():
            ex.prefill(t)
        worst = max(worst, diff(pair, "last_prefill_logits"))
    for depths in ([4, 0, 2], [1, 3, 0], [2, 2, 2], [0, 4, 1], [3, 1, 4]):
        for ex in pair.values():
            ex.decode(tasks, depths)
        # commits may differ on a near-tie between the draft's and the
        # target's argmax; the streams may not
        worst = max(worst, diff(pair, "last_logits"))
    spec = compare("paged spec (self-draft)", pair, tasks, worst)
    plain = on("cuda")
    for t in tasks:
        plain.prefill(t)
    for _ in range(max(len(s) for s in spec)):
        plain.decode(tasks)
    depth0 = [plain.generated_tokens(t)[: len(s)] for t, s in zip(tasks, spec)]
    print(f"spec streams ({[len(x) for x in spec]} tokens) equal depth-0 "
          f"streams: {depth0 == spec}; verify steps "
          f"{pair['cuda'].spec_steps}, accepted "
          f"{pair['cuda'].accepted_tokens}/{pair['cuda'].drafted_tokens}")
    if depth0 != spec or pair["cuda"].spec_steps == 0:
        fail("spec engine on the card: streams differ from depth-0 decode")

    # prefix-shared prefill and decode: two pages shared, one private tail
    pair = {d: on(d, prefix_cache=True) for d in ("cpu", "cuda")}
    tasks = tasks_of(7200, (40, 40, 45), 8, group=3, prefix=32)
    worst = 0.0
    for t in tasks:
        for ex in pair.values():
            ex.prefill(t)
        worst = max(worst, diff(pair, "last_prefill_logits"))
    for step in range(3):
        for ex in pair.values():
            ex.decode(tasks if step != 1 else tasks[1:])
        worst = max(worst, diff(pair, "last_logits"))
    compare("paged prefix-shared", pair, tasks, worst)
    hits = pair["cuda"].prefix_cache.hits
    for ex in pair.values():
        for t in tasks:
            ex.release(t)
        ex.prefix_cache.clear()
        ex.pool.check()
    if hits != 2 or pair["cuda"].pool.used_pages != 0:
        fail(f"prefix engine: {hits} hits (2 expected) or pages leaked")

    # suspend / resume against the never-suspended engine on the card
    pair = {d: on(d) for d in ("cpu", "cuda")}
    ref_ex = on("cuda")
    tasks = tasks_of(7300, (18, 33), 8)
    for t in tasks:
        for ex in (*pair.values(), ref_ex):
            ex.prefill(t)

    def kv(ex, t):
        idx = torch.as_tensor(ex.pool.page_table(t.task_id), device="cuda")
        return [ex.pages[n][:, idx].clone() for n in ("k_pages", "v_pages")]

    for ex in (*pair.values(), ref_ex):
        ex.decode(tasks)
    before = kv(pair["cuda"], tasks[0])
    for ex in pair.values():
        ex.suspend(tasks[0])
    for ex in (*pair.values(), ref_ex):
        ex.decode(tasks[1:])
    for ex in pair.values():
        ex.resume(tasks[0])
    same_kv = all(torch.equal(a, b)
                  for a, b in zip(kv(pair["cuda"], tasks[0]), before))
    worst, vs_ref = 0.0, 0.0
    for _ in range(2):
        for ex in (*pair.values(), ref_ex):
            ex.decode(tasks)
        worst = max(worst, diff(pair, "last_logits"))
        vs_ref = max(vs_ref, float(np.abs(pair["cuda"].last_logits
                                          - ref_ex.last_logits).max()))
    compare("paged suspend/resume", pair, tasks, worst)
    print(f"swap: restored K/V bit for bit: {same_kv}; logits after resume "
          f"vs never-suspended on the card: max diff {vs_ref:.3e}; "
          f"swapped {pair['cuda'].swapped_bytes:.0f} B")
    if not same_kv or vs_ref > 0.0:
        fail("suspend/resume on the card changed the task's K/V or logits")


def check_hetero_engines():
    """Reduced mamba2-780m (SSM), hymba-1.5b (hybrid) and
    granite-moe-3b-a800m (MoE) paged engines on the card against the same
    engines on the CPU (fp32, same weights, same tasks): prefill and
    decode logits within 1e-4 and identical greedy streams, across a
    suspend/resume after which the task's SSM state, conv tail and K/V
    pages are bit for bit what they were; no page or state slot left
    held."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.task import SLOSpec, Task
    from repro_torch.models import model as M
    from repro_torch.serving.executor import PagedTorchExecutor
    phase("check SSM, hybrid and MoE engines on the card against the CPU")
    for arch in ("mamba2-780m", "hymba-1.5b", "granite-moe-3b-a800m"):
        cfg = get_config(arch).reduced()
        params = M.init_params(cfg, seed=0, device="cpu")
        on = {d: PagedTorchExecutor(cfg, params=to_device(params, d),
                                    n_pages=48, page_size=16, max_seq=128,
                                    max_batch=4, device=d)
              for d in ("cpu", "cuda")}
        # a 2-token prompt leaves the conv tail left-padded
        tasks = [Task(SLOSpec(tpot_ms=100.0), 1.0, prompt_len=n, output_len=8,
                      task_id=7400 + i) for i, n in enumerate((5, 17, 40, 2))]
        worst = 0.0

        def diff(attr):
            return float(np.abs(getattr(on["cuda"], attr)
                                - getattr(on["cpu"], attr)).max())

        def state_of(ex, t):
            snap = []
            if cfg.has_attention:
                idx = torch.as_tensor(ex.pool.page_table(t.task_id),
                                      device=ex.device)
                snap += [ex.pages[n][:, idx].clone()
                         for n in ("k_pages", "v_pages")]
            if ex.states is not None:
                slot = ex.states.slot_of(t.task_id)
                snap += [ex.pages[n][:, slot].clone()
                         for n in ("ssm_state", "conv_state")]
            return snap

        for t in tasks:
            for ex in on.values():
                ex.prefill(t)
            worst = max(worst, diff("last_prefill_logits"))
        same = True
        for step in range(5):
            if step == 1:
                before = state_of(on["cuda"], tasks[0])
                for ex in on.values():
                    ex.suspend(tasks[0])
            if step == 3:
                for ex in on.values():
                    ex.resume(tasks[0])
                same = all(torch.equal(a, b) for a, b in
                           zip(before, state_of(on["cuda"], tasks[0])))
            batch = tasks[1:] if step in (1, 2) else tasks
            for ex in on.values():
                ex.decode(batch)
            got = on["cuda"].last_logits
            if (got.shape != (len(batch), cfg.vocab_size)
                    or not np.isfinite(got).all()):
                fail(f"{arch}: logits shape {got.shape} or non-finite values")
            worst = max(worst, diff("last_logits"))
        streams = {d: [ex.generated_tokens(t) for t in tasks]
                   for d, ex in on.items()}
        for ex in on.values():
            for t in tasks:
                ex.release(t)
            ex.store.check()
        leaked = on["cuda"].store.leaked()
        print(f"engine {arch}-smoke cuda vs cpu: max |logit diff|="
              f"{worst:.3e} tol=1e-4 streams_equal="
              f"{streams['cuda'] == streams['cpu']}; suspend/resume restored "
              f"{'state and pages' if cfg.has_ssm else 'pages'} bit for bit: "
              f"{same}; swapped {on['cuda'].swapped_bytes:.0f} B; held after "
              f"release {leaked}")
        if (worst > 1e-4 or streams["cuda"] != streams["cpu"] or not same
                or leaked):
            fail(f"reduced {arch} engine on the card disagrees with the CPU, "
                 "changed a swapped task or leaked")


def check_slot_ssm_engines():
    """Reduced mamba2-780m (SSM) and hymba-1.5b (hybrid) slot engines on
    the card against the same engines on the CPU (fp32, same weights,
    same tasks), masked and compacted decode: prefill (one prompt of 2
    tokens, shorter than the conv width), decode steps under a changing
    active set, a release and a new task in the freed slot; prefill and
    decode logits within 1e-4, greedy streams identical, every slot free
    at the end. Steps captured on the card (the engines' default)."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core.task import SLOSpec, Task
    from repro_torch.models import model as M
    from repro_torch.serving.executor import TorchExecutor
    phase("check SSM and hybrid slot engines on the card against the CPU")
    for arch in ("mamba2-780m", "hymba-1.5b"):
        cfg = get_config(arch).reduced()
        params = M.init_params(cfg, seed=0, device="cpu")
        for compact in (False, True):
            on = {d: TorchExecutor(cfg, params=to_device(params, d),
                                   max_slots=3, max_seq=128, device=d,
                                   compact_buckets=compact)
                  for d in ("cpu", "cuda")}
            tasks = [Task(SLOSpec(tpot_ms=100.0), 1.0, prompt_len=n,
                          output_len=16, task_id=7500 + i)
                     for i, n in enumerate((2, 17, 40, 9))]
            worst = 0.0

            def diff(attr):
                return float(np.abs(getattr(on["cuda"], attr)
                                    - getattr(on["cpu"], attr)).max())

            for t in tasks[:3]:
                for ex in on.values():
                    ex.prefill(t)
                worst = max(worst, diff("last_prefill_logits"))
            live = tasks[:3]
            for step, sel in enumerate(((0, 1, 2), (1, 2), (2,), (0, 2),
                                        (0, 1, 2), "reuse", (0, 1, 2),
                                        (0, 2))):
                if sel == "reuse":      # task 3 takes task 0's slot
                    for ex in on.values():
                        ex.release(live[0])
                        ex.prefill(tasks[3])
                    worst = max(worst, diff("last_prefill_logits"))
                    live = [tasks[3]] + live[1:]
                    continue
                batch = [live[i] for i in sel]
                for ex in on.values():
                    ex.decode(batch)
                got = on["cuda"].last_logits
                if (got.shape != (len(batch), cfg.vocab_size)
                        or not np.isfinite(got).all()):
                    fail(f"{arch} slot: logits shape {got.shape} or "
                         "non-finite values")
                worst = max(worst, diff("last_logits"))
            streams = {d: [ex.generated_tokens(t) for t in live]
                       for d, ex in on.items()}
            reused = on["cuda"].slot_of[tasks[3].task_id] == 0
            for ex in on.values():
                for t in live:
                    ex.release(t)
            name = f"{arch}-smoke slot {'compacted' if compact else 'masked'}"
            print(f"engine {name} cuda vs cpu: max |logit diff|={worst:.3e} "
                  f"tol=1e-4 streams_equal="
                  f"{streams['cuda'] == streams['cpu']}; slot reused: "
                  f"{reused}; free after release "
                  f"{sorted(on['cuda'].free)}")
            if (worst > 1e-4 or streams["cuda"] != streams["cpu"]
                    or not reused or sorted(on["cuda"].free) != [0, 1, 2]):
                fail(f"reduced {name} engine on the card disagrees with the "
                     "CPU or kept a slot")


def check_ring_prefill():
    """The ring branch of prefill (a prompt longer than its 64-slot buffer,
    the reduced configs' sliding window) on the card against the CPU,
    reduced hymba-1.5b and smollm-360m at S = 100 and 200 over two rows,
    then four decode steps on the ring: logits, K/V within 1e-4, kv_pos
    exact (the tail's positions at p % 64)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    phase("check the ring prefill on the card against the CPU")
    ring = 64
    for arch in ("hymba-1.5b", "smollm-360m"):
        cfg = get_config(arch).reduced()
        if cfg.sliding_window != ring:
            fail(f"{arch} reduced: window {cfg.sliding_window}, {ring} "
                 "expected")
        params = {d: to_device(M.init_params(cfg, seed=0, device="cpu"), d)
                  for d in ("cpu", "cuda")}
        for S in (100, 200):
            toks = torch.from_numpy(np.random.default_rng(S).integers(
                0, cfg.vocab_size, (2, S))).int()
            out = {d: M.prefill(cfg, params[d], toks.to(d), buf_len=ring)
                   for d in ("cpu", "cuda")}
            worst, kv_err, pos_ok = 0.0, 0.0, True
            for step in range(5):
                (lc, cc), (lg, cg) = out["cpu"], out["cuda"]
                worst = max(worst, (lg.cpu() - lc).abs().max().item())
                for k in ("k", "v"):
                    kv_err = max(kv_err, (cg[k].cpu() - cc[k]).abs().max()
                                 .item())
                pos_ok &= torch.equal(cg["kv_pos"].cpu(), cc["kv_pos"])
                if step == 0:
                    want = np.full(ring, -1)
                    for pp in range(S - ring, S):
                        want[pp % ring] = pp
                    pos_ok &= bool((cc["kv_pos"][0].numpy() == want).all())
                if step == 4:
                    break
                tok = lc.argmax(-1).int()
                out = {d: M.decode_step(cfg, params[d], out[d][1],
                                        tok.to(d)) for d in ("cpu", "cuda")}
            print(f"ring prefill {arch}-smoke S={S} buf_len={ring} + 4 "
                  f"decode steps, cuda vs cpu: max |logit diff|={worst:.3e} "
                  f"max |K/V diff|={kv_err:.3e} tol=1e-4 kv_pos equal and "
                  f"the tail's: {pos_ok}")
            if worst > 1e-4 or kv_err > 1e-4 or not pos_ok:
                fail(f"ring prefill of {arch} on the card disagrees with the "
                     "CPU")


def check_fleet_gate():
    """``engine_fleet`` of reduced mamba2-780m and granite-moe-3b-a800m
    on the card (fp32, steps captured) under the structural gate of
    ``benchmarks/fleet_routing.py``: each instance keeps its cache kind,
    every request served exactly once, no page or state slot left held, no
    quality request served below its tier floor."""
    from repro_torch.core.task import SLOSpec, control_task, qa_task
    from repro_torch.kernels import ops
    from repro_torch.serving.fleet import engine_fleet, run_fleet_loop
    phase("check a reduced heterogeneous fleet on the card (the structural "
          "gate)")
    router = engine_fleet(["mamba2-780m", "granite-moe-3b-a800m"],
                          n_pages=48, page_size=8, max_seq=96, max_batch=4,
                          seed=0, device="cuda")
    kinds = tuple(i.executor.store.kinds for i in router.instances)
    scale = max(max(i.lat.decode_ms(2) for i in router.instances) / 50.0,
                0.02)
    tasks = []
    for k in range(3):
        tasks.append(control_task(arrival_ms=40.0 * k, prompt_len=10,
                                  output_len=8))
        q = qa_task(arrival_ms=70.0 * k, prompt_len=14, output_len=10)
        q.min_tier = 1
        tasks.append(q)
    for t in tasks:                       # the benchmark's relaxation
        t.slo.tpot_ms *= scale * 4
        t.slo.ttft_ms *= max(scale, 1.0)
        if t.slo.deadline_ms:
            t.slo = SLOSpec.realtime_deadline(
                t.slo.deadline_ms * max(scale, 1.0) * 4, t.output_len)
    ops.reset_launches()
    res = run_fleet_loop(router, tasks, max_ms=3e7)
    launches = {k: v for k, v in ops.LAUNCHES.items() if v}
    unserved = sum(1 for t in res.tasks if not t.finished and not t.dropped)
    n_inst = sum(len(lr.tasks) for lr in res.per_instance.values())
    leaked = 0
    for inst in router.instances:
        inst.executor.store.check()
        leaked += inst.executor.store.leaked()
    floor_ok = all(t.served_tier >= 1 for t in tasks if t.min_tier >= 1)
    print(f"hetero fleet (mamba2-780m, granite-moe-3b-a800m reduced) on the "
          f"card: kinds {kinds}, unserved {unserved}, per-instance tasks "
          f"{n_inst} of {len(tasks)}, leaked {leaked}, spills {res.spills}, "
          f"quality served at tier >= 1: {floor_ok}; launches {launches}")
    if (kinds != (("state",), ("kv",)) or unserved or n_inst != len(tasks)
            or leaked or not floor_ok):
        fail("the reduced heterogeneous fleet failed the structural gate")


def async_drive(ex, tasks, spare, observe):
    """The scripted sequence the sync and async engines both run: prefill
    three tasks, decode across the batch buckets 4 -> 1 -> 4, a suspend
    issued while a decode is in flight, then (when the engine chunks) a
    chunked prefill of ``spare``, whose chunk step is captured while the
    suspension's copy may still be in flight, decode the others, resume,
    one speculative iteration (when the engine drafts), then decode all.
    ``observe`` is called at a few points (each commits what is
    pending)."""
    for t in tasks:
        ex.prefill(t)
    observe("prefill", ex.last_prefill_logits)
    for n in (3, 3, 1, 1, 3, 3):
        ex.decode(tasks[:n])
    observe("bucket change", ex.last_logits)
    ex.decode(tasks)
    ex.suspend(tasks[0])                     # behind the in-flight decode
    if ex.prefill_chunk_size is not None:
        while not ex.prefill_chunk(spare, ex.prefill_chunk_size)[1]:
            pass
        observe("chunked prefill", ex.last_prefill_logits)
    for _ in range(2):
        ex.decode(tasks[1:])
    ex.resume(tasks[0])
    ex.decode(tasks)
    observe("suspend/resume", ex.last_logits)
    if ex.prefill_chunk_size is not None:
        tasks = tasks + [spare]
    if ex.draft is not None:
        ex.decode(tasks, [2] * len(tasks))
        observe("spec decode", ex.last_logits)
    for _ in range(3):
        ex.decode(tasks)
    ex.drain()
    observe("end", ex.last_logits)
    return tasks


def check_async_engines():
    """The async pipelined engine against the synchronous one on the card
    (reduced edge-6b, fp32, steps captured, same weights, chunked prefill
    and speculative decoding on): one scripted sequence (``async_drive``),
    logits bit for bit at every observed point, greedy streams equal, the
    pool consistent and the ledger idle after drain()."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core.task import SLOSpec, Task
    from repro_torch.models import model as M
    from repro_torch.serving.executor import PagedTorchExecutor
    phase("check the async engine against the sync engine on the card")
    cfg = get_config("edge-6b").reduced()
    params = M.init_params(cfg, seed=0, device="cuda")
    out = {}
    for async_dispatch in (False, True):
        ex = PagedTorchExecutor(cfg, params=params, n_pages=64, page_size=16,
                                max_seq=128, max_batch=4, device="cuda",
                                prefill_chunk_size=16, spec_decode=True,
                                max_spec_depth=2,
                                async_dispatch=async_dispatch)
        tasks = [Task(SLOSpec(tpot_ms=100.0), 1.0, prompt_len=n,
                      output_len=40, task_id=7600 + i)
                 for i, n in enumerate((5, 17, 40, 29))]
        seen = []
        tasks = async_drive(ex, tasks[:3], tasks[3],
                            lambda what, a: seen.append((what, a)))
        ex.pool.check()
        ex.ledger.check()
        out[async_dispatch] = dict(
            seen=seen, streams=[ex.generated_tokens(t) for t in tasks],
            stalls=ex.gap_stats.stalls, idle=ex.ledger.outstanding() == 0,
            swaps=ex.ledger.started, stage_waits=ex.graphs.stage_waits)
    sync, asy = out[False], out[True]
    same = all(np.array_equal(a, b) for (_, a), (_, b) in
               zip(sync["seen"], asy["seen"]))
    print(f"engine async vs sync (reduced edge-6b, captured): logits bit for "
          f"bit at {[w for w, _ in asy['seen']]}: {same}; streams_equal="
          f"{sync['streams'] == asy['streams']}; stalls {asy['stalls']}, "
          f"transfers {asy['swaps']}, staging waits {asy['stage_waits']}, "
          f"ledger idle {asy['idle']}")
    if (not same or sync["streams"] != asy["streams"] or not asy["idle"]
            or asy["stalls"] == 0 or asy["swaps"] != 1):
        fail("the async engine on the card disagrees with the sync engine")


ASYNC_STEPS = 32          # timed steady-state decode steps at b=8


def async_graphs_phase():
    """The async engine at full width (edge-6b paged, bf16, captured)
    against the synchronous one on the same weights: the scripted drive
    (``async_drive`` over 3 tasks, no chunking or drafting) and then
    ASYNC_STEPS decode steps at b=8 over 8 tasks, greedy streams bit for
    bit; prints both modes' engine clock per step (the host time of the
    steps, the async drive's ending in drain()), the async dispatch ms,
    staging waits (must be 0) and commit waits (at most one a stall) per
    step."""
    import gc

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.task import SLOSpec, Task
    from repro_torch.models import model as M
    from repro_torch.serving.executor import PagedTorchExecutor
    phase("graphs: the async engine against the sync engine, full width "
          "(bf16)")
    cfg = get_config("edge-6b")
    params = M.init_params(cfg, seed=0, dtype=torch.bfloat16, device="cuda")
    out = {}
    for async_dispatch in (False, True):
        ex = PagedTorchExecutor(cfg, params=params, n_pages=512, page_size=16,
                                max_seq=1024, max_batch=8, device="cuda",
                                async_dispatch=async_dispatch)
        tasks = [Task(SLOSpec(tpot_ms=100.0), 1.0, prompt_len=96 + 9 * i,
                      output_len=512, task_id=9800 + i) for i in range(8)]
        async_drive(ex, tasks[:3], None, lambda what, a: None)
        for t in tasks[3:]:
            ex.prefill(t)
        for _ in range(3):                   # warm the b=8 step
            ex.decode(tasks)
        ex.drain()
        torch.cuda.synchronize()
        g = ex.graphs
        w0 = (g.stage_waits, g.commit_waits, ex.gap_stats.stalls)
        t0 = time.perf_counter()
        disp = sum(ex.decode(tasks) for _ in range(ASYNC_STEPS))
        # the waits of the dispatch loop; the drain's commits come after
        w1 = (g.stage_waits, g.commit_waits, ex.gap_stats.stalls)
        ex.drain()
        wall = (time.perf_counter() - t0) * 1e3
        out[async_dispatch] = dict(
            ms=wall / ASYNC_STEPS, disp=disp / ASYNC_STEPS,
            stage=w1[0] - w0[0], commit=w1[1] - w0[1],
            stalls=w1[2] - w0[2], drained=g.commit_waits - w1[1],
            streams=[ex.generated_tokens(t) for t in tasks])
        del ex
        gc.collect()
        torch.cuda.empty_cache()
    params = None
    gc.collect()
    torch.cuda.empty_cache()
    sync, asy = out[False], out[True]
    same = sync["streams"] == asy["streams"]
    print(f"edge-6b paged b=8, {ASYNC_STEPS} steps: engine clock sync "
          f"{sync['ms']:.3f} ms/step, async {asy['ms']:.3f} ms/step "
          f"(dispatch {asy['disp']:.3f} ms/step); async host waits per step "
          f"while dispatching: staging {asy['stage'] / ASYNC_STEPS:.2f}, "
          f"commits {asy['commit'] / ASYNC_STEPS:.2f} ({asy['commit']} over "
          f"{asy['stalls']} stalls), then {asy['drained']} in the drain; "
          f"streams_equal={same} ({sum(map(len, asy['streams']))} tokens)")
    if not same:
        fail("full-width async engine: streams differ from the sync engine")
    if asy["stage"] or asy["commit"] > asy["stalls"]:
        fail("full-width async engine: host waits beyond the commits its "
             "queue's depth forces")


# (case, arch, engine, engine arguments, batch sizes, verify depth): the
# decode-type steps the serving engines capture, at full width in bf16
GRAPH_CASES = (
    ("edge-6b paged", "edge-6b", "paged", {}, (1, 2, 4, 8), None),
    ("edge-6b verify", "edge-6b", "paged",
     {"spec_decode": True, "max_spec_depth": 4}, (4,), 4),
    ("edge-6b slot masked", "edge-6b", "slot", {}, (1, 2, 4, 8), None),
    ("edge-6b slot compacted", "edge-6b", "slot", {"compact_buckets": True},
     (1, 2, 4, 8), None),
    ("mamba2-780m paged", "mamba2-780m", "paged", {}, (1, 2, 4, 8), None),
    ("mamba2-780m slot masked", "mamba2-780m", "slot", {}, (1, 2, 4, 8),
     None),
    ("mamba2-780m slot compacted", "mamba2-780m", "slot",
     {"compact_buckets": True}, (1, 2, 4, 8), None),
    ("granite-moe paged", "granite-moe-3b-a800m", "paged", {}, (1, 2, 4, 8),
     None),
    ("hymba-1.5b slot masked", "hymba-1.5b", "slot", {}, (1, 2, 4, 8), None),
    ("hymba-1.5b slot compacted", "hymba-1.5b", "slot",
     {"compact_buckets": True}, (1, 2, 4, 8), None),
)
GRAPH_STEPS = 16          # compared steps an engine, spread over its batches
SPREAD_STEPS = 20         # timed steps at the case's largest batch
# (case, arch, engine, engine arguments, how, prompt lengths): the
# prefill-type steps the serving engines capture, at full width in bf16.
# "whole": one step per prompt length; "chunk": prefill_chunk over the
# whole prompt in pieces of 64; "suffix": a prompt whose first 192
# tokens (12 pages) another task of its prefix group left in the radix
# cache, so its 58-token suffix runs in pieces 32, 16, 8 and 2
PREFILL_CASES = (
    ("edge-6b whole prefill", "edge-6b", "paged", {}, "whole",
     (64, 128, 256)),
    ("mamba2-780m whole prefill", "mamba2-780m", "paged", {}, "whole",
     (64, 128, 256)),
    ("granite-moe whole prefill", "granite-moe-3b-a800m", "paged", {},
     "whole", (64, 128, 256)),
    ("edge-6b slot whole prefill", "edge-6b", "slot", {}, "whole", (256,)),
    ("edge-6b paged chunks of 64", "edge-6b", "paged",
     {"prefill_chunk_size": 64}, "chunk", (256,)),
    ("edge-6b slot chunks of 64", "edge-6b", "slot",
     {"prefill_chunk_size": 64}, "chunk", (256,)),
    ("edge-6b prefix suffix", "edge-6b", "paged", {"prefix_cache": True},
     "suffix", (250,)),
    ("mamba2-780m slot whole prefill", "mamba2-780m", "slot", {}, "whole",
     (64, 128, 256)),
    ("hymba-1.5b slot whole prefill", "hymba-1.5b", "slot", {}, "whole",
     (64, 128, 256)),
)
PREFILL_REPS = 5          # timed prompts an engine at each length


def graphs_phase():
    """Each decode-type step the engines capture (paged decode of edge-6b,
    mamba2-780m and granite-moe at b = 1, 2, 4, 8; edge-6b's verify step
    at b = 4, K = 4; the slot engine's masked and compacted steps over 16
    slots) run by two engines on the same weights and tasks: one eager
    (``cuda_graphs=False``), one captured. GRAPH_STEPS steps each: logits
    within the bf16 TOL, greedy streams identical (dense, SSM, MoE: the
    MoE combine has no atomics), launch counts equal; then SPREAD_STEPS
    more at the largest batch for the step-time spread. Prints both
    engines' l(b) (median of the steps at each b), the spread and the
    peak memory with and without graphs."""
    import gc

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.task import SLOSpec, Task
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.serving.executor import PagedTorchExecutor, TorchExecutor
    phase("graphs: captured steps against eager, full width "
          "(bf16)")
    bf16 = torch.bfloat16
    params, params_of = None, None
    for case, arch, kind, kw, batches, depth in GRAPH_CASES:
        cfg = get_config(arch)
        if params_of != arch:
            params = None
            gc.collect()
            torch.cuda.empty_cache()
            params = M.init_params(cfg, seed=0, dtype=bf16, device="cuda")
            params_of = arch
        per_b = GRAPH_STEPS // len(batches)
        plan = [b for b in batches for _ in range(per_b)]
        out = {}
        for graphs in (False, True):
            torch.cuda.reset_peak_memory_stats()
            if kind == "slot":
                ex = TorchExecutor(cfg, params=params, max_slots=16,
                                   max_seq=1024, device="cuda",
                                   cuda_graphs=graphs, **kw)
            else:
                ex = PagedTorchExecutor(cfg, params=params, n_pages=512,
                                        page_size=16, max_seq=1024,
                                        max_batch=8, device="cuda",
                                        cuda_graphs=graphs, **kw)
            tasks = [Task(SLOSpec(tpot_ms=100.0), 1.0, prompt_len=96 + 9 * i,
                          output_len=512, task_id=9500 + i) for i in range(8)]
            for t in tasks:
                ex.prefill(t)
            ops.reset_launches()
            logits, ms = [], {}
            for b in plan:
                d = None if depth is None else [depth] * b
                ms.setdefault(b, []).append(ex.decode(tasks[:b], d))
                logits.append(ex.last_logits)
            launches = dict(ops.LAUNCHES)
            top = batches[-1]
            d = None if depth is None else [depth] * top
            spread = sorted(ex.decode(tasks[:top], d)
                            for _ in range(SPREAD_STEPS))
            torch.cuda.synchronize()
            out[graphs] = dict(
                logits=logits, launches=launches, spread=spread,
                lb={b: float(np.median(v)) for b, v in ms.items()},
                streams=[ex.generated_tokens(t) for t in tasks],
                peak=torch.cuda.max_memory_allocated(),
                steps=len(ex.graphs.steps) + len(
                    ex.draft.graphs.steps if getattr(ex, "draft", None)
                    else ()))
            del ex
            gc.collect()
            torch.cuda.empty_cache()
        eager, cap = out[False], out[True]
        err = max(float(np.abs(a - b).max())
                  for a, b in zip(eager["logits"], cap["logits"]))
        same = eager["streams"] == cap["streams"]
        print(f"{case}: {GRAPH_STEPS} steps, max |logit diff| captured vs "
              f"eager {err:.3e} tol={TOL['bfloat16']:g}, streams_equal="
              f"{same}, launches equal={eager['launches'] == cap['launches']}"
              f" ({sum(cap['launches'].values())} launches, "
              f"{cap['steps']} steps captured)")
        print(f"{case}: l(b) eager / captured: " + " ".join(
            f"l({b})={eager['lb'][b]:.3f}/{cap['lb'][b]:.3f}ms"
            for b in batches) + (f" (verify K={depth})" if depth else ""))
        for name, r in (("eager", eager), ("captured", cap)):
            sp = r["spread"]
            print(f"{case}: {name} step at b={batches[-1]} over "
                  f"{SPREAD_STEPS} steps: min {sp[0]:.3f} median "
                  f"{float(np.median(sp)):.3f} max {sp[-1]:.3f} ms; peak "
                  f"memory {r['peak'] / 2**30:.2f} GiB")
        if err > TOL["bfloat16"] or not same:
            fail(f"{case}: the captured step disagrees with the eager step")
        if eager["launches"] != cap["launches"]:
            fail(f"{case}: launches captured {cap['launches']} != eager "
                 f"{eager['launches']}")
    for case in PREFILL_CASES:
        if params_of != case[1]:
            params = None
            gc.collect()
            torch.cuda.empty_cache()
            params = M.init_params(get_config(case[1]), seed=0, dtype=bf16,
                                   device="cuda")
            params_of = case[1]
        prefill_graph_case(params, *case)
    params = None
    gc.collect()
    torch.cuda.empty_cache()


def prefill_graph_case(params, case, arch, kind, kw, how, lengths):
    """One prefill-type case of the graphs phase: an eager engine and a
    captured one on the same weights run PREFILL_REPS prompts of each
    length ``how`` ("whole", "chunk" or "suffix"), then 4 decode steps
    over the first 8 of them. Logits of every prefill within the bf16
    TOL, greedy streams identical, launch counts equal; prints each
    length's engine clock (min / median of the reps; a captured step is
    captured at its first prompt, before the clock) and the peak memory
    with and without graphs."""
    import gc

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.task import SLOSpec, Task
    from repro_torch.kernels import ops
    from repro_torch.serving.executor import PagedTorchExecutor, TorchExecutor
    cfg = get_config(arch)
    out = {}
    for graphs in (False, True):
        torch.cuda.reset_peak_memory_stats()
        if kind == "slot":
            ex = TorchExecutor(cfg, params=params, max_slots=16,
                               max_seq=1024, device="cuda",
                               cuda_graphs=graphs, **kw)
        else:
            ex = PagedTorchExecutor(cfg, params=params, n_pages=512,
                                    page_size=16, max_seq=1024,
                                    max_batch=8, device="cuda",
                                    cuda_graphs=graphs, **kw)
        tasks, logits, ms = [], [], {}
        ops.reset_launches()
        if how == "suffix":         # the prefix group's first task, untimed
            first = Task(SLOSpec(tpot_ms=100.0), 1.0, prompt_len=lengths[0],
                         output_len=64, task_id=9699)
            first.prefix_group, first.prefix_len = 5, 192
            ex.prefill(first)
            ex.release(first)
        for L in lengths:
            for r in range(PREFILL_REPS):
                t = Task(SLOSpec(tpot_ms=100.0), 1.0, prompt_len=L,
                         output_len=64, task_id=9700 + len(tasks))
                if how == "suffix":
                    t.prefix_group, t.prefix_len = 5, 192
                if how == "chunk":
                    took, done = ex.prefill_chunk(t, L)
                    if not done:
                        fail(f"{case}: prefill_chunk({L}) left the prompt "
                             "unfinished")
                else:
                    took = ex.prefill(t)
                ms.setdefault(L, []).append(took)
                logits.append(ex.last_prefill_logits)
                tasks.append(t)
        for t in tasks[8:]:
            ex.release(t)
        tasks = tasks[:8]
        for _ in range(4):
            ex.decode(tasks)
        torch.cuda.synchronize()
        out[graphs] = dict(
            logits=logits, ms=ms, launches=dict(ops.LAUNCHES),
            streams=[ex.generated_tokens(t) for t in tasks],
            peak=torch.cuda.max_memory_allocated(),
            steps=sorted(k for k in ex.graphs.steps if k[0] in (
                "prefill", "chunk")),
            hits=getattr(getattr(ex, "prefix_cache", None), "hits", None))
        del ex
        gc.collect()
        torch.cuda.empty_cache()
    eager, cap = out[False], out[True]
    err = max(float(np.abs(a - b).max())
              for a, b in zip(eager["logits"], cap["logits"]))
    same = eager["streams"] == cap["streams"]
    print(f"{case}: {len(cap['logits'])} prompts, max |logit diff| captured "
          f"vs eager {err:.3e} tol={TOL['bfloat16']:g}, streams_equal={same}"
          f", launches equal={eager['launches'] == cap['launches']} "
          f"({sum(cap['launches'].values())} launches), steps captured "
          f"{cap['steps']}" + (f", prefix hits {cap['hits']}"
                               if cap["hits"] is not None else ""))
    for L in lengths:
        e, c = sorted(eager["ms"][L]), sorted(cap["ms"][L])
        print(f"{case}: {how} prefill of {L} tokens, engine clock eager / "
              f"captured: min {e[0]:.3f} / {c[0]:.3f} ms, median "
              f"{float(np.median(e)):.3f} / {float(np.median(c)):.3f} ms "
              f"(of {PREFILL_REPS})")
    print(f"{case}: peak memory eager / captured "
          f"{eager['peak'] / 2**30:.2f} / {cap['peak'] / 2**30:.2f} GiB")
    if err > TOL["bfloat16"] or not same:
        fail(f"{case}: the captured steps disagree with the eager steps")
    if eager["launches"] != cap["launches"]:
        fail(f"{case}: launches captured {cap['launches']} != eager "
             f"{eager['launches']}")
    if how == "suffix" and not (eager["hits"] == cap["hits"]
                                == PREFILL_REPS):
        fail(f"{case}: prefix hits {eager['hits']} / {cap['hits']}, "
             f"{PREFILL_REPS} expected")


def serve_phase(run_name, extra, required):
    """One serving run through the serve entry point; returns, by run
    name, what the time phase needs of it (the engine's shapes and the
    tasks) and the run's launch counts, and frees the engine. A fleet run
    gives one entry per instance, ``run/arch``, with the launches made
    inside that instance's engine."""
    import gc

    import numpy as np
    import torch
    from repro_torch.core.task import SLOSpec, Task
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.serving.metrics import summarize
    with tempfile.TemporaryDirectory() as tmp:
        trace_path = os.path.join(tmp, "trace.json")
        argv = SERVE_ARGS + [a.replace("{trace}", trace_path) for a in extra]
        args = serve.parse_args(argv)
        phase(f"serve {run_name}: {args.fleet or args.arch} at full width "
              "(bf16) under SLICE")
        print("serve args:", " ".join(argv))
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        ops.reset_launches()
        with (launches_by_engine() if args.fleet
              else contextlib.nullcontext({})) as by_engine:
            run = serve.run(args)
        launches = dict(ops.LAUNCHES)
        wall = time.perf_counter() - t0
        if isinstance(run, serve.FleetRun):
            out = check_fleet_run(run_name, run, launches, by_engine, wall,
                                  trace_path, required)
            del run                      # the engines: reference cycles
            gc.collect()
            torch.cuda.empty_cache()
            return out
        if run.trace is not None:
            check_trace(run, trace_path)
    ex, res = run.executor, run.result
    peak = torch.cuda.max_memory_allocated()
    print("l(b) curve: " + " ".join(f"l({b})={ms:.3f}ms" for b, ms in run.probes))
    print(f"served n={len(res.tasks)} prefills={res.prefills} "
          f"prefill_chunks={res.prefill_chunks} "
          f"decode_iters={res.decode_iterations} loop_clock={res.end_ms:.1f}ms "
          f"wall={wall:.1f}s max_memory_allocated={peak} "
          f"({peak / 2**30:.2f} GiB)")
    print(f"launches in the {run_name} run: {launches}")
    att = summarize(res.tasks)
    print(f"attainment: realtime {att['realtime'].slo:.1%} of "
          f"{att['realtime'].n}, non-realtime {att['non_realtime'].slo:.1%} "
          f"of {att['non_realtime'].n}")
    unfinished = [t.task_id for t in res.tasks if t.dropped or not t.finished]
    if not res.tasks or unfinished:
        fail(f"{run_name}: tasks not finished: {unfinished} of "
             f"{len(res.tasks)}")
    pool = getattr(ex, "pool", None)
    cache = getattr(ex, "prefix_cache", None)
    if cache is not None:
        print(f"prefix cache: hits={cache.hits} misses={cache.misses} "
              f"hit_tokens={cache.hit_tokens} pages_indexed="
              f"{cache.pages_indexed}")
        if cache.hits == 0:
            fail(f"{run_name}: no prompt hit the prefix cache")
        cache.clear()
    if pool is not None:
        ex.store.check()
        if pool.used_pages != 0 or pool.owners() or ex.store.leaked():
            fail(f"{run_name}: leak: {pool.used_pages} pages held by "
                 f"{pool.owners()}, {ex.store.leaked()} pages and state "
                 "slots held")
        if ex.states is not None:
            print(f"state slots: {ex.n_state_slots} of "
                  f"{ex.store.state_bytes} B each, all free at the end")
    elif ex.slot_of:
        fail(f"{run_name}: slots still held by {sorted(ex.slot_of)}")
    logits = ex.last_logits
    if (logits is None or logits.shape[1] != ex.cfg.vocab_size
            or not np.isfinite(logits).all()):
        fail(f"{run_name}: last decode logits missing, misshapen or "
             "non-finite")
    for name in required:
        if launches[name] <= 0:
            fail(f"{run_name}: kernel {name} was not launched on its path")
    # engine clock of one prompt of the workload's longest effective
    # length, whole or in chunks, min of 3, on the idle engine
    L = max(min(t.prompt_len, ex.max_seq // 2) for t in res.tasks)
    probe_ms = []
    for i in range(3):
        t = Task(SLOSpec(tpot_ms=100.0), 1.0, prompt_len=L, output_len=1,
                 task_id=9000 + i)
        t1 = time.perf_counter()
        probe_ms.append(ex.prefill(t) if args.prefill_chunk is None
                        else ex.prefill_chunk(t, L)[0])
        if getattr(ex, "async_dispatch", False):   # dispatch ms: drain
            ex.drain()
            probe_ms[-1] = (time.perf_counter() - t1) * 1e3
        ex.release(t)
    how = ("whole" if args.prefill_chunk is None
           else f"in chunks of {args.prefill_chunk}")
    print(f"prefill of {L} prompt tokens {how}: {min(probe_ms):.3f} ms "
          f"(min of {', '.join(f'{m:.3f}' for m in probe_ms)})")
    shapes = {"cfg": ex.cfg, "max_seq": ex.max_seq, "tasks": res.tasks,
              "chunk": args.prefill_chunk}
    if args.spec_decode:
        print(f"speculative decoding: verify steps={ex.spec_steps} "
              f"spec_extra={res.spec_extra_tokens} "
              f"accepted/drafted={res.accepted_tokens}/{res.drafted_tokens}"
              f" draft slots reclaimed={ex.draft.reclaimed_slots}")
        if ex.spec_steps == 0 or ex.last_verify is None:
            fail(f"{run_name}: SLICE granted no depth: no verify step ran")
        C, rows, verify_ms = ex.last_verify
        print(f"last verify step served: C={C} rows' lengths={rows} "
              f"{verify_ms:.3f} ms")
        spec_probe(ex, L)
        shapes["window"] = ex.spec_depth + 1
    if pool is not None:
        shapes.update(batch=ex.max_batch, n_pages=ex.n_pages,
                      page_size=ex.page_size, maxp=ex.max_pages_per_seq)
    else:
        shapes.update(batch=ex.max_slots)
    del run, ex, res, pool, cache
    gc.collect()
    torch.cuda.empty_cache()
    return {run_name: (shapes, launches)}


@contextlib.contextmanager
def launches_by_engine():
    """Tally the growth of ``ops.LAUNCHES`` by the paged engine whose
    constructor or public method (the outermost, if they nest) was
    running: yields {id(engine): {kernel: n}}, filled as the engines run.
    Every launch of a serving run happens inside one of these calls: the
    steps are dispatched there, captured graphs replayed there."""
    from repro_torch.kernels import ops
    from repro_torch.serving.executor import PagedTorchExecutor as cls
    by, depth, saved = {}, [0], {}

    def wrap(fn):
        @functools.wraps(fn)
        def inner(self, *a, **kw):
            if depth[0]:
                return fn(self, *a, **kw)
            before = dict(ops.LAUNCHES)
            depth[0] += 1
            try:
                return fn(self, *a, **kw)
            finally:
                depth[0] -= 1
                tally = by.setdefault(id(self), dict.fromkeys(ops.LAUNCHES, 0))
                for k, n in ops.LAUNCHES.items():
                    tally[k] += n - before[k]
        return inner

    names = {n for k in cls.__mro__[:-1] for n, f in vars(k).items()
             if inspect.isfunction(f) and (n == "__init__"
                                           or not n.startswith("_"))}
    for n in names:
        saved[n] = vars(cls).get(n)
        setattr(cls, n, wrap(getattr(cls, n)))
    try:
        yield by
    finally:
        for n, f in saved.items():
            if f is None:
                delattr(cls, n)
            else:
                setattr(cls, n, f)


def check_fleet_run(run_name, run, launches, by_engine, wall, path,
                    required):
    """The traced fleet run: every task finishes; the per-instance results
    partition the tasks; each instance's pool ends empty; each QA task is
    served on the top tier or counted among the degraded routings; the
    event stream replays the merged result and each instance's track its
    own; the Perfetto file loads back; the run's kernels launched; the
    launches made inside each instance's engine sum to the run's. Prints
    each instance's l(b), its share of the traffic and its launches.
    Returns what the time phase reads of each instance, as ``run/arch``:
    its engine's shapes, the tasks it served and its launches."""
    import torch
    from repro_torch.serving.metrics import per_tier, summarize
    from repro_torch.serving.trace import events_conserved, replay_counters
    router, res, tr = run.router, run.result, run.trace
    peak = torch.cuda.max_memory_allocated()
    for inst in router.instances:
        print(f"l(b) curve of {inst.name} (tier {inst.tier}, quality "
              f"{inst.quality:g}): " + " ".join(
                  f"l({b})={ms:.3f}ms" for b, ms in run.probes[inst.name]))
    m = res.merged
    print(f"served n={len(res.tasks)} prefills={m.prefills} "
          f"decode_iters={m.decode_iterations} loop_clock={res.end_ms:.1f}ms "
          f"wall={wall:.1f}s max_memory_allocated={peak} "
          f"({peak / 2**30:.2f} GiB); admissions {res.admissions}, spills "
          f"{res.spills}, degraded {res.degraded}, defers "
          f"{dict(m.defers_by_reason)}")
    att = summarize(res.tasks)
    print(f"attainment: realtime {att['realtime'].slo:.1%} of "
          f"{att['realtime'].n}, non-realtime {att['non_realtime'].slo:.1%} "
          f"of {att['non_realtime'].n}; per serving instance " + ", ".join(
              f"{n} {a.n} tasks {a.slo:.1%}"
              for n, a in per_tier(res.tasks).items()))
    print(f"launches in the {run_name} run: {launches}")
    unfinished = [t.task_id for t in res.tasks if t.dropped or not t.finished]
    if not res.tasks or unfinished:
        fail(f"{run_name}: tasks not finished: {unfinished} of "
             f"{len(res.tasks)}")
    ids = sorted(t.task_id for r in res.per_instance.values()
                 for t in r.tasks)
    if ids != sorted(t.task_id for t in res.tasks):
        fail(f"{run_name}: the per-instance results do not partition the "
             "tasks")
    top = max(i.tier for i in router.instances)
    low_qa = sum(1 for t in res.tasks
                 if t.kind == "qa" and t.served_tier < top)
    if low_qa > res.degraded:
        fail(f"{run_name}: {low_qa} QA tasks served below tier {top}, only "
             f"{res.degraded} routings degraded")
    for inst in router.instances:
        ex = inst.executor
        ex.store.check()
        if ex.pool.used_pages or ex.pool.owners() or ex.store.leaked():
            fail(f"{run_name}: {inst.name} leaked {ex.pool.used_pages} "
                 f"pages held by {ex.pool.owners()}")
    conserved = events_conserved(tr.events, m)
    tracks = sorted(i for i in tr.instances() if i != "fleet")
    per = [replay_counters(tr.events, instance=i) for i in tr.instances()]
    merged = replay_counters(tr.events)
    tracks_sum = all(merged[k] == sum(q[k] for q in per)
                     for k in ("finished", "decode_iterations", "prefills"))
    with open(path) as f:
        rows = len(json.load(f)["traceEvents"])
    print(f"trace: {len(tr)} events ({tr.dropped} dropped), {rows} Perfetto "
          f"rows read back, {len(tr.snapshots)} snapshots, tracks {tracks}; "
          f"events_conserved={conserved}; per-track replays sum to the "
          f"merged one: {tracks_sum}; QA served below tier {top}: {low_qa}")
    if (not conserved or not tracks_sum or tr.dropped or not rows
            or tracks != sorted(i.name for i in router.instances)):
        fail(f"{run_name}: the event stream does not reproduce the fleet's "
             "counters, or the Perfetto file is empty")
    for name in required:
        if launches[name] <= 0:
            fail(f"{run_name}: kernel {name} was not launched on its path")
    out = {}
    for inst in router.instances:
        ex = inst.executor
        own = by_engine.get(id(ex), dict.fromkeys(launches, 0))
        print(f"launches inside {inst.name}'s engine: "
              f"{ {k: n for k, n in own.items() if n} }")
        out[f"{run_name}/{inst.name}"] = (
            {"cfg": ex.cfg, "max_seq": ex.max_seq, "chunk": None,
             "tasks": res.per_instance[inst.name].tasks or res.tasks,
             "batch": ex.max_batch, "n_pages": ex.n_pages,
             "page_size": ex.page_size, "maxp": ex.max_pages_per_seq}, own)
    if len(by_engine) != len(router.instances) or any(
            sum(o[1][k] for o in out.values()) != launches[k]
            for k in launches):
        fail(f"{run_name}: the launches inside the instances' engines do "
             f"not sum to the run's {launches}")
    return out


def check_trace(run, path):
    """The traced async serve run: the replay ledger reproduces the loop's
    counters, the Perfetto file loads back, the pipeline counters are
    there (stalls, a positive dispatch time) and the engine is idle."""
    from repro_torch.serving.trace import events_conserved, replay_counters
    tr, res, ex = run.trace, run.result, run.executor
    conserved = events_conserved(tr.events, res)
    with open(path) as f:
        doc = json.load(f)
    rows = len(doc["traceEvents"])
    kinds = sorted({e.kind for e in tr.events})
    print(f"trace: {len(tr)} events ({tr.dropped} dropped), {rows} Perfetto "
          f"rows read back, {len(tr.snapshots)} snapshots, kinds {kinds}; "
          f"events_conserved={conserved}; replayed "
          f"{replay_counters(tr.events)['decode_iterations']} decode steps")
    print(f"pipeline: stalls={res.pipeline_stalls} dispatch_ms="
          f"{res.dispatch_ms:.3f} wait_ms={res.wait_ms:.3f} schedule_ms="
          f"{res.schedule_ms:.3f} swap_overlap_ms={res.swap_overlap_ms:.3f} "
          f"host_gap_ms={res.dispatch_ms + res.wait_ms:.3f}; staging waits "
          f"{ex.graphs.stage_waits}, commit waits {ex.graphs.commit_waits}")
    if not conserved or tr.dropped or not rows:
        fail("traced run: the event stream does not reproduce the loop's "
             "counters, or the Perfetto file is empty")
    if res.dispatch_ms <= 0 or len(ex._queue) or ex.ledger.outstanding():
        fail("async run: no dispatch time booked, or steps or transfers "
             "left in flight")


def spec_probe(ex, L, b=4, depth=4, reps=3):
    """Engine clock of a speculative iteration (draft of ``depth`` tokens,
    one verify step of depth+1 queries, acceptance) beside a plain decode
    step, both at batch b over b prompts of L tokens, min of ``reps`` each,
    on the idle engine; the first iteration (the draft's catch-up) is not
    counted."""
    from repro_torch.core.task import SLOSpec, Task
    tasks = [Task(SLOSpec(tpot_ms=100.0), 1.0, prompt_len=L, output_len=64,
                  task_id=9100 + i) for i in range(b)]
    for t in tasks:
        ex.prefill(t)
    ex.decode(tasks, [depth] * b)
    plain, spec, commits, verify_ms = [], [], [], []
    for _ in range(reps):
        plain.append(ex.decode(tasks))
        spec.append(ex.decode(tasks, [depth] * b))
        commits.append(sum(ex.last_commits))
        verify_ms.append(ex.last_verify[2])
    for t in tasks:
        ex.release(t)
    print(f"at b={b}: verify step ({depth + 1} queries a row) "
          f"{min(verify_ms):.3f} ms; whole speculative iteration (draft, "
          f"verify, acceptance) {min(spec):.3f} ms committing {commits} "
          f"tokens; plain decode step l({b}) {min(plain):.3f} ms committing "
          f"{b} (min of {reps}: verify "
          f"{', '.join(f'{m:.3f}' for m in verify_ms)}; iteration "
          f"{', '.join(f'{m:.3f}' for m in spec)}; decode "
          f"{', '.join(f'{m:.3f}' for m in plain)})")


# ---------------------------------------------------------------- sharded

# edge-6b's heads a rank (query, KV) over 2 ranks (the paged-mesh run's)
# and over 4 (8 query heads and the one KV head they read)
MESH_HEADS = ((16, 1), (8, 1))
# (b): fp32 logits of the 2-rank engine against the single-process one.
# TF32 is off, so each product is fp32 on both sides; the ranks sum a
# row-parallel product's two halves (K = 2048 or 6848 each) after cuBLAS
# has summed each half, where the single engine sums all K in one call: a
# reordering of fp32 sums, ~sqrt(K) * 2^-24 relative per product, through
# 28 layers and the final norm. This check measured 1.3e-5 on an H100
# 80GB HBM3 at 700 W; the tolerance leaves 8x room, and the greedy
# streams beside it are compared exactly
MESH_TOL = 1e-4
MESH_ENGINE = dict(n_pages=64, page_size=16, max_seq=512, max_batch=4)
MESH_PROMPTS = (37, 100, 201)       # (b): prompt lengths, then 16 steps
MESH_STEPS = 16


def check_sharded_kernels(worst):
    """(a) The four paged-path kernels against their plain versions at the
    heads a rank of edge-6b holds over 2 and 4 ranks, fp32 and bf16, with
    the check phase's cases: pad rows and -1 table entries, page-boundary
    positions, verify windows of C = 1, 3, 5, prefill at ragged lengths,
    chunks at q_start 0/16/300 through the strides of a slot buffer."""
    import torch
    from repro_torch.kernels import flash_prefill as _fp
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import paged_attention as _pa
    phase("sharded (a): the paged-path kernels at edge-6b's heads a rank")

    def report(name, case, dt, err):
        ok = err <= TOL[dt]
        print(f"{name} {case} {dt}: max_abs_err={err:.3e} tol={TOL[dt]:g} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            fail(f"{name} {case} {dt} disagrees with its plain version at "
                 "a rank's heads")
        worst[name] = max(worst[name], err)

    lengths = [-1, 0, 15, 16, 31, 32, 100, 517, 1000, 1023]
    for Hq, Hkv in MESH_HEADS:
        heads = dict(Hq=Hq, Hkv=Hkv)
        for dt in ("float32", "bfloat16"):
            dtype = getattr(torch, dt)
            body = _pa.body(dtype, 128)
            q, kp, vp, pt, qp = decode_inputs(lengths, dtype, holes=(3, 10),
                                              **heads)
            poison(q.shape, q.dtype)
            out = ops.paged_decode_attention(q, kp, vp, pt, qp)
            torch.cuda.synchronize()
            want = ref.paged_decode_attention_ref(q.float(), kp.float(),
                                                  vp.float(), pt, qp)
            live = torch.tensor([ln >= 0 for ln in lengths], device="cuda")
            if not (torch.isfinite(out.float()).all()
                    and (out[~live].float() == 0).all()):
                fail("paged_decode_attention: pad rows must give finite "
                     "zeros at a rank's heads")
            report("paged_decode_attention", f"Hq={Hq} Hkv={Hkv} B=10 "
                   f"lengths={lengths} holes 3,10 ({body} body)", dt,
                   (out.float() - want)[live].abs().max().item())
            for C in (1, 3, 5):
                starts = [-1, 0, 15, 16, 30, 517, 1024 - C]
                q, kp, vp, pt, qs = verify_inputs(starts, C, dtype, seed=C,
                                                  **heads)
                poison(q.shape, q.dtype)
                out = ops.paged_verify_attention(q, kp, vp, pt, qs)
                torch.cuda.synchronize()
                want = ref.paged_verify_attention_ref(q.float(), kp.float(),
                                                      vp.float(), pt, qs)
                live = torch.tensor([s0 >= 0 for s0 in starts],
                                    device="cuda")
                if not (torch.isfinite(out.float()).all()
                        and (out[~live].float() == 0).all()):
                    fail("paged_verify_attention: pad rows must give finite "
                         "zeros at a rank's heads")
                report("paged_verify_attention",
                       f"Hq={Hq} Hkv={Hkv} B=7 C={C} q_start={starts} "
                       f"({body} body)", dt,
                       (out.float() - want)[live].abs().max().item())
            fbody = _fp.body(dtype, 128)
            for B, S in ((2, 77), (1, 1000), (1, 1)):
                q, k, v = prefill_inputs(B, S, dtype, **heads)
                out = ops.flash_prefill(q, k, v, causal=True)
                torch.cuda.synchronize()
                want = ref.flash_prefill_ref(q.float(), k.float(), v.float(),
                                             causal=True)
                if not torch.isfinite(out.float()).all():
                    fail("flash_prefill: non-finite output at a rank's heads")
                report("flash_prefill", f"Hq={Hq} Hkv={Hkv} B={B} S={S} "
                       f"causal ({fbody} body)", dt,
                       (out.float() - want).abs().max().item())
            for q0 in (0, 16, 300):
                for C in (1, 64):
                    q, k, v = chunk_inputs(2, C, 1024, dtype, seed=q0 + C,
                                           **heads)
                    qs = torch.tensor([q0, q0 + 3], dtype=torch.int32,
                                      device="cuda")
                    out = ops.flash_prefill_chunk(q, k, v, qs)
                    torch.cuda.synchronize()
                    want = ref.flash_prefill_chunk_ref(q.float(), k.float(),
                                                       v.float(), qs, None)
                    if not torch.isfinite(out.float()).all():
                        fail("flash_prefill_chunk: non-finite output at a "
                             "rank's heads")
                    report("flash_prefill_chunk",
                           f"Hq={Hq} Hkv={Hkv} B=2 C={C} q_start={q0},"
                           f"{q0 + 3} S=1024 strided ({fbody} body)", dt,
                           (out.float() - want).abs().max().item())


# (e): the grouped-expert FFN at a rank's slab of granite-moe (D 1536,
# F 512, 40 experts, top-8): expert-parallel over 2 and 4 ranks (E_local,
# F) and inside each expert (all 40 experts, the d_ff columns of 2 and 4
# ranks); the decode layout of 8 tokens (one group an expert, C = 8 x 8)
# and the per-example layout of 2 examples of 200 tokens (C = int(200 x 8
# / 40 x 1.25 + 0.999) = 50, from the whole layer's 40 experts)
MOE_SLABS = ((20, 512), (10, 512), (40, 256), (40, 128))
MOE_LAYOUTS = (("decode", 1, 64), ("per-example", 2, 50))


def check_sharded_moe(worst):
    """(e) moe_grouped_ffn against its plain version, fp32 and bf16, at the
    MOE_SLABS slabs in both MOE_LAYOUTS: live-row counts that include 0
    and C, rows past a count NaN (never read; they must come out exact
    0). Each case is timed with CUDA events beside its bound (the weights
    of the experts with live rows, the live rows in and out, the counts;
    6 flop a live row's weight) and beside the chain of batched matmuls
    over the same buffer (a yardstick, not one library call). Returns the
    bf16 cases' numbers."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import moe_dispatch as _moe
    from repro_torch.kernels import ops, ref
    from repro_torch.launch.timing import time_ms
    phase("sharded (e): the grouped-expert FFN at a rank's slab of "
          "granite-moe")
    D, out = 1536, []
    for dt in ("float32", "bfloat16"):
        dtype = getattr(torch, dt)
        elt = torch.finfo(dtype).bits // 8
        for E, Fd in MOE_SLABS:
            for layout, B, C in MOE_LAYOUTS:
                G = B * E
                buf, wg, wu, wd = moe_inputs(G, C, dtype, E=E, D=D, F=Fd,
                                             seed=E + Fd + C)
                g = torch.Generator(device="cuda").manual_seed(G + Fd)
                counts = torch.randint(0, C + 1, (G,), generator=g,
                                       device="cuda", dtype=torch.int32)
                counts[::4] = 0
                counts[1] = C
                dead = (torch.arange(C, device="cuda")[None, :]
                        >= counts[:, None])
                buf = buf.masked_fill(dead[..., None], float("nan"))
                poison(buf.shape, dtype)
                got = ops.moe_grouped_ffn(buf, wg, wu, wd, counts)
                torch.cuda.synchronize()
                want = ref.moe_grouped_ffn_ref(buf.float(), wg.float(),
                                               wu.float(), wd.float(), counts)
                if not (torch.isfinite(got.float()).all()
                        and (got[dead] == 0).all()):
                    fail("moe_grouped_ffn: rows past a count must give exact "
                         "zeros at a rank's slab")
                err = (got.float() - want)[~dead].abs().max().item()
                used = int((counts.view(B, E).sum(0) > 0).sum())
                live = int(counts.sum())
                nbytes = 3 * used * D * Fd * elt + 2 * live * D * elt + G * 4
                flops = 6 * live * D * Fd
                bound = max(nbytes / HBM_BYTES_PER_S,
                            flops / PEAK_FLOPS[dt]) * 1e3
                by = ("bytes" if nbytes / HBM_BYTES_PER_S
                      >= flops / PEAK_FLOPS[dt] else "operations")
                ms = time_ms(lambda: ops.moe_grouped_ffn(buf, wg, wu, wd,
                                                         counts))
                b4 = buf.nan_to_num().view(B, E, C, D)
                chain_ms = time_ms(lambda: torch.matmul(
                    F.silu(torch.matmul(b4, wg)) * torch.matmul(b4, wu),
                    wd))
                case = (f"{layout} G={G} E_local={E} C={C} D={D} F={Fd}, "
                        f"{int((counts == 0).sum())} empty groups, "
                        f"{int((counts == C).sum())} full, {live} live rows "
                        f"over {used} experts ({_moe.body(dtype)} body)")
                ok = err <= TOL[dt]
                print(f"moe_grouped_ffn {case} {dt}: max_abs_err={err:.3e} "
                      f"tol={TOL[dt]:g} {'ok' if ok else 'FAIL'}; kernel "
                      f"{ms:.4f} ms, bmm chain {chain_ms:.4f} ms, bound "
                      f"{bound:.5f} ms by {by} ({nbytes} B, {flops} flop)",
                      flush=True)
                if not ok:
                    fail(f"moe_grouped_ffn {case} {dt} disagrees with its "
                         "plain version at a rank's slab")
                worst["moe_grouped_ffn"] = max(worst["moe_grouped_ffn"], err)
                if dt == "bfloat16":
                    out.append({"layout": layout, "G": G, "E_local": E,
                                "C": C, "D": D, "F": Fd, "live_rows": live,
                                "experts_used": used, "ms": ms,
                                "bmm_chain_ms": chain_ms, "bound_ms": bound,
                                "bound_by": by, "max_abs_err": err})
                del buf, wg, wu, wd, got, want, b4
    return out


def mesh_ops(ex):
    """(b)'s ops: MESH_PROMPTS prefilled whole, then MESH_STEPS greedy
    decode steps of the three; returns (prefill logits, decode logits,
    streams) and releases the tasks."""
    from repro_torch.core.task import SLOSpec, Task
    tasks = [Task(SLOSpec(tpot_ms=100.0), 1.0, prompt_len=L,
                  output_len=MESH_STEPS + 1, task_id=9100 + i)
             for i, L in enumerate(MESH_PROMPTS)]
    pre, dec = [], []
    for t in tasks:
        ex.prefill(t)
        pre.append(ex.last_prefill_logits)
    for _ in range(MESH_STEPS):
        ex.decode(tasks)
        dec.append(ex.last_logits)
    streams = [ex.generated_tokens(t) for t in tasks]
    for t in tasks:
        ex.release(t)
    return pre, dec, streams


def mesh_rank(rank, arch, shape):
    """A rank of (b) or (f): ``arch`` at full width in fp32 (TF32 off) on
    its slab of a ``shape`` (data, model) mesh, over gloo on the one card,
    eager steps. Returns what mesh_ops saw, the rank's launches during
    them, its heads, the experts it holds, its digest and loop clock (the
    agreed ms of its ops) and any JAX module."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // (shape[0]
                                                             * shape[1])))
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.serving.executor import PagedTorchExecutor
    mesh = make_serving_mesh(data=shape[0], model=shape[1],
                             device=torch.device("cuda", 0))
    ex = PagedTorchExecutor(get_config(arch), mesh=mesh, device="cuda:0",
                            cuda_graphs=False, **MESH_ENGINE)
    ops.reset_launches()
    t0 = time.perf_counter()
    pre, dec, streams = mesh_ops(ex)
    torch.cuda.synchronize()
    moe = ex.params["blocks"].get("moe")
    return {"pre": pre, "dec": dec, "streams": streams, "heads": ex.heads,
            "experts": 0 if moe is None else moe["wg"].shape[1],
            "digest": ex.digest, "clock": ex.gap_stats.wait_ms,
            "launches": dict(ops.LAUNCHES), "s": time.perf_counter() - t0,
            "leaked": sorted(m for m in sys.modules if m == "jax"
                             or m.startswith(("jax.", "repro.")))}


def check_mesh_equivalence(arch="edge-6b", shape=(1, 2), label="(b)"):
    """(b) edge-6b at full width, fp32: the single-process paged engine,
    then 2 ranks over gloo sharing the card, on the same ops: streams
    identical, logits within MESH_TOL, equal launches on the ranks. (f)
    granite-moe the same way on a (2, 2) mesh, 4 ranks: mesh_ops's
    decode bucket of 4 split 2 + 2 over the data groups, each rank on 20
    of the 40 experts; also equal digests and loop clocks on the four
    ranks and the grouped FFN launched on every rank."""
    import gc

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import sharding as S
    from repro_torch.launch.mesh import spawn_ranks
    from repro_torch.serving.executor import PagedTorchExecutor
    data, model = shape
    ways = data * model
    cfg = get_config(arch)
    experts = (cfg.n_experts // model if cfg.block_kind == "moe"
               and cfg.n_experts % model == 0 else cfg.n_experts)
    phase(f"sharded {label}: {arch} fp32, a ({data}, {model}) mesh of "
          f"{ways} ranks over gloo against one engine")
    ex = PagedTorchExecutor(cfg, device="cuda", cuda_graphs=False,
                            **MESH_ENGINE)
    t0 = time.perf_counter()
    pre, dec, streams = mesh_ops(ex)
    torch.cuda.synchronize()
    one_s = time.perf_counter() - t0
    del ex
    gc.collect()
    torch.cuda.empty_cache()
    ranks = spawn_ranks(mesh_rank, ways, (arch, shape), backend="gloo",
                        timeout=300)
    for r, res in enumerate(ranks):
        heads = S.head_slab(cfg, model, r % model)
        if res["leaked"]:
            fail(f"{label} rank {r} imported JAX or the JAX package: "
                 f"{res['leaked'][:5]}")
        if res["heads"] != heads or res["experts"] != experts:
            fail(f"{label} rank {r} holds heads {res['heads']} and "
                 f"{res['experts']} experts, not {heads} and {experts}")
        if res["streams"] != streams:
            fail(f"{label} rank {r}'s greedy streams differ from the single "
                 f"engine's: {res['streams']} != {streams}")
        err = max(float(np.abs(a - b).max()) for a, b in
                  zip(res["pre"] + res["dec"], pre + dec))
        print(f"rank {r}: heads {res['heads']}, {res['experts']} experts, "
              f"streams identical ({len(MESH_PROMPTS)} x "
              f"{MESH_STEPS + 1} tokens), logits max_abs_err={err:.3e} "
              f"tol={MESH_TOL:g}, launches {res['launches']}, digest "
              f"{res['digest']:#x}, loop clock {res['clock']:.3f} ms, ops "
              f"{res['s']:.2f} s (single engine {one_s:.2f} s; {ways} ranks "
              "sharing one H100 over gloo, eager: no tensor-parallel speed)")
        if not err <= MESH_TOL:
            fail(f"{label} rank {r}'s logits differ from the single engine's "
                 f"by {err:.3e} > {MESH_TOL:g}")
        for key in ("launches", "digest", "clock"):
            if res[key] != ranks[0][key]:
                fail(f"{label} ranks 0 and {r} differ in {key}: "
                     f"{ranks[0][key]} != {res[key]}")
    required = ["paged_decode_attention", "flash_prefill"]
    if cfg.block_kind == "moe":
        required.append("moe_grouped_ffn")
    for name in required:
        if ranks[0]["launches"][name] <= 0:
            fail(f"{label} the ranks never launched {name}")


def nccl_ops(ex, tid):
    """(c)'s ops: a whole prefill, a chunked prefill, decode with
    speculative steps between; every observation and the streams."""
    from repro_torch.core.task import SLOSpec, Task
    a, b = [Task(SLOSpec(tpot_ms=100.0), 1.0, prompt_len=L, output_len=24,
                 task_id=tid + i) for i, L in enumerate((40, 50))]
    out = []
    ex.prefill(a)
    out.append(ex.last_prefill_logits)
    done = False
    while not done:
        done = ex.prefill_chunk(b, 64)[1]
    out.append(ex.last_prefill_logits)
    for depths in (None, None, [2, 3], None, [1, 0], None):
        ex.decode([a, b], depths)
        out.append(ex.last_logits)
    out.append([ex.generated_tokens(t) for t in (a, b)])
    return out


def check_mesh_nccl_captured():
    """(c) A one-rank mesh over NCCL, every step captured (the collectives
    in the graphs), against the engine without a mesh and against the
    same mesh engine with eager steps, on reduced edge-6b and granite-moe
    (its one slab all 40 experts, the combine's all-reduce in the
    graphs): whole prefill, chunked prefill, decode, speculative verify
    with a self-draft; logits and streams bit for bit."""
    import gc

    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.models import model as M
    from repro_torch.serving.executor import PagedTorchExecutor
    phase("sharded (c): --mesh-shape 1,1 over NCCL, steps captured, "
          "against no mesh and eager steps")
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", store=dist.FileStore(
            os.path.join(tmp, "store"), 1), rank=0, world_size=1)
        try:
            mesh = make_serving_mesh(model=1, device=torch.device("cuda", 0))
            for arch in ("edge-6b", "granite-moe-3b-a800m"):
                cfg = get_config(arch).reduced()
                params = M.init_params(cfg, seed=0, device="cuda")
                kw = dict(n_pages=64, page_size=16, max_seq=256, max_batch=4,
                          prefill_chunk_size=32, spec_decode=True,
                          draft_cfg=cfg, draft_params=params, device="cuda")
                engines = [PagedTorchExecutor(cfg, params=params, **kw),
                           PagedTorchExecutor(cfg, params=params, mesh=mesh,
                                              **kw),
                           PagedTorchExecutor(cfg, params=params, mesh=mesh,
                                              cuda_graphs=False, **kw)]
                seen = [nccl_ops(ex, 9200) for ex in engines]
                captured = [k for k, st in engines[1].graphs.steps.items()
                            if st.graph is not None]
                if (len(captured) != len(engines[1].graphs.steps)
                        or not captured):
                    fail(f"(c) {arch}: the mesh engine's steps were not all "
                         "captured: "
                         f"{sorted(map(str, engines[1].graphs.steps))}")
                for other, what in ((0, "the engine without a mesh"),
                                    (2, "its eager steps")):
                    for i, (x, y) in enumerate(zip(seen[1], seen[other])):
                        same = (x == y if isinstance(x, list)
                                else np.array_equal(x, y))
                        if not same:
                            fail(f"(c) {arch}: observation {i} of the "
                                 f"captured one-rank NCCL mesh differs from "
                                 f"{what}")
                print(f"one-rank NCCL mesh, {cfg.name}: {len(captured)} "
                      f"captured steps "
                      f"({', '.join(sorted(str(k) for k in captured))}), "
                      f"{len(seen[0])} observations bit for bit with no "
                      f"mesh and with eager steps, streams {seen[1][-1]}")
                del engines      # reference cycles: their graphs go first
                gc.collect()
                torch.cuda.synchronize()
        finally:
            dist.destroy_process_group()


# (d) and (d'): (run, extra serve arguments, kernels every rank must
# launch) on the serve phase's workload, the ranks sharing the card over
# gloo with eager steps
MESH_SERVE_RUNS = (
    ("paged-mesh", ["--mesh-shape", "1,2"],
     ("paged_decode_attention", "flash_prefill")),
    # granite-moe expert-parallel (20 of its 40 experts a rank), the
    # decode batches of 2, 4 and 8 split over two data groups
    ("paged-mesh-moe", ["--arch", "granite-moe-3b-a800m", "--mesh-shape",
                        "2,2"],
     ("paged_decode_attention", "flash_prefill", "moe_grouped_ffn")),
)


def mesh_serve_phase():
    """(d) The CLI with --mesh-shape 1,2: edge-6b at full width in bf16 on
    the serve phase's workload, 2 ranks over gloo on the one card. (d')
    granite-moe the same way with --mesh-shape 2,2, 4 ranks. Every task
    finishes, every rank's pool ends empty, the ranks' digests are
    equal, each rank holds its slab (heads, experts) and launches its
    run's kernels. Returns the runs' entries for the time phase: the
    shapes a rank's kernels saw (a rank's heads, experts and rows of a
    full decode batch), the ranks' launches summed."""
    import dataclasses
    import types

    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.launch import sharding as S
    entries = {}
    for name, extra, required in MESH_SERVE_RUNS:
        argv = SERVE_ARGS + ["--executor", "paged"] + extra
        args = serve.parse_args(argv)
        data, model = serve._mesh_shape(args)
        cfg = get_config(args.arch)
        experts = (cfg.n_experts // model if cfg.block_kind == "moe"
                   and cfg.n_experts % model == 0 else cfg.n_experts)
        phase(f"sharded serve {name}: {args.arch} at full width (bf16), "
              f"{data * model} ranks of a ({data}, {model}) mesh over gloo "
              "sharing the card")
        print("serve args:", " ".join(argv))
        t0 = time.perf_counter()
        run = serve.run(args)
        wall = time.perf_counter() - t0
        if not isinstance(run, serve.MeshRun) or run.backend != "gloo":
            fail(f"{name}: not a gloo mesh run")
        launches = dict.fromkeys(KERNELS, 0)
        for r, res in enumerate(run.ranks):
            heads = S.head_slab(cfg, model, r % model)
            print(f"rank {r} ({res['device']}): heads q={res['heads'][0]} "
                  f"kv={res['heads'][1]} (KV head {res['heads'][2]}), "
                  f"{res['experts']} experts, l(b) "
                  f"{' '.join(f'l({b})={ms:.3f}ms' for b, ms in res['probes'])}"
                  f", engine clock {res['end_ms']:.1f} ms over "
                  f"{res['decode_iters']} decode steps and {res['prefills']} "
                  f"prefills ({data * model} ranks sharing one H100 over "
                  f"gloo, eager: no tensor-parallel speed), launches "
                  f"{res['launches']}, digest {res['digest']:#x}")
            if res["unfinished"] or not res["n_tasks"]:
                fail(f"{name}: rank {r} left tasks unfinished: "
                     f"{res['unfinished']} of {res['n_tasks']}")
            if res["used_pages"] or res["leaked"]:
                fail(f"{name}: rank {r} ends with {res['used_pages']} pages "
                     "held")
            if res["jax_modules"]:
                fail(f"{name}: rank {r} imported JAX or the JAX package: "
                     f"{res['jax_modules'][:5]}")
            if res["digests"] != [run.ranks[0]["digest"]] * len(run.ranks):
                fail(f"{name}: the ranks' digests differ: {res['digests']}")
            if res["heads"] != heads or res["experts"] != experts:
                fail(f"{name}: rank {r} holds heads {res['heads']} and "
                     f"{res['experts']} experts, not {heads} and {experts}")
            for kernel in required:
                if res["launches"][kernel] <= 0:
                    fail(f"{name}: rank {r} never launched {kernel}")
            for kernel, n in res["launches"].items():
                launches[kernel] += n
        print(f"{name}: {run.ranks[0]['n_tasks']} tasks, wall {wall:.1f} s")
        hq, hkv, _ = S.head_slab(cfg, model, 0)
        shapes = {"cfg": dataclasses.replace(cfg, n_heads=hq,
                                             n_kv_heads=hkv),
                  "experts": experts, "max_seq": args.max_seq,
                  "chunk": None,
                  "tasks": [types.SimpleNamespace(prompt_len=p, output_len=o)
                            for p, o in run.ranks[0]["tasks"]],
                  "batch": args.slots // data,
                  "page_size": args.page_size,
                  "n_pages": (args.slots * args.max_seq) // args.page_size,
                  "maxp": -(-args.max_seq // args.page_size)}
        entries[name] = (shapes, launches)
    return entries


def sharded_phase(worst):
    """(a)-(f); returns the serving runs' entries for the time phase and
    (e)'s timed cases."""
    check_sharded_kernels(worst)
    moe_slabs = check_sharded_moe(worst)
    check_mesh_equivalence()
    check_mesh_equivalence("granite-moe-3b-a800m", (2, 2), "(f)")
    check_mesh_nccl_captured()
    return mesh_serve_phase(), moe_slabs


def time_phase(runs, worst):
    """Time each kernel, its plain version and the library yardstick at the
    shapes its serving run gave it; bound from these inputs. ``runs`` maps
    a run's name (a fleet instance's as ``run/arch``) to (shapes,
    launches); a timed row's launches are the sum over the serving runs
    at whose shapes (heads, state widths, cache layout) it is timed, and
    each run's launches of a kernel stand under exactly one of its rows."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_prefill as _fp
    from repro_torch.kernels import moe_dispatch as _moe
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import paged_attention as _pa
    from repro_torch.kernels import decode_attention as _da
    from repro_torch.kernels import ssd_decode as _ssdd
    from repro_torch.kernels import ssd_scan as _ssd
    from repro_torch.launch.timing import (ATTENTION_PASSES, SSD_PASSES,
                                           passes_us, time_ms)
    from repro_torch.models import model as M
    phase("time kernels at the serving runs' shapes")
    dt = "bfloat16"
    dtype = torch.bfloat16
    elt = 2
    rows = []

    def row(name, shape, kern, plain, plain_fp32, lib, nbytes, flops, *,
            of_runs, body="cuda_core", passes=None, floor=None):
        """One timed kernel: its call, plain versions (working type and
        fp32), library yardstick or None, bytes and flops for the bound,
        the serving runs at whose shapes it is timed and whose launches it
        reports, the body it runs, for a multi-pass kernel the names of
        its passes' kernels (``launch.timing``), each pass then timed
        apart, and an empty kernel on the same grid, timed the same way
        (the launch floor), or None."""
        rows.append(dict(name=name, shape=shape, kern=kern, plain=plain,
                         plain_fp32=plain_fp32, lib=lib, nbytes=nbytes,
                         flops=flops, body=body, passes=passes,
                         of_runs=of_runs, floor=floor))

    def lengths_of(shapes):
        """Cached tokens of a full batch over the workload's first requests,
        each mid-way through its output (prompt + half its output)."""
        tasks = shapes["tasks"]                  # in arrival order
        eff = [min(t.prompt_len, shapes["max_seq"] // 2) for t in tasks]
        return eff, [eff[i % len(tasks)] + tasks[i % len(tasks)].output_len // 2
                     for i in range(shapes["batch"])]

    def masked_sdpa(q, k, v, keep):
        """One library call for the same function: K/V repeated to Hq and
        an explicit boolean mask. q [B,Hq,Sq,hd], k/v [B,Hkv,S,hd]."""
        g = q.shape[1] // k.shape[1]
        kr, vr = (x.repeat_interleave(g, dim=1) for x in (k, v))
        return lambda: F.scaled_dot_product_attention(q, kr, vr,
                                                      attn_mask=keep)

    def heads(cfg):
        return cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    def splits(B, R, Hkv, hd, sh):
        _, pps, nsplit = _pa.plan(B, R, Hkv, hd, sh["page_size"],
                                  sh["maxp"], dtype,
                                  _pa.sm_count(torch.device("cuda")))
        return f"{nsplit} splits of {pps} pages"

    def paged_decode_row(run, seed, of_runs):
        """A full batch of ``run``'s engine over its arena shape, at its
        arch's heads."""
        sh = runs[run][0]
        Hq, Hkv, hd = heads(sh["cfg"])
        _, lengths = lengths_of(sh)
        B = sh["batch"]
        q, kp, vp, pt, qp = decode_inputs(
            lengths, dtype, n_pages=sh["n_pages"], Hq=Hq, Hkv=Hkv, hd=hd,
            psz=sh["page_size"], maxp=sh["maxp"], seed=seed)
        live = sum(ln + 1 for ln in lengths)
        row("paged_decode_attention",
            f"B={B} q_pos={lengths} maxp={sh['maxp']} Hq={Hq} Hkv={Hkv} "
            f"hd={hd}, " + splits(B, Hq // Hkv, Hkv, hd, sh),
            lambda: ops.paged_decode_attention(q, kp, vp, pt, qp),
            lambda: ref.paged_decode_attention_ref(q, kp, vp, pt, qp),
            lambda: ref.paged_decode_attention_ref(
                q.float(), kp.float(), vp.float(), pt, qp),
            None, 2 * live * Hkv * hd * elt + 2 * B * Hq * hd * elt
            + pt.numel() * 4 + B * 4, 4 * live * Hq * hd,
            body=_pa.body(dtype, hd), of_runs=of_runs)

    def prefill_row(run, seed, of_runs):
        """One prompt of ``run``'s median effective length, at its arch's
        heads."""
        sh = runs[run][0]
        Hq, Hkv, hd = heads(sh["cfg"])
        eff, _ = lengths_of(sh)
        S = sorted(eff)[len(eff) // 2]
        q, k, v = prefill_inputs(1, S, dtype, Hq=Hq, Hkv=Hkv, hd=hd,
                                 seed=seed)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        kr, vr = (x.repeat_interleave(Hq // Hkv, dim=1) for x in (kt, vt))
        row("flash_prefill", f"B=1 S={S} Hq={Hq} Hkv={Hkv} hd={hd} causal",
            lambda: ops.flash_prefill(q, k, v, causal=True),
            lambda: ref.flash_prefill_ref(q, k, v, causal=True),
            lambda: ref.flash_prefill_ref(q.float(), k.float(), v.float(),
                                          causal=True),
            lambda: F.scaled_dot_product_attention(qt, kr, vr,
                                                   is_causal=True),
            (2 * S * Hq + 2 * S * Hkv) * hd * elt,
            4 * (S * (S + 1) // 2) * Hq * hd, body=_fp.body(dtype, hd),
            of_runs=of_runs)

    def ring_decode_row(run, seed, of_runs):
        """Ring-cache decode over ``run``'s whole slot array at its arch's
        heads and window: every slot holds a request mid-way through its
        output, append-only."""
        sh = runs[run][0]
        Hq, Hkv, hd = heads(sh["cfg"])
        _, lengths = lengths_of(sh)
        Sbuf, B = sh["max_seq"], sh["batch"]
        window = M.cache_window(sh["cfg"], Sbuf)
        kv_pos = appended_kv_pos([ln + 1 for ln in lengths], Sbuf)
        dq, dk, dv, dkp, dqp = ring_inputs(lengths, kv_pos, dtype, Sbuf,
                                           Hq=Hq, Hkv=Hkv, hd=hd, seed=seed)
        live = sum(ln + 1 for ln in lengths)
        keep = (dkp >= 0)[:, None, None, :]
        _, sps, nsplit = _da.plan(Hq // Hkv, hd, Sbuf, dtype)
        row("decode_attention",
            f"B={B} S={Sbuf} q_pos={lengths} window={window} Hq={Hq} "
            f"Hkv={Hkv} hd={hd}, {nsplit} splits of {sps} slots",
            lambda: ops.decode_attention(dq, dk, dv, dkp, dqp,
                                         window=window),
            lambda: ref.decode_attention_ref(dq, dk, dv, dkp, dqp, window),
            lambda: ref.decode_attention_ref(dq.float(), dk.float(),
                                             dv.float(), dkp, dqp, window),
            masked_sdpa(dq[:, :, None], dk, dv, keep),
            2 * live * Hkv * hd * elt + 2 * B * Hq * hd * elt
            + dkp.numel() * 4 + B * 4, 4 * live * Hq * hd,
            body=_pa.body(dtype, hd), passes=ATTENTION_PASSES,
            of_runs=of_runs)

    def f32(ts):
        return [t.float() for t in ts]

    def ssd_scan_row(run, seed, of_runs):
        """One prompt of ``run``'s median effective length through its
        arch's SSD heads, inputs as strided splits of one projection, as
        the mixer passes them."""
        sh = runs[run][0]
        c = sh["cfg"]
        eff, _ = lengths_of(sh)
        T = sorted(eff)[len(eff) // 2]
        H, P, N = c.ssm_heads, c.ssm_head_dim, c.ssm_state
        sx, sdt, sb, sc, sprm = ssd_inputs(1, T, H, P, N, dtype, seed=seed)
        s_args = (sx, sdt, sprm[0], sb, sc, sprm[1], sprm[2])
        s_args32 = f32(s_args)
        pieces = [min(64, T - t0) for t0 in range(0, T, 64)]   # chunks
        row("ssd_scan", f"B=1 T={T} H={H} P={P} N={N} strided, "
            f"{_ssd.chunks(T)} chunks",
            lambda: ops.ssd_scan(*s_args)[0],
            lambda: ref.ssd_scan_ref(*s_args)[0],
            lambda: ref.ssd_scan_ref(*s_args32)[0], None,
            (2 * T * H * P + T * H + 2 * T * N + 3 * H) * elt
            + H * P * N * 4,
            H * sum(n * (n + 1) * (N + P) + 4 * n * P * N
                    for n in pieces), body=_ssd.body(dtype, P, N),
            passes=SSD_PASSES, of_runs=of_runs)

    def ssd_step_row(run, seed, of_runs):
        """The full decode batch of ``run``'s engine, every row active, on
        its arena's layout: the paged engine's state arena (2 * batch
        slots, row b at slot 2b) or the slot engine's (a layer of its slot
        cache, row b at slot b, the spare row past them). The kernel and
        its plain version each step the next of n copies of the arena a
        call, the n copies' live rows twice the L2, so no call finds its
        state there, as in serving, where every layer steps its own
        arena; the first kernel call's copy is the one the fp32 check
        starts from."""
        sh = runs[run][0]
        c = sh["cfg"]
        H, P, N = c.ssm_heads, c.ssm_head_dim, c.ssm_state
        B = sh["batch"]
        dx, ddt, dbm, dcm, dprm = ssd_inputs(B, 1, H, P, N, dtype, seed=seed)
        d_args = (dx[:, 0], ddt[:, 0], dprm[0], dbm[:, 0], dcm[:, 0],
                  dprm[1], dprm[2])
        d_args32 = f32(d_args)
        if "n_pages" in sh:
            n_arena, layout = 2 * B, f"arena={2 * B}"
            slots = torch.arange(0, 2 * B, 2, dtype=torch.int32,
                                 device="cuda")
        else:
            n_arena, layout = B + 1, f"slot-cache layout arena={B + 1}"
            slots = torch.arange(B, dtype=torch.int32, device="cuda")
        g = torch.Generator(device="cuda").manual_seed(seed + 2)
        base = 0.5 * torch.randn(n_arena, H, P, N, generator=g,
                                 device="cuda")
        n = max(2, -(-2 * L2_BYTES // (B * H * P * N * 4)))
        kern_arenas = [base.clone() for _ in range(n)]
        plain_arenas = [base.clone() for _ in range(n)]
        calls = {"kern": 0, "plain": 0}

        def rotating(fn, arenas, key, *args):
            def call():
                arena = arenas[calls[key] % n]
                calls[key] += 1
                return fn(*args, arena, slots, act)
            return call

        act = torch.ones(B, dtype=torch.bool, device="cuda")
        row("ssd_decode_step", f"B={B} H={H} P={P} N={N} {layout} in place, "
            f"{n} arenas in turn",
            rotating(ops.ssd_decode_step, kern_arenas, "kern", *d_args),
            rotating(ref.ssd_decode_step_ref, plain_arenas, "plain",
                     *d_args),
            lambda: ref.ssd_decode_step_ref(*d_args32, base, slots, act),
            None,
            2 * B * H * P * N * 4
            + (2 * B * H * P + B * H + 2 * B * N + 3 * H) * elt + 5 * B,
            5 * B * H * P * N, body=_ssdd.body(P, N), of_runs=of_runs,
            floor=lambda: _ssdd.launch_empty(B, H, P, N, dx.device))

    # paged decode: edge-6b's heads over run paged-atomic's batch (its
    # runs and the fleet's edge-6b instance), granite-moe's over run
    # paged-moe's, smollm-360m's over the fleet's smollm instance's
    paged_decode_row("paged-atomic", 1, (
        "paged-atomic", "paged-realtime", "paged-chunked",
        "paged-chunked-realtime", "paged-spec", "paged-spec-rate8",
        "paged-async-traced", "fleet-traced/edge-6b"))
    paged_decode_row("paged-moe", 11, ("paged-moe",))
    paged_decode_row("fleet-traced/smollm-360m", 15,
                     ("fleet-traced/smollm-360m",))

    # whole-prompt prefill, the same way, and hymba-1.5b's heads over run
    # slot-hybrid's prompts
    prefill_row("paged-atomic", 2, (
        "paged-atomic", "paged-realtime", "paged-spec", "paged-spec-rate8",
        "paged-async-traced", "fleet-traced/edge-6b"))
    prefill_row("paged-moe", 10, ("paged-moe",))
    prefill_row("slot-hybrid", 12, ("slot-hybrid",))
    prefill_row("fleet-traced/smollm-360m", 16,
                ("fleet-traced/smollm-360m",))

    # ring-cache decode: edge-6b's heads over run slot-chunked's slot array
    # (the draft model of the spec runs is edge-6b cut to one layer),
    # hymba-1.5b's over run slot-hybrid's
    ring_decode_row("slot-chunked", 3,
                    ("slot-chunked", "paged-spec", "paged-spec-rate8"))
    ring_decode_row("slot-hybrid", 17, ("slot-hybrid",))

    def chunk_row(run, seed, of_runs, at=None):
        """One full chunk of ``run``'s median prompt, its last full one,
        over the slot engine's [1,Hkv,S,hd] layer buffer read through its
        strides, at its arch's heads or ``at`` (Hq, Hkv)."""
        sh = runs[run][0]
        Hq, Hkv, hd = heads(sh["cfg"])
        if at is not None:
            Hq, Hkv = at
        eff, _ = lengths_of(sh)
        Sbuf = sh["max_seq"]
        window = M.cache_window(sh["cfg"], Sbuf)
        C = sh["chunk"]
        S_med = sorted(eff)[len(eff) // 2]
        q0 = C * max(0, S_med // C - 1)
        cq, ck, cv = chunk_inputs(1, C, Sbuf, dtype, Hq=Hq, Hkv=Hkv, hd=hd,
                                  seed=seed)
        cqs = torch.tensor([q0], dtype=torch.int32, device="cuda")
        q_pos = q0 + torch.arange(C, device="cuda")
        ckeep = (torch.arange(Sbuf, device="cuda")[None, :] <= q_pos[:, None])
        row("flash_prefill_chunk",
            f"B=1 C={C} q_start={q0} S={Sbuf} Hq={Hq} Hkv={Hkv} hd={hd} "
            f"strided window={window}",
            lambda: ops.flash_prefill_chunk(cq, ck, cv, cqs,
                                            window=window),
            lambda: ref.flash_prefill_chunk_ref(cq, ck, cv, cqs, window),
            lambda: ref.flash_prefill_chunk_ref(cq.float(), ck.float(),
                                                cv.float(), cqs, window),
            masked_sdpa(cq.transpose(1, 2), ck.transpose(1, 2),
                        cv.transpose(1, 2), ckeep),
            (2 * C * Hq + 2 * (q0 + C) * Hkv) * hd * elt + 4,
            4 * Hq * hd * (C * q0 + C * (C + 1) // 2),
            body=_fp.body(dtype, hd), of_runs=of_runs)

    def verify_row(run, seed, of_runs, at=None):
        """A full batch of the widest window ``run``'s depth grants,
        q_start as the paged-decode row's q_pos, over the engine's arena
        shape, at its arch's heads or ``at`` (Hq, Hkv)."""
        sh = runs[run][0]
        Hq, Hkv, hd = heads(sh["cfg"])
        if at is not None:
            Hq, Hkv = at
        C = sh["window"]
        _, starts = lengths_of(sh)
        psz = sh["page_size"]
        B = len(starts)
        vq, vkp, vvp, vpt, vqs = verify_inputs(starts, C, dtype,
                                               n_pages=sh["n_pages"], Hq=Hq,
                                               Hkv=Hkv, hd=hd, psz=psz,
                                               maxp=sh["maxp"], seed=seed)
        keys = sum(s0 + C for s0 in starts)      # K/V rows the windows keep
        pairs = sum(C * s0 + C * (C + 1) // 2 for s0 in starts)  # (q, key)
        row("paged_verify_attention",
            f"B={B} C={C} q_start={starts} maxp={sh['maxp']} Hq={Hq} "
            f"Hkv={Hkv} hd={hd}, " + splits(B, C * Hq // Hkv, Hkv, hd, sh),
            lambda: ops.paged_verify_attention(vq, vkp, vvp, vpt, vqs),
            lambda: ref.paged_verify_attention_ref(vq, vkp, vvp, vpt,
                                                   vqs),
            lambda: ref.paged_verify_attention_ref(
                vq.float(), vkp.float(), vvp.float(), vpt, vqs),
            None, 2 * keys * Hkv * hd * elt + 2 * B * C * Hq * hd * elt
            + vpt.numel() * 4 + B * 4, 4 * pairs * Hq * hd,
            body=_pa.body(dtype, hd), of_runs=of_runs)

    # prompt chunks over run slot-chunked's slot buffer
    chunk_row("slot-chunked", 4, (
        "slot-chunked", "paged-chunked", "paged-chunked-realtime",
        "paged-spec", "paged-spec-rate8"))
    # paged verify over run paged-spec's arena
    verify_row("paged-spec", 5, ("paged-spec", "paged-spec-rate8"))

    # a rank of the paged-mesh run (edge-6b over 2 ranks: 16 query heads,
    # 1 KV head): paged decode and whole-prompt prefill over its batch and
    # prompts, the verify and chunk kernels (which that run does not
    # launch) at the same heads over the paged-spec and slot-chunked
    # runs' shapes
    paged_decode_row("paged-mesh", 21, ("paged-mesh",))
    prefill_row("paged-mesh", 22, ("paged-mesh",))
    verify_row("paged-spec", 23, (), at=MESH_HEADS[0])
    chunk_row("slot-chunked", 24, (), at=MESH_HEADS[0])

    # SSD scan: mamba2-780m's heads (runs paged-ssm and slot-ssm give it
    # the same prompts), hymba-1.5b's over run slot-hybrid's prompts
    ssd_scan_row("paged-ssm", 6, ("paged-ssm", "slot-ssm"))
    ssd_scan_row("slot-hybrid", 18, ("slot-hybrid",))

    # SSD decode step: each run's own batch and arena layout
    ssd_step_row("paged-ssm", 7, ("paged-ssm",))
    ssd_step_row("slot-ssm", 19, ("slot-ssm",))
    ssd_step_row("slot-hybrid", 13, ("slot-hybrid",))

    def moe_row(run, seed, of_runs):
        """The dispatch buffer of ``run``'s full decode batch, C = batch *
        top_k, rows placed by a random top-k routing of the batch's tokens
        over all the arch's experts and each expert's count passed, so
        most of each expert's capacity is dead rows, as in serving; on a
        rank's slab of the experts (its ``experts``, the first ones),
        only the assignments to the slab's experts."""
        sh = runs[run][0]
        mcfg = sh["cfg"]
        E, D, Fd, K = mcfg.n_experts, mcfg.d_model, mcfg.d_ff, mcfg.top_k
        El = sh.get("experts", E)
        B = sh["batch"]
        g = torch.Generator(device="cuda").manual_seed(seed)
        C = B * K
        mbuf, mwg, mwu, mwd = moe_inputs(El, C, dtype, E=El, D=D, F=Fd,
                                         seed=seed - 1)
        mbuf.zero_()
        picks = torch.rand(B, E, generator=g, device="cuda").topk(K).indices
        fill = torch.zeros(El, dtype=torch.long)
        for e in picks.flatten().tolist():
            if e < El:
                mbuf[e, fill[e]] = torch.randn(D, generator=g,
                                               device="cuda").to(dtype)
                fill[e] += 1
        used = int((fill > 0).sum())
        live_rows = int(fill.sum())
        mcounts = fill.to(torch.int32).cuda()
        m_args32 = f32((mbuf, mwg, mwu, mwd))
        slab = "" if El == E else f" (a rank's {El} of {E} experts)"
        row("moe_grouped_ffn", f"G=E={El}{slab} C={C} D={D} F={Fd}, "
            f"{live_rows} live rows over {used} experts, counts passed",
            lambda: ops.moe_grouped_ffn(mbuf, mwg, mwu, mwd, mcounts),
            lambda: ref.moe_grouped_ffn_ref(mbuf, mwg, mwu, mwd, mcounts),
            lambda: ref.moe_grouped_ffn_ref(*m_args32, mcounts), None,
            # the weights of experts with rows, the live rows in and out,
            # the counts
            3 * used * D * Fd * elt + 2 * live_rows * D * elt + El * 4,
            6 * live_rows * D * Fd, body=_moe.body(dtype), of_runs=of_runs)
        return mbuf, mwg, mwu, mwd

    # grouped-expert FFN: run paged-moe's batch over all 40 experts, and a
    # rank's rows of a full batch of the paged-mesh-moe run on its 20
    mbuf, mwg, mwu, mwd = moe_row("paged-moe", 9, ("paged-moe",))
    moe_row("paged-mesh-moe", 25, ("paged-mesh-moe",))

    # a rank of the paged-mesh-moe run (granite-moe over a (2, 2) mesh: 12
    # query heads, 4 KV heads), paged decode over its rows of a full batch
    # and whole-prompt prefill over its prompts
    paged_decode_row("paged-mesh-moe", 26, ("paged-mesh-moe",))
    prefill_row("paged-mesh-moe", 27, ("paged-mesh-moe",))

    # every run's launches of a kernel stand under exactly one of its rows
    for run, (_, counts) in runs.items():
        for name, n in counts.items():
            under = sum(run in r["of_runs"] for r in rows if r["name"] == name)
            if (n and under != 1) or under > 1:
                fail(f"time phase: run {run}'s {n} launches of {name} stand "
                     f"under {under} timed rows")
    out, entries = [], {}
    for r in rows:
        name, shape = r["name"], r["shape"]
        # held against the plain version at these shapes too
        err = (r["kern"]().float() - r["plain_fp32"]()).abs().max().item()
        print(f"{name} [{shape}, {dt}, {r['body']} body]: max_abs_err="
              f"{err:.3e} tol={TOL[dt]:g}")
        if err > TOL[dt]:
            fail(f"{name} disagrees with its plain version at the timed shapes")
        worst[name] = max(worst[name], err)
        ms = time_ms(r["kern"])
        paced_ms = time_ms(r["kern"], queued=False)
        plain_ms = time_ms(r["plain"])
        lib_ms = time_ms(r["lib"]) if r["lib"] is not None else None
        floor_ms = time_ms(r["floor"]) if r["floor"] is not None else None
        t_bytes = r["nbytes"] / HBM_BYTES_PER_S * 1e3
        t_ops = r["flops"] / PEAK_FLOPS[dt] * 1e3
        bound, by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops,
                                                                 "operations")
        launches = sum(runs[run][1][name] for run in r["of_runs"])
        pass_us = (passes_us(r["kern"], r["passes"]) if r["passes"]
                   else None)
        if pass_us is not None:
            print(f"{name} [{shape}] passes (torch.profiler, us a call): "
                  + ", ".join(f"{k} {v:.2f}" for k, v in pass_us.items()))
        print(f"{name} [{shape}, {dt}, {r['body']} body]: kernel {ms:.4f} ms "
              f"(launched at the host's pace: {paced_ms:.4f}), plain "
              f"{plain_ms:.4f} ms, library "
              f"{'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'}, bound "
              f"{bound:.5f} ms by {by} ({r['nbytes']} B, {r['flops']} flop)"
              + ("" if floor_ms is None else
                 f", empty kernel on its grid {floor_ms:.4f} ms")
              + ", launches " + ", ".join(f"{run} {runs[run][1][name]}"
                                          for run in r["of_runs"]))
        timed = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                 "bound_by": by, "library_ms": lib_ms, "shape": shape,
                 "body": r["body"], "launches": launches}
        if floor_ms is not None:
            timed["floor_ms"] = floor_ms
        if pass_us is not None:
            timed["passes_us"] = pass_us
        if name in entries:
            # one entry per kernel: a further shape goes under it, and
            # the entry's launches cover every serving run
            entries[name]["other_shapes"].append(timed)
            entries[name]["launches"] += launches
            continue
        entries[name] = {"name": name, "route": "cuda",
                         "source": KERNELS[name]["source"],
                         "replaces": KERNELS[name]["replaces"],
                         "max_abs_err": worst[name], **timed,
                         "other_shapes": []}
        out.append(entries[name])
    for e in out:
        e["max_abs_err"] = worst[e["name"]]
    # no single PyTorch call computes the grouped FFN: the chain of
    # batched matmuls over the same buffer is a yardstick, used nowhere
    chain_ms = time_ms(lambda: torch.bmm(
        F.silu(torch.bmm(mbuf, mwg)) * torch.bmm(mbuf, mwu), mwd))
    print(f"moe_grouped_ffn yardstick (not one library call): "
          f"bmm/silu/bmm/bmm chain over the same buffer {chain_ms:.4f} ms")
    return out


# ------------------------------------------------------------------ train

FP32_PEAK = PEAK_FLOPS["float32"]
# card against CPU, reduced archs, fp32 (TF32 off): cuBLAS and the CPU's
# BLAS add in different orders
TRAIN_TOL = {"logits": 1e-4, "loss": 1e-5, "grad": 1e-4, "steps": 1e-4}
# full-width training runs after smollm-360m's: (arch, layers kept or
# None for all, batch, sequence, steps). granite-moe's fp32 AdamW state
# (~16 B a parameter, ~53 GB at 32 layers) is cut to 8 layers
TRAIN_RUNS = (("mamba2-780m", None, 4, 1024, 3),
              ("hymba-1.5b", None, 4, 1024, 3),
              ("hubert-xlarge", None, 4, 1024, 3),
              ("granite-moe-3b-a800m", 8, 4, 1024, 3))


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()
    if smi.returncode != 0 or not card:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    return card[0]


def matmul_params(cfg) -> int:
    """Weights one token's matmuls read: every layer's projections (for
    MoE its router and its top-k experts), and the head once; no
    embedding gather, no attention scores. 2x this is the token's dense
    forward FLOPs."""
    D, per = cfg.d_model, 0
    if cfg.has_attention:
        per += 2 * D * cfg.q_dim + 2 * D * cfg.kv_dim
    if cfg.has_ssm:
        per += D * (2 * cfg.ssm_inner + 2 * cfg.ssm_state
                    + cfg.ssm_heads) + cfg.ssm_inner * D
    if cfg.block_kind == "moe":
        per += D * cfg.n_experts + cfg.top_k * 3 * D * cfg.d_ff
    elif cfg.d_ff:
        per += 3 * D * cfg.d_ff
    return cfg.n_layers * per + D * cfg.padded_vocab


def train_batch(cfg, B, S, dev, seed):
    """Random tokens (random [B,S,D] frames for embedding-input archs),
    labels the tokens with every 7th position ignored."""
    import torch
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                         device=dev)
    labels = toks.clone()
    labels[:, ::7] = -1
    inputs = toks
    if cfg.embedding_inputs:
        inputs = torch.randn((B, S, cfg.d_model), generator=gen, device=dev)
    return {"inputs": inputs, "labels": labels}


def leaf_names(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from leaf_names(tree[k], f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}"


def copy_state(dst, src):
    """Set a training state (params, AdamWState) to another's values."""
    import torch
    from repro_torch.training.optimizer import leaves
    with torch.no_grad():
        for a, b in zip(leaves({"p": dst[0], "m": dst[1].mu, "v": dst[1].nu}),
                        leaves({"p": src[0], "m": src[1].mu, "v": src[1].nu})):
            a.copy_(b)
        dst[1].step.copy_(src[1].step)


def check_train_reduced():
    """(a) Every registry arch, reduced, fp32: forward, loss_fn and the
    per-leaf gradients, then two train_steps (the card's state set to the
    CPU's before each), on the card against the port on the CPU from the
    same weights and batch. Every leaf forward
    reads has a nonzero gradient on the card (embed of an embedding-input
    arch with an untied head excepted: JAX's gradient leaves it at zero
    too), and no kernel is launched. Then forward with use_ssd_kernel on
    mamba2 launches the SSD scan and matches the default forward, and
    raises under autograd."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.registry import list_archs
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.training.optimizer import leaves
    from repro_torch.training.trainer import loss_and_grads, make_train_step
    phase("train: every registry arch reduced, fp32, card against CPU")
    opts = M.ModelOptions(remat=True)
    for arch in list_archs():
        cfg = get_config(arch).reduced()
        weights = M.init_params(cfg, seed=0, device="cpu")
        batch = train_batch(cfg, 2, 64, "cpu", 0)
        out, steps, states = {}, [], {}
        ops.reset_launches()
        for dev in ("cpu", "cuda"):
            init_state, train_step = make_train_step(
                cfg, peak_lr=1e-3, warmup=1, total=10, device=dev)
            states[dev] = (init_state(weights), train_step)
            b = {k: v.to(dev) for k, v in batch.items()}
            with torch.no_grad():
                logits, _ = M.forward(cfg, states[dev][0][0], b["inputs"])
            loss, grads = loss_and_grads(cfg, states[dev][0][0], b, opts)
            out[dev] = (logits.cpu(), float(loss),
                        [g.cpu() for g in leaves(grads)])
        # two steps, the card's state set to the CPU's before each: AdamW
        # moves a component whose gradient is near 0 by up to lr whatever
        # the gradient's last bits, which would part the two runs
        for _ in range(2):
            copy_state(states["cuda"][0], states["cpu"][0])
            m = {}
            for dev in ("cpu", "cuda"):
                state, train_step = states[dev]
                b = {k: v.to(dev) for k, v in batch.items()}
                state, m[dev] = train_step(state, b)
            steps += [(float(m["cuda"][k]), float(m["cpu"][k]))
                      for k in ("loss", "grad_norm")]
        launched = sum(ops.LAUNCHES.values())
        (lc, loss_c, gc), (lg, loss_g, gg) = out["cpu"], out["cuda"]
        names = list(leaf_names(weights))
        l_err = ((lg - lc).abs().max() / lc.abs().max().clamp(min=1)).item()
        g_err = max(((a - b).abs().max() / b.abs().max().clamp(min=1e-30))
                    .item() for a, b in zip(gg, gc))
        s_err = max(abs(a - b) / abs(b) for a, b in steps)
        zero = [n for n, g in zip(names, gg) if not g.abs().max() > 0
                and not (n == "embed" and cfg.embedding_inputs
                         and not cfg.tied_embeddings)]
        print(f"train {cfg.name}: logits rel err {l_err:.2e} "
              f"loss {loss_g:.6f} vs {loss_c:.6f} grad rel err (of each "
              f"leaf's max) {g_err:.2e} two steps' loss/grad_norm rel err "
              f"{s_err:.2e} leaves {len(names)} zero-grad {zero} "
              f"launches {launched}", flush=True)
        if (l_err > TRAIN_TOL["logits"]
                or abs(loss_g - loss_c) > TRAIN_TOL["loss"] * abs(loss_c)
                or g_err > TRAIN_TOL["grad"] or s_err > TRAIN_TOL["steps"]):
            fail(f"training {cfg.name} on the card disagrees with the CPU")
        if zero:
            fail(f"{cfg.name}: leaves with no gradient on the card: {zero}")
        if launched:
            fail(f"{cfg.name}: training launched kernels: {ops.LAUNCHES}")
    cfg = get_config("mamba2-780m").reduced()
    params = M.init_params(cfg, seed=0, device="cuda")
    x = train_batch(cfg, 2, 200, "cuda", 1)["inputs"]
    ops.reset_launches()
    with torch.no_grad():
        lk, _ = M.forward(cfg, params, x, M.ModelOptions(use_ssd_kernel=True))
        n = ops.LAUNCHES["ssd_scan"]
        lp, _ = M.forward(cfg, params, x)
    err = ((lk - lp).abs().max() / lp.abs().max()).item()
    for p in leaves(params):
        p.requires_grad_(True)
    try:
        M.forward(cfg, params, x, M.ModelOptions(use_ssd_kernel=True))
        refused = False
    except RuntimeError as e:
        refused = "no backward" in str(e)
    print(f"forward with use_ssd_kernel ({cfg.name}, S=200): ssd_scan "
          f"launches {n} (layers {cfg.n_layers}), rel err to the default "
          f"forward {err:.2e} tol {TOL['float32']}; under autograd "
          f"refused: {refused}", flush=True)
    if n != cfg.n_layers or err > TOL["float32"] or not refused:
        fail("the SSD kernel option of forward is wrong on the card")


def train_run(arch, layers, B, S, steps, card, lr=1e-3):
    """``steps`` train_steps of one arch at full width in fp32 on one
    fixed batch: losses, grad norms, ms a step (host clock, synced), the
    median over the steps after the first, tokens/s, dense TFLOP/s and
    peak memory, printed with the card. Returns (state, batch, row)."""
    import dataclasses
    import statistics
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.training.trainer import make_train_step
    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    init_state, train_step = make_train_step(cfg, peak_lr=lr, warmup=1,
                                             total=10, device="cuda")
    state = init_state(0)
    batch = train_batch(cfg, B, S, "cuda", 2)
    ops.reset_launches()
    losses, norms, ms = [], [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = train_step(state, batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    launched = sum(ops.LAUNCHES.values())
    med = statistics.median(ms[1:])
    fpt = 8 * matmul_params(cfg)          # fwd + remat fwd + bwd (2x)
    tps = B * S / (med / 1e3)
    row = {"arch": arch, "layers": cfg.n_layers, "B": B, "S": S,
           "ms_per_step": med, "first_step_ms": ms[0],
           "tokens_per_s": tps, "dense_flops_per_token": fpt,
           "dense_tflops": fpt * tps / 1e12,
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "losses": losses, "grad_norms": norms, "launches": launched}
    print(f"train {cfg.name} ({cfg.n_layers} layers) B={B} S={S} fp32 on "
          f"{card}: loss {' '.join(f'{v:.4f}' for v in losses)} grad_norm "
          f"{norms[0]:.3f}..{norms[-1]:.3f}; {med:.1f} ms/step (first "
          f"{ms[0]:.1f}), {tps:.0f} tokens/s, {fpt / 1e9:.2f} dense GFLOP "
          f"a token -> {row['dense_tflops']:.1f} TFLOP/s "
          f"({row['dense_tflops'] * 1e12 / FP32_PEAK:.1%} of the fp32 "
          f"peak), peak memory {row['peak_gib']:.2f} GiB, launches "
          f"{launched}", flush=True)
    if not all(map(math.isfinite, losses + norms)) or launched:
        fail(f"training {cfg.name} at full width: non-finite loss or "
             f"grad_norm, or kernel launches ({ops.LAUNCHES})")
    return state, batch, row


def train_phase():
    """(b) smollm-360m at full width and depth, fp32: 10 steps at B=8,
    S=1024 on one batch (loss falls), then at B=1, S=4096 the chunked
    attention's step against a dense one. (c) mamba2-780m, hymba-1.5b,
    hubert-xlarge at full width, granite-moe-3b-a800m at full width with
    8 of its 32 layers. (d) The training CLI at full width in a
    subprocess."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.training.optimizer import leaves
    from repro_torch.training.trainer import loss_and_grads, make_train_step
    check_train_reduced()
    card = card_line()
    phase("train: smollm-360m at full width and depth, fp32")
    state, _, row = train_run("smollm-360m", None, 8, 1024, 10, card)
    rows = [row]
    if not row["losses"][-1] < row["losses"][0]:
        fail(f"smollm-360m: loss did not fall over 10 steps on one batch "
             f"({row['losses']})")
    cfg = get_config("smollm-360m")
    batch = train_batch(cfg, 1, 4096, "cuda", 3)
    auto = M.ModelOptions(remat=True)
    if auto.resolve_attn(4096) != "chunked":
        fail("resolve_attn does not pick chunked at S=4096")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss_d, grads_d = loss_and_grads(cfg, state[0], batch,
                                     M.ModelOptions(attn_impl="dense",
                                                    remat=True))
    torch.cuda.synchronize()
    dense_ms = (time.perf_counter() - t0) * 1e3
    norm_d = torch.sqrt(sum(torch.dot(g.reshape(-1), g.reshape(-1))
                            for g in leaves(grads_d)))
    del grads_d
    _, train_step = make_train_step(cfg, peak_lr=1e-3, warmup=1, total=10,
                                    device="cuda")
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, m = train_step(state, batch)
    torch.cuda.synchronize()
    chunk_ms = (time.perf_counter() - t0) * 1e3
    l_err = abs(float(m["loss"]) - float(loss_d)) / float(loss_d)
    n_err = abs(float(m["grad_norm"]) - float(norm_d)) / float(norm_d)
    print(f"smollm-360m B=1 S=4096 on {card}: chunked step loss "
          f"{float(m['loss']):.6f} grad_norm {float(m['grad_norm']):.4f} "
          f"vs dense {float(loss_d):.6f} {float(norm_d):.4f} (rel err "
          f"{l_err:.1e}, {n_err:.1e}, tol 1e-5, 1e-4); chunked train step "
          f"{chunk_ms:.1f} ms (peak {torch.cuda.max_memory_allocated() / 2**30:.2f} "
          f"GiB), dense loss+grad {dense_ms:.1f} ms", flush=True)
    if l_err > 1e-5 or n_err > 1e-4:
        fail("chunked and dense attention disagree at S=4096")
    rows.append({"arch": "smollm-360m", "B": 1, "S": 4096,
                 "chunked_step_ms": chunk_ms, "dense_loss_grad_ms": dense_ms})
    del state
    phase("train: mamba2, hymba, hubert, granite-moe at full width, fp32")
    for run in TRAIN_RUNS:
        state, _, row = train_run(*run, card)
        rows.append(row)
        del state
    torch.cuda.empty_cache()
    phase("train: the training CLI at full width")
    t0 = time.perf_counter()
    cli = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "smollm-360m", "--steps", "20"], cwd=ROOT, capture_output=True,
        text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")))
    print(cli.stdout.strip())
    print(f"CLI exit {cli.returncode} in {time.perf_counter() - t0:.1f}s")
    if cli.returncode != 0:
        fail(f"the training CLI failed: {cli.stderr[-2000:]}")
    print(json.dumps({"train": rows, "card": card}), flush=True)


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
    check_engine_features()
    check_hetero_engines()
    check_slot_ssm_engines()
    check_ring_prefill()
    check_fleet_gate()
    check_async_engines()
    graphs_phase()
    async_graphs_phase()
    runs = {}
    for name, extra, required in SERVE_RUNS:
        runs.update(serve_phase(name, extra, required))
    mesh_runs, moe_slabs = sharded_phase(worst)
    runs.update(mesh_runs)
    kernels = time_phase(runs, worst)
    for k in kernels:
        if k["name"] == "moe_grouped_ffn":
            k["rank_slabs"] = moe_slabs
    train_phase()
    leaked = sorted(m for m in sys.modules
                    if m == "jax" or m.startswith(("jax.", "repro.")))
    if leaked:
        fail(f"JAX or the JAX package was imported: {leaked[:5]}")
    card = card_line()
    print(f"total {time.perf_counter() - t0:.1f}s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
