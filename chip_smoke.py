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
            8192, and with its log-sum-exp output on the two 512-slot
            halves of a 1024-slot ring (a half that keeps nothing for a
            row: out 0, lse -1e30; the halves merged by combine_model_lse's
            arithmetic against the whole ring); prompt chunks at
            q_start 0/16/300, C 1/37/64/128, over a 1024-slot buffer
            with stale data past the chunk, K/V read
            through the strides of a [B,Hkv,S,hd] buffer, with a window,
            and chunks past the buffer's end whose rows that see no key
            must give exact zeros. Each flash case names the body it ran
            (bf16 at hd 64 and 128: the tensor-core body).
            The five attention kernels again at granite-moe (Hq=24, Hkv=8,
            hd=64), hymba (Hq=25, Hkv=5, hd=64) and smollm-360m (Hq=15,
            Hkv=5, hd=64) head shapes (the ring over a ragged 1000-slot
            ring). The SSD scan at mamba2-780m
            (H=48, P=64, N=128) and hymba (H=50, N=16) widths, T=1, 65,
            77 and 256, and at a rank's heads of each over 2 (H=24, 8
            prompts of 256; H=25, 2 of 1100), inputs as strided splits of
            one projection; the SSD decode step over a shuffled state arena
            with a pad and an inactive row (arena after the step compared
            too), at both widths, at a rank's 24 and 25 heads, and at
            every other branch of its slab
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
            inactive rows) at the same shapes. The async pipelined paged
            engine against the synchronous one, reduced edge-6b,
            granite-moe-3b-a800m (chunked prefill and speculative
            decoding on), mamba2-780m and hymba-1.5b (off, as JAX gates
            them): a bucket change with steps in flight, a suspend behind
            an in-flight decode, resume; logits bit for bit, and for the
            SSM archs the resumed state slot bit for bit what it held at
            the suspension. Every reduced engine on
            the card runs its steps captured as CUDA graphs (the
            engines' default).
3. graphs — each step the engines capture, at full width in bf16, run
            by an eager engine (cuda_graphs=False) and a captured one on
            the same weights and tasks. Decode-type: edge-6b's paged
            decode at b = 1, 2, 4, 8, its speculative iteration at b = 4,
            K = 4 (verify step and the draft's catch-up and masked decode),
            the slot engine's masked and compacted steps (16 slots) of
            edge-6b, mamba2-780m and hymba-1.5b, and the paged decode of
            mamba2-780m, granite-moe-3b-a800m and hymba-1.5b; 16 steps
            each. Prefill-type: the whole prompt at 64, 128 and 256 tokens
            (edge-6b, mamba2-780m, granite-moe-3b-a800m and hymba-1.5b on
            the paged engine; mamba2-780m and hymba-1.5b on the slot
            engine; edge-6b's slot engine at 256), a 256-token
            prompt in chunks of 64 on the paged and the slot engine, and
            a prefix hit's suffix in power-of-two pieces; 5 prompts a
            length, then 4 decode steps. Logits within the bf16
            tolerance, greedy streams identical, launch counts equal.
            Prints both engines' l(b) and prefill engine clock, the
            spread of 20 steps at the largest batch and the peak memory
            with and without graphs. Then the async engine against the
            synchronous one at full width for edge-6b, mamba2-780m,
            hymba-1.5b and granite-moe-3b-a800m: the scripted drive and
            32 decode steps at b=8, streams bit for bit, no staging wait,
            commit waits at most the stalls, both clocks per step.
4. serve  — the serve entry point, edge-6b at full width in bf16, every
            step captured: measured l(b), a few Poisson requests; under
            SLICE in seven runs: (a) the paged engine with atomic
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
            Then the paper's baselines, on the paged engine at --ratio
            0.5: (o) paged-orca (--scheduler orca) and (p)
            paged-fastserve (--scheduler fastserve), on the 512-page
            pool; (q) paged-fastserve-swap (fastserve --kv-swap) and (r)
            paged-slice-swap (SLICE --kv-swap), both on 28 pages at 12
            requests/s, where arrivals overlap past the pool. Each
            launches paged decode and flash prefill and finishes every
            task; each swap run must suspend at least SWAP_MIN_SUSPENDS
            times, resume every suspension, move bytes, restore each
            suspended task's private K/V pages bit for bit (a digest of
            their bytes in logical order before the suspension, held to
            the same after the resume, by wrapping the engine's suspend
            and resume), and end with no page held and an empty host
            arena; it prints suspends, resumes, swapped MB and the pool.
            One line then sets these runs' attainment (all, realtime,
            non-realtime) beside paged-realtime's, each with its SLO
            scale l(4) / 50: a smoke reading, as each run scales its SLOs
            from its own probed l(b).
            Then (e) mamba2-780m and (f) granite-moe-3b-a800m at full width
            in bf16 on the paged engine, with the same workload, each also
            through the async pipelined engine (paged-ssm-async,
            paged-moe-async: the engine idle at the end, no step in
            flight and no transfer outstanding), and hymba-1.5b on the
            paged engine (paged-hybrid): every task
            finishes, no page or state slot is left held, (e) launches the
            SSD scan and decode-step kernels, (f) the grouped-expert FFN,
            paged decode and flash prefill at head_dim 64, group 3,
            paged-hybrid all four.
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
            bf16 on the serve phase's workload cut to its first 2 s (8
            requests), 2 ranks over gloo on the
            card; every task finishes, every rank's pool ends empty, the
            ranks' digests are equal, each rank launches paged decode and
            flash prefill at its 16 query heads and 1 KV head. (d') The
            same with --arch granite-moe-3b-a800m --mesh-shape 2,2 (run
            paged-mesh-moe), 4 ranks: each rank on 12 query heads, 4 KV
            heads and 20 experts launches the grouped FFN too. The ranks
            import no JAX. Prints each rank's l(b) and engine clock,
            labelled as ranks sharing one H100 over gloo: no
            tensor-parallel speed. (b), (f), the slot-mesh cases and
            train-mesh's rank parts run on two groups of gloo ranks, one
            of 4 ranks, then one of 2 (``gloo_phase``), after the single
            process's references, with the dry-run cells and two
            examples and train-mesh (c)'s CLIs beside them
            (``start_background``); (d) and (d') each run alone.
5'. slot-mesh — the slot prefill and decode_step in JAX's sharded cache
            layout (cache_specs: the batch over ('pod', 'data'), the
            ring's K/V and kv_pos slots over 'model', every KV head, the
            SSM heads over 'model' where they divide it), one
            process a rank over gloo on the card, fp32 (TF32 off), each
            rank drawing its slab of the weights the single process
            draws: (a) edge-6b at full width and depth on a (1, 2) mesh,
            8 prompts of 500 tokens into a 1024-slot ring (512 slots a
            rank), 32 greedy decode steps under a fixed active pattern;
            (b) hymba-1.5b at full width, 8 of its 32 layers, on a
            (2, 2) mesh, 4 prompts of 1100 tokens into its 1024-slot
            window ring (wrapped, then cut in two; 2 rows a data group),
            25 of its 50 SSM heads a rank, 16 steps; (c) mamba2-780m at
            4 of its 48 layers on a (1, 2) mesh, 24 of its 48 SSM heads a
            rank, 8 prompts of 256 tokens, 32 steps (random fp32 stacks
            deeper amplify any reordering of a sum past MESH_TOL: see
            SLOT_MESH_CASES). The cases run on the sharded phase's gloo
            groups ((a) and (c) on its 2 ranks, (b) on its 4).
            Against the single process's prefill +
            decode steps on the whole cache, at a case's first depth:
            every rank's logits within MESH_TOL
            (prefill, and active rows), greedy streams identical, the
            ranks' caches put together (launch.sharding.gather_cache)
            equal to the process's (positions exact, K/V and SSM state
            within MESH_TOL of their magnitude); at every depth each
            rank's SSD state its rows and heads, every rank's launches
            exactly layers x steps ring decodes (with the log-sum-exp
            output) and a flash prefill a layer where the arch has
            attention, an SSD scan a layer and layers x steps SSD steps
            where it has SSM layers, no JAX imported. Runs (a)'s and
            (c)'s rank 0 launches stand under the time
            phase's rows at a rank's shapes.
6. time   — each kernel (device time: CUDA events over 30 calls queued
            behind a spin kernel, so the calls run back to back; the
            kernel's time launched at the host's pace is printed beside
            it), its plain version and the library's
            scaled_dot_product_attention as a yardstick (explicit boolean
            mask, K/V repeated to Hq, where the kernel masks by position;
            none for the paged kernels, which no single PyTorch call
            gathers), at the shapes its serving run used (the paged
            kernels over a full batch of the run's first requests, each
            mid-way through its output, run (a)'s rows also reporting
            the launches of every other edge-6b paged run, (o)-(r)
            among them, at the same heads, page size and pages a
            sequence; verify windows of depth+1
            queries; paged decode and flash prefill also at granite-moe's
            heads over run (f)'s batch and median prompt and at
            smollm-360m's over run (h)'s smollm instance's and at
            hymba-1.5b's over run paged-hybrid's; each paged row
            names its page splits); ring-cache decode over run (b)'s slot
            array and over run (j)'s at hymba's heads and window; the SSD
            scan over one median prompt of run (e) and of run (j); the SSD
            step over the full decode batch of runs (e), (i), (j) and
            paged-hybrid, each
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
            prompts; at a rank of run slot-mesh (a), the ring decode
            with its log-sum-exp over rank 0's 512 slots of a 1024-slot
            ring (B=8, every slot live) and the flash prefill of its 8
            prompts of 500 tokens at 16 query heads and 1 KV head; at a
            rank of run slot-mesh (c) (24 of mamba2-780m's 48 SSM heads),
            the SSD scan of its 8 prompts of 256 tokens and the SSD step
            over its 8 rows of the slot cache, cold. The
            multi-pass kernels' rows also print
            each pass's device time (torch.profiler): the ring-cache
            decode's split and combine, the SSD scan's chunk states, state
            passing and chunk outputs (JSON key "passes_us").
7. dryrun — python -m repro_torch.launch.dryrun in subprocesses (no JAX
            may be imported), started together in the background before
            the gloo ranks of the sharded phase (they use the CPU only,
            one thread each), read right after them: smollm-360m's
            decode_32k, prefill_32k and train_4k on the stand-in pod mesh
            (16, 16) and decode_32k on the multi-pod mesh (2,
            16, 16), every record ok; hubert-xlarge's decode_32k, a skip
            (encoder-only); mamba2-780m's decode_32k on the pod mesh, ok,
            its SSD state not among its departures (3 of the 48 SSM heads
            a rank). The roofline table of the pod records (python
            -m repro_torch.launch.roofline). Then the H100 roofline of
            three of the graphs phase's captured steps: build_cell and
            count_cell on a 1x1 stand-in mesh at full width in bf16
            (edge-6b's slot decode over 16 slots of a 1024-slot ring and
            its whole 256-token prefill, mamba2-780m's slot decode over
            16 slots), each term and the dominant one printed beside the
            captured clock the graphs phase measured, and the share
            bound / clock, which must not exceed 1.05 (JSON line
            {"roofline": [...]}).
8. examples — examples/torch_quickstart.py and
            torch_multi_slo_serving.py at their defaults, one after the
            other, torch_train_tiny.py (300 steps) and
            torch_edge_serving_sim.py at --duration 20 (the CPU only),
            these two started with the dry-run cells, each in a
            subprocess: exit 0, its SLO or
            loss line (the loss must fall), its kernels launched
            (flash_prefill and decode_attention; ssd_scan and
            ssd_decode_step), no JAX imported.
9. train  — the training path (forward, loss_fn, AdamW, train_step,
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
            subprocess must exit 0. The order on the card is: sharded
            (a), (e), the gloo ranks (the background jobs beside them),
            dryrun, train-mesh (c), sharded (c), the mesh serve runs,
            time, train, examples, the train-mesh checks.
10. train-mesh — the trainer over gloo ranks sharing the card
            (``train_mesh_phase``): (a) smollm-360m at 4 of 32 layers on
            (2, 2) against one process, (b) hubert-xlarge's forward on
            (1, 2), (d) a (2, 2) checkpoint of smollm-360m at 2 layers
            restored onto (1, 2), (2, 1, 2) and one process, (e)
            granite-moe's sorted MoE path (2 layers) on a split batch,
            (f) (a) on the pod mesh, run by the gloo groups of the
            sharded phase (one of 4 ranks and one of 2, with sharded (b),
            (f) and slot-mesh); (c) the training CLI with --mesh-shape
            2,2 and in one process, one step each, run together beside
            the gloo ranks.

The kernels JSON has one entry per kernel; each also names its shape and
the kernel body it ran ("tensor_core" or "cuda_core"), and a kernel timed
at a second shape lists it under "other_shapes" (its launches then sum
over every serving run). Each run's launches of a kernel stand under the
one row timed at that run's shapes (heads, state widths, arena layout):
the script fails if a run's launches stand under no row or under two.
The last lines are one line of each phase's seconds (largest first), the
kernels JSON, the card's name and power limit, and
{"ok": true, "device": {...}}. Exits non-zero, printing no result, when
CUDA is not available or the repository's sources are not beside it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import inspect
import json
import math
import os
import shutil
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
     ("paged_decode_attention", "flash_prefill", "add_rms_norm",
      "rope_kv_write", "silu_mul")),
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
    # the paper's baselines on the CLI's default mix: Orca (FCFS, every
    # resident in every step) and FastServe (skip-join MLFQ, a priority
    # subset each step), both with the CLI's batch cap, which the 512-page
    # pool leaves at 8
    ("paged-orca", ["--executor", "paged", "--scheduler", "orca",
                    "--ratio", "0.5"],
     ("paged_decode_attention", "flash_prefill")),
    ("paged-fastserve", ["--executor", "paged", "--scheduler", "fastserve",
                         "--ratio", "0.5"],
     ("paged_decode_attention", "flash_prefill")),
    # KV swap under real page pressure: 28 pages of 16 hold one QA peak
    # ((256 + 32) / 16 = 18 pages) and a little more, and at 12 requests/s
    # arrivals overlap. FastServe swaps out its most demoted resident for
    # an arrival that does not fit and swaps in by priority; SLICE
    # suspends low-utility residents for starved realtime arrivals. Each
    # must suspend at least SWAP_MIN_SUSPENDS times and restore every
    # suspended task's K/V pages bit for bit (swap_digests). At 40 pages
    # and 8/s SLICE suspended 1 task, and 0 or 1 at 28 pages and 8/s; 28
    # pages at 12/s suspended 7 twice (PERF.md §6)
    ("paged-fastserve-swap", ["--executor", "paged", "--scheduler",
                              "fastserve", "--kv-swap", "--pages", "28",
                              "--rate", "12", "--ratio", "0.5"],
     ("paged_decode_attention", "flash_prefill")),
    ("paged-slice-swap", ["--executor", "paged", "--kv-swap", "--pages",
                          "28", "--rate", "12", "--ratio", "0.5"],
     ("paged_decode_attention", "flash_prefill")),
    # SSM and MoE serving (DESIGN.md §12): the later --arch overrides
    # SERVE_ARGS's
    ("paged-ssm", ["--executor", "paged", "--arch", "mamba2-780m"],
     ("ssd_scan", "ssd_decode_step", "add_rms_norm")),
    # the same through the async pipelined engine: the state slots of
    # steps in flight
    ("paged-ssm-async", ["--executor", "paged", "--arch", "mamba2-780m",
                         "--async-pipeline"],
     ("ssd_scan", "ssd_decode_step")),
    ("paged-moe", ["--executor", "paged", "--arch", "granite-moe-3b-a800m"],
     ("moe_grouped_ffn", "paged_decode_attention", "flash_prefill",
      "add_rms_norm", "rope_kv_write")),
    # the MoE step's live-row counts under a queued step
    ("paged-moe-async", ["--executor", "paged", "--arch",
                         "granite-moe-3b-a800m", "--async-pipeline"],
     ("moe_grouped_ffn", "paged_decode_attention", "flash_prefill")),
    # the hybrid arch on the paged engine: attention over the pages and
    # the SSM mixer over the state arena in every step
    ("paged-hybrid", ["--executor", "paged", "--arch", "hymba-1.5b"],
     ("paged_decode_attention", "flash_prefill", "ssd_scan",
      "ssd_decode_step", "add_rms_norm", "rope_kv_write", "silu_mul")),
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
SWAP_MIN_SUSPENDS = 2      # suspensions each --kv-swap run must make
# the runs whose attainment the serve phase prints side by side, each with
# its own SLO scale (a smoke reading: the scale follows each run's l(b))
BASELINE_RUNS = ("paged-realtime", "paged-orca", "paged-fastserve",
                 "paged-fastserve-swap", "paged-slice-swap")
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
    # the paged decode step's fused elementwise chain: no TPU kernel (the
    # JAX package leaves these chains to XLA's fusion)
    "add_rms_norm": {
        "source": "src/repro_torch/csrc/decode_fused.cu",
        "replaces": "none (XLA fusion of layers.py rms_norm)"},
    "rope_kv_write": {
        "source": "src/repro_torch/csrc/decode_fused.cu",
        "replaces": "none (XLA fusion of layers.py apply_rope)"},
    "silu_mul": {
        "source": "src/repro_torch/csrc/decode_fused.cu",
        "replaces": "none (XLA fusion of layers.py gated_mlp)"},
}
# (Hq, Hkv, hd) of the fused RoPE + K/V write's checks: edge-6b, granite,
# hymba, smollm, a rank's slab of edge-6b and of granite, the reduced
# configs
FUSED_HEADS = ((32, 2, 128), (24, 8, 64), (25, 5, 64), (15, 5, 64),
               (16, 1, 128), (12, 4, 64), (4, 1, 32))


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


_START = time.perf_counter()
# (label, start) of every phase header so far: a header's label is its
# text before the first ": "
PHASES = []


def phase(name: str) -> None:
    """A phase's header line, with the seconds since the script started."""
    PHASES.append((name.split(": ")[0], time.perf_counter()))
    print(f"== {name} (at {time.perf_counter() - _START:.1f}s)", flush=True)


def phase_seconds() -> str:
    """One line: each phase's seconds (from its header to the next one's,
    the last to now; headers with one label summed), largest first."""
    took = {}
    ends = [t for _, t in PHASES[1:]] + [time.perf_counter()]
    for (label, t0), t1 in zip(PHASES, ends):
        took[label] = took.get(label, 0.0) + t1 - t0
    return "phase seconds, largest first: " + "; ".join(
        f"{label} {s:.1f}" for label, s in sorted(took.items(),
                                                   key=lambda kv: -kv[1]))


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
    check_ring_lse(report)
    check_fused(report)
    return worst


def fused_inputs(dtype, B, D=0, F=0, heads=None, n_pages=80, psz=16,
                 seed=0):
    """Inputs of the fused decode chain, scaled so every output stays
    below 2 (one bf16 ulp there is at most 2^-7, under TOL): add_rms_norm
    x, delta [B,D] and w [D] near -0.5 (so 1 + w halves the normed row);
    silu_mul g [B,F] at 0.5 and u at 0.25; rope_kv_write (``heads`` =
    (Hq, Hkv, hd)) q, k, v at 0.25, positions up to 1023 on distinct
    pages, rows 0 and 1 sent to the spare page at offset 0 as an untabled
    and an inactive row are. Returns a dict."""
    import numpy as np
    import torch
    from repro_torch.models import layers as L
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(scale, *shape):
        return (scale * torch.randn(*shape, generator=g,
                                    device="cuda")).to(dtype)
    out = {}
    if D:
        out["norm"] = (rnd(1.0, B, D), rnd(1.0, B, D),
                       (-0.5 + 0.05 * torch.randn(D, generator=g,
                                                  device="cuda")).to(dtype))
    if F:
        out["silu"] = (rnd(0.5, B, F), rnd(0.25, B, F))
    if heads is not None:
        Hq, Hkv, hd = heads
        rng = np.random.default_rng(seed)
        q_pos = torch.from_numpy(rng.integers(0, 1024, B).astype(np.int32))
        w_page = torch.from_numpy(rng.permutation(n_pages - 1)[:B]).long()
        w_off = (q_pos % psz).long()
        w_page[:min(B, 2)], w_off[:min(B, 2)] = n_pages - 1, 0
        out["rope"] = (rnd(0.25, B, Hq, hd), rnd(0.25, B, Hkv, hd),
                       rnd(0.25, B, Hkv, hd), q_pos.cuda(),
                       L.rope_table(hd, 10000.0, torch.device("cuda", 0)),
                       rnd(1.0, n_pages, Hkv, psz, hd),
                       rnd(1.0, n_pages, Hkv, psz, hd), w_page.cuda(),
                       w_off.cuda())
    return out


def check_fused(report):
    """The paged decode step's fused chain (csrc/decode_fused.cu) against
    its plain versions on the same inputs in the working type (the
    kernels round where the plain path rounds; bf16 outputs below 2,
    ``fused_inputs``), rows 1, 8 and 32: add_rms_norm at the serving
    archs' widths (the residual sum exact), rope_kv_write at FUSED_HEADS
    (written K within the tolerance and V exact, a spare-page row and an
    inactive row, every other page slot untouched), silu_mul at the
    dense archs' d_ff and a rank's slab."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.models import layers as L
    for dt in ("float32", "bfloat16"):
        dtype = getattr(torch, dt)
        for B in (1, 8, 32):
            for D in (4096, 1536, 1600, 960, 256):
                x, delta, w = fused_inputs(dtype, B, D=D, seed=B + D)["norm"]
                want_x, want_h = ref.add_rms_norm_ref(x.clone(), delta, w,
                                                      1e-5)
                got_x, got_h = ops.add_rms_norm(x, delta, w, 1e-5)
                torch.cuda.synchronize()
                if not torch.equal(got_x, want_x):
                    fail(f"add_rms_norm B={B} D={D} {dt}: the residual sum "
                         "differs from x + delta")
                report("add_rms_norm", f"B={B} D={D}, residual exact", dt,
                       (got_h.float() - want_h.float()).abs().max().item())
            for F in (13696, 6848, 5504, 2560, 512):
                gt, up = fused_inputs(dtype, B, F=F, seed=B + F)["silu"]
                got = ops.silu_mul(gt, up)
                torch.cuda.synchronize()
                report("silu_mul", f"B={B} F={F}", dt,
                       (got.float() - ref.silu_mul_ref(gt, up).float())
                       .abs().max().item())
            for heads in FUSED_HEADS:
                (q, k, v, qp, fr, kp, vp, wp,
                 wo) = fused_inputs(dtype, B, heads=heads, seed=B)["rope"]
                kp0, vp0 = kp.clone(), vp.clone()
                want_q = ref.rope_kv_write_ref(q, k, v, qp, fr, kp0.clone(),
                                               vp0.clone(), wp, wo)
                want_k = L.rope_rotate(k[:, None], qp[:, None], fr)[:, 0]
                got_q = ops.rope_kv_write(q, k, v, qp, fr, kp, vp, wp, wo)
                torch.cuda.synchronize()
                lo = min(B, 2)                # rows 0, 1: the spare page
                # rows that meet on the spare page write it in no fixed
                # order, 16 bytes at a time: each element is one of theirs
                errs = [(got_q.float() - want_q.float()).abs().max().item(),
                        torch.stack([(kp[-1, :, 0].float()
                                      - want_k[r].float()).abs()
                                     for r in range(lo)]).amin(0)
                        .max().item()]
                if B > lo:
                    errs.append((kp[wp[lo:], :, wo[lo:]].float()
                                 - want_k[lo:].float()).abs().max().item())
                err = max(errs)
                written = torch.zeros(kp.shape[0], kp.shape[2],
                                      dtype=torch.bool, device="cuda")
                written[wp, wo] = True
                keep = ~written[:, None, :, None].expand_as(kp)
                if not (torch.equal(vp[wp[lo:], :, wo[lo:]], v[lo:])
                        and torch.equal(kp[keep], kp0[keep])
                        and torch.equal(vp[keep], vp0[keep])
                        and torch.stack([vp[-1, :, 0] == v[r]
                                         for r in range(lo)]).any(0).all()):
                    fail(f"rope_kv_write B={B} heads={heads} {dt}: V not "
                         "written exactly, or a slot no row writes changed")
                report("rope_kv_write", f"B={B} Hq,Hkv,hd={heads}, spare "
                       "and inactive rows, V and other slots exact", dt, err)


def check_ring_lse(report):
    """The ring decode kernel with ``return_lse`` (what a rank runs over
    its slice of a slot cache cut by sequence) at edge-6b's heads
    on the two 512-slot halves of a 1024-slot ring, fp32 and bf16, into
    NaN-poisoned outputs: each half's output and each row's log-sum-exp
    against the plain version's; rows a half keeps nothing of (row 0
    everywhere, row 1 in the upper half) give out 0 and lse -1e30; the
    halves merged by ``combine_model_lse``'s arithmetic
    (``partitioning.merge_lse``) against the kernel over the whole ring."""
    import numpy as np
    import torch
    from repro_torch.kernels import decode_attention as _da
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import paged_attention as _pa
    from repro_torch.models.partitioning import merge_lse
    S, half = 1024, 512
    q_pos = [0, 300, 700, 2 * S + 100, 900]
    kv_pos = np.full((len(q_pos), S), -1, np.int32)
    kv_pos[1, :301] = np.arange(301)
    kv_pos[2, :701] = np.arange(701)
    for p in range(q_pos[3] - S + 1, q_pos[3] + 1):
        kv_pos[3, p % S] = p
    kv_pos[4] = np.random.default_rng(4).integers(0, 1000, S)
    kv_pos[4, ::7] = -1
    for dt in ("float32", "bfloat16"):
        dtype = getattr(torch, dt)
        q, k, v, kp, qp = ring_inputs(q_pos, kv_pos, dtype, S, seed=41)
        _, sps, nsplit = _da.plan(16, 128, half, dtype)
        parts = []
        for lo in (0, half):
            sk, sv = (x[:, :, lo:lo + half].contiguous() for x in (k, v))
            skp = kp[:, lo:lo + half].contiguous()
            poison(q.shape, q.dtype)
            out, lse = ops.decode_attention(q, sk, sv, skp, qp,
                                            return_lse=True)
            torch.cuda.synchronize()
            want, want_lse = ref.decode_attention_ref(
                q.float(), sk.float(), sv.float(), skp, qp, None, True)
            live = want_lse > -1e29                        # [B, Hq]
            if not (torch.isfinite(out.float()).all()
                    and (out[~live].float() == 0).all()
                    and (lse[~live] == -1e30).all() and not live[0].any()
                    and live[2:].all() and live[1].all() == (lo == 0)):
                fail("decode_attention lse: rows a slice keeps nothing of "
                     "must give out 0 and lse -1e30")
            err = max((out.float() - want)[live].abs().max().item(),
                      (lse - want_lse)[live].abs().max().item())
            report("decode_attention", f"return_lse, slots {lo}..{lo + half}"
                   f" of a {S}-slot ring, Hq=32 Hkv=2 hd=128 B={len(q_pos)} "
                   f"q_pos={q_pos} ({_pa.body(dtype, 128)} body, {nsplit} "
                   f"splits of {sps} slots; out and lse)", dt, err)
            parts.append((out, lse))
        whole = ops.decode_attention(q, k, v, kp, qp)
        merged = merge_lse(parts)
        torch.cuda.synchronize()
        report("decode_attention", f"two {half}-slot halves merged by "
               "combine_model_lse's arithmetic against the whole ring",
               dt, (merged.float() - whole.float())[1:].abs().max().item())


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
        # mamba2-780m's and hymba-1.5b's widths, then a rank's heads of
        # each over 2 (slot-mesh (c)'s 8 prompts of 256, (b)'s data
        # group's 2 prompts of 1100)
        for B, T, H, P, N in ((1, 256, 48, 64, 128), (2, 77, 48, 64, 128),
                              (1, 1, 48, 64, 128), (1, 256, 50, 64, 16),
                              (2, 65, 50, 64, 16), (8, 256, 24, 64, 128),
                              (2, 1100, 25, 64, 16)):
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
        # mamba2-780m's and hymba-1.5b's widths, a rank's heads of each
        # over 2, then every other branch of the slab plan: the reduced
        # configs' width, N/4 = 3 (row sums in shared memory), P = 80 (a
        # ragged last slab), N = 256 (a 64 KB tile, N/4 past a warp)
        for H, P, N in ((48, 64, 128), (50, 64, 16), (24, 64, 128),
                        (25, 64, 16), (4, 32, 16), (4, 24, 12), (4, 80, 64),
                        (2, 64, 256)):
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


# the archs the async engine runs on: edge-6b with chunked prefill and
# speculative decoding on in the reduced check, granite-moe with them too,
# mamba2-780m (SSM) and hymba-1.5b (hybrid) without them, as JAX gates
# them for recurrent state (DESIGN.md §12)
ASYNC_ARCHS = ("edge-6b", "mamba2-780m", "hymba-1.5b", "granite-moe-3b-a800m")


def check_async_engines():
    """The async pipelined engine against the synchronous one on the card
    (reduced, fp32, steps captured, same weights), one scripted sequence
    (``async_drive``) an arch of ASYNC_ARCHS, chunked prefill and
    speculative decoding on where the arch takes them: logits bit for
    bit at every observed point, greedy streams equal, the pool and store
    consistent and the ledger idle after drain(); for the SSM archs the
    suspended task's state slot (SSD state and conv tail) after its
    resume bit for bit what it held when the suspension was issued
    behind the in-flight decode."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.task import SLOSpec, Task
    from repro_torch.models import model as M
    from repro_torch.serving.executor import PagedTorchExecutor
    phase("check the async engine against the sync engine on the card")
    for arch in ASYNC_ARCHS:
        cfg = get_config(arch).reduced()
        params = M.init_params(cfg, seed=0, device="cuda")
        feats = {} if cfg.has_ssm else dict(prefill_chunk_size=16,
                                            spec_decode=True,
                                            max_spec_depth=2)
        out = {}
        for async_dispatch in (False, True):
            ex = PagedTorchExecutor(cfg, params=params, n_pages=64,
                                    page_size=16, max_seq=128, max_batch=4,
                                    device="cuda",
                                    async_dispatch=async_dispatch, **feats)
            tasks = [Task(SLOSpec(tpot_ms=100.0), 1.0, prompt_len=n,
                          output_len=40, task_id=7600 + i)
                     for i, n in enumerate((5, 17, 40, 29))]
            if cfg.has_ssm:                     # a prompt below the conv width
                tasks[2].prompt_len = 2
            seen, restored = [], []
            if cfg.has_ssm:
                held_state(ex, restored)
            tasks = async_drive(ex, tasks[:3], tasks[3],
                                lambda what, a: seen.append((what, a)))
            ex.pool.check()
            ex.store.check()
            ex.ledger.check()
            out[async_dispatch] = dict(
                seen=seen, streams=[ex.generated_tokens(t) for t in tasks],
                stalls=ex.gap_stats.stalls, idle=ex.ledger.outstanding() == 0,
                swaps=ex.ledger.started, stage_waits=ex.graphs.stage_waits,
                restored=restored)
            del ex
        sync, asy = out[False], out[True]
        same = all(np.array_equal(a, b) for (_, a), (_, b) in
                   zip(sync["seen"], asy["seen"]))
        state = ("" if not cfg.has_ssm else
                 f"; state slot restored bit for bit {asy['restored']}")
        print(f"engine async vs sync ({cfg.name}, captured): logits bit for "
              f"bit at {[w for w, _ in asy['seen']]}: {same}; streams_equal="
              f"{sync['streams'] == asy['streams']}; stalls {asy['stalls']}, "
              f"transfers {asy['swaps']}, staging waits "
              f"{asy['stage_waits']}, ledger idle {asy['idle']}{state}")
        if (not same or sync["streams"] != asy["streams"] or not asy["idle"]
                or asy["stalls"] == 0 or asy["swaps"] != 1
                or (cfg.has_ssm and sync["restored"] + asy["restored"]
                    != [True, True])):
            fail(f"the async engine on the card disagrees with the sync "
                 f"engine ({cfg.name})")
        del params
        torch.cuda.empty_cache()


def held_state(ex, restored):
    """Wrap ``ex``'s suspend and resume (this instance only): at a
    suspension, a copy of the task's state slot taken on the compute
    stream, so behind any step in flight; after its resume, whether the
    slot it got back holds that copy bit for bit, appended to
    ``restored``."""
    import torch
    suspend, resume, held = ex.suspend, ex.resume, {}
    names = ("ssm_state", "conv_state")

    def slot_of(task):
        return ex.states.slot_of(task.task_id)

    def on_suspend(task):
        held[task.task_id] = [ex.pages[n][:, slot_of(task)].clone()
                              for n in names]
        return suspend(task)

    def on_resume(task):
        ms = resume(task)
        restored.append(all(torch.equal(ex.pages[n][:, slot_of(task)], h)
                            for n, h in zip(names,
                                            held.pop(task.task_id))))
        return ms

    ex.suspend, ex.resume = on_suspend, on_resume


ASYNC_STEPS = 32          # timed steady-state decode steps at b=8


def async_graphs_phase():
    """The async engine at full width (paged, bf16, captured) against the
    synchronous one on the same weights, for each arch of ASYNC_ARCHS:
    the scripted drive (``async_drive`` over 3 tasks, no chunking or
    drafting) and then ASYNC_STEPS decode steps at b=8 over 8 tasks,
    greedy streams bit for bit; prints both modes' engine clock per step
    (the host time of the steps, the async drive's ending in drain()),
    the async dispatch ms, staging waits (must be 0) and commit waits (at
    most one a stall) per step."""
    import gc

    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.task import SLOSpec, Task
    from repro_torch.models import model as M
    from repro_torch.serving.executor import PagedTorchExecutor
    phase("graphs async: the async engine against the sync engine, full "
          "width (bf16)")
    for arch in ASYNC_ARCHS:
        cfg = get_config(arch)
        params = M.init_params(cfg, seed=0, dtype=torch.bfloat16,
                               device="cuda")
        out = {}
        for async_dispatch in (False, True):
            ex = PagedTorchExecutor(cfg, params=params, n_pages=512,
                                    page_size=16, max_seq=1024, max_batch=8,
                                    device="cuda",
                                    async_dispatch=async_dispatch)
            tasks = [Task(SLOSpec(tpot_ms=100.0), 1.0,
                          prompt_len=96 + 9 * i, output_len=512,
                          task_id=9800 + i) for i in range(8)]
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
        print(f"{arch} paged b=8, {ASYNC_STEPS} steps: engine clock sync "
              f"{sync['ms']:.3f} ms/step, async {asy['ms']:.3f} ms/step "
              f"(dispatch {asy['disp']:.3f} ms/step); async host waits per "
              f"step while dispatching: staging "
              f"{asy['stage'] / ASYNC_STEPS:.2f}, commits "
              f"{asy['commit'] / ASYNC_STEPS:.2f} ({asy['commit']} over "
              f"{asy['stalls']} stalls), then {asy['drained']} in the "
              f"drain; streams_equal={same} "
              f"({sum(map(len, asy['streams']))} tokens)", flush=True)
        if not same:
            fail(f"full-width async engine ({arch}): streams differ from the "
                 "sync engine")
        if asy["stage"] or asy["commit"] > asy["stalls"]:
            fail(f"full-width async engine ({arch}): host waits beyond the "
                 "commits its queue's depth forces")


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
    # attention over the pages and the SSM mixer over the state arena in
    # one step (decode_step_paged's hybrid _mix)
    ("hymba-1.5b paged", "hymba-1.5b", "paged", {}, (1, 2, 4, 8), None),
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
    ("hymba-1.5b whole prefill", "hymba-1.5b", "paged", {}, "whole",
     (64, 128, 256)),
)
PREFILL_REPS = 5          # timed prompts an engine at each length
# the graphs phase's captured clocks (ms, median): a decode case's step at
# its largest batch by case, a prefill case's prompt by (case, length)
CAPTURED = {}


def graphs_phase():
    """Each decode-type step the engines capture (paged decode of edge-6b,
    mamba2-780m, granite-moe and hymba-1.5b at b = 1, 2, 4, 8; edge-6b's
    verify step
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
        CAPTURED[case] = float(np.median(cap["spread"]))
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
        CAPTURED[(case, L)] = float(np.median(c))
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
              f"(bf16) under --scheduler {args.scheduler}")
        print("serve args:", " ".join(argv))
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        ops.reset_launches()
        with (launches_by_engine() if args.fleet
              else contextlib.nullcontext({})) as by_engine, \
                (swap_digests() if args.kv_swap
                 else contextlib.nullcontext(None)) as swaps:
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
        if args.async_pipeline:
            check_async_run(run_name, run)
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
    if swaps is not None:
        check_swap_run(run_name, ex, res, swaps)
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
              "chunk": args.prefill_chunk,
              "slo_scale": max(run.lat.decode_ms(max(2, args.slots // 2))
                               / 50.0, 0.02)}
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


@contextlib.contextmanager
def swap_digests():
    """Hold every suspension of the paged engine to its resume: before a
    suspend, a digest of the bytes of the task's private K/V pages (the
    ones the swap releases), in logical order; after the resume, the same
    digest of the pages now at those logical positions. Yields
    {"suspended": n, "restored": n, "differ": [task ids]}, filled as the
    engines run; a call that raises records nothing."""
    import hashlib

    import torch
    from repro_torch.serving.executor import PagedTorchExecutor as cls
    out = {"suspended": 0, "restored": 0, "differ": []}
    before = {}
    saved = {"suspend": cls.suspend, "resume": cls.resume}

    def digest(ex, tid, logical):
        table = ex.pool.page_table(tid)
        idx = torch.as_tensor([table[i] for i in logical], device=ex.device)
        h = hashlib.sha256()
        for name in ("k_pages", "v_pages"):
            h.update(ex.pages[name][:, idx].contiguous().view(torch.uint8)
                     .cpu().numpy().tobytes())
        return h.hexdigest()

    def suspend(self, task):
        tid = task.task_id
        logical = [i for i, p in enumerate(self.pool.page_table(tid))
                   if self.pool.ref_count(p) == 1]
        seen = digest(self, tid, logical)
        ms = saved["suspend"](self, task)
        before[tid] = (logical, seen)
        out["suspended"] += 1
        return ms

    def resume(self, task):
        ms = saved["resume"](self, task)
        logical, seen = before.pop(task.task_id)
        if digest(self, task.task_id, logical) != seen:
            out["differ"].append(task.task_id)
        out["restored"] += 1
        return ms

    cls.suspend, cls.resume = suspend, resume
    try:
        yield out
    finally:
        cls.suspend, cls.resume = saved["suspend"], saved["resume"]


def check_swap_run(run_name, ex, res, swaps):
    """A --kv-swap run: at least SWAP_MIN_SUSPENDS suspensions, each
    resumed, bytes moved, every resumed task's K/V pages bit for bit what
    they were before its suspension, and the host arena empty."""
    print(f"swap: suspends={res.suspends} resumes={res.resumes} swapped="
          f"{res.swapped_bytes / 1e6:.1f}MB pool={ex.n_pages} pages of "
          f"{ex.page_size}; {swaps['restored']} resumes held to their "
          f"suspension's K/V digest, {len(swaps['differ'])} differ; host "
          f"arena {ex.arena.bytes_held} B held at the end (peak "
          f"{ex.arena.peak_bytes / 1e6:.1f}MB)")
    if res.suspends < SWAP_MIN_SUSPENDS:
        fail(f"{run_name}: {res.suspends} suspensions, fewer than "
             f"{SWAP_MIN_SUSPENDS}: the pool was under no pressure")
    if (res.resumes != res.suspends or swaps["suspended"] != res.suspends
            or swaps["restored"] != res.resumes):
        fail(f"{run_name}: {res.suspends} suspends and {res.resumes} "
             f"resumes in the loop, {swaps['suspended']} and "
             f"{swaps['restored']} in the engine")
    if res.swapped_bytes <= 0:
        fail(f"{run_name}: suspensions moved no bytes")
    if swaps["differ"]:
        fail(f"{run_name}: resumed K/V pages differ from the suspended "
             f"ones for tasks {swaps['differ']}")
    ex.arena.check()
    if ex.arena.bytes_held or ex.arena.owners_held:
        fail(f"{run_name}: the host arena still holds "
             f"{ex.arena.bytes_held} B of {ex.arena.owners_held} tasks")


def print_baseline_attainment(runs):
    """One line: the attainment of the baseline and swap runs beside
    paged-realtime's, each with the SLO scale of its own probed l(b)."""
    from repro_torch.serving.metrics import summarize
    parts = []
    for name in BASELINE_RUNS:
        shapes = runs[name][0]
        att = summarize(shapes["tasks"])
        parts.append(f"{name} {att['all'].slo:.1%} / "
                     f"{att['realtime'].slo:.1%} / "
                     f"{att['non_realtime'].slo:.1%} (scale "
                     f"{shapes['slo_scale']:.4f})")
    print("attainment, all / realtime / non-realtime, a smoke reading (each "
          "run scales its SLOs by its own l(4) / 50): " + "; ".join(parts))


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
    """The traced serve run: the replay ledger reproduces the loop's
    counters and the Perfetto file loads back."""
    from repro_torch.serving.trace import events_conserved, replay_counters
    tr, res = run.trace, run.result
    conserved = events_conserved(tr.events, res)
    with open(path) as f:
        doc = json.load(f)
    rows = len(doc["traceEvents"])
    kinds = sorted({e.kind for e in tr.events})
    print(f"trace: {len(tr)} events ({tr.dropped} dropped), {rows} Perfetto "
          f"rows read back, {len(tr.snapshots)} snapshots, kinds {kinds}; "
          f"events_conserved={conserved}; replayed "
          f"{replay_counters(tr.events)['decode_iterations']} decode steps")
    if not conserved or tr.dropped or not rows:
        fail("traced run: the event stream does not reproduce the loop's "
             "counters, or the Perfetto file is empty")


def check_async_run(run_name, run):
    """An --async-pipeline serve run: the pipeline counters are there
    (stalls, a positive dispatch time) and the engine is idle: no step
    in flight, no transfer outstanding."""
    res, ex = run.result, run.executor
    print(f"pipeline: stalls={res.pipeline_stalls} dispatch_ms="
          f"{res.dispatch_ms:.3f} wait_ms={res.wait_ms:.3f} schedule_ms="
          f"{res.schedule_ms:.3f} swap_overlap_ms={res.swap_overlap_ms:.3f} "
          f"host_gap_ms={res.dispatch_ms + res.wait_ms:.3f}; staging waits "
          f"{ex.graphs.stage_waits}, commit waits {ex.graphs.commit_waits}")
    if res.dispatch_ms <= 0 or len(ex._queue) or ex.ledger.outstanding():
        fail(f"{run_name}: no dispatch time booked, or steps or transfers "
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


def mesh_engine_run(mesh, arch):
    """(b) or (f) on a rank (``gloo_rank``): ``arch`` at full width in
    fp32 (TF32 off) on its slab of ``mesh``, over gloo on the one card,
    eager steps. Returns what mesh_ops saw, the rank's launches during
    them, its heads, the experts it holds, its digest and loop clock (the
    agreed ms of its ops)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.serving.executor import PagedTorchExecutor
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
            "launches": dict(ops.LAUNCHES), "ops_s": time.perf_counter() - t0}


# sharded (b) and (f): (label, arch, (data, model) mesh)
MESH_EQUIV = (("(b)", "edge-6b", (1, 2)),
              ("(f)", "granite-moe-3b-a800m", (2, 2)))


def mesh_one(label, arch, shape):
    """(b) or (f)'s reference: the single-process paged engine at full
    width in fp32 on mesh_ops; (prefill logits, decode logits, streams,
    seconds)."""
    import gc

    import torch
    from repro_torch.configs import get_config
    from repro_torch.serving.executor import PagedTorchExecutor
    phase(f"sharded {label}: {arch} fp32, one engine (the reference of a "
          f"{shape} mesh of {shape[0] * shape[1]} gloo ranks)")
    ex = PagedTorchExecutor(get_config(arch), device="cuda",
                            cuda_graphs=False, **MESH_ENGINE)
    t0 = time.perf_counter()
    pre, dec, streams = mesh_ops(ex)
    torch.cuda.synchronize()
    one_s = time.perf_counter() - t0
    del ex
    gc.collect()
    torch.cuda.empty_cache()
    return pre, dec, streams, one_s


def check_mesh_equivalence(label, arch, shape, one, ranks):
    """(b) edge-6b at full width, fp32: 2 ranks over gloo sharing the card
    against the single-process paged engine (``one``), on the same ops:
    streams identical, logits within MESH_TOL, equal launches, digests
    and loop clocks on the ranks. (f) granite-moe the same way on a (2,
    2) mesh, 4 ranks: mesh_ops's decode bucket of 4 split 2 + 2 over the
    data groups, each rank on 20 of the 40 experts, the grouped FFN
    launched on every rank. ``ranks``: each rank's ``mesh_engine_run``."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.launch import sharding as S
    data, model = shape
    ways = data * model
    cfg = get_config(arch)
    experts = (cfg.n_experts // model if cfg.block_kind == "moe"
               and cfg.n_experts % model == 0 else cfg.n_experts)
    pre, dec, streams, one_s = one
    for r, res in enumerate(ranks):
        heads = S.head_slab(cfg, model, r % model)
        if res["heads"] != heads or res["experts"] != experts:
            fail(f"{label} rank {r} holds heads {res['heads']} and "
                 f"{res['experts']} experts, not {heads} and {experts}")
        if res["streams"] != streams:
            fail(f"{label} rank {r}'s greedy streams differ from the single "
                 f"engine's: {res['streams']} != {streams}")
        err = max(float(np.abs(a - b).max()) for a, b in
                  zip(res["pre"] + res["dec"], pre + dec))
        print(f"sharded {label} rank {r}: heads {res['heads']}, "
              f"{res['experts']} experts, streams identical "
              f"({len(MESH_PROMPTS)} x {MESH_STEPS + 1} tokens), logits "
              f"max_abs_err={err:.3e} tol={MESH_TOL:g}, launches "
              f"{res['launches']}, digest {res['digest']:#x}, loop clock "
              f"{res['clock']:.3f} ms, ops {res['ops_s']:.2f} s (single "
              f"engine {one_s:.2f} s; {ways} ranks sharing one H100 over "
              "gloo, eager: no tensor-parallel speed)")
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
# launch) on the serve phase's workload cut to its first 2 s (8 requests,
# the batch cap: at 4 s the 14 requests queued behind it for 131 eager
# steps of 160-250 ms), the ranks sharing the card over gloo with eager
# steps
MESH_SERVE_CUT = ["--duration", "2"]
MESH_SERVE_RUNS = (
    ("paged-mesh", ["--mesh-shape", "1,2"] + MESH_SERVE_CUT,
     ("paged_decode_attention", "flash_prefill")),
    # granite-moe expert-parallel (20 of its 40 experts a rank), the
    # decode batches of 2, 4 and 8 split over two data groups
    ("paged-mesh-moe", ["--arch", "granite-moe-3b-a800m", "--mesh-shape",
                        "2,2"] + MESH_SERVE_CUT,
     ("paged_decode_attention", "flash_prefill", "moe_grouped_ffn")),
)


def mesh_serve_phase():
    """(d) The serve CLI with --mesh-shape 1,2: edge-6b at full width in
    bf16 on the serve phase's workload, 2 ranks over gloo on the one
    card. (d') granite-moe the same way with --mesh-shape 2,2, 4 ranks.
    Each runs alone: SLICE schedules by the clock, and beside the other
    run it deferred tasks past the end of the workload. Every task
    finishes, every rank's pool ends empty, the ranks' digests are
    equal, each rank holds its slab (heads, experts) and launches its
    run's kernels. Returns the runs' entries for the time phase: the
    shapes a rank's kernels saw (a rank's heads, experts and rows of a
    full decode batch), the ranks' launches summed."""
    from repro_torch.launch import serve
    entries = {}
    for name, extra, required in MESH_SERVE_RUNS:
        argv = SERVE_ARGS + ["--executor", "paged"] + extra
        args = serve.parse_args(argv)
        data, model = serve._mesh_shape(args)
        phase(f"sharded serve {name}: {args.arch} at full width (bf16), "
              f"{data * model} ranks of a ({data}, {model}) mesh over gloo "
              "sharing the card")
        print("serve args:", " ".join(argv))
        t0 = time.perf_counter()
        run = serve.run(args)
        entries[name] = check_mesh_serve(name, args, required, run,
                                         time.perf_counter() - t0)
    return entries


def check_mesh_serve(name, args, required, run, wall):
    """One MESH_SERVE_RUNS run's checks (``mesh_serve_phase``); returns
    its entry for the time phase."""
    import dataclasses
    import types

    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.launch import sharding as S
    data, model = serve._mesh_shape(args)
    cfg = get_config(args.arch)
    experts = (cfg.n_experts // model if cfg.block_kind == "moe"
               and cfg.n_experts % model == 0 else cfg.n_experts)
    if not isinstance(run, serve.MeshRun) or run.backend != "gloo":
        fail(f"{name}: not a gloo mesh run")
    launches = dict.fromkeys(KERNELS, 0)
    for r, res in enumerate(run.ranks):
        heads = S.head_slab(cfg, model, r % model)
        print(f"rank {r} ({res['device']}): heads q={res['heads'][0]} "
              f"kv={res['heads'][1]} (KV head {res['heads'][2]}), "
              f"{res['experts']} experts, l(b) "
              f"{' '.join(f'l({b})={ms:.3f}ms' for b, ms in res['probes'])}"
              f" (read: {' '.join(f'l({b})={ms:.3f}ms' for b, ms in res['probe_read'])})"
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
    return shapes, launches


# (label, arch, (data, model), batch, prompt length, ring slots, decode
# steps, depths: layers or None for all; the logits, streams and caches
# are checked at the first, launches and SSD state shapes at every one,
# the others' logits errors printed): (a) edge-6b's prompts fill rank 0's
# half of the ring and its decode steps cross into rank 1's; (b) hymba's
# prompts are longer than its 1024-token window, so the ring wraps before
# it is cut in two, and its 50 SSM heads are cut 25 a rank; (c) mamba2's
# 48 SSM heads 24 a rank (no attention: the ring is not used). Random
# fp32 stacks this deep amplify any change in the order of a sum: one
# process against itself with out_proj's product cut in two and added
# lands 1.10e-4 from itself at hymba's 16 layers and 3.18e-4 at
# mamba2's 24, and flips a greedy token at mamba2's 48
# (launch/slot_mesh_margins.py, PERF.md §6). The ranks' partial sums of
# the MLP, out_proj and the norm's squares are such changes: (b) came
# 1.035e-4 from one process at 16 layers (8.401e-5 with the SSM whole),
# (c) on (1, 2) 4.292e-5 at 4 layers, 1.073e-4 at 8, 1.505e-3 at 48. So
# (b) is checked at 8 layers and (c) at 4 (deeper stacks could only print
# their errors; launch/slot_mesh_margins.py measures them). The cases run
# on the gloo groups of gloo_phase
SLOT_MESH_CASES = (("(a)", "edge-6b", (1, 2), 8, 500, 1024, 32, (None,)),
                   ("(b)", "hymba-1.5b", (2, 2), 4, 1100, 1024, 16, (8,)),
                   ("(c)", "mamba2-780m", (1, 2), 8, 256, 512, 32, (4,)))


def slot_mesh_config(index, layers):
    """The config of SLOT_MESH_CASES[index], cut to ``layers`` (None:
    all)."""
    from repro_torch.configs import get_config
    cfg = get_config(SLOT_MESH_CASES[index][1])
    return cfg if layers is None else dataclasses.replace(cfg,
                                                          n_layers=layers)


def slot_mesh_inputs(cfg, batch, prompt, steps):
    """The case's prompts [batch, prompt] int32 and active pattern [steps,
    batch] bool, from seeded generators on the host."""
    import torch
    g = torch.Generator().manual_seed(27)
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt), generator=g,
                            dtype=torch.int32)
    active = torch.tensor([[(b + t) % 4 != 3 for b in range(batch)]
                           for t in range(steps)])
    return prompts, active


def slot_mesh_ops(cfg, params, prompts, active, buf_len):
    """``prefill`` of every prompt into a ``buf_len``-slot cache, then the
    greedy decode steps under the active pattern (an inactive row keeps
    its token), under whatever partitioning context is installed; the
    logits, tokens and final cache as numpy arrays (a spawned rank's
    result crosses a queue)."""
    import numpy as np
    import torch
    from repro_torch.models import model as M
    dev = torch.device("cuda", 0)

    def host(x):
        return x.float().cpu().numpy() if x.is_floating_point() else \
            x.cpu().numpy()

    logits, cache = M.prefill(cfg, params, prompts.to(dev), buf_len)
    pre = host(logits)
    tokens = logits.argmax(-1).to(torch.int32)
    dec, streams = [], [host(tokens)]
    for act in active.to(dev):
        logits, cache = M.decode_step(cfg, params, cache, tokens, act,
                                      buf_len=buf_len)
        dec.append(host(logits))
        tokens = torch.where(act, logits.argmax(-1).to(torch.int32), tokens)
        streams.append(host(tokens))
    torch.cuda.synchronize()
    return {"pre": pre, "dec": dec, "streams": np.stack(streams),
            "cache": {k: host(v) for k, v in cache.items()}}


def slot_mesh_run(mesh, index):
    """Case SLOT_MESH_CASES[index] on a rank (``gloo_rank``), at each of
    its depths: its slab of the weights (drawn as the single process
    draws them, fp32, TF32 off) on ``mesh``, slot_mesh_ops under
    activation_partitioning; also its launches and seconds. A list, one
    entry a depth."""
    import gc

    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import sharding as S
    from repro_torch.models import model as M
    from repro_torch.models.partitioning import activation_partitioning
    _, _, shape, batch, prompt, buf_len, steps, depths = \
        SLOT_MESH_CASES[index]
    outs = []
    for layers in depths:
        cfg = slot_mesh_config(index, layers)
        params = M.init_params(cfg, seed=0, dtype=torch.float32,
                               device="cuda:0", cut=S.cutter(cfg, mesh))
        prompts, active = slot_mesh_inputs(cfg, batch, prompt, steps)
        ops.reset_launches()
        t0 = time.perf_counter()
        with activation_partitioning(mesh, S.cut_leaves(cfg, shape[1])):
            out = slot_mesh_ops(cfg, params, prompts, active, buf_len)
        out.update(launches=dict(ops.LAUNCHES), ops_s=time.perf_counter() - t0)
        outs.append(out)
        del params
        gc.collect()
        torch.cuda.empty_cache()
    return outs


def slot_mesh_errors(one, res, active):
    """(largest |logits - one process's| over the prefill and the active
    rows of every step, the prefill's, the steps', the logits' largest
    magnitude)."""
    import numpy as np
    pre = float(np.abs(res["pre"] - one["pre"]).max())
    dec = max(float(np.abs(a - b)[act].max()) for a, b, act in
              zip(res["dec"], one["dec"], active.numpy()))
    scale = max(float(np.abs(x).max()) for x in [one["pre"]] + one["dec"])
    return max(pre, dec), pre, dec, scale


def slot_mesh_one(index):
    """The single process's prefill + decode steps of case
    SLOT_MESH_CASES[index] on the whole cache at each depth: [(what
    slot_mesh_ops returned, its seconds)]."""
    import gc

    import torch
    from repro_torch.models import model as M
    label, arch, shape, batch, prompt, buf_len, steps, depths = \
        SLOT_MESH_CASES[index]
    data, model = shape
    cfgs = [slot_mesh_config(index, layers) for layers in depths]
    phase(f"slot-mesh {label}: {arch} fp32 prefill + decode_step in JAX's "
          f"cache layout on a ({data}, {model}) mesh of {data * model} gloo "
          f"ranks against one process, {batch} prompts of {prompt} tokens "
          f"into {buf_len} slots, {steps} steps, at "
          + ", ".join(str(c.n_layers) for c in cfgs) + " layers (the "
          f"logits, streams and caches checked at {cfgs[0].n_layers})")
    ones = []
    for c in cfgs:
        params = M.init_params(c, seed=0, dtype=torch.float32, device="cuda")
        prompts, active = slot_mesh_inputs(c, batch, prompt, steps)
        t0 = time.perf_counter()
        ones.append((slot_mesh_ops(c, params, prompts, active, buf_len),
                     time.perf_counter() - t0))
        del params
        gc.collect()
        torch.cuda.empty_cache()
    return ones


def check_slot_mesh(index, ones, ranks):
    """One SLOT_MESH_CASES case: the single process's results at each
    depth (``slot_mesh_one``) against the mesh's ranks' (``ranks``: each
    rank's list, one entry a depth). At every depth each rank's launches,
    its SSD state's rows and heads and its imports are checked and its
    logits' error printed; at the first depth also the logits within
    MESH_TOL, the streams and the gathered cache. Returns rank 0's
    launches at the case's full depth (its first depth if it has
    none)."""
    import numpy as np
    import torch
    from repro_torch.launch import sharding as S
    label, arch, shape, batch, prompt, buf_len, steps, depths = \
        SLOT_MESH_CASES[index]
    data, model = shape
    cfgs = [slot_mesh_config(index, layers) for layers in depths]
    _, active = slot_mesh_inputs(cfgs[0], batch, prompt, steps)
    rows = batch // data if batch % data == 0 else batch
    for k, (cfg, (one, one_s)) in enumerate(zip(cfgs, ones)):
        checked = k == 0
        want = {}
        if cfg.has_attention:
            want.update(decode_attention=cfg.n_layers * steps,
                        flash_prefill=cfg.n_layers)
        if cfg.has_ssm:
            want.update(ssd_scan=cfg.n_layers,
                        ssd_decode_step=cfg.n_layers * steps)
        heads = (cfg.ssm_heads // model if S.ssm_split(cfg, model)
                 else cfg.ssm_heads)
        for r, outs in enumerate(ranks):
            res = outs[k]
            same = np.array_equal(res["streams"], one["streams"])
            err, pre_err, dec_err, scale = slot_mesh_errors(one, res, active)
            got = {n: res["launches"][n] for n in want}
            note = "" if checked else " (logits not checked)"
            print(f"slot-mesh {label} at {cfg.n_layers} layers{note} rank "
                  f"{r}: logits max_abs_err={err:.3e} tol="
                  f"{MESH_TOL:g} (prefill {pre_err:.3e}, {steps} steps' "
                  f"active rows {dec_err:.3e}; logits up to {scale:.3g}), "
                  f"streams {'identical' if same else 'DIFFER'} ({batch} x "
                  f"{steps + 1} tokens), launches {got}, ops "
                  f"{res['ops_s']:.2f} "
                  f"s (one process {one_s:.2f} s; ranks sharing one H100 "
                  "over gloo, eager: no tensor-parallel speed)")
            if checked and not same:
                fail(f"slot-mesh {label} rank {r}'s greedy streams differ "
                     "from the single process's")
            if checked and not err <= MESH_TOL:
                fail(f"slot-mesh {label} rank {r}'s logits differ from the "
                     f"single process's by {err:.3e} > {MESH_TOL:g}")
            if got != want:
                fail(f"slot-mesh {label} rank {r} launched {got}, not "
                     f"{want}: every layer of every step must go through "
                     "the kernels")
            if cfg.has_ssm:
                ssm = tuple(res["cache"]["ssm"].shape)
                if ssm != (cfg.n_layers, rows, heads, cfg.ssm_head_dim,
                           cfg.ssm_state):
                    fail(f"slot-mesh {label} rank {r} holds ssm "
                         f"{list(ssm)}, not its {rows} rows and {heads} "
                         "heads")
        if not checked:
            continue
        parts = [{n: torch.from_numpy(v) for n, v in outs[0]["cache"].items()}
                 for outs in ranks]
        whole = S.gather_cache(cfg, parts, {"data": data, "model": model},
                               batch, buf_len)
        for key, w in one["cache"].items():
            g = whole[key].numpy()
            if key in ("length", "kv_pos"):
                ok, what = np.array_equal(g, w), "exact"
            else:
                scale = max(1.0, float(np.abs(w).max()))
                e = float(np.abs(g - w).max())
                ok, what = e <= MESH_TOL * scale, (
                    f"max_abs_err={e:.3e} tol={MESH_TOL:g} x {scale:.3g}")
            print(f"slot-mesh {label}: gathered cache {key} "
                  f"{list(g.shape)}: {what}")
            if not ok:
                fail(f"slot-mesh {label}: the ranks' gathered cache {key} "
                     "differs from the single process's")
        print(f"slot-mesh {label}: rank 0 holds " + ", ".join(
            f"{n} {list(v.shape)}" for n, v in parts[0].items())
            + " of " + ", ".join(f"{n} {list(v.shape)}"
                                 for n, v in one["cache"].items()))
    full = depths.index(None) if None in depths else 0
    print(f"slot-mesh {label}: rank 0 at {cfgs[full].n_layers} layers holds "
          + ", ".join(f"{n} {list(v.shape)}"
                      for n, v in ranks[0][full]["cache"].items()))
    return ranks[0][full]["launches"]


def slot_mesh_checks(ones, res):
    """Every case against its single process (``ones[index]``, from
    ``slot_mesh_one``) and its ranks (``res[("slot", index)]``: each
    rank's list, from ``slot_mesh_run``); returns cases (a)'s and (c)'s
    runs for the time phase (rank 0's launches, under the rows timed at
    a rank's shapes; (c)'s shapes: its batch, prompt and rank's SSM
    heads)."""
    launches = {index: check_slot_mesh(index, ones[index],
                                       res[("slot", index)])
                for index in range(len(SLOT_MESH_CASES))}
    _, _, shape, batch, prompt, *_ = SLOT_MESH_CASES[2]
    cfg = slot_mesh_config(2, None)
    ssm = {"cfg": cfg, "batch": batch, "prompt": prompt, "arena": batch,
           "heads": cfg.ssm_heads // shape[1]}
    return {"slot-mesh": ({}, launches[0]),
            "slot-mesh-ssm": (ssm, launches[2])}


def time_phase(runs, worst):
    """Time each kernel, its plain version and the library yardstick at the
    shapes its serving run gave it; bound from these inputs. ``runs`` maps
    a run's name (a fleet instance's as ``run/arch``) to (shapes,
    launches); a timed row's launches are the sum over the serving runs
    at whose shapes (heads, state widths, cache layout) it is timed, and
    each run's launches of a kernel stand under exactly one of its rows."""
    import numpy as np
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
        the mixer passes them; for a run whose shapes name a ``prompt``,
        its batch of prompts of that length at its ``heads`` (a rank's)."""
        sh = runs[run][0]
        c = sh["cfg"]
        if "prompt" in sh:
            B, T = sh["batch"], sh["prompt"]
        else:
            eff, _ = lengths_of(sh)
            B, T = 1, sorted(eff)[len(eff) // 2]
        H, P, N = sh.get("heads", c.ssm_heads), c.ssm_head_dim, c.ssm_state
        sx, sdt, sb, sc, sprm = ssd_inputs(B, T, H, P, N, dtype, seed=seed)
        s_args = (sx, sdt, sprm[0], sb, sc, sprm[1], sprm[2])
        s_args32 = f32(s_args)
        pieces = [min(64, T - t0) for t0 in range(0, T, 64)]   # chunks
        row("ssd_scan", f"B={B} T={T} H={H} P={P} N={N} strided, "
            f"{_ssd.chunks(T)} chunks",
            lambda: ops.ssd_scan(*s_args)[0],
            lambda: ref.ssd_scan_ref(*s_args)[0],
            lambda: ref.ssd_scan_ref(*s_args32)[0], None,
            B * (2 * T * H * P + T * H + 2 * T * N) * elt + 3 * H * elt
            + B * H * P * N * 4,
            B * H * sum(n * (n + 1) * (N + P) + 4 * n * P * N
                        for n in pieces), body=_ssd.body(dtype, P, N),
            passes=SSD_PASSES, of_runs=of_runs)

    def ssd_step_row(run, seed, of_runs):
        """The full decode batch of ``run``'s engine, every row active, on
        its arena's layout: the paged engine's state arena (2 * batch
        slots, row b at slot 2b) or the slot engine's (a layer of its slot
        cache, row b at slot b, the spare row past them; a run's shapes
        may name its ``arena`` rows, and its ``heads``). The kernel and
        its plain version each step the next of n copies of the arena a
        call, the n copies' live rows twice the L2, so no call finds its
        state there, as in serving, where every layer steps its own
        arena; the first kernel call's copy is the one the fp32 check
        starts from."""
        sh = runs[run][0]
        c = sh["cfg"]
        H, P, N = sh.get("heads", c.ssm_heads), c.ssm_head_dim, c.ssm_state
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
            n_arena = sh.get("arena", B + 1)
            layout = f"slot-cache layout arena={n_arena}"
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
    # runs, the baseline and swap runs and the fleet's edge-6b instance),
    # granite-moe's over run paged-moe's, smollm-360m's over the fleet's
    # smollm instance's, hymba-1.5b's over run paged-hybrid's
    paged_decode_row("paged-atomic", 1, (
        "paged-atomic", "paged-realtime", "paged-chunked",
        "paged-chunked-realtime", "paged-spec", "paged-spec-rate8",
        "paged-async-traced", "paged-orca", "paged-fastserve",
        "paged-fastserve-swap", "paged-slice-swap", "fleet-traced/edge-6b"))
    paged_decode_row("paged-moe", 11, ("paged-moe", "paged-moe-async"))
    paged_decode_row("fleet-traced/smollm-360m", 15,
                     ("fleet-traced/smollm-360m",))
    paged_decode_row("paged-hybrid", 32, ("paged-hybrid",))

    # whole-prompt prefill, the same way, and hymba-1.5b's heads over run
    # slot-hybrid's prompts (run paged-hybrid's are the same)
    prefill_row("paged-atomic", 2, (
        "paged-atomic", "paged-realtime", "paged-spec", "paged-spec-rate8",
        "paged-async-traced", "paged-orca", "paged-fastserve",
        "paged-fastserve-swap", "paged-slice-swap", "fleet-traced/edge-6b"))
    prefill_row("paged-moe", 10, ("paged-moe", "paged-moe-async"))
    prefill_row("slot-hybrid", 12, ("slot-hybrid", "paged-hybrid"))
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

    # a rank of the slot-mesh run (a) (edge-6b over (1, 2): the cache's
    # 512 slots of 1024 with both KV heads, every query head): the ring
    # decode with its log-sum-exp over rank 0's full half, the flash
    # prefill of its 8 prompts of 500 tokens at its 16 query heads and
    # 1 KV head
    sm_q, sm_B, sm_S = 524, 8, 512
    sm = ring_inputs([sm_q] * sm_B, np.tile(np.arange(sm_S, dtype=np.int32),
                                             (sm_B, 1)), dtype, sm_S, seed=28)
    _, sm_sps, sm_n = _da.plan(16, 128, sm_S, dtype)
    row("decode_attention",
        f"B={sm_B} S={sm_S} (a rank's half of a 1024-slot ring) "
        f"q_pos={sm_q} Hq=32 Hkv=2 hd=128, return_lse, {sm_n} splits of "
        f"{sm_sps} slots",
        lambda: ops.decode_attention(*sm, return_lse=True)[0],
        lambda: ref.decode_attention_ref(*sm),
        lambda: ref.decode_attention_ref(*f32(sm[:3]), *sm[3:]),
        masked_sdpa(sm[0][:, :, None], sm[1], sm[2],
                    (sm[3] >= 0)[:, None, None, :]),
        2 * sm_B * sm_S * 2 * 128 * elt + 2 * sm_B * 32 * 128 * elt
        + sm_B * sm_S * 4 + sm_B * 4 + sm_B * 32 * 4,
        4 * sm_B * sm_S * 32 * 128, body=_pa.body(dtype, 128),
        passes=ATTENTION_PASSES, of_runs=("slot-mesh",))
    pq, pk, pv = prefill_inputs(8, 500, dtype, Hq=16, Hkv=1, hd=128,
                                seed=29)
    pqt, pkt, pvt = (x.transpose(1, 2) for x in (pq, pk, pv))
    pkr, pvr = (x.repeat_interleave(16, dim=1) for x in (pkt, pvt))
    row("flash_prefill", "B=8 S=500 Hq=16 Hkv=1 hd=128 causal (a rank's "
        "slab, slot-mesh (a))",
        lambda: ops.flash_prefill(pq, pk, pv, causal=True),
        lambda: ref.flash_prefill_ref(pq, pk, pv, causal=True),
        lambda: ref.flash_prefill_ref(pq.float(), pk.float(), pv.float(),
                                      causal=True),
        lambda: F.scaled_dot_product_attention(pqt, pkr, pvr,
                                               is_causal=True),
        8 * (2 * 500 * 16 + 2 * 500 * 1) * 128 * elt,
        8 * 4 * (500 * 501 // 2) * 16 * 128, body=_fp.body(dtype, 128),
        of_runs=("slot-mesh",))

    # SSD scan: mamba2-780m's heads (runs paged-ssm, paged-ssm-async and
    # slot-ssm give it the same prompts), hymba-1.5b's over run
    # slot-hybrid's prompts (and paged-hybrid's, the same)
    ssd_scan_row("paged-ssm", 6, ("paged-ssm", "slot-ssm", "paged-ssm-async"))
    ssd_scan_row("slot-hybrid", 18, ("slot-hybrid", "paged-hybrid"))

    # SSD decode step: each run's own batch and arena layout (the paged
    # engine's state arena for runs paged-ssm, paged-ssm-async and
    # paged-hybrid)
    ssd_step_row("paged-ssm", 7, ("paged-ssm", "paged-ssm-async"))
    ssd_step_row("slot-ssm", 19, ("slot-ssm",))
    ssd_step_row("slot-hybrid", 13, ("slot-hybrid",))
    ssd_step_row("paged-hybrid", 33, ("paged-hybrid",))

    # a rank of the slot-mesh run (c) (mamba2-780m over (1, 2): 24 of its
    # 48 SSM heads): the SSD scan of its 8 prompts of 256 tokens, and the
    # SSD step over its 8 rows of the slot cache (row b at slot b, no
    # spare row), cold
    ssd_scan_row("slot-mesh-ssm", 30, ("slot-mesh-ssm",))
    ssd_step_row("slot-mesh-ssm", 31, ("slot-mesh-ssm",))

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
    moe_bufs = {"paged-moe": moe_row("paged-moe", 9, ("paged-moe",
                                                      "paged-moe-async")),
                "paged-mesh-moe": moe_row("paged-mesh-moe", 25,
                                          ("paged-mesh-moe",))}

    # a rank of the paged-mesh-moe run (granite-moe over a (2, 2) mesh: 12
    # query heads, 4 KV heads), paged decode over its rows of a full batch
    # and whole-prompt prefill over its prompts
    paged_decode_row("paged-mesh-moe", 26, ("paged-mesh-moe",))
    prefill_row("paged-mesh-moe", 27, ("paged-mesh-moe",))

    def fused_rows(run, seed, of_runs, batch=None):
        """The paged decode step's fused chain at ``run``'s shapes: its
        full decode batch (or ``batch`` rows, a cell's, launched by no
        run here), its arch's D, its heads and d_ff slab (a rank's, for a
        mesh run), each kernel the arch launches. Checked against the
        plain version in the working type on the same inputs
        (``check_fused``); the norm's kernel updates its own copy of x."""
        from repro_torch.configs import get_config
        c = runs[run][0]["cfg"]
        B = batch or runs[run][0]["batch"]
        ways = get_config(c.name).n_heads // c.n_heads if c.n_heads else 1
        dense = c.block_kind != "moe" and c.d_ff > 0
        F_ = c.d_ff // ways if dense else 0
        heads = ((c.n_heads, c.n_kv_heads, c.head_dim) if c.has_attention
                 else None)
        ins = fused_inputs(dtype, B, D=c.d_model, F=F_, heads=heads,
                           seed=seed)
        cell = "" if batch is None else " (a cell's batch)"
        x0, delta, w = ins["norm"]
        xk, xp = x0.clone(), x0.clone()
        D = c.d_model
        row("add_rms_norm", f"B={B}{cell} D={D}, x += delta in place",
            lambda: ops.add_rms_norm(xk, delta, w, 1e-5)[1],
            lambda: ref.add_rms_norm_ref(xp, delta, w, 1e-5)[1],
            lambda: ref.add_rms_norm_ref(x0.clone(), delta, w,
                                         1e-5)[1].float(),
            None, (4 * B * D + D) * elt, 6 * B * D, of_runs=of_runs)
        if heads is not None:
            Hq, Hkv, hd = heads
            q, k, v, qp, fr, kp, vp, wp, wo = ins["rope"]
            kp2, vp2 = kp.clone(), vp.clone()
            row("rope_kv_write", f"B={B}{cell} Hq={Hq} Hkv={Hkv} hd={hd}, "
                "K/V into a page arena",
                lambda: ops.rope_kv_write(q, k, v, qp, fr, kp, vp, wp, wo),
                lambda: ref.rope_kv_write_ref(q, k, v, qp, fr, kp2, vp2, wp,
                                              wo),
                lambda: ref.rope_kv_write_ref(q, k, v, qp, fr, kp2, vp2, wp,
                                              wo).float(),
                None, 2 * B * (Hq + 2 * Hkv) * hd * elt + hd * 2
                + B * 20, 6 * B * (Hq + Hkv) * hd, of_runs=of_runs)
        if F_:
            gt, up = ins["silu"]
            row("silu_mul", f"B={B}{cell} F={F_}",
                lambda: ops.silu_mul(gt, up),
                lambda: ref.silu_mul_ref(gt, up),
                lambda: ref.silu_mul_ref(gt, up).float(),
                None, 3 * B * F_ * elt, 5 * B * F_, of_runs=of_runs)

    # the fused decode chain: every paged decode step's, at each run's
    # arch (edge-6b's runs as the paged-decode row groups them, granite's,
    # mamba2's, hymba's, the fleet's smollm instance, the two mesh runs'
    # rank slabs); edge-6b and granite also at the cells' batch of 32
    fused_rows("paged-atomic", 40, (
        "paged-atomic", "paged-realtime", "paged-chunked",
        "paged-chunked-realtime", "paged-spec", "paged-spec-rate8",
        "paged-async-traced", "paged-orca", "paged-fastserve",
        "paged-fastserve-swap", "paged-slice-swap", "fleet-traced/edge-6b"))
    fused_rows("paged-atomic", 41, (), batch=32)
    fused_rows("paged-moe", 42, ("paged-moe", "paged-moe-async"))
    fused_rows("paged-moe", 43, (), batch=32)
    fused_rows("paged-ssm", 44, ("paged-ssm", "paged-ssm-async"))
    fused_rows("paged-hybrid", 45, ("paged-hybrid",))
    fused_rows("fleet-traced/smollm-360m", 46, ("fleet-traced/smollm-360m",))
    fused_rows("paged-mesh", 47, ("paged-mesh",))
    fused_rows("paged-mesh-moe", 48, ("paged-mesh-moe",))

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
    # batched matmuls over the same buffer is a yardstick, used nowhere;
    # at the whole layer's shape and at a rank's slab of paged-mesh-moe
    for run, (mbuf, mwg, mwu, mwd) in moe_bufs.items():
        chain_ms = time_ms(lambda: torch.bmm(
            F.silu(torch.bmm(mbuf, mwg)) * torch.bmm(mbuf, mwu), mwd))
        print(f"moe_grouped_ffn yardstick (not one library call) at {run}'s "
              f"shape (G=E={mbuf.shape[0]} C={mbuf.shape[1]}): "
              f"bmm/silu/bmm/bmm chain over the same buffer {chain_ms:.4f} "
              "ms")
    return out


# ------------------------------------------------------------------ train

FP32_PEAK = PEAK_FLOPS["float32"]
# card against CPU, reduced archs, fp32 (TF32 off): cuBLAS and the CPU's
# BLAS add in different orders
# (arch, shape, mesh, status its record must have): one subprocess each,
# all started together (smollm-360m's train_4k cell takes ~55 s)
DRYRUN_CELLS = (("smollm-360m", "decode_32k", "pod", "ok"),
                ("smollm-360m", "prefill_32k", "pod", "ok"),
                ("smollm-360m", "train_4k", "pod", "ok"),
                ("smollm-360m", "decode_32k", "multipod", "ok"),
                ("hubert-xlarge", "decode_32k", "pod", "skip"),
                ("mamba2-780m", "decode_32k", "pod", "ok"))
# (the graphs phase's captured row, arch, (name, seq_len, batch, kind)):
# the slot engine's masked step computes all 16 slots of a 1024-slot ring
ROOFLINE_CASES = (
    ("edge-6b slot masked", "edge-6b", ("slot_decode_16x1024", 1024, 16,
                                        "decode")),
    (("edge-6b whole prefill", 256), "edge-6b", ("prefill_1x256", 256, 1,
                                                 "prefill")),
    ("mamba2-780m slot masked", "mamba2-780m", ("slot_decode_16x1024", 1024,
                                                16, "decode")))
MAX_SHARE = 1.05          # a bound above the measured clock is a fault
# runs a module (-m) or a file in a subprocess, then prints the JAX
# modules it imported
_SUBPROCESS = ("import runpy, sys\n"
               "how, what = sys.argv[1], sys.argv[2]\n"
               "sys.argv = [what] + sys.argv[3:]\n"
               "if how == '-m':\n"
               "    runpy.run_module(what, run_name='__main__', "
               "alter_sys=True)\n"
               "else:\n"
               "    runpy.run_path(what, run_name='__main__')\n"
               "print('LEAKED', sorted(m for m in sys.modules if m == 'jax' "
               "or m.startswith(('jax.', 'repro.'))))\n")


def python_job(how, what, *args, one_thread=False):
    """Start ``python -m what args`` (how "-m") or ``python what args``
    (how "file") in a subprocess with the repository's src on the path;
    ``one_thread``: PyTorch's CPU ops on one thread (a job that runs
    beside a phase keeps the other cores to it)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    if one_thread:
        env.update(OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    return subprocess.Popen([sys.executable, "-c", _SUBPROCESS, how, what,
                             *args], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, cwd=ROOT)


def python_result(proc, label, timeout=600):
    """The standard output of a ``python_job`` (without the JAX check's
    line); fails on a non-zero exit, on ``timeout`` seconds (the process
    is ended) or when the process imported JAX or the JAX package."""
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        fail(f"{label}: still running after {timeout} s: ended")
    if proc.returncode != 0:
        print(out[-3000:])
        fail(f"{label} exited {proc.returncode}: {err[-3000:]}")
    out, _, leaked = out.rpartition("LEAKED ")
    if leaked.strip() != "[]":
        fail(f"{label} imported JAX or the JAX package: {leaked.strip()}")
    return out


@contextlib.contextmanager
def ended_on_exit(procs):
    """Kill whichever of ``procs`` still runs when the block is left (a
    failed check elsewhere must not leave them behind)."""
    try:
        yield procs
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()


def run_python(how, what, *args, timeout=600):
    """``python_job`` and ``python_result`` in one."""
    with ended_on_exit([python_job(how, what, *args)]) as (proc,):
        return python_result(proc, f"{what} {' '.join(args)}", timeout)


def dryrun_phase(background):
    """The dry-run (python -m repro_torch.launch.dryrun) in subprocesses,
    started together in the background (``start_background``):
    smollm-360m's decode_32k, prefill_32k and train_4k
    on the pod mesh, decode_32k on the multipod
    mesh, hubert-xlarge's decode (a skip), mamba2-780m's decode_32k on the
    pod mesh (its SSM cut by heads: cache.ssm must not depart from the
    spec; no train or encoder step may run unsharded, a "train:" or
    "forward" departure); each record must be ok (a skip
    where JAX skips) and no subprocess may import JAX. Then the roofline
    table of the pod records (python -m repro_torch.launch.roofline).
    Then the card check: build_cell and count_cell at the shapes of the
    graphs phase's captured rows (edge-6b's slot decode over 16 slots of
    a 1024-slot ring and its whole 256-token prefill, mamba2-780m's slot
    decode over 16 slots), a 1x1 stand-in mesh, full width, bf16 meta
    tensors; each roofline term and the dominant one beside the same
    run's captured clock, and the share bound / clock, which must not
    exceed MAX_SHARE."""
    from repro_torch.configs import InputShape, get_config
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import roofline as R
    from repro_torch.launch.mesh import make_stand_in_mesh
    phase("dryrun: stand-in production meshes on meta tensors, the H100 "
          "roofline, and the captured steps against it")
    out, t0 = background["dir"], background["t0"]
    for (arch, shape, mesh, _), proc in zip(DRYRUN_CELLS,
                                            background["dryrun"]):
        print(python_result(proc, f"dryrun {arch} {shape} {mesh}").strip())
        print(f"dryrun {arch} {shape} {mesh}: done at "
              f"{time.perf_counter() - t0:.1f}s of the background jobs",
              flush=True)
    for name in sorted(os.listdir(out)):
        with open(os.path.join(out, name)) as f:
            rec = json.load(f)
        want = next(st for a, sh, m, st in DRYRUN_CELLS
                    if (a, sh, m) == (rec["arch"], rec["shape"],
                                      rec["mesh"]))
        if rec["status"] != want:
            fail(f"dryrun {name}: status {rec['status']}, {want} "
                 f"expected: {rec.get('error', rec.get('reason'))}")
        if rec["status"] == "ok":
            print(f"dryrun {name}: flops/dev {rec['flops_per_device']:.4g}"
                  f", bytes/dev floor {rec['bytes_floor_per_device']:.4g} "
                  f"eager {rec['bytes_per_device']:.4g}, collectives "
                  f"{rec['collectives']['total']:.4g} B, arguments "
                  f"{rec['argument_size_in_bytes']} (JAX's specs "
                  f"{rec['argument_size_in_bytes_spec']}), "
                  f"{len(rec['departures'])} departures")
            if any(d.startswith("cache.ssm")
                   for d in rec["departures"]):
                fail(f"dryrun {name}: the SSD state departs from its "
                     f"spec: {rec['departures']}")
            if any(d.startswith(("train:", "forward"))
                   for d in rec["departures"]):
                fail(f"dryrun {name}: the step runs unsharded: "
                     f"{rec['departures']}")
    print(run_python("-m", "repro_torch.launch.roofline", "--dir", out,
                     "--out", os.path.join(out, "roofline")).strip())
    shutil.rmtree(out, ignore_errors=True)
    rows = []
    with make_stand_in_mesh({"data": 1, "model": 1}) as mesh:
        for key, arch, (name, S, B, kind) in ROOFLINE_CASES:
            cfg = get_config(arch)
            rec = D.count_cell(cfg, InputShape(name, S, B, kind), mesh)
            rec["mesh_shape"] = dict(mesh.shape)
            t = R.terms(rec)
            clock = CAPTURED[key]
            share = t["bound_s"] * 1e3 / clock
            rows.append({"case": key if isinstance(key, str)
                         else f"{key[0]} {key[1]}", "arch": arch,
                         "shape": name, "dtype": "bfloat16",
                         **{k: t[k] * 1e3 for k in (
                             "compute_s", "memory_s", "memory_unfused_s",
                             "collective_s", "bound_s")},
                         "dominant": t["dominant"], "captured_ms": clock,
                         "share": share,
                         "arg_bytes": rec["argument_size_in_bytes"],
                         "flops": rec["flops_per_device"]})
            print(f"roofline {arch} {name} (bf16, 1x1): compute "
                  f"{t['compute_s'] * 1e3:.4f} ms, memory "
                  f"{t['memory_s'] * 1e3:.4f} ms (unfused "
                  f"{t['memory_unfused_s'] * 1e3:.4f}), collective "
                  f"{t['collective_s'] * 1e3:.4f} ms; dominant "
                  f"{t['dominant']} {t['bound_s'] * 1e3:.4f} ms against the "
                  f"captured {clock:.4f} ms ({rows[-1]['case']}): share "
                  f"{share:.3f}", flush=True)
            if not (0 < share <= MAX_SHARE):
                fail(f"roofline {arch} {name}: share {share:.3f} outside "
                     f"(0, {MAX_SHARE}]")
    print(json.dumps({"roofline": rows}))


# (file, arguments, a line its output must hold, kernels it must launch,
# whether it starts with the background jobs): the simulation (the CPU
# only) and train_tiny (its loss line does not depend on time) run
# beside the gloo ranks; the serving examples run in the examples phase,
# one after the other (their SLICE runs schedule by the l(b) each probes)
EXAMPLES = (
    ("torch_quickstart.py", (), r"SLO attainment: \d+%",
     ("flash_prefill", "decode_attention"), False),
    ("torch_multi_slo_serving.py", (), r"SLICE delivered DIFFERENT",
     ("ssd_scan", "ssd_decode_step"), False),
    ("torch_train_tiny.py", (), r"loss [\d.]+ -> [\d.]+ \(improved\)", (),
     True),
    ("torch_edge_serving_sim.py", ("--duration", "20"),
     r"(?m)^SLICE +[\d.]+% ", (), True))


def example_job(name, args, tmp, one_thread=False):
    """``python_job`` of examples/``name``; torch_train_tiny.py writes its
    checkpoint under ``tmp``."""
    if name == "torch_train_tiny.py":
        args += ("--ckpt", os.path.join(tmp, "tiny.npz"))
    return python_job("file", os.path.join(ROOT, "examples", name), *args,
                      one_thread=one_thread)


def start_background():
    """Start the work whose checks do not depend on time, to run beside
    the gloo ranks (``gloo_phase``), whose checks do not either: the
    dry-run cells (``dryrun_phase``, read right after the gloo ranks) and
    the examples EXAMPLES marks, each in a subprocess on one thread, and
    train-mesh (c)'s two training CLIs (``train_clis``, about 18 GB of
    the card). Beside the train phase instead, with a pool of threads
    each and then with one, the first two slowed mamba2-780m's host-bound
    training step from 1302.9 to 1773.9 and 1940.1 ms on the H100.
    Returns what the phases that read them take; its "procs" are to be
    ended when the script leaves (``ended_on_exit``)."""
    out, tmp = tempfile.mkdtemp(prefix="dryrun-"), tempfile.mkdtemp()
    dry = [python_job("-m", "repro_torch.launch.dryrun", "--arch", arch,
                      "--shape", shape, "--mesh", mesh, "--out", out,
                      one_thread=True)
           for arch, shape, mesh, _ in DRYRUN_CELLS]
    jobs = {name: example_job(name, args, tmp, one_thread=True)
            for name, args, _, _, early in EXAMPLES if early}
    clis = train_clis()
    print(f"background: {len(dry)} dry-run cells, {', '.join(jobs)} and "
          "train-mesh (c)'s two training CLIs started", flush=True)
    return {"dir": out, "tmp": tmp, "t0": time.perf_counter(),
            "dryrun": dry, "examples": jobs, "train_clis": clis,
            "procs": dry + list(jobs.values()) + clis}


def examples_phase(background):
    """The four examples/torch_*.py on the card in subprocesses:
    quickstart, multi-SLO and train_tiny (300 steps, ~5 s on the card;
    its checkpoint in a temporary directory) at their defaults, and the
    simulation at --duration 20, as the JAX package's CI runs its
    examples; the two serving ones here, one after the other, the others
    started with the background jobs (EXAMPLES). Each must exit 0, print
    its SLO or loss line, launch its kernels (printed by the example) and
    import no JAX."""
    import re
    phase("examples: examples/torch_*.py on the card")
    t0 = time.perf_counter()
    with ended_on_exit([]) as started:
        for name, args, line, kernels, _ in EXAMPLES:
            proc = background["examples"].get(name)
            if proc is None:
                proc = example_job(name, args, background["tmp"])
                started.append(proc)
            out = python_result(proc, f"{name} {' '.join(args)}")
            print("\n".join(f"{name}: {x}" for x in
                            out.strip().splitlines()[-8:]))
            print(f"{name}: done at {time.perf_counter() - t0:.1f}s",
                  flush=True)
            if not re.search(line, out):
                fail(f"{name}: no line matching {line!r}")
            launched = dict(re.findall(r"(\w+)=(\d+)", "".join(
                x for x in out.splitlines()
                if x.startswith("kernel launches:"))))
            missing = [k for k in kernels if int(launched.get(k, 0)) == 0]
            if missing:
                fail(f"{name}: launched none of {missing} "
                     f"(launches {launched})")
    shutil.rmtree(background["tmp"], ignore_errors=True)


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


# (a) of train-mesh: (arch, layers kept, batch, sequence, steps, mesh)
TRAIN_MESH = ("smollm-360m", 4, 8, 256, 3, (2, 2))
# (b): hubert-xlarge's forward with 8 of its 48 layers, B x S frames
FORWARD_MESH = ("hubert-xlarge", 8, 4, 512, (1, 2))
TRAIN_MESH_LR = 1e-3


def _train_cfg(arch, layers):
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    return cfg if layers is None else dataclasses.replace(cfg,
                                                          n_layers=layers)


def _train_rank_setup(ways):
    """A train-mesh rank on the one card: TF32 off, its share of the
    host's cores."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // ways))


def _card_mesh(shape):
    """A ('data', 'model') or ('pod', 'data', 'model') mesh of ``shape``
    over the rank's gloo group, on the card."""
    import torch
    from repro_torch.launch.mesh import make_serving_mesh
    *pod, data, model = shape
    return make_serving_mesh(pod=pod[0] if pod else 1, data=data,
                             model=model, device=torch.device("cuda", 0))


def skew_moe(params):
    """Skew an MoE arch's weights (in place) so that expert 0 takes every
    token and the sorted dispatch drops assignments: every embedding row
    shifted by the table's mean |entry|, and d_model^-0.5 * 4 added to
    every layer's router column of expert 0."""
    import torch
    with torch.no_grad():
        embed = params["embed"]
        embed += embed.abs().mean()
        router = params["blocks"]["moe"]["router"]
        router[..., 0] += 4.0 * embed.shape[-1] ** -0.5


def sorted_drops(cfg, params, batch):
    """Assignments the sorted dispatch drops over the whole ``batch`` in
    one process, summed over the layers: each expert's assignments past
    its capacity C = max(int(N K / E * 1.25 + 0.999), K)."""
    import torch
    from repro_torch.models import model as M
    from repro_torch.models import moe as MOE
    route, seen = MOE.route, []

    def record(*args, **kw):
        out = route(*args, **kw)
        seen.append(out[1])
        return out

    MOE.route = record
    try:
        with torch.no_grad():
            M.loss_fn(cfg, params, batch["inputs"], batch["labels"],
                      M.ModelOptions(moe_impl="sorted"))
    finally:
        MOE.route = route
    E, K = cfg.n_experts, cfg.top_k
    drops = 0
    for ids in seen:
        C = max(int(ids.numel() / E * 1.25 + 0.999), K)
        load = torch.bincount(ids.reshape(-1), minlength=E)
        drops += int((load - C).clamp(min=0).sum())
    return drops


def mesh_vs_one(mesh, arch, layers, B, S, steps, moe_impl="grouped"):
    """``arch`` at full width in fp32 (TF32 off) on this rank's shards of
    ``mesh`` beside the one-process trainer from the same weights (on the
    sorted MoE path skewed, ``skew_moe``). Each step starts the mesh from
    the one process's state (its shards of params, mu and nu), then both
    take the step on the same batch (the rank its rows). Returns per step
    the two losses and grad norms, the largest |mesh - one process| of
    the updated params where the one process's gradient is at least 1e-3
    of its leaf's largest (there the gradient fixes the update: AdamW
    moves a component whose gradient is near 0 by up to lr whatever its
    last bits say), the largest excess elsewhere over two diverging AdamW
    steps' bound, 2 lr (1 + wd |p|), and the largest over every
    component; the rank's seconds, the whole first batch's drops on the
    sorted path, and any JAX module."""
    import torch
    from repro_torch.launch import sharding as SH
    from repro_torch.models import model as M
    from repro_torch.training.optimizer import leaves
    from repro_torch.training.trainer import (local_batch, make_train_step,
                                              step_grads)
    cfg = _train_cfg(arch, layers)
    opts = M.ModelOptions(remat=True, moe_impl=moe_impl)
    kw = dict(peak_lr=TRAIN_MESH_LR, warmup=1, total=10, device="cuda")
    weights = M.init_params(cfg, seed=0, device="cuda")
    drops = None
    if moe_impl == "sorted":
        skew_moe(weights)
        drops = sorted_drops(cfg, weights, train_batch(cfg, B, S, "cuda", 10))
    init_one, step_one = make_train_step(cfg, opts, **kw)
    one = init_one(weights)
    init_mesh, step_mesh = make_train_step(cfg, opts, mesh=mesh, **kw)
    mine = init_mesh(weights)
    del weights

    def flat(tree):
        return dict(zip(leaf_names(tree), leaves(tree)))

    out = []
    t0 = time.perf_counter()
    for i in range(steps):
        batch = train_batch(cfg, B, S, "cuda", 10 + i)
        with torch.no_grad():
            for a, b in ((mine[0], one[0]), (mine[1].mu, one[1].mu),
                         (mine[1].nu, one[1].nu)):
                want = flat(SH.local_train_params(cfg, b, mesh))
                for k, v in flat(a).items():
                    v.copy_(want[k])
            mine[1].step.copy_(one[1].step)
        p0 = {k: v.detach().clone() for k, v in flat(mine[0]).items()}
        _, grads, _ = step_grads(cfg, one[0], batch, opts)
        g = flat(SH.local_train_params(cfg, grads, mesh))
        g_max = {k: float(v.abs().max()) for k, v in flat(grads).items()}
        del grads
        one, m_one = step_one(one, batch)
        mine, m_mesh = step_mesh(mine, local_batch(batch, mesh))
        big_err = over = all_err = 0.0
        with torch.no_grad():
            p_one = flat(SH.local_train_params(cfg, one[0], mesh))
            for k, p in flat(mine[0]).items():
                d = (p - p_one[k]).abs()
                all_err = max(all_err, float(d.max()))
                big = g[k].abs() >= 1e-3 * g_max[k]
                if big.any():
                    big_err = max(big_err, float(d[big].max()))
                bound = 2 * TRAIN_MESH_LR * (1 + 0.1 * p0[k].abs()) + MESH_TOL
                over = max(over, float((d - bound).max()))
        out.append({"loss": (float(m_mesh["loss"]), float(m_one["loss"])),
                    "norm": (float(m_mesh["grad_norm"]),
                             float(m_one["grad_norm"])),
                    "big_err": big_err, "over": over, "all_err": all_err})
    torch.cuda.synchronize()
    return {"steps": out, "s": time.perf_counter() - t0, "drops": drops,
            "leaked": sorted(m for m in sys.modules if m == "jax"
                             or m.startswith(("jax.", "repro.")))}


# (d): smollm-360m at full width with 2 of its 32 layers, B x S tokens: its
# (2, 2) state after one step saved, restored onto CKPT_ONTO and in one
# process, each taking the second step; (e): granite-moe-3b-a800m on the
# sorted MoE path, skewed, 2 of 32 layers, on each of SORTED_MESHES against
# one process for SORTED_STEPS steps; (f): TRAIN_MESH on the pod mesh.
# (d) and (e) at 2 layers: their checks do not depend on the depth, and
# the script's time limit holds every phase
CKPT_MESH = ("smollm-360m", 2, 8, 256, (2, 2))
CKPT_ONTO = ((1, 2), (2, 1, 2))
SORTED_MESH = ("granite-moe-3b-a800m", 2, 8, 256)
SORTED_MESHES = ((2, 2), (1, 2))
SORTED_STEPS = 2
POD_MESH = (2, 1, 2)


def _ckpt_files():
    d = os.path.join(ROOT, "build", "train_mesh_ckpt")
    return (os.path.join(d, "after_step1.npz"),
            os.path.join(d, "after_step2.npz"))


def ckpt_next_step(cfg, state, train_step, batch, opts, mesh, want_path):
    """The second step of a restored ``state`` (the rank's shards, or the
    whole state without ``mesh``) held to the (2, 2) run's second step
    (its saved state, read back in this layout): the loss and grad norm,
    the largest |difference| of the params where the step's gradient is
    at least 1e-3 of its leaf's largest (the whole leaf's, over the
    mesh), and the largest excess elsewhere over two diverging AdamW
    steps' bound."""
    import torch
    import torch.distributed as dist
    from repro_torch.training import checkpoint as CK
    from repro_torch.training.optimizer import leaves
    from repro_torch.training.trainer import step_grads
    for p in leaves(state[0]):
        p.requires_grad_(True)
    _, grads, _ = step_grads(cfg, state[0], batch, opts, mesh)
    g = list(leaves(grads))
    g_max = torch.tensor([float(v.abs().max()) for v in g])
    if mesh is not None:
        dist.all_reduce(g_max, op=dist.ReduceOp.MAX,
                        group=mesh.world_cpu_group)
    p0 = [p.detach().clone() for p in leaves(state[0])]
    state, m = train_step(state, batch)
    want = CK.restore(want_path, state, cfg=cfg, mesh=mesh)
    big_err = over = 0.0
    with torch.no_grad():
        for p, q, gk, gm, a in zip(leaves(state[0]), leaves(want[0]), g,
                                   g_max.tolist(), p0):
            d = (p - q).abs()
            big = gk.abs() >= 1e-3 * gm
            if big.any():
                big_err = max(big_err, float(d[big].max()))
            bound = 2 * TRAIN_MESH_LR * (1 + 0.1 * a.abs()) + MESH_TOL
            over = max(over, float((d - bound).max()))
    return {"loss": float(m["loss"]), "norm": float(m["grad_norm"]),
            "big_err": big_err, "over": over}


def ckpt_restore(mesh):
    """(d) on ``mesh`` (None: one process): the (2, 2) state's file
    restored, and its second step (``ckpt_next_step``)."""
    import torch
    from repro_torch.models import model as M
    from repro_torch.training import checkpoint as CK
    from repro_torch.training.trainer import local_batch, make_train_step
    arch, layers, B, S, _ = CKPT_MESH
    cfg = _train_cfg(arch, layers)
    opts = M.ModelOptions(remat=True)
    after1, after2 = _ckpt_files()
    init, step = make_train_step(cfg, opts, peak_lr=TRAIN_MESH_LR, warmup=1,
                                 total=10, device="cuda", mesh=mesh)
    t0 = time.perf_counter()
    state = CK.restore(after1, init(0), cfg=cfg, mesh=mesh)
    restore_s = time.perf_counter() - t0
    batch = train_batch(cfg, B, S, "cuda", 31)
    if mesh is not None:
        batch = local_batch(batch, mesh)
    out = ckpt_next_step(cfg, state, step, batch, opts, mesh, after2)
    torch.cuda.synchronize()
    return {**out, "restore_s": restore_s}


def ckpt_save(mesh):
    """(d) on CKPT_MESH's (2, 2) mesh: seed-0 weights, one step, the state
    saved (``checkpoint.save(mesh=...)``); the second step, and that state
    saved too, for the restored runs to be held to."""
    import torch
    from repro_torch.models import model as M
    from repro_torch.training import checkpoint as CK
    from repro_torch.training.trainer import local_batch, make_train_step
    arch, layers, B, S, _ = CKPT_MESH
    cfg = _train_cfg(arch, layers)
    opts = M.ModelOptions(remat=True)
    after1, after2 = _ckpt_files()
    init, step = make_train_step(cfg, opts, peak_lr=TRAIN_MESH_LR, warmup=1,
                                 total=10, device="cuda", mesh=mesh)
    state = init(0)
    state, _ = step(state, local_batch(train_batch(cfg, B, S, "cuda", 30),
                                       mesh))
    t0 = time.perf_counter()
    CK.save(after1, state, cfg=cfg, mesh=mesh)
    save_s = time.perf_counter() - t0
    state, m = step(state, local_batch(train_batch(cfg, B, S, "cuda", 31),
                                       mesh))
    CK.save(after2, state, cfg=cfg, mesh=mesh)
    torch.cuda.synchronize()
    return {"loss": float(m["loss"]), "norm": float(m["grad_norm"]),
            "save_s": save_s}


def gloo_rank(rank, world):
    """A rank of the script's gloo work (``gloo_phase``), every part for
    ``world`` ranks in turn, each mesh made once, the card's cache
    emptied after each part: with 4, sharded (f) on (2, 2), slot-mesh
    (b) on (2, 2), train-mesh (a) on (2, 2), (d)'s save on (2, 2) and its
    restore on (2, 1, 2), (e) on (2, 2), (f) on (2, 1, 2); with 2,
    sharded (b) on (1, 2), slot-mesh (a) and (c) on (1, 2), train-mesh
    (b) on (1, 2), (d)'s restore and (e) on (1, 2). Returns {part: what
    the rank saw} (with the part's seconds) and any JAX module it
    imported."""
    import gc

    import torch
    _train_rank_setup(world)
    meshes, out = {}, {}

    def mesh(shape):
        if shape not in meshes:
            meshes[shape] = _card_mesh(shape)
        return meshes[shape]

    def timed(key, shape, fn, *args):
        t0 = time.perf_counter()
        out[key] = fn(mesh(shape), *args)
        if isinstance(out[key], dict):
            out[key]["s"] = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()

    for label, arch, shape in MESH_EQUIV:
        if math.prod(shape) == world:
            timed(("sharded", label), shape, mesh_engine_run, arch)
    for index, case in enumerate(SLOT_MESH_CASES):
        if math.prod(case[2]) == world:
            timed(("slot", index), case[2], slot_mesh_run, index)
    arch, layers, B, S, steps, shape = TRAIN_MESH
    if math.prod(shape) == world:
        timed(("a", shape), shape, mesh_vs_one, arch, layers, B, S, steps)
    *forward, shape = FORWARD_MESH
    if math.prod(shape) == world:
        timed(("b", shape), shape, forward_vs_one, *forward)
    if math.prod(CKPT_MESH[-1]) == world:
        timed(("d", CKPT_MESH[-1]), CKPT_MESH[-1], ckpt_save)
    for shape in CKPT_ONTO:
        if math.prod(shape) == world:
            timed(("d", shape), shape, ckpt_restore)
    for shape in SORTED_MESHES:
        if math.prod(shape) == world:
            timed(("e", shape), shape, mesh_vs_one, *SORTED_MESH,
                  SORTED_STEPS, "sorted")
    if math.prod(POD_MESH) == world:
        timed(("f", POD_MESH), POD_MESH, mesh_vs_one, arch, layers, B, S,
              steps)
    out["leaked"] = sorted(m for m in sys.modules if m == "jax"
                           or m.startswith(("jax.", "repro.")))
    return out


def gloo_references():
    """The single process's references of the gloo work, in this process
    before the ranks start: sharded (b), (f) (``mesh_one``) and the
    slot-mesh cases (``slot_mesh_one``)."""
    return ({label: mesh_one(label, arch, shape)
             for label, arch, shape in MESH_EQUIV},
            {index: slot_mesh_one(index)
             for index in range(len(SLOT_MESH_CASES))})


def gloo_phase(refs):
    """The script's work on gloo ranks that share the card, in two
    spawns, one group of 4 ranks, then one of 2 (``gloo_rank``; the
    4-rank group saves the checkpoint the 2-rank group restores; at once,
    they ran the card out of memory): sharded (b) and (f), slot-mesh
    (a)-(c), train-mesh (a), (b) and (d)-(f). Checks sharded (b), (f) and
    slot-mesh against ``refs`` (``gloo_references``); returns {part: each
    rank's result} (read by the train-mesh phase) and slot-mesh's entries
    for the time phase."""
    import gc

    import torch
    from repro_torch.launch.mesh import spawn_ranks
    ones, slot_ones = refs
    after1, _ = _ckpt_files()
    shutil.rmtree(os.path.dirname(after1), ignore_errors=True)
    res = {}
    for world in (4, 2):
        sharded = [lb for lb, _, sh in MESH_EQUIV if math.prod(sh) == world]
        slots = [c[0] for c in SLOT_MESH_CASES if math.prod(c[2]) == world]
        phase(f"gloo ranks {world}: sharded {', '.join(sharded)}, slot-mesh "
              f"{', '.join(slots)} and train-mesh's parts on {world} gloo "
              "ranks sharing the card")
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ranks = spawn_ranks(gloo_rank, world, (world,), backend="gloo",
                            timeout=900)
        print(f"{world} ranks {time.perf_counter() - t0:.1f} s wall, rank "
              "0's parts: " + ", ".join(
                  f"{k[0]} {k[1]} {ranks[0][k]['s']:.1f} s" for k in ranks[0]
                  if isinstance(ranks[0][k], dict)), flush=True)
        for r, got in enumerate(ranks):
            if got.pop("leaked"):
                fail(f"gloo rank {r} of {world} imported JAX or the JAX "
                     "package")
        res.update({k: [got[k] for got in ranks] for k in ranks[0]})
    for label, arch, shape in MESH_EQUIV:
        check_mesh_equivalence(label, arch, shape, ones[label],
                               res[("sharded", label)])
    return res, slot_mesh_checks(slot_ones, res)


def forward_vs_one(mesh, arch, layers, B, S):
    """Train-mesh (b) on a rank: ``arch``'s ``forward`` at full width in
    fp32 on its serving slab of the weights and its rows of the frames;
    the largest |mesh - one process| over its rows of the logits (the one
    process's computed here too) and their largest magnitude."""
    import torch
    from repro_torch.launch import sharding as SH
    from repro_torch.models import model as M
    from repro_torch.models.partitioning import activation_partitioning
    shape = (mesh.shape["data"], mesh.shape["model"])
    cfg = _train_cfg(arch, layers)
    weights = M.init_params(cfg, seed=0, device="cuda")
    x = train_batch(cfg, B, S, "cuda", 20)["inputs"] * 0.02
    n = B // shape[0]
    rows = slice(mesh.coords["data"] * n, (mesh.coords["data"] + 1) * n)
    with torch.no_grad():
        want, _ = M.forward(cfg, weights, x[rows])
        params = SH.local_params(cfg, weights, mesh)
        with activation_partitioning(mesh, SH.cut_leaves(cfg, shape[1])):
            got, _ = M.forward(cfg, params, x[rows])
    return {"shape": tuple(got.shape),
            "err": float((got - want).abs().max()),
            "scale": float(want.abs().max())}


def _cli_peaks(out):
    """The peak memory lines of a training CLI run: one process's (GiB)
    or every rank's list."""
    try:
        for line in out.splitlines():
            if "peak memory a rank [" in line:
                return [float(v) for v in line.split("[")[1].split("]")[0]
                        .split(",")]
        for line in out.splitlines():
            if line.startswith("median ") and "peak memory" in line:
                return [float(line.split("peak memory ")[1].split()[0])]
    except ValueError:              # "n/a (cpu)"
        pass
    return None


def train_clis():
    """Start train-mesh (c): the training CLI at full width, one step of
    B=8, S=256, with --mesh-shape 2,2 and in one process."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    return [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "smollm-360m", "--steps", "1", "--batch", "8", "--seq", "256"]
        + extra, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=env) for extra in (["--mesh-shape", "2,2"], [])]


def train_cli_row(clis, card):
    """Train-mesh (c)'s checks over ``train_clis``'s processes (started
    with the background jobs, beside the gloo ranks): both exit 0 and
    print their peak memory, the mesh's ranks their equal losses; each
    rank's peak printed beside the one process's. Returns (c)'s row of
    the train-mesh JSON line."""
    phase("train-mesh (c): the training CLI at full width, --mesh-shape "
          "2,2 and one process, started beside the gloo ranks")
    peaks = {}
    for how, proc in zip(("mesh", "one"), clis):
        try:
            out, err = proc.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            fail(f"the training CLI ({how}) still ran after 600 s")
        print(out.strip())
        print(f"train-mesh (c): CLI ({how}) exit {proc.returncode}",
              flush=True)
        peaks[how] = _cli_peaks(out)
        if proc.returncode != 0 or peaks[how] is None:
            fail(f"the training CLI ({how}) failed: {err[-2000:]}")
        if how == "mesh" and "losses equal on every rank" not in out:
            fail("the training CLI's ranks disagree on the losses")
    print(f"train-mesh (c) on {card}: peak memory a rank "
          f"{peaks['mesh']} GiB (4 ranks of (2, 2)) against one process's "
          f"{peaks['one'][0]} GiB", flush=True)
    return {"run": "(c)", "peak_gib_ranks": peaks["mesh"],
            "peak_gib_one": peaks["one"][0]}


def train_mesh_phase(gloo, cli_row):
    """train-mesh: the trainer under FSDP over 'data' x tensor parallelism
    over 'model' on gloo ranks that share the one H100 (eager, every
    collective through the host: no tensor-parallel speed is read here).
    (a) smollm-360m at full width in fp32 with 4 of its 32 layers, B=8,
    S=256, on a (2, 2) mesh for 3 steps against one process from the same
    weights and batches: loss within 1e-5 and grad_norm within 1e-4
    (relative), the params within MESH_TOL where the gradient fixes the
    update (elsewhere within two diverging AdamW steps). (b)
    hubert-xlarge's forward with 8 of its 48 layers on (1, 2) within
    MESH_TOL of one process. (d)-(f): a (2, 2) state's checkpoint
    restored onto (1, 2), (2, 1, 2) and one process; the sorted MoE path
    on a split batch and a rank's experts; (a) on the pod mesh (2, 1, 2).
    (a), (b) and (d)-(f) ran on the gloo groups of ``gloo_phase``
    (``gloo``: their results), checked here (``train_mesh_checks``). (c)
    The CLI with --mesh-shape 2,2 at full width and the CLI in one
    process ran beside the gloo ranks (``cli_row``: its row,
    ``train_cli_row``)."""
    card = card_line()
    rows = train_mesh_checks(card, gloo) + [cli_row]
    print(json.dumps({"train_mesh": rows, "card": card}), flush=True)


def _worst(steps):
    """(a)'s errors over a mesh_vs_one run's steps."""
    worst = {"loss": 0.0, "norm": 0.0, "big_err": 0.0, "over": 0.0,
             "all_err": 0.0}
    for st in steps:
        for key in ("loss", "norm"):
            a, b = st[key]
            worst[key] = max(worst[key], abs(a - b) / abs(b))
        for key in ("big_err", "over", "all_err"):
            worst[key] = max(worst[key], st[key])
    return worst


def _held(label, worst):
    """Fail unless ``worst`` meets (a)'s bounds."""
    if (worst["loss"] > 1e-5 or worst["norm"] > 1e-4
            or worst["big_err"] > MESH_TOL or worst["over"] > 0):
        fail(f"train-mesh {label}: {worst} over (a)'s bounds")


def train_mesh_checks(card, res):
    """train-mesh (a), (b) and (d)-(f) from the gloo groups' results
    (``res``), then (d)'s restore in this process. (a) and (b) as
    ``train_mesh_phase`` says. (d) smollm-360m (2 of 32 layers, B=8,
    S=256): the (2, 2) state after one step saved by
    ``checkpoint.save(mesh=...)``, the file's keys and shapes held to
    ``param_shapes``, restored onto (1, 2), (2, 1, 2) and in one process,
    each run's second step within (a)'s bounds of (2, 2)'s own (loss,
    grad_norm, the params against (2, 2)'s saved second state read back in
    the run's layout). (e) granite-moe-3b-a800m on the sorted MoE path (2
    of 32 layers, skewed so expert 0 takes every token) on (2, 2) and (1,
    2) against one process, within (a)'s bounds; the whole batch's drops
    printed, and none fails. (f) (a) on the pod mesh (2, 1, 2). Returns
    the rows of the phase's JSON line."""
    import gc
    import types

    import numpy as np
    import torch
    from repro_torch.models import model as M
    from repro_torch.training import checkpoint as CK
    from repro_torch.training.optimizer import AdamWState
    phase("train-mesh (a), (b), (d)-(f): the gloo groups' results")
    rows = []
    after1, _ = _ckpt_files()
    arch, layers, B, S, steps, shape = TRAIN_MESH
    runs = res[("a", shape)]
    for i, st in enumerate(runs[0]["steps"]):
        print(f"step {i}: loss {st['loss'][0]:.6f} (one process "
              f"{st['loss'][1]:.6f}) grad_norm {st['norm'][0]:.6f} "
              f"({st['norm'][1]:.6f})")
    worst = _worst(st for r in runs for st in r["steps"])
    print(f"train-mesh (a) on {card}: {arch} ({layers} layers) B={B} S={S} "
          f"on {shape} against one process, {steps} steps: loss rel err "
          f"{worst['loss']:.3e} (tol 1e-5), grad_norm rel err "
          f"{worst['norm']:.3e} (tol 1e-4), params max_abs_err where the "
          f"gradient fixes the update {worst['big_err']:.3e} (tol "
          f"{MESH_TOL:g}), excess over two AdamW steps elsewhere "
          f"{worst['over']:.3e} (tol 0), over every component "
          f"{worst['all_err']:.3e} (printed); "
          f"{max(r['s'] for r in runs):.1f} s", flush=True)
    rows.append({"run": "(a)", "arch": arch, "layers": layers, "B": B,
                 "S": S, "mesh": list(shape), **worst})
    _held("(a)", worst)
    arch, layers, B, S, shape = FORWARD_MESH
    runs = res[("b", shape)]
    err = max(r["err"] for r in runs)
    print(f"train-mesh (b) on {card}: {arch} forward ({layers} layers) "
          f"B={B} S={S} on {shape}, logits {runs[0]['shape']} a rank, "
          f"max_abs_err {err:.3e} (tol {MESH_TOL:g}; |logits| up to "
          f"{runs[0]['scale']:.3f}); {max(r['s'] for r in runs):.1f} s",
          flush=True)
    rows.append({"run": "(b)", "arch": arch, "layers": layers, "B": B,
                 "S": S, "mesh": list(shape), "max_abs_err": err})
    if not err <= MESH_TOL:
        fail(f"train-mesh (b): {arch}'s forward on the mesh differs from "
             f"one process's by {err:.3e}")
    phase("train-mesh (d): the (2, 2) checkpoint in one process")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    arch, layers, B, S, from_shape = CKPT_MESH
    cfg = _train_cfg(arch, layers)

    def shaped(node):
        return {k: shaped(v) if isinstance(v, dict) else
                types.SimpleNamespace(shape=tuple(v)) for k, v in node.items()}

    tree = shaped(M.param_shapes(cfg))
    want = {k: leaf.shape for k, _, leaf in CK._items(
        (tree, AdamWState(types.SimpleNamespace(shape=()), tree, tree)))}
    with np.load(after1) as f:
        got = {k: tuple(f[k].shape) for k in f.files}
    one = ckpt_restore(None)
    one["s"] = time.perf_counter() - t0
    res[("d", None)] = [one]
    print(f"checkpoint {os.path.getsize(after1) / 2**30:.3f} GiB, "
          f"{len(got)} keys", flush=True)
    shutil.rmtree(os.path.dirname(after1), ignore_errors=True)
    ref = res[("d", from_shape)][0]
    for shape in CKPT_ONTO + (None,):
        runs = res[("d", shape)]
        worst = {"loss": max(abs(r["loss"] - ref["loss"]) / abs(ref["loss"])
                             for r in runs),
                 "norm": max(abs(r["norm"] - ref["norm"]) / ref["norm"]
                             for r in runs),
                 "big_err": max(r["big_err"] for r in runs),
                 "over": max(r["over"] for r in runs), "all_err": 0.0}
        where = "one process" if shape is None else f"{shape}"
        print(f"train-mesh (d) on {card}: {arch} ({layers} layers) saved on "
              f"{from_shape} after one step (save "
              f"{res[('d', from_shape)][0]['save_s']:.1f} s), restored on "
              f"{where} (restore {runs[0]['restore_s']:.1f} s): second step "
              f"loss rel err {worst['loss']:.3e} (tol 1e-5), grad_norm rel "
              f"err {worst['norm']:.3e} (tol 1e-4), params max_abs_err "
              f"where the gradient fixes the update {worst['big_err']:.3e} "
              f"(tol {MESH_TOL:g}), excess elsewhere {worst['over']:.3e} "
              f"(tol 0); {max(r['s'] for r in runs):.1f} s", flush=True)
        rows.append({"run": "(d)", "arch": arch, "layers": layers, "B": B,
                     "S": S, "saved_on": list(from_shape),
                     "mesh": None if shape is None else list(shape),
                     **worst})
        _held(f"(d) {where}", worst)
    if got != want:
        bad = sorted(set(got) ^ set(want)) or [
            k for k in got if got[k] != want[k]]
        fail(f"train-mesh (d): the checkpoint's keys or shapes differ from "
             f"param_shapes' (params, mu, nu) and the step at {bad[:5]}")
    arch, layers, B, S = SORTED_MESH
    for shape in SORTED_MESHES:
        runs = res[("e", shape)]
        worst = _worst(st for r in runs for st in r["steps"])
        drops = runs[0]["drops"]
        print(f"train-mesh (e) on {card}: {arch} ({layers} layers) sorted "
              f"MoE, skewed, B={B} S={S} on {shape} against one process, "
              f"{SORTED_STEPS} steps: the whole batch drops {drops} "
              f"assignments over the layers; loss rel err "
              f"{worst['loss']:.3e} (tol 1e-5), grad_norm rel err "
              f"{worst['norm']:.3e} (tol 1e-4), params max_abs_err where "
              f"the gradient fixes the update {worst['big_err']:.3e} (tol "
              f"{MESH_TOL:g}), excess elsewhere {worst['over']:.3e} (tol 0), "
              f"over every component {worst['all_err']:.3e} (printed); "
              f"{max(r['s'] for r in runs):.1f} s", flush=True)
        rows.append({"run": "(e)", "arch": arch, "layers": layers, "B": B,
                     "S": S, "mesh": list(shape), "drops": drops, **worst})
        if not drops:
            fail("train-mesh (e): the skewed batch drops no assignment")
        _held(f"(e) {shape}", worst)
    arch, layers, B, S, steps, _ = TRAIN_MESH
    runs = res[("f", POD_MESH)]
    worst = _worst(st for r in runs for st in r["steps"])
    print(f"train-mesh (f) on {card}: {arch} ({layers} layers) B={B} S={S} "
          f"on the pod mesh {POD_MESH} against one process, {steps} steps: "
          f"loss rel err {worst['loss']:.3e} (tol 1e-5), grad_norm rel err "
          f"{worst['norm']:.3e} (tol 1e-4), params max_abs_err where the "
          f"gradient fixes the update {worst['big_err']:.3e} (tol "
          f"{MESH_TOL:g}), excess elsewhere {worst['over']:.3e} (tol 0), "
          f"over every component {worst['all_err']:.3e} (printed); "
          f"{max(r['s'] for r in runs):.1f} s", flush=True)
    rows.append({"run": "(f)", "arch": arch, "layers": layers, "B": B,
                 "S": S, "mesh": list(POD_MESH), **worst})
    _held("(f)", worst)
    return rows


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
    print_baseline_attainment(runs)
    check_sharded_kernels(worst)
    moe_slabs = check_sharded_moe(worst)
    refs = gloo_references()
    background = start_background()
    with ended_on_exit(background["procs"]):
        gloo, slot_runs = gloo_phase(refs)
        dryrun_phase(background)
        cli_row = train_cli_row(background["train_clis"], card_line())
        check_mesh_nccl_captured()
        runs.update(mesh_serve_phase())
        runs.update(slot_runs)
        kernels = time_phase(runs, worst)
        for k in kernels:
            if k["name"] == "moe_grouped_ffn":
                k["rank_slabs"] = moe_slabs
        train_phase()
        examples_phase(background)
    train_mesh_phase(gloo, cli_row)
    leaked = sorted(m for m in sys.modules
                    if m == "jax" or m.startswith(("jax.", "repro.")))
    if leaked:
        fail(f"JAX or the JAX package was imported: {leaked[:5]}")
    card = card_line()
    print(f"total {time.perf_counter() - t0:.1f}s")
    print(phase_seconds())
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
