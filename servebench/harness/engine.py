"""The system under test as users deploy it, built from a cell's files.

``SliceScheduler`` over ``PagedTorchExecutor``: the synchronous engine
with every step captured as a CUDA graph, in the configuration's served
type, on one card. Set-up warms exactly the shapes this window's
traffic uses: the whole-prompt step of every prompt length it draws (the
engine keys those by exact length), or every chunk piece size, and every
decode batch bucket. The port is imported here and nowhere else in the
harness's core.
"""
from __future__ import annotations

import itertools
from typing import Dict, Iterable, List, Set

import torch

from servebench.harness.traffic import Request

WARM_ID = 2_000_000


def arch(model: Dict):
    """The port's ``ArchConfig`` of a configuration file's ``port`` block."""
    from repro_torch.configs.base import ArchConfig
    return ArchConfig(**model)


def executor(model: Dict, params: Dict, eng: Dict, seed: int, device,
             dtype):
    from repro_torch.serving.executor import PagedTorchExecutor
    return PagedTorchExecutor(
        arch(model), params=params, n_pages=eng["pages"],
        page_size=eng["page_size"], max_seq=eng["max_seq"], seed=seed,
        max_batch=eng["max_batch"], dtype=dtype, device=device,
        prefill_chunk_size=eng.get("prefill_chunk"))


def scheduler(name: str, ex, lat, eng: Dict):
    from repro_torch.core.schedulers import SliceScheduler
    if name != "slice":
        raise ValueError(f"unknown scheduler {name!r}")
    return SliceScheduler(lat, page_budget=ex.page_budget(),
                          prefill_chunk=eng.get("prefill_chunk"))


def task(r: Request):
    """The port's ``Task`` of a request: its fixed SLO, no scaling."""
    from repro_torch.core.task import SLOSpec, Task
    return Task(SLOSpec(tpot_ms=r.slo.tpot_ms, ttft_ms=r.slo.ttft_ms,
                        deadline_ms=r.slo.deadline_ms,
                        realtime=r.slo.realtime),
                utility=r.utility, prompt_len=r.prompt_len,
                output_len=r.output_len, arrival_ms=r.due_ms,
                task_id=r.rid, kind=r.kind)


def check_fits(requests: Iterable[Request], eng: Dict) -> None:
    """Traffic on which no operation fails: the engine caps prompts at
    max_seq // 2 and sequences at max_seq."""
    for r in requests:
        if r.prompt_len > eng["max_seq"] // 2 or (
                r.prompt_len + r.output_len > eng["max_seq"]):
            raise ValueError(f"request of {r.prompt_len} + {r.output_len} "
                             f"tokens does not fit max_seq {eng['max_seq']}")


def chunk_pieces(n: int, chunk: int) -> List[int]:
    """The engine's split of one chunk action of ``n`` tokens into step
    sizes (a copy of ``serving/executor.py`` ``_chunk_pieces``): whole
    ``chunk`` pieces, then the remainder's powers of two, largest first."""
    pieces = []
    while n > 0:
        p = chunk
        if n < chunk:
            p = 1
            while p * 2 <= n:
                p *= 2
        pieces.append(p)
        n -= p
    return pieces


def chunk_actions(prompt_len: int, chunk: int) -> List[int]:
    """The token counts of SLICE's chunk actions over one prompt."""
    out, done = [], 0
    while done < prompt_len:
        out.append(min(chunk, prompt_len - done))
        done += out[-1]
    return out


def pieces_used(requests: Iterable[Request], chunk: int) -> Set[int]:
    return {p for r in requests for n in chunk_actions(r.prompt_len, chunk)
            for p in chunk_pieces(n, chunk)}


def warm(ex, requests: List[Request], eng: Dict) -> Dict[str, int]:
    """Capture every step the window will run; returns what was warmed.
    Warm tasks hold ids no request has, and are released after."""
    from repro_torch.core.task import SLOSpec, Task
    ids = itertools.count(WARM_ID)
    chunk = eng.get("prefill_chunk")

    def new(L):
        return Task(SLOSpec(tpot_ms=100.0, ttft_ms=2000.0), utility=1.0,
                    prompt_len=L, output_len=2, task_id=next(ids),
                    kind="warm")

    def fill(t):
        if chunk is None:
            ex.prefill(t)
        else:
            ex.prefill_chunk(t, t.prompt_len)

    if chunk is None:
        shapes = sorted({r.prompt_len for r in requests})
    else:
        shapes = sorted(pieces_used(requests, chunk))
    for L in shapes:
        t = new(L)
        fill(t)
        ex.release(t)
    resident = [new(shapes[0]) for _ in range(eng["max_batch"])]
    for t in resident:
        fill(t)
    buckets = []
    b = 1
    while True:
        b = min(b, eng["max_batch"])
        buckets.append(b)
        for _ in range(2):
            ex.decode(resident[:b])
        if b == eng["max_batch"]:
            break
        b *= 2
    for t in resident:
        ex.release(t)
    if ex.device.type == "cuda":
        torch.cuda.synchronize()
    return {"prompt_shapes": len(shapes), "decode_buckets": len(buckets)}
