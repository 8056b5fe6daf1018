"""Compiled steps: each step kind and static shape captured once as a
CUDA graph and replayed after. The port's counterpart of the JAX
executor's AOT-compiled steps (``repro.serving.executor``: ``_lower``,
``_build_steps``, ``_build_verify_steps``, ``_build_bucket_steps``,
``_build_chunk_steps``, ``_suffix_step``, ``_prefill_jit``) and of the
JAX draft model's (``repro.serving.spec_decode.DraftModel``:
``_decode_jit``, ``_chunk_jit``).

An engine owns one ``StepGraphs`` and asks it for a ``Step`` per key (a
step kind and its static shape, such as ``("decode", 8)``), giving the
step's static inputs (shape, type and the pad value a row of no task
holds) and its function of them. A ``Step`` owns:

- static input tensors on the engine's device, allocated once, and
  pinned host staging of the same shapes: ``run`` writes the host arrays
  into the staging and makes one host-to-device copy per input;
- on the card, a ``torch.cuda.CUDAGraph``: when the step is made (at an
  engine's first request for its key, before the engine's clock starts)
  the function runs once eagerly on a side stream with every input at its
  pad value
  (rows of no task write only the arenas' spare page and slot, so the
  warm-up changes no state a task owns), which builds the kernels'
  libraries, runs their one-time attribute calls and initialises cuBLAS
  outside capture; then it is captured into the engine's one memory pool
  (``torch.cuda.graph_pool_handle()``; an engine's replays never
  overlap), with Python's garbage collector off for the capture; every
  ``run`` replays it and returns the static outputs the capture
  allocated, which the next replay overwrites;
- the launches the capture made through ``kernels.ops`` (recorded, then
  taken back out of ``ops.LAUNCHES``, so warm-up and capture count
  nothing), added to ``ops.LAUNCHES`` on every replay: a replayed step
  counts as the eager step does;
- the ``data_ptr`` of every arena tensor at capture: a replay raises if
  the engine's arenas are no longer those tensors.

On the CPU, or with ``capture=False``, the same staging runs the step
function on the static inputs at every ``run``, uncaptured: the CPU tests
exercise everything but the capture itself. There is no fallback: a
capture that fails raises and leaves no step behind (the next request
tries again), and a replay that fails raises.

The slot cache's steps are here too (``slot_cache``, ``masked_step``,
``chunk_step``), shared by the slot engine and the draft model: both own
a slot cache with one spare row past their slots, which the pad inputs
of these steps write.
"""
from __future__ import annotations

import gc
from typing import (Callable, Dict, Hashable, List, Optional, Sequence,
                    Tuple, Union)

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.models import model as M

# name -> (shape, type, pad value: a scalar or an array of the shape)
InputSpec = Dict[str, Tuple[Tuple[int, ...], torch.dtype,
                            Union[int, bool, np.ndarray]]]
StepFn = Callable[[Dict[str, torch.Tensor]], Tuple[torch.Tensor, ...]]


class Step:
    """One step kind at one static shape; see the module docstring."""

    def __init__(self, device: torch.device, spec: InputSpec, fn: StepFn,
                 arenas: Callable[[], List[torch.Tensor]], capture: bool,
                 pool=None):
        self.device = device
        self.fn = fn
        self.arenas = arenas
        self.capture = capture
        self.pool = pool
        self.pads = {name: np.broadcast_to(np.asarray(pad), shape)
                     for name, (shape, _, pad) in spec.items()}
        self.inputs = {name: torch.from_numpy(np.array(self.pads[name])).to(
            device=device, dtype=dtype) for name, (_, dtype, _) in spec.items()}
        pin = device.type == "cuda"
        # the staging the host writes; on the CPU the inputs themselves
        self.staging = ({name: torch.empty(t.shape, dtype=t.dtype,
                                           pin_memory=True)
                         for name, t in self.inputs.items()} if pin
                        else self.inputs)
        self._copied: Optional[torch.cuda.Event] = None
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.outputs: Optional[Tuple[torch.Tensor, ...]] = None
        self.launches: Dict[str, int] = {}
        self._arena_ptrs: List[int] = []
        self.runs = 0

    # -- staging --
    def stage(self, host: Dict[str, np.ndarray]) -> None:
        """Write the host arrays (every input, numpy, shaped as the input)
        into the static inputs: into the pinned staging, then one
        asynchronous host-to-device copy each."""
        if self._copied is not None:
            self._copied.synchronize()     # the last copies left the staging
        for name, a in host.items():
            self.staging[name].numpy()[...] = a
        if self.staging is self.inputs:
            return
        for name, t in self.inputs.items():
            t.copy_(self.staging[name], non_blocking=True)
        self._copied = torch.cuda.Event()
        self._copied.record()

    # -- capture and replay --
    def capture_graph(self) -> None:
        """Run the step once on the pad inputs (nothing is staged before)
        on a side stream, then capture it into the pool; the launches of
        both are taken back out of ``ops.LAUNCHES`` and the capture's are
        kept for the replays."""
        cur = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            ops.recorded_launches(lambda: self.fn(self.inputs))
        cur.wait_stream(side)
        graph = torch.cuda.CUDAGraph()

        def capture():
            with torch.cuda.graph(graph, pool=self.pool):
                return self.fn(self.inputs)

        # the collector stays off while the stream captures: collecting an
        # engine that died in a reference cycle destroys its graphs and
        # frees its buffers, which invalidates the capture in progress
        collecting = gc.isenabled()
        gc.disable()
        try:
            self.outputs, self.launches = ops.recorded_launches(capture)
        finally:
            if collecting:
                gc.enable()
        self.graph = graph
        self._arena_ptrs = [t.data_ptr() for t in self.arenas()]

    def replay(self) -> Tuple[torch.Tensor, ...]:
        """Replay the captured graph on the static inputs as they stand and
        count its launches; raises if the engine's arenas are no longer
        the tensors the graph writes."""
        if self.graph is None:
            raise RuntimeError("captured step: no graph was captured")
        ptrs = [t.data_ptr() for t in self.arenas()]
        if ptrs != self._arena_ptrs:
            raise RuntimeError(
                "captured step: the engine's arena tensors are not those "
                "the graph was captured on (an arena was rebound; the "
                "arenas must be updated in place)")
        self.graph.replay()
        ops.add_launches(self.launches)
        return self.outputs

    def run(self, host: Dict[str, np.ndarray]) -> Tuple[torch.Tensor, ...]:
        """Stage the host arrays and run the step: replay its graph when
        it is captured, else the step function on the static inputs.
        Returns the step's outputs; a captured step's are its static
        outputs, overwritten by its next run."""
        self.stage(host)
        out = self.replay() if self.capture else self.fn(self.inputs)
        self.runs += 1
        return out


class StepGraphs:
    """The steps of one engine by key, sharing one graph memory pool.
    ``capture`` asks for CUDA graphs; it holds only on a CUDA device."""

    def __init__(self, device: torch.device, capture: bool = True):
        self.device = device
        self.capture = bool(capture) and device.type == "cuda"
        self.pool = torch.cuda.graph_pool_handle() if self.capture else None
        self.steps: Dict[Hashable, Step] = {}

    def step(self, key: Hashable, spec: InputSpec, fn: StepFn,
             arenas: Callable[[], List[torch.Tensor]]) -> Step:
        """The step of ``key``, made (and captured) at its first request:
        ``spec`` and ``fn`` are read only then. A capture that fails
        raises and keeps no step."""
        st = self.steps.get(key)
        if st is None:
            st = Step(self.device, spec, fn, arenas, self.capture, self.pool)
            if self.capture:
                st.capture_graph()
            self.steps[key] = st
        return st


class LazyLogits:
    """A step's logits kept on the device and read to the host once, when
    first asked for, as JAX keeps them device-resident until read. The
    tensor given is copied on the device now: a captured step's output is
    its next replay's. ``rows`` selects rows, ``pick`` then one column
    of each row (a verify window's accepted position)."""

    def __init__(self, logits: torch.Tensor,
                 rows: Optional[Sequence[int]] = None,
                 pick: Optional[Sequence[int]] = None):
        self._dev: Optional[torch.Tensor] = logits.clone()
        self._rows, self._pick = rows, pick
        self._host: Optional[np.ndarray] = None

    def numpy(self) -> np.ndarray:
        if self._host is None:
            a = self._dev.float().cpu().numpy()
            if self._rows is not None:
                a = a[np.asarray(self._rows, dtype=np.int64)]
            if self._pick is not None:
                a = a[np.arange(a.shape[0]), np.asarray(self._pick)]
            self._host, self._dev = a, None
        return self._host


def with_argmax(logits: torch.Tensor):
    """A step's outputs: its logits and their argmax (int32), fused into
    the step as JAX fuses it, so only the argmax is read to the host."""
    return logits, logits.argmax(-1).to(torch.int32)


# ------------------------------------------------------ slot-cache steps

def slot_cache(cfg, n_slots: int, max_seq: int, dtype, device) -> M.Cache:
    """A slot cache of ``n_slots`` rows (model.init_cache) and one spare
    row past them (row ``n_slots``), which no task holds: a slot step's
    pad inputs write only there."""
    return M.init_cache(cfg, n_slots + 1, max_seq, dtype=dtype,
                        device=device)


def _slot_arenas(eng) -> Callable[[], List[torch.Tensor]]:
    return lambda: list(eng.cache.values())


def masked_step(eng) -> Step:
    """The masked decode step over the ``eng.max_slots`` rows of
    ``eng.cache`` (the spare row excluded), in place: inputs tokens and
    valid (the decode-mask column) per row; pads are inactive rows,
    which write nothing. Returns (logits [S,V], argmax [S] int32).
    ``eng`` is a slot engine or a draft model: it has ``cfg``, ``params``,
    ``cache``, ``max_slots`` and ``graphs``."""
    S, cfg, params = eng.max_slots, eng.cfg, eng.params
    spec = {"tokens": ((S,), torch.int32, 0),
            "valid": ((S,), torch.bool, False)}

    def masked(x):
        rows = {k: v[:, :S] if k in ("k", "v") else v[:S]
                for k, v in eng.cache.items()}
        logits, _ = M.decode_step(cfg, params, rows, x["tokens"], x["valid"])
        return with_argmax(logits)

    return eng.graphs.step(("masked", S), spec, masked, _slot_arenas(eng))


def chunk_step(eng, c: int) -> Step:
    """The chunk step of ``c`` tokens on one row of ``eng.cache`` (JAX's
    slot ``_build_chunk_steps`` and the draft's ``_chunk_step``): gather
    the row ``idx``, append the tokens at ``length`` (the row's cached
    tokens, staged by the host) through model.prefill_chunk, scatter the
    row back. Inputs: idx [1], length [1], tokens [1, c]; the pad is the
    spare row at length 0. Returns (logits [1,V], argmax [1] int32)."""
    cfg, params = eng.cfg, eng.params
    spec = {"idx": ((1,), torch.int64, eng.max_slots),
            "length": ((1,), torch.int32, 0),
            "tokens": ((1, c), torch.int32, 0)}

    def chunk(x):
        cache, idx = eng.cache, x["idx"]
        row = {k: cache[k][:, idx] for k in ("k", "v")}
        row["kv_pos"] = cache["kv_pos"][idx]
        row["length"] = x["length"].clone()     # prefill_chunk adds c to it
        logits, row = M.prefill_chunk(cfg, params, row, x["tokens"])
        for k in ("k", "v"):
            cache[k][:, idx] = row[k]
        for k in ("kv_pos", "length"):
            cache[k][idx] = row[k]
        return with_argmax(logits)

    return eng.graphs.step(("chunk", c), spec, chunk, _slot_arenas(eng))
