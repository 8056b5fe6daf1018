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

- static input tensors on the engine's device, allocated once, and a
  ring of pinned host stagings of the same shapes (``ring`` deep, each
  with an event recorded after its copies): ``run`` writes the host
  arrays into the next staging and makes one host-to-device copy per
  input, waiting only on the copies that staging made ``ring`` runs ago
  (a synchronous engine runs with a ring of 1; the async engine with
  ``max_in_flight + 1``, so staging a step never waits on a step still
  in flight). An input whose host array equals the one it was last
  staged from is not copied again (the input cache of the JAX async
  engine). Named inputs can instead take rows from device tensors, by a
  copy ordered on the stream before the replay (``stage``'s ``dev``):
  the async engine chains the next step's tokens from the argmax of a
  step it has not observed yet;
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
  the engine's arenas are no longer those tensors;
- ``marks``, a pair of timing events captured in the graph (``external``:
  each replay records them on the device), the first after a one-element
  kernel that opens the graph, the second as its last node, so the
  graph's device time is read from its kernels: a mark as the first node
  fires as the launch begins, before the kernels have reached the device.
  The kernels can still wait inside the graph on a launch under way (a
  launch takes 0.05-0.15 ms at full size, ~1 ms with a profiler attached,
  PERF.md); the marks cannot tell those waits from the kernels' own gaps.

A step's outputs are static, so what outlives the next replay is copied
out at once: ``Snapshot`` takes a step's argmax ints into a device copy
(the chain source) and, without blocking, into a ring of pinned host
buffers with an event after the copy, so a commit waits on that one
step only; ``LazyLogits`` keeps a device copy of its logits until read.
``StepGraphs`` counts every wait on an event that had not completed:
``stage_waits`` (a staging's copies still queued) and ``commit_waits``
(a snapshot read before its step finished). The async engine's steady
state makes no stage wait, and commit waits only where its queue's
depth forces a commit.

``StepGraphs`` also counts the steps it made (``captures``; on the card
each one a capture) and the host ms making them took (``make_ms``: the
step's buffers, the eager warm-up and the capture). With a ``PhaseTimer``
set as its ``timer`` (an engine's traced ops, ``PhaseTimer``'s docstring)
every run is timed: a captured graph by its ``marks``, an uncaptured step
by the host clock around its function. With no timer a run makes no
event and reads no clock.

On the CPU, or with ``capture=False``, the same staging runs the step
function on the static inputs at every ``run``, uncaptured: the CPU tests
exercise everything but the capture itself. There is no fallback: a
capture that fails raises and leaves no step behind (the next request
tries again), and a replay that fails raises. Before a capture the
engine's ``quiesce`` callback runs (the async engine waits out its host
transfers there: a worker thread waiting on a CUDA event while the
stream captures would invalidate the capture).

The slot cache's steps are here too (``slot_cache``, ``masked_step``,
``chunk_step``), shared by the slot engine and the draft model: both own
a slot cache with one spare row past their slots, which the pad inputs
of these steps write.
"""
from __future__ import annotations

import gc
import time
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
                 pool=None, owner: Optional["StepGraphs"] = None,
                 ring: int = 1):
        self.device = device
        self.fn = fn
        self.arenas = arenas
        self.capture = capture
        self.pool = pool
        self.owner = owner
        self.pads = {name: np.broadcast_to(np.asarray(pad), shape)
                     for name, (shape, _, pad) in spec.items()}
        self.inputs = {name: torch.from_numpy(np.array(self.pads[name])).to(
            device=device, dtype=dtype) for name, (_, dtype, _) in spec.items()}
        pin = device.type == "cuda"
        # the stagings the host writes, each with the event recorded after
        # its copies; on the CPU the inputs themselves
        self.staging = ([{name: torch.empty(t.shape, dtype=t.dtype,
                                            pin_memory=True)
                          for name, t in self.inputs.items()}
                         for _ in range(ring)] if pin else [self.inputs])
        self._copied: List[Optional[torch.cuda.Event]] = [None] * ring
        # per staging: pinned and device row maps of the device-sourced
        # rows (made at the first gather)
        self._rowmaps: List[Optional[Tuple[torch.Tensor, torch.Tensor]]] = (
            [None] * ring)
        self._next = 0
        # the host array each input was last staged from (none once the
        # input was written from the device)
        self._staged: Dict[str, np.ndarray] = {}
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.outputs: Optional[Tuple[torch.Tensor, ...]] = None
        self.launches: Dict[str, int] = {}
        self._arena_ptrs: List[int] = []
        self.marks: Optional[Tuple[torch.cuda.Event, torch.cuda.Event]] = None
        self._tick: Optional[torch.Tensor] = None   # the graph's first kernel
        self.runs = 0

    # -- staging --
    def stage(self, host: Dict[str, np.ndarray],
              dev: Optional[Dict[str, Sequence[DevRows]]] = None) -> None:
        """Write the host arrays (every input, numpy, shaped as the input)
        into the static inputs: into the next pinned staging, then one
        asynchronous host-to-device copy for each input whose array
        changed since it was last staged. Then, for each input named in
        ``dev``, rows taken from device tensors: ``(src, dst_rows,
        src_rows)`` copies ``src[src_rows]`` into the input's rows
        ``dst_rows``, in stream order after the host copies; a source
        whose rows are 0..n-1 on both sides is one slice copy, any other
        a gather by a row map uploaded through the staging."""
        k = self._next
        self._next = (k + 1) % len(self.staging)
        staging = self.staging[k]
        pinned = staging is not self.inputs
        if self._copied[k] is not None:   # this staging's last copies left
            wait_event(self._copied[k], self.owner, "stage_waits")
        for name, a in host.items():
            last = self._staged.get(name)
            if last is not None and np.array_equal(last, a):
                continue
            staging[name].numpy()[...] = a
            self._staged[name] = np.array(a, copy=True)
            if pinned:
                self.inputs[name].copy_(staging[name], non_blocking=True)
        for name, sources in (dev or {}).items():
            self._gather(k, self.inputs[name], sources)
            self._staged.pop(name, None)
        if pinned:
            self._copied[k] = torch.cuda.Event()
            self._copied[k].record()

    def _gather(self, k: int, dst: torch.Tensor,
                sources: Sequence[DevRows]) -> None:
        maps = []
        for src, dst_rows, src_rows in sources:
            n = len(dst_rows)
            ident = np.arange(n)
            if np.array_equal(dst_rows, ident) and np.array_equal(
                    src_rows, ident):
                dst[:n].copy_(src[:n])
            else:
                maps.append((src, dst_rows, src_rows))
        if not maps:
            return
        # one flat row map: every source's destination rows, then every
        # source's rows (contiguous, so the upload is one pinned copy)
        dst_all = np.concatenate([d for _, d, _ in maps])
        m = len(dst_all)
        flat = np.concatenate([dst_all] + [r for _, _, r in maps])
        if self.device.type == "cuda":
            if (self._rowmaps[k] is None
                    or self._rowmaps[k][0].numel() < 2 * m):
                width = 2 * max(m, dst.shape[0])
                self._rowmaps[k] = (
                    torch.empty((width,), dtype=torch.int64, pin_memory=True),
                    torch.empty((width,), dtype=torch.int64,
                                device=self.device))
            host_map, dev_map = self._rowmaps[k]
            host_map.numpy()[: 2 * m] = flat
            dev_map[: 2 * m].copy_(host_map[: 2 * m], non_blocking=True)
        else:
            dev_map = torch.from_numpy(flat.astype(np.int64))
        at = 0
        for src, dst_rows, _ in maps:
            n = len(dst_rows)
            d = dev_map[at: at + n]
            s = dev_map[m + at: m + at + n]
            dst.index_copy_(0, d, src.index_select(0, s).to(dst.dtype))
            at += n

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
        marks = tuple(torch.cuda.Event(enable_timing=True, external=True)
                      for _ in range(2))
        for m in marks:          # made outside the capture
            m.record()
        tick = torch.zeros((1,), dtype=torch.int32, device=self.device)

        def capture():
            with torch.cuda.graph(graph, pool=self.pool):
                tick.add_(1)     # see the module docstring's ``marks``
                marks[0].record()
                out = self.fn(self.inputs)
                marks[1].record()
                return out

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
        self.marks, self._tick = marks, tick
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

    def run(self, host: Dict[str, np.ndarray],
            dev: Optional[Dict[str, Sequence[DevRows]]] = None
            ) -> Tuple[torch.Tensor, ...]:
        """Stage the host arrays (and the device-sourced rows ``dev``) and
        run the step: replay its graph when it is captured, else the step
        function on the static inputs. Returns the step's outputs; a
        captured step's are its static outputs, overwritten by its next
        run."""
        self.stage(host, dev)
        tm = self.owner.timer if self.owner is not None else None
        if tm is not None:
            tm.start(self)
        out = self.replay() if self.capture else self.fn(self.inputs)
        if tm is not None:
            tm.stop(self)
        self.runs += 1
        return out


class StepGraphs:
    """The steps of one engine by key, sharing one graph memory pool.
    ``capture`` asks for CUDA graphs; it holds only on a CUDA device.
    ``ring`` is the depth of each step's staging ring and of the argmax
    snapshots' host ring; ``quiesce`` runs before every capture.
    ``captures`` and ``make_ms`` count the steps made and the host ms it
    took; ``timer``, a ``PhaseTimer`` or None, times every run."""

    def __init__(self, device: torch.device, capture: bool = True,
                 ring: int = 1, quiesce: Optional[Callable[[], None]] = None):
        self.device = device
        self.capture = bool(capture) and device.type == "cuda"
        self.pool = torch.cuda.graph_pool_handle() if self.capture else None
        self.steps: Dict[Hashable, Step] = {}
        self.ring = ring
        self.quiesce = quiesce
        # waits on events not yet complete: staging, snapshot reads
        self.stage_waits = 0
        self.commit_waits = 0
        self._snap_slots: List[Optional["Snapshot"]] = [None] * ring
        self._snap_next = 0
        self.captures = 0
        self.make_ms = 0.0
        self.timer: Optional[PhaseTimer] = None

    def step(self, key: Hashable, spec: InputSpec, fn: StepFn,
             arenas: Callable[[], List[torch.Tensor]]) -> Step:
        """The step of ``key``, made (and captured) at its first request:
        ``spec`` and ``fn`` are read only then. A capture that fails
        raises and keeps no step."""
        st = self.steps.get(key)
        if st is None:
            t0 = time.perf_counter()
            st = Step(self.device, spec, fn, arenas, self.capture, self.pool,
                      owner=self, ring=self.ring)
            if self.capture:
                if self.quiesce is not None:
                    self.quiesce()
                st.capture_graph()
            self.steps[key] = st
            self.captures += 1
            self.make_ms += (time.perf_counter() - t0) * 1000.0
        return st

    def snapshot(self, t: torch.Tensor) -> "Snapshot":
        """A ``Snapshot`` of a step's int output ``t``, taken now in
        stream order (before anything can replay the step again)."""
        k = self._snap_next
        self._snap_next = (k + 1) % self.ring
        old = self._snap_slots[k]
        if old is not None:
            old.read()           # its pinned slot is about to be reused
        snap = Snapshot(self, t, old)
        self._snap_slots[k] = snap
        return snap


DevRows = Tuple[torch.Tensor, np.ndarray, np.ndarray]


class PhaseTimer:
    """The phases of a synchronous engine's ops, on the host's
    ``time.perf_counter`` clock. The engine calls ``enter`` at an op's
    entry, ``anchor`` where the stream is idle (right after its clock's
    device sync), and ``leave`` at its return, once the op has waited on
    what its steps computed; its ``StepGraphs`` calls ``start`` and
    ``stop`` around each step it runs. ``last`` gives the op's phases,
    None for an op that ran no step or did not return, else, in ms:

    - ``stage_ms``: entry to the first step's start (step lookup and any
      capture, pool and page-table work, the sync, staging, and the
      launch up to the graph's first kernel);
    - ``graph_ms``: the op's steps' summed run time, on the card from each
      graph's first kernel to its last node (the module docstring's
      ``marks``: waits inside a graph on its launch are in it);
      ``graphs`` their count;
    - ``gaps_ms``: the time between its steps (0 for one step);
    - ``commit_ms``: the last step's end to the return (the snapshot and
      logits copies, the wake, the argmax read, the bookkeeping);
    - ``captures``: the steps the op made.

    The four times partition the op's host time from entry to return. A
    captured step is timed on the device by its graph's ``marks``, put on
    the host's clock by the anchor's event. A graph that runs again in
    the same op records its marks anew, so the earlier run's are read
    just before that replay if they have completed, and that run falls
    back otherwise to a pair of events recorded around its replay (one
    pair a run, reused from op to op): its end then holds while the
    stream is busy with the graph, its start holds the launch too.
    ``leave`` only reads the clock: the events are read, and the fields
    made, by ``last``, after the op has returned and its events have
    completed, so timing adds no wait and little host time to the op. An
    uncaptured step's time is the host's around its function."""

    def __init__(self, graphs: StepGraphs):
        self.graphs = graphs
        self.on_device = graphs.capture
        self._pairs: List[Tuple[torch.cuda.Event, torch.cuda.Event]] = []
        self._steps: List[Step] = []        # each run's step, in order
        self._read: List[List[Optional[float]]] = []  # marks read early
        self._unread: Dict[Step, int] = {}  # step -> run its marks hold
        self._host: List[float] = []       # uncaptured: start, end, ...
        self._anchor = (torch.cuda.Event(enable_timing=True)
                        if self.on_device else None)
        self._t_anchor = 0.0
        self._n = 0
        self._entry = self._ret = 0.0
        self._captures = 0
        self._left = False
        self._last: Optional[Dict[str, float]] = None

    def enter(self) -> None:
        self._n = 0
        self._host.clear()
        self._steps.clear()
        self._read.clear()
        self._unread.clear()
        self._left = False
        self._last = None
        self._captures = self.graphs.captures
        self._entry = time.perf_counter()

    def anchor(self) -> None:
        if self.on_device:
            self._anchor.record()
        self._t_anchor = time.perf_counter()

    def start(self, step: Step) -> None:
        if not self.on_device:
            self._host.append(time.perf_counter())
            return
        i = self._unread.pop(step, None)
        if i is not None:                # its marks are about to be reused
            self._read[i] = [self._anchor.elapsed_time(m) if m.query()
                             else None for m in step.marks]
        if self._n == len(self._pairs):
            self._pairs.append((torch.cuda.Event(enable_timing=True),
                                torch.cuda.Event(enable_timing=True)))
        self._pairs[self._n][0].record()

    def stop(self, step: Step) -> None:
        if self.on_device:
            self._pairs[self._n][1].record()
            self._steps.append(step)
            self._read.append([None, None])
            self._unread[step] = self._n
        else:
            self._host.append(time.perf_counter())
        self._n += 1

    def leave(self) -> None:
        self._ret = time.perf_counter()
        self._left = True

    def _stamps(self) -> List[float]:
        """[start, end] of each run in ms after the anchor, in order."""
        out = []
        for i, step in enumerate(self._steps):
            read = self._read[i]
            if self._unread.get(step) == i:
                read = [self._anchor.elapsed_time(m) for m in step.marks]
            out += [self._anchor.elapsed_time(h) if r is None else r
                    for r, h in zip(read, self._pairs[i])]
        return out

    def last(self) -> Optional[Dict[str, float]]:
        """The phases of the last op (see the class docstring)."""
        if self._last is not None or not self._left or self._n == 0:
            return self._last
        n = self._n
        if self.on_device:
            base = self._t_anchor * 1000.0
            h = [base + t for t in self._stamps()]
        else:
            h = [t * 1000.0 for t in self._host]
        # h: [start, end] of each step, in order
        graph = sum(h[i + 1] - h[i] for i in range(0, 2 * n, 2))
        gaps = sum((h[i + 1] - h[i] for i in range(1, 2 * n - 1, 2)), 0.0)
        self._last = {"stage_ms": h[0] - self._entry * 1000.0,
                      "graph_ms": graph, "gaps_ms": gaps,
                      "commit_ms": self._ret * 1000.0 - h[-1],
                      "graphs": n,
                      "captures": self.graphs.captures - self._captures}
        return self._last


def wait_event(ev: "torch.cuda.Event", owner: Optional[StepGraphs],
               counter: str) -> None:
    """Wait on ``ev``, adding one to ``owner``'s ``counter`` when the
    event had not completed (the host really waited on the device)."""
    if not ev.query():
        if owner is not None:
            setattr(owner, counter, getattr(owner, counter) + 1)
        ev.synchronize()


class Snapshot:
    """A step's int output (its argmax) copied out before the step's next
    replay overwrites it: ``dev``, a copy on the device (the source the
    next step's chained tokens are gathered from), and on the card a
    non-blocking copy into a pinned host buffer of the owner's ring with
    an event recorded after it. ``read`` waits on that event only (not on
    steps dispatched after this one) and returns the ints, flat."""

    def __init__(self, owner: StepGraphs, t: torch.Tensor,
                 reuse: Optional["Snapshot"] = None):
        self.owner = owner
        self.shape = tuple(t.shape)
        self.dev = t.clone()
        self._host: Optional[np.ndarray] = None
        self._done: Optional[torch.cuda.Event] = None
        self._pinned: Optional[torch.Tensor] = None
        if self.dev.device.type == "cuda":
            n = self.dev.numel()
            buf = reuse._pinned if reuse is not None else None
            if buf is None or buf.numel() < n:
                buf = torch.empty((max(n, 64),), dtype=self.dev.dtype,
                                  pin_memory=True)
            self._pinned = buf
            buf[:n].copy_(self.dev.reshape(-1), non_blocking=True)
            self._done = torch.cuda.Event()
            self._done.record()

    def read(self) -> np.ndarray:
        if self._host is None:
            if self._pinned is None:
                self._host = self.dev.reshape(-1).numpy().copy()
            else:
                wait_event(self._done, self.owner, "commit_waits")
                self._host = self._pinned[: self.dev.numel()].numpy().copy()
        return self._host.reshape(self.shape)


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
        # ``pick`` may be set after construction, before the first read
        # (an async verify step learns it at commit)
        self.rows, self.pick = rows, pick
        self._host: Optional[np.ndarray] = None

    def numpy(self) -> np.ndarray:
        if self._host is None:
            a = self._dev.float().cpu().numpy()
            if self.rows is not None:
                a = a[np.asarray(self.rows, dtype=np.int64)]
            if self.pick is not None:
                a = a[np.arange(a.shape[0]), np.asarray(self.pick)]
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
        rows = {k: v[:, :S] if k in M.LAYER_FIELDS else v[:S]
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
