"""Async-pipeline substrate: the engine-agnostic state machine behind the
dispatch-ahead paged executor (DESIGN.md §10).

The synchronous serving loop serializes host and device: every decode
calls ``block_until_ready()``, every swap blocks on ``device_get/put``,
so the host idles during device steps and the device idles during
replanning and transfers. The async mode keeps the device fed by
*dispatching ahead* — JAX dispatch is already asynchronous; the engine
just stops forcing early syncs — and defers sampling/observation to
*commit time*. This module owns the three pure host-side pieces, kept
free of jax so they can be unit-tested with a deterministic fake clock
(tests/test_pipeline.py):

``DispatchQueue``
    Bounded FIFO of in-flight device steps (double buffering by default).
    Pushing past ``max_in_flight`` commits the oldest step first (a
    *stall* — counted in ``GapStats``), so host-side state never runs
    more than a fixed number of cycles ahead of the device. A commit
    that raises rolls the remaining queue back (newest first, via the
    ``rollback`` callback) and re-raises, leaving no partially committed
    suffix behind a poisoned step.

``TransferLedger``
    In-flight host<->device page-transfer bookkeeping: while a swap
    gather/scatter is outstanding, its pages are *busy* — they must not
    be freed, CoW-forked, or written. The JAX engine gets this for free
    from functional array snapshots (the gather captures the arena
    version at enqueue time), so there the ledger enforces *lifecycle*
    ordering — resume/release wait for the owner's transfer — and gives
    audits a surface; the hypothesis interleaving property
    (tests/test_property.py) models the stricter mutable-buffer
    discipline against the same API.

``GapStats``
    The per-run host/device gap breakdown surfaced in ``LoopResult`` and
    the benchmark JSON: ``schedule_ms`` (host replanning), ``dispatch_ms``
    (host time enqueuing device work), ``wait_ms`` (host blocked on
    device results), ``swap_overlap_ms`` (transfer time that ran on the
    background worker, overlapped with device compute). The sync engine
    books an op's whole blocking time as ``wait_ms``; the async engine
    splits it — ``host_gap_ms()`` (= dispatch + wait) is the number the
    async-pipeline benchmark gate requires to strictly shrink.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import (Any, Callable, Deque, Dict, FrozenSet, Iterable, List,
                    Optional, Sequence, Tuple)


def real_clock_ms() -> float:
    """Default pipeline clock: monotonic wall-clock milliseconds."""
    return time.perf_counter() * 1000.0


class FakeClock:
    """Deterministic clock for pipeline unit tests: returns ``now_ms`` and
    only moves when ``advance()`` is called, so timing assertions never
    depend on wall-clock and cannot flake in CI."""

    def __init__(self, now_ms: float = 0.0):
        self.now_ms = float(now_ms)

    def __call__(self) -> float:
        return self.now_ms

    def advance(self, ms: float) -> float:
        if ms < 0:
            raise ValueError("clock cannot run backwards")
        self.now_ms += ms
        return self.now_ms


class GapStats:
    """Host/device gap accumulator (see module docstring for the fields).
    ``swap_overlap_ms`` is written from the background transfer worker, so
    its add goes through a lock; everything else is single-threaded."""

    FIELDS = ("schedule_ms", "dispatch_ms", "wait_ms", "swap_overlap_ms")

    def __init__(self):
        self.schedule_ms = 0.0
        self.dispatch_ms = 0.0
        self.wait_ms = 0.0
        self.swap_overlap_ms = 0.0
        self.cycles = 0      # device steps dispatched
        self.stalls = 0      # pushes that found the queue full
        self._lock = threading.Lock()

    def add_swap_overlap(self, ms: float) -> None:
        with self._lock:
            self.swap_overlap_ms += ms

    def host_gap_ms(self) -> float:
        """Total host time serialized against the device: dispatch + wait.
        The async engine's win condition is strictly shrinking this at
        equal policy decisions (benchmarks/async_pipeline.py)."""
        return self.dispatch_ms + self.wait_ms

    def as_dict(self) -> Dict[str, float]:
        d = {k: getattr(self, k) for k in self.FIELDS}
        d["host_gap_ms"] = self.host_gap_ms()
        d["cycles"] = self.cycles
        d["stalls"] = self.stalls
        return d


class PendingStep:
    """One dispatched, not-yet-committed device step. ``kind`` selects the
    executor's commit routine; ``payload`` carries whatever that routine
    needs (in-flight arrays, drafts, pre-dispatch lengths for rollback)."""

    __slots__ = ("kind", "task_ids", "payload", "dispatched_at_ms")

    def __init__(self, kind: str, task_ids: Sequence[int],
                 payload: Optional[Dict[str, Any]] = None,
                 dispatched_at_ms: float = 0.0):
        self.kind = kind
        self.task_ids = list(task_ids)
        self.payload = payload or {}
        self.dispatched_at_ms = dispatched_at_ms

    def __repr__(self):  # pragma: no cover - debugging aid
        return f"PendingStep({self.kind}, tasks={self.task_ids})"


class DispatchQueue:
    """Bounded in-flight step queue with stall accounting and
    drain-on-error rollback (DESIGN.md §10 stage 2).

    ``commit`` is called with each step in dispatch order; the time it
    spends (measured on the injected clock) is booked as ``wait_ms``.
    ``rollback`` is called for every *uncommitted* step, newest first,
    when a commit raises — the executor uses it to rewind pool-side
    reservations the poisoned pipeline suffix had already made.
    """

    def __init__(self, commit: Callable[[PendingStep], None],
                 max_in_flight: int = 2,
                 rollback: Optional[Callable[[PendingStep], None]] = None,
                 stats: Optional[GapStats] = None,
                 clock: Callable[[], float] = real_clock_ms):
        if max_in_flight < 1:
            raise ValueError("max_in_flight must be >= 1")
        self._commit = commit
        self._rollback = rollback
        self.max_in_flight = max_in_flight
        self.stats = stats if stats is not None else GapStats()
        self.clock = clock
        self._q: Deque[PendingStep] = deque()

    def __len__(self) -> int:
        return len(self._q)

    @property
    def depth(self) -> int:
        return len(self._q)

    def push(self, step: PendingStep) -> None:
        """Enqueue a dispatched step, committing the oldest first when the
        in-flight bound is hit (a stall: the host ran too far ahead)."""
        while len(self._q) >= self.max_in_flight:
            self.stats.stalls += 1
            self.commit_oldest()
        step.dispatched_at_ms = self.clock()
        self._q.append(step)
        self.stats.cycles += 1

    def commit_oldest(self) -> Optional[PendingStep]:
        """Commit the oldest in-flight step (FIFO — commits must observe
        device results in dispatch order). On commit failure the rest of
        the queue is rolled back newest-first and the error propagates:
        a poisoned step must not leave later steps half-committed."""
        if not self._q:
            return None
        step = self._q.popleft()
        t0 = self.clock()
        try:
            self._commit(step)
        except BaseException:
            self.drain(discard=True)
            raise
        finally:
            self.stats.wait_ms += self.clock() - t0
        return step

    def commit_all(self) -> int:
        """Drain the queue through commit; returns steps committed."""
        n = 0
        while self._q:
            self.commit_oldest()
            n += 1
        return n

    def drain(self, discard: bool = False) -> int:
        """Empty the queue. ``discard=True`` is the error path: uncommitted
        steps are handed to ``rollback`` newest first (undoing their
        host-side reservations in reverse dispatch order) and dropped."""
        if not discard:
            return self.commit_all()
        n = 0
        while self._q:
            step = self._q.pop()        # newest first
            if self._rollback is not None:
                self._rollback(step)
            n += 1
        return n

    def pending_for(self, task_id: int) -> int:
        return sum(1 for s in self._q if task_id in s.task_ids)


class _Transfer:
    __slots__ = ("handle", "owner", "pages", "done")

    def __init__(self, handle: int, owner: int, pages: Tuple[int, ...]):
        self.handle = handle
        self.owner = owner
        self.pages = pages
        self.done = threading.Event()


class TransferLedger:
    """In-flight page-transfer ledger (DESIGN.md §10 stage 3).

    Tracks every outstanding swap gather/scatter by owner and physical
    page. The discipline it encodes: while a transfer is outstanding, its
    pages are *busy* — ``assert_idle`` refuses frees / CoW forks / writes
    over them — and an owner's next lifecycle step (resume, release)
    waits for its transfer to land. Thread-safe: ``complete`` is called
    from the background transfer worker.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._live: Dict[int, _Transfer] = {}         # handle -> transfer
        self._by_owner: Dict[int, List[int]] = {}     # owner -> handles
        self._next_handle = 0
        self.started = 0
        self.completed = 0

    # ---- lifecycle ----
    def begin(self, owner: int, pages: Iterable[int]) -> int:
        """Register an outstanding transfer of ``pages`` for ``owner``;
        returns the handle ``complete`` takes."""
        with self._lock:
            h = self._next_handle
            self._next_handle += 1
            t = _Transfer(h, owner, tuple(pages))
            self._live[h] = t
            self._by_owner.setdefault(owner, []).append(h)
            self.started += 1
            return h

    def complete(self, handle: int) -> None:
        """Mark a transfer landed; its pages stop being busy. Completing
        an unknown handle is a caller bug (double completion would mean
        two codepaths think they own the same data movement)."""
        with self._lock:
            t = self._live.pop(handle, None)
            if t is None:
                raise ValueError(f"unknown transfer handle {handle}")
            hs = self._by_owner.get(t.owner)
            hs.remove(handle)
            if not hs:
                del self._by_owner[t.owner]
            self.completed += 1
        t.done.set()

    # ---- queries ----
    def outstanding(self, owner: Optional[int] = None) -> int:
        with self._lock:
            if owner is None:
                return len(self._live)
            return len(self._by_owner.get(owner, ()))

    def busy_pages(self) -> FrozenSet[int]:
        with self._lock:
            pages = set()
            for t in self._live.values():
                pages.update(t.pages)
            return frozenset(pages)

    def busy(self, page: int) -> bool:
        return page in self.busy_pages()

    def handles(self, owner: Optional[int] = None) -> List[int]:
        with self._lock:
            if owner is None:
                return sorted(self._live)
            return list(self._by_owner.get(owner, ()))

    # ---- discipline ----
    def assert_idle(self, pages: Iterable[int], what: str = "touch") -> None:
        """Raise if any of ``pages`` has an outstanding transfer: the
        caller was about to free / fork / write a page mid-flight."""
        clash = set(pages) & self.busy_pages()
        if clash:
            raise RuntimeError(
                f"cannot {what} pages {sorted(clash)}: transfer outstanding")

    def wait(self, owner: Optional[int] = None,
             timeout: Optional[float] = 30.0) -> None:
        """Block until the owner's (or all) outstanding transfers land.
        Only meaningful when a background worker completes them; the
        synchronous model in tests completes handles explicitly instead."""
        with self._lock:
            if owner is None:
                events = [t.done for t in self._live.values()]
            else:
                events = [self._live[h].done
                          for h in self._by_owner.get(owner, ())]
        for ev in events:
            if not ev.wait(timeout):
                raise TimeoutError("transfer did not land")

    def check(self) -> None:
        """Invariant audit: the owner index and the live map agree, and
        lifetime counters reconcile with what is still in flight."""
        with self._lock:
            by_owner_handles = sorted(
                h for hs in self._by_owner.values() for h in hs)
            assert by_owner_handles == sorted(self._live), (
                by_owner_handles, sorted(self._live))
            for owner, hs in self._by_owner.items():
                assert hs, f"owner {owner} indexed with no transfers"
                for h in hs:
                    assert self._live[h].owner == owner, (h, owner)
            assert self.started - self.completed == len(self._live), (
                self.started, self.completed, len(self._live))
