"""Host-offload KV swap arena (DESIGN.md §7).

On a memory-starved edge device the page pool is the binding admission
constraint, and SLICE's only levers so far were *defer* (TTFT blows up)
or *drop* (SLO = 0). Host memory is a third tier: a suspended task's
private KV pages move to host RAM over the PCIe-class link — a transfer
priced at ``LatencyModel.swap_ms`` — freeing device pages for a
real-time arrival *immediately*, and move back when the task is resumed.
This is the same memory-tier lever FastServe's proactive swapping and
SLOs-Serve's preemption use; see PAPERS.md.

This class is the host half of the tier: it stores the *contents* of
swapped-out pages, keyed by (owner, logical page index). Which pages a
given owner may swap — only private ones; shared prefix pages stay
resident — is the pool's decision (``KVPagePool.swap_out``); which tasks
get suspended is the scheduler's (``core.selection.select_swap_victims``).
The executor glues the three: it gathers the released pages' device
contents into ``put`` on suspend and scatters ``take`` back into freshly
allocated pages on resume, so a resumed task's logits are bit-for-bit
the never-suspended ones (benchmarks/kv_swap.py asserts < 1e-5).

Pure host-side bookkeeping + numpy storage — no jax. An optional
``capacity_bytes`` models the edge device's limited host RAM: ``put``
beyond it raises ``HostArenaFull`` with the arena unchanged, and the
caller (executor) surfaces that as a failed suspension.

Async pipelining (DESIGN.md §10): under ``async_dispatch`` the executor
puts *lazy* page blobs — functional jax snapshots whose device->host copy
runs later on a background transfer worker, tracked by a TransferLedger.
That works unchanged here because the capacity check only needs
``.nbytes`` (shape-derived, available before the copy lands) and the
worker materializes each blob IN PLACE (``blob["k"] = np.asarray(...)``),
so ``check()``'s byte audit holds before, during, and after the
transfer. ``take``/``drop`` callers must wait out the owner's ledger
entry first — the executor's resume/release do.

Cache kinds (DESIGN.md §12): the arena is kind-agnostic — an entry is
(logical index, blob dict) and blobs may carry any keys. SSM/hybrid
archs stash the task's constant-size recurrent state as a ``{"ssm",
"conv"}`` blob at sentinel logical index ``-1``, PREPENDED to the KV
page entries so ``check()``'s ascending-unique-index audit covers it,
and the whole suspension stays one atomic ``put`` (capacity is priced
across both kinds; ``HostArenaFull`` rolls back state and pages
together in the executor).

Tensor parallelism (DESIGN.md §9): each rank of a tensor-parallel engine
swaps its own slab of every page (1/``byte_scale`` of the page's KV
heads) into its own arena. The arena counts each blob at ``byte_scale``
times its size, the whole page's bytes, so its accounting and every
capacity decision are the single-device engine's on every rank.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

PageBlob = Dict[str, "object"]          # e.g. {"k": np.ndarray, "v": np.ndarray}
Entry = Tuple[int, PageBlob]            # (logical page index, contents)


class HostArenaFull(RuntimeError):
    """Raised when a put() would exceed capacity_bytes. State is unchanged —
    the caller keeps the task resident instead of suspending it."""


def _blob_bytes(blob: PageBlob) -> int:
    total = 0
    for arr in blob.values():
        total += int(getattr(arr, "nbytes", 0))
    return total


class KVSwapArena:
    def __init__(self, page_size: int, capacity_bytes: Optional[int] = None,
                 byte_scale: int = 1):
        if page_size <= 0:
            raise ValueError("page_size must be positive")
        if capacity_bytes is not None and capacity_bytes < 0:
            raise ValueError("capacity_bytes must be non-negative")
        self.page_size = page_size
        self.capacity_bytes = capacity_bytes
        self.byte_scale = byte_scale
        self._entries: Dict[int, List[Entry]] = {}   # owner -> saved pages
        self._bytes: Dict[int, int] = {}             # owner -> bytes held
        # lifetime counters (surfaced through LoopResult / benchmark JSON)
        self.swap_outs = 0
        self.swap_ins = 0
        self.bytes_out = 0
        self.bytes_in = 0
        self.peak_bytes = 0

    # ---- accounting ----
    @property
    def bytes_held(self) -> int:
        return sum(self._bytes.values())

    @property
    def owners_held(self) -> int:
        return len(self._entries)

    def holds(self, owner: int) -> bool:
        return owner in self._entries

    def pages_held(self, owner: int) -> int:
        return len(self._entries.get(owner, ()))

    # ---- data plane ----
    def put(self, owner: int, entries: List[Entry]) -> int:
        """Stash an owner's swapped-out page contents (one Entry per page
        the pool released, logical indices ascending). Returns bytes
        stored. An owner may hold at most one stash — suspending an
        already-suspended task is a caller bug."""
        if owner in self._entries:
            raise ValueError(f"owner {owner} already has swapped pages")
        size = self.byte_scale * sum(_blob_bytes(blob) for _, blob in entries)
        if (self.capacity_bytes is not None
                and self.bytes_held + size > self.capacity_bytes):
            raise HostArenaFull(
                f"stash of {size} B for owner {owner} exceeds host arena "
                f"capacity ({self.bytes_held}/{self.capacity_bytes} B used)")
        self._entries[owner] = list(entries)
        self._bytes[owner] = size
        self.swap_outs += 1
        self.bytes_out += size
        self.peak_bytes = max(self.peak_bytes, self.bytes_held)
        return size

    def take(self, owner: int) -> List[Entry]:
        """Remove and return an owner's stash (resume path). The arena
        gives the pages back exactly once — restoring them twice would
        mean two live copies of one logical page."""
        if owner not in self._entries:
            raise ValueError(f"owner {owner} has no swapped pages")
        entries = self._entries.pop(owner)
        self.bytes_in += self._bytes.pop(owner)
        self.swap_ins += 1
        return entries

    def drop(self, owner: int) -> int:
        """Discard an owner's stash without restoring it (the task finished
        while suspended, was dropped, or released). Idempotent; returns
        pages discarded."""
        entries = self._entries.pop(owner, None)
        self._bytes.pop(owner, None)
        return 0 if entries is None else len(entries)

    def check(self) -> None:
        """Invariant audit: per-owner byte tallies match the stored blobs
        and the two maps cover the same owners."""
        assert set(self._entries) == set(self._bytes), (
            set(self._entries), set(self._bytes))
        for owner, entries in self._entries.items():
            got = self.byte_scale * sum(_blob_bytes(blob)
                                        for _, blob in entries)
            assert got == self._bytes[owner], (owner, got, self._bytes[owner])
            idxs = [i for i, _ in entries]
            assert idxs == sorted(set(idxs)), f"owner {owner}: bad indices {idxs}"
