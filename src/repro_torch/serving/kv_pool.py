"""Paged KV-cache block pool (DESIGN.md §3 adaptation #2, §6).

The slot-based ``JaxExecutor`` reserves a contiguous ``max_seq`` KV buffer
per admitted task, so admission is bounded by worst-case memory:
``max_slots`` tasks regardless of how short their sequences actually are.
This pool instead carves the KV arena into fixed-size *pages* of
``page_size`` tokens each and hands them out on demand — a task holding
``n`` cached tokens occupies exactly ``ceil(n / page_size)`` pages. The
free list is the single source of truth for residency, which is what lets
SLICE's admission (core.selection.PageBudget) reason about *actual* memory
instead of a fixed slot count.

Pages are REFCOUNTED (DESIGN.md §6): two owners with a common page-aligned
prompt prefix can hold the same physical pages (``share``), and the radix
prefix cache (serving.prefix_cache) can pin pages beyond any owner's
lifetime (``retain_page``/``release_page``). A shared page is immutable
from any single owner's point of view; an owner that must write into one
first breaks the sharing with ``fork`` (copy-on-write — the caller copies
the device-side page contents, this class only swaps the bookkeeping).

Pages can also be SWAPPED to host memory (DESIGN.md §7): ``swap_out``
releases an owner's *private* device pages (the contents go to a
serving.kv_swap.KVSwapArena) while preserving the owner's logical length
and keeping its references on shared pages — a shared prefix page is
never swapped, because other owners (or the prefix cache's pins) still
need it resident and its contents were never copied to host. ``swap_in``
re-allocates fresh device pages for exactly the swapped-out positions so
the executor can restore the contents.

Pure bookkeeping — no jax. The executor owns the physical page arrays
(``k_pages``/``v_pages``: [L, n_pages, Hkv, page_size, hd]); this class
owns which page ids belong to which task. A slot array is the degenerate
pool with ``page_size == max_seq`` and one page per task, which is how the
kv_pressure benchmark compares the two layouts at equal bytes.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple


class OutOfPages(RuntimeError):
    """Raised when an alloc/extend/fork cannot be satisfied. State is
    unchanged — callers (scheduler admission) defer the task rather than
    drop it."""


class KVPagePool:
    def __init__(self, n_pages: int, page_size: int):
        if n_pages <= 0 or page_size <= 0:
            raise ValueError("n_pages and page_size must be positive")
        self.n_pages = n_pages
        self.page_size = page_size
        self._free: List[int] = list(range(n_pages))
        self._table: Dict[int, List[int]] = {}   # owner -> page ids, in order
        self._len: Dict[int, int] = {}           # owner -> cached tokens
        self._ref: Dict[int, int] = {}           # page -> total refcount
        self._pins: Dict[int, int] = {}          # page -> non-owner retains
        # swapped owners (DESIGN.md §7): page list with -1 at positions
        # whose contents live in the host arena; still-resident (shared)
        # positions keep their page id AND their refcount.
        self._swapped: Dict[int, List[int]] = {}
        self._swapped_len: Dict[int, int] = {}

    # ---- accounting ----
    def pages_for(self, n_tokens: int) -> int:
        """Pages needed to hold n_tokens (ceil)."""
        return -(-max(n_tokens, 0) // self.page_size)

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return self.n_pages - len(self._free)

    def owners(self) -> List[int]:
        return list(self._table)

    def page_table(self, owner: int) -> List[int]:
        return list(self._table[owner])

    def length(self, owner: int) -> int:
        if owner in self._swapped_len:
            return self._swapped_len[owner]
        return self._len[owner]

    def holds(self, owner: int) -> bool:
        return owner in self._table

    def is_swapped(self, owner: int) -> bool:
        return owner in self._swapped

    def swapped_owners(self) -> List[int]:
        return list(self._swapped)

    def resident_page_count(self, owner: int) -> int:
        """Device pages an owner holds RIGHT NOW: its full table when
        resident, only the still-shared pages while swapped out, zero for
        unknown owners — the held-pages view admission charges."""
        if owner in self._table:
            return len(self._table[owner])
        if owner in self._swapped:
            return sum(1 for p in self._swapped[owner] if p >= 0)
        return 0

    def ref_count(self, page: int) -> int:
        """Total references (owner table entries + external pins)."""
        return self._ref.get(page, 0)

    def owner_refs(self, page: int) -> int:
        """References held by owners (table entries), excluding pins."""
        return self._ref.get(page, 0) - self._pins.get(page, 0)

    def is_shared(self, owner: int, logical_idx: int) -> bool:
        """True when owner's logical page has other references — writing it
        requires a fork() first (copy-on-write)."""
        return self._ref[self._table[owner][logical_idx]] > 1

    # ---- alloc / extend / free ----
    def alloc(self, owner: int, n_tokens: int) -> List[int]:
        """Reserve pages for a new owner's first n_tokens. Returns page ids."""
        if owner in self._table or owner in self._swapped:
            raise ValueError(f"owner {owner} already holds pages")
        need = self.pages_for(n_tokens)
        if need > len(self._free):
            raise OutOfPages(
                f"need {need} pages for {n_tokens} tokens, "
                f"{len(self._free)}/{self.n_pages} free")
        pages = [self._free.pop(0) for _ in range(need)]
        for p in pages:
            self._ref[p] = 1
        self._table[owner] = pages
        self._len[owner] = n_tokens
        return list(pages)

    def extend(self, owner: int, new_len: int) -> List[int]:
        """Grow an owner's allocation to cover new_len tokens. Returns the
        newly allocated page ids (possibly empty). Shrinking is a no-op:
        pages are only returned wholesale by free(). On OutOfPages the pool
        (free list, refcounts, tables) is left exactly as it was."""
        if owner in self._swapped:
            raise ValueError(f"owner {owner} is swapped out; swap_in first")
        if owner not in self._table:
            raise ValueError(f"owner {owner} holds no pages")
        if new_len <= self._len[owner]:
            return []
        grow = self.pages_for(new_len) - len(self._table[owner])
        if grow > len(self._free):
            raise OutOfPages(
                f"extend to {new_len} tokens needs {grow} more pages, "
                f"{len(self._free)}/{self.n_pages} free")
        fresh = [self._free.pop(0) for _ in range(max(grow, 0))]
        for p in fresh:
            self._ref[p] = 1
        self._table[owner].extend(fresh)
        self._len[owner] = new_len
        return fresh

    def truncate(self, owner: int, new_len: int) -> int:
        """Roll back a resident owner's allocation to ``new_len`` tokens —
        the speculative-decode rejection path (DESIGN.md §8): pages wholly
        beyond ``ceil(new_len / page_size)`` drop this owner's reference
        (returning to the free list when nothing else references them) and
        the logical length shrinks. Rejected-draft KV still sitting inside
        the kept boundary page is invisible to attention (positions beyond
        the length are causally masked) and is overwritten in place as the
        stream grows back through it. Growing is an error — use extend().
        Returns the number of pages actually freed."""
        if owner in self._swapped:
            raise ValueError(f"owner {owner} is swapped out; swap_in first")
        if owner not in self._table:
            raise ValueError(f"owner {owner} holds no pages")
        if new_len > self._len[owner]:
            raise ValueError(
                f"truncate cannot grow: {new_len} > {self._len[owner]}")
        keep = self.pages_for(new_len)
        pages = self._table[owner]
        freed = 0
        for p in pages[keep:]:
            freed += self._unref(p)
        self._table[owner] = pages[:keep]
        self._len[owner] = new_len
        return freed

    def free(self, owner: int) -> int:
        """Drop all of owner's references; pages whose refcount hits zero
        return to the pool. Returns #pages actually freed. Unknown owners
        are a no-op (idempotent release)."""
        pages = self._table.pop(owner, None)
        self._len.pop(owner, None)
        if pages is None:
            # a swapped owner still references its shared resident pages;
            # freeing it drops those (the host-side contents are the
            # arena's to reclaim — serving.kv_swap)
            pages = [p for p in self._swapped.pop(owner, []) if p >= 0]
            self._swapped_len.pop(owner, None)
            if not pages:
                return 0
        freed = 0
        for p in pages:
            freed += self._unref(p)
        return freed

    # ---- sharing (DESIGN.md §6) ----
    def share(self, owner: int, pages: Sequence[int], n_tokens: int) -> None:
        """Register a new owner over EXISTING pages (a cached prompt prefix):
        the owner's table starts as ``pages`` covering ``n_tokens`` cached
        tokens, and every page's refcount is incremented. ``n_tokens`` must
        exactly fill the pages (page-aligned prefix, DESIGN.md deviation #5)
        so a later extend() never writes into a shared page mid-stream."""
        if owner in self._table or owner in self._swapped:
            raise ValueError(f"owner {owner} already holds pages")
        if n_tokens != len(pages) * self.page_size:
            raise ValueError(
                f"shared prefix must be page-aligned: {n_tokens} tokens "
                f"!= {len(pages)} pages x {self.page_size}")
        for p in pages:
            if self._ref.get(p, 0) <= 0:
                raise ValueError(f"page {p} is not allocated")
        for p in pages:
            self._ref[p] += 1
        self._table[owner] = list(pages)
        self._len[owner] = n_tokens

    def fork(self, owner: int, logical_idx: int) -> Optional[Tuple[int, int]]:
        """Copy-on-write: give owner a private copy of its logical page.

        Returns (old_phys, new_phys) — the caller must copy the device-side
        page contents old -> new before writing — or None when the page was
        already private (refcount 1, nothing to do). Raises OutOfPages
        (state unchanged) when no free page is available for the copy."""
        if owner in self._swapped:
            raise ValueError(f"owner {owner} is swapped out; swap_in first")
        page = self._table[owner][logical_idx]
        if self._ref[page] <= 1:
            return None
        if not self._free:
            raise OutOfPages(
                f"fork of page {page} needs 1 free page, 0/{self.n_pages} free")
        new = self._free.pop(0)
        self._ref[page] -= 1
        self._ref[new] = 1
        self._table[owner][logical_idx] = new
        return page, new

    # ---- host-offload swap (DESIGN.md §7) ----
    def swap_out(self, owner: int) -> List[Tuple[int, int]]:
        """Release an owner's PRIVATE pages (refcount 1: no other owner, no
        index pin) back to the free list, preserving the owner's logical
        length. Returns [(logical_idx, phys_page)] of the released pages —
        the caller must copy their device contents to host IMMEDIATELY
        (before any other pool operation can re-allocate them). Shared
        pages stay resident with this owner's reference intact: their
        contents were never copied, so they must survive until swap_in.

        A fully-shared owner swaps out zero pages — suspension is then
        pure bookkeeping with nothing to transfer."""
        if owner in self._swapped:
            raise ValueError(f"owner {owner} already swapped out")
        if owner not in self._table:
            raise ValueError(f"owner {owner} holds no pages")
        pages = self._table.pop(owner)
        released: List[Tuple[int, int]] = []
        for idx, p in enumerate(pages):
            if self._ref[p] == 1:
                self._unref(p)
                released.append((idx, p))
                pages[idx] = -1
        self._swapped[owner] = pages
        self._swapped_len[owner] = self._len.pop(owner)
        return released

    def swap_in(self, owner: int) -> List[Tuple[int, int]]:
        """Re-allocate device pages for every swapped-out position and make
        the owner resident again. Returns [(logical_idx, phys_page)] of the
        fresh pages — the caller must restore the host-side contents into
        them (same positions swap_out reported). Raises OutOfPages with the
        pool unchanged when not enough pages are free."""
        if owner not in self._swapped:
            raise ValueError(f"owner {owner} is not swapped out")
        pages = self._swapped[owner]
        need = sum(1 for p in pages if p < 0)
        if need > len(self._free):
            raise OutOfPages(
                f"swap_in of owner {owner} needs {need} pages, "
                f"{len(self._free)}/{self.n_pages} free")
        restored: List[Tuple[int, int]] = []
        for idx, p in enumerate(pages):
            if p < 0:
                fresh = self._free.pop(0)
                self._ref[fresh] = 1
                pages[idx] = fresh
                restored.append((idx, fresh))
        self._table[owner] = self._swapped.pop(owner)
        self._len[owner] = self._swapped_len.pop(owner)
        return restored

    def retain_page(self, page: int) -> None:
        """External (non-owner) pin — the prefix cache retaining a page
        beyond its inserting owner's lifetime."""
        if self._ref.get(page, 0) <= 0:
            raise ValueError(f"page {page} is not allocated")
        self._ref[page] += 1
        self._pins[page] = self._pins.get(page, 0) + 1

    def release_page(self, page: int) -> bool:
        """Drop one external pin. Returns True when the page went back to
        the free list (no owners or other pins left)."""
        pins = self._pins.get(page, 0)
        if pins <= 0:
            raise ValueError(f"page {page} has no external pins")
        if pins == 1:
            self._pins.pop(page)
        else:
            self._pins[page] = pins - 1
        return self._unref(page) == 1

    def _unref(self, page: int) -> int:
        self._ref[page] -= 1
        if self._ref[page] == 0:
            del self._ref[page]
            self._free.append(page)
            return 1
        return 0

    def check(self) -> None:
        """Invariant audit: every page is either free (no references) or
        allocated with refcount == owner table occurrences + external pins;
        free list and allocated set partition the arena."""
        occurrences: Dict[int, int] = {}
        for pages in self._table.values():
            for p in pages:
                occurrences[p] = occurrences.get(p, 0) + 1
        for pages in self._swapped.values():
            for p in pages:
                if p >= 0:          # still-resident shared pages keep a ref
                    occurrences[p] = occurrences.get(p, 0) + 1
        allocated = set(self._ref)
        assert allocated.isdisjoint(self._free), "page both free and allocated"
        assert len(allocated) + len(self._free) == self.n_pages, (
            len(allocated), len(self._free), self.n_pages)
        assert len(set(self._free)) == len(self._free), "page freed twice"
        for p, r in self._ref.items():
            assert r == occurrences.get(p, 0) + self._pins.get(p, 0), (
                p, r, occurrences.get(p, 0), self._pins.get(p, 0))
            assert r > 0, (p, r)
        for p in self._pins:
            assert p in allocated, f"pinned page {p} not allocated"
        for o, pages in self._table.items():
            assert len(pages) == self.pages_for(self._len[o]), (o, pages)
        assert set(self._swapped) == set(self._swapped_len), (
            set(self._swapped), set(self._swapped_len))
        assert set(self._swapped).isdisjoint(self._table), (
            "owner both resident and swapped")
        for o, pages in self._swapped.items():
            assert len(pages) == self.pages_for(self._swapped_len[o]), (o, pages)
