"""Prefix-sharing radix cache over the paged KV arena (DESIGN.md §6).

Edge agents (navigation, control, dialogue) overwhelmingly share
system-prompt / task-template prefixes. Their KV is identical token for
token, so keeping one physical copy and letting every request reference it
is the cheapest way to raise the number of admissible residents — and
thus SLO attainment — under SLICE's memory-bounded admission.

This class is the index half of that: a radix tree (trie) over
page-aligned prompt-token blocks. Each edge is one ``page_size``-token
block and carries the physical page holding that block's KV. Matching
walks whole blocks only (deviation #5: page-aligned matching — a partial
page is never shared, so copy-on-write is a boundary defense rather than
a hot path). The pool half lives in kv_pool.KVPagePool: the cache PINS
every indexed page (``retain_page``) so it survives its inserting owner's
release, and ``acquire`` registers a new owner over the matched pages
(``share``) without copying a byte.

Pure bookkeeping — no jax; the executor owns the device arrays and the
logits-equivalence contract (tests/test_prefix_cache.py): a cache-hit
prefill must reproduce the cold path's logits to < 1e-5, which holds
because the pinned pages contain exactly the KV the cold path would
recompute.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.serving.kv_pool import KVPagePool

Block = Tuple[int, ...]


class _Node:
    __slots__ = ("children", "page", "tick", "parent", "block")

    def __init__(self, page: int, parent: Optional["_Node"], block: Block):
        self.children: Dict[Block, _Node] = {}
        self.page = page
        self.tick = 0
        self.parent = parent
        self.block = block


class RadixPrefixCache:
    """Maps page-aligned prompt prefixes to pinned physical pages.

    max_pages bounds the index's own footprint; inserts beyond it evict
    least-recently-used leaves first (leaf-first keeps every indexed
    prefix reachable: evicting an interior node would orphan its longer
    extensions). Evicting a node drops the cache's pin — the page returns
    to the free list once no running owner still references it.
    """

    def __init__(self, pool: KVPagePool, max_pages: Optional[int] = None):
        self.pool = pool
        self.page_size = pool.page_size
        self.max_pages = max_pages
        self._root = _Node(page=-1, parent=None, block=())
        self._n_nodes = 0
        self._tick = 0
        self.hits = 0
        self.misses = 0
        self.hit_tokens = 0

    # ---- internals ----
    def _blocks(self, tokens: Sequence[int]) -> List[Block]:
        psz = self.page_size
        n_full = len(tokens) // psz
        return [tuple(int(t) for t in tokens[i * psz:(i + 1) * psz])
                for i in range(n_full)]

    def _walk(self, tokens: Sequence[int]) -> List[_Node]:
        node, path = self._root, []
        for blk in self._blocks(tokens):
            node = node.children.get(blk)
            if node is None:
                break
            path.append(node)
        return path

    # ---- index ops ----
    @property
    def pages_indexed(self) -> int:
        return self._n_nodes

    def match(self, tokens: Sequence[int],
              touch: bool = True) -> Tuple[int, List[int]]:
        """Longest page-aligned cached prefix of ``tokens``:
        (n_tokens_matched, physical pages in prefix order). Touches the
        matched path's LRU clocks unless ``touch=False`` — pure-query
        callers (admission hints, scheduler feasibility pruning) must not
        let polling masquerade as use, or eviction would keep perpetually
        polled idle prefixes over actively shared ones."""
        path = self._walk(tokens)
        if touch:
            self._tick += 1
            for n in path:
                n.tick = self._tick
        return len(path) * self.page_size, [n.page for n in path]

    def acquire(self, owner: int, tokens: Sequence[int],
                max_tokens: Optional[int] = None) -> Tuple[int, List[int]]:
        """Match, then register ``owner`` over the matched pages
        (pool.share — refcounts up, zero copies). ``max_tokens`` caps the
        usable prefix (the executor passes L-1 so at least one suffix token
        is always recomputed — its logits seed the first output token).
        Returns (n_tokens shared, pages). A zero-length match registers
        nothing: the caller allocates from scratch."""
        matched, pages = self.match(tokens)
        if max_tokens is not None:
            cap = (max_tokens // self.page_size) * self.page_size
            if matched > cap:
                matched, pages = cap, pages[:cap // self.page_size]
        if matched <= 0:
            self.misses += 1
            return 0, []
        self.pool.share(owner, pages, matched)
        self.hits += 1
        self.hit_tokens += matched
        return matched, pages

    def insert(self, tokens: Sequence[int], pages: Sequence[int]) -> int:
        """Index the page-aligned prefix of a completed prefill: ``pages``
        are the owner's pages holding ``tokens`` (only the first
        ``len(tokens) // page_size`` are used). Already-indexed blocks keep
        their existing page (first writer wins — the duplicate stays
        private to its owner and dies with it). Returns #pages newly
        pinned. Evicts LRU leaves when max_pages would be exceeded."""
        blocks = self._blocks(tokens)
        node, added = self._root, 0
        for blk, page in zip(blocks, pages):
            child = node.children.get(blk)
            if child is None:
                if self.max_pages is not None:
                    while (self._n_nodes >= self.max_pages
                           and self.evict(1, protect=node) > 0):
                        pass
                    if self._n_nodes >= self.max_pages:
                        break
                child = _Node(page=page, parent=node, block=blk)
                self.pool.retain_page(page)
                node.children[blk] = child
                self._n_nodes += 1
                added += 1
            child.tick = self._tick
            node = child
        self._tick += 1
        return added

    def evict(self, n_pages: int, protect: Optional[_Node] = None) -> int:
        """Unpin up to n_pages least-recently-used LEAF nodes (ancestors of
        ``protect`` are spared — insert() must not evict its own partially
        built path). Returns #nodes evicted; the pages return to the free
        list only once no owner still shares them."""
        spared = set()
        node = protect
        while node is not None:
            spared.add(id(node))
            node = node.parent
        evicted = 0
        while evicted < n_pages:
            # one DFS collects ALL current leaves; evicting in tick order
            # may expose parents as new leaves, hence the outer loop —
            # each pass frees up to len(leaves) pages, so bulk eviction is
            # near-linear instead of one full scan per page
            leaves = []
            stack = [self._root]
            while stack:
                n = stack.pop()
                if n.children:
                    stack.extend(n.children.values())
                elif n is not self._root and id(n) not in spared:
                    leaves.append(n)
            if not leaves:
                break
            leaves.sort(key=lambda n: n.tick)
            for leaf in leaves:
                if evicted >= n_pages:
                    break
                self.pool.release_page(leaf.page)
                del leaf.parent.children[leaf.block]
                self._n_nodes -= 1
                evicted += 1
        return evicted

    def reclaimable_pages(self) -> int:
        """Pages pinned ONLY by the index (no running owner): evicting them
        would return them to the free list right now. This is the slack
        PageBudget adds to the pool's free count — cached-but-idle prefix
        KV is reclaimable headroom, not spent memory."""
        count = 0
        stack = list(self._root.children.values())
        while stack:
            n = stack.pop()
            if self.pool.owner_refs(n.page) == 0:
                count += 1
            stack.extend(n.children.values())
        return count

    def clear(self) -> int:
        """Unpin everything in one linear pass (order is irrelevant when
        the whole index goes — no reachability to preserve)."""
        cleared = 0
        stack = list(self._root.children.values())
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            self.pool.release_page(n.page)
            cleared += 1
        self._root.children.clear()
        self._n_nodes = 0
        return cleared
