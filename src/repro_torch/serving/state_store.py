"""Architecture-generic cache store (DESIGN.md §12).

The serving stack manages two first-class cache *kinds*:

- ``"kv"``    — growable paged key/value cache (``KVPagePool``): per-token
  state, O(T) pages per task, copy-on-write sharing, partial swap.
- ``"state"`` — constant-size SSD recurrent state (``SSMStateStore``): one
  fixed-size slot per task holding the per-layer ``[H, P, N]`` SSM state
  plus the ``[C, K-1]`` causal-conv tail. O(1) per task regardless of
  sequence length, so suspend/resume and host swap compose trivially —
  the whole state is a single fixed-size "page".

``CacheStore`` is the facade the executor and benchmarks audit through:
it derives the kind set from the architecture (dense/MoE -> kv; pure
SSM -> state; hybrid -> both), forwards leak checks to every member
store, and prices a task's resident bytes across kinds under one roof
(the ``StateBudget`` admission extension in ``core/selection.py`` reads
these numbers).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Set

from repro_torch.serving.kv_pool import KVPagePool, OutOfPages


class OutOfStates(OutOfPages):
    """No free state slot. Raised with the store unchanged — callers may
    suspend a victim and retry. Subclasses ``OutOfPages`` so every
    defer-on-pressure handler in the serving loop covers both cache kinds
    without knowing which one ran dry."""


class SSMStateStore:
    """Fixed-slot allocator for constant-size recurrent state.

    Each owner holds at most ONE slot (the whole recurrent state is one
    fixed-size blob), or is *swapped* (state lives in the host arena, no
    device slot). The device arenas themselves (``[L, S, H, P, N]`` SSM
    state + ``[L, S, C, K-1]`` conv tails) live in the executor's pages
    dict; this class only does the slot bookkeeping, exactly as
    ``KVPagePool`` does page bookkeeping for the KV arenas.
    """

    def __init__(self, n_slots: int):
        if n_slots <= 0:
            raise ValueError(f"n_slots must be positive, got {n_slots}")
        self.n_slots = int(n_slots)
        # LIFO free stack: reuse hot slots first
        self._free: List[int] = list(range(self.n_slots - 1, -1, -1))
        self._slot: Dict[object, int] = {}
        self._swapped: Set[object] = set()

    # -- introspection --
    @property
    def used_slots(self) -> int:
        return len(self._slot)

    @property
    def free_slots(self) -> int:
        return len(self._free)

    def owners(self) -> Set[object]:
        return set(self._slot) | set(self._swapped)

    def holds(self, owner) -> bool:
        return owner in self._slot or owner in self._swapped

    def is_swapped(self, owner) -> bool:
        return owner in self._swapped

    def slot_of(self, owner) -> int:
        if owner not in self._slot:
            raise KeyError(f"owner {owner!r} holds no resident state slot")
        return self._slot[owner]

    def resident_slot_count(self, owner) -> int:
        """1 if the owner's state is device-resident, else 0 — the
        state-kind analogue of ``KVPagePool.resident_page_count``."""
        return 1 if owner in self._slot else 0

    # -- lifecycle --
    def alloc(self, owner) -> int:
        if self.holds(owner):
            raise RuntimeError(f"owner {owner!r} already holds state")
        if not self._free:
            raise OutOfStates(
                f"no free state slot ({self.n_slots} total)")
        slot = self._free.pop()
        self._slot[owner] = slot
        return slot

    def free(self, owner) -> None:
        """Idempotent release (resident or swapped)."""
        slot = self._slot.pop(owner, None)
        if slot is not None:
            self._free.append(slot)
        self._swapped.discard(owner)

    def swap_out(self, owner) -> int:
        """Release the owner's device slot to the free list; the owner
        becomes *swapped* (contents are the caller's to stash — snapshot
        BEFORE reusing the slot). Returns the released slot index."""
        if owner in self._swapped:
            raise RuntimeError(f"owner {owner!r} already swapped")
        slot = self.slot_of(owner)
        del self._slot[owner]
        self._free.append(slot)
        self._swapped.add(owner)
        return slot

    def swap_in(self, owner) -> int:
        """Re-allocate a device slot for a swapped owner. ``OutOfStates``
        propagates with the store unchanged (the owner stays swapped)."""
        if owner not in self._swapped:
            raise RuntimeError(f"owner {owner!r} is not swapped")
        if not self._free:
            raise OutOfStates(
                f"no free state slot ({self.n_slots} total)")
        slot = self._free.pop()
        self._swapped.discard(owner)
        self._slot[owner] = slot
        return slot

    def check(self) -> None:
        """Invariant audit: every slot is free or owned exactly once."""
        used = sorted(self._slot.values())
        assert len(set(used)) == len(used), f"slot double-owned: {used}"
        assert len(used) + len(self._free) == self.n_slots, (
            f"slot leak: {len(used)} used + {len(self._free)} free "
            f"!= {self.n_slots}")
        assert not (set(self._free) & set(used)), "slot both free and owned"
        assert all(0 <= s < self.n_slots for s in self._free + used)
        assert not (self._swapped & set(self._slot)), (
            "owner both resident and swapped")


# ------------------------------------------------------------------ sizing

def state_bytes_per_task(cfg) -> int:
    """Device bytes of one task's constant-size recurrent state: per layer
    an f32 ``[H, P, N]`` SSM state plus the f32 ``[C, K-1]`` conv tail
    (C = d_inner + 2N). Zero for attention-only architectures."""
    if not cfg.has_ssm:
        return 0
    ssm = cfg.ssm_heads * cfg.ssm_head_dim * cfg.ssm_state
    conv = (cfg.ssm_inner + 2 * cfg.ssm_state) * (cfg.ssm_conv - 1)
    return cfg.n_layers * 4 * (ssm + conv)


def kv_bytes_per_page(cfg, page_size: int) -> int:
    """Device bytes of one KV page across all layers (k + v, f32). Zero
    for attention-free architectures (their page table is a pure logical
    ledger, see DESIGN.md §12)."""
    if not cfg.has_attention:
        return 0
    return cfg.n_layers * 2 * cfg.n_kv_heads * page_size * cfg.head_dim * 4


def cache_kinds(cfg) -> tuple:
    """The cache kinds an architecture needs: attention layers grow paged
    KV, SSM layers carry one constant-size state slot; hybrids need both."""
    kinds = []
    if cfg.has_attention:
        kinds.append("kv")
    if cfg.has_ssm:
        kinds.append("state")
    return tuple(kinds)


class CacheStore:
    """Facade over the per-kind stores of one engine.

    ``pool`` is always present (the page table doubles as the logical
    token-length ledger for every architecture); ``states`` is present
    iff the architecture has SSM layers. One ``check()``/leak audit and
    one bytes-resident metric span both kinds.
    """

    def __init__(self, cfg, pool: KVPagePool,
                 states: Optional[SSMStateStore] = None):
        self.cfg = cfg
        self.kinds = cache_kinds(cfg)
        self.pool = pool
        self.states = states
        if ("state" in self.kinds) != (states is not None):
            raise ValueError(
                f"arch {cfg.name}: kinds {self.kinds} but "
                f"states={'set' if states is not None else 'None'}")
        self.page_bytes = kv_bytes_per_page(cfg, pool.page_size)
        self.state_bytes = state_bytes_per_task(cfg)

    def owners(self) -> Set[object]:
        out = set(self.pool.owners())
        if self.states is not None:
            out |= self.states.owners()
        return out

    def holds(self, owner) -> bool:
        held = self.pool.holds(owner)
        if self.states is not None:
            held = held or self.states.holds(owner)
        return held

    def resident_bytes(self, owner) -> int:
        """Device bytes the owner currently pins, across both kinds."""
        n = self.pool.resident_page_count(owner) * self.page_bytes
        if self.states is not None:
            n += self.states.resident_slot_count(owner) * self.state_bytes
        return n

    def total_bytes(self) -> int:
        """Device bytes of the whole store (both arenas, used + free)."""
        n = self.pool.n_pages * self.page_bytes
        if self.states is not None:
            n += self.states.n_slots * self.state_bytes
        return n

    def check(self) -> None:
        self.pool.check()
        if self.states is not None:
            self.states.check()

    def leaked(self) -> int:
        """Pages + slots still held — zero once every task is released."""
        n = self.pool.used_pages
        if self.states is not None:
            n += self.states.used_slots
        return n
