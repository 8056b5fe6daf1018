"""Speculative decoding (DESIGN.md §8), PyTorch port: the draft proposer,
greedy acceptance and depth bucketing behind
``PagedTorchExecutor``'s draft-verify iteration.

A cheap ``DraftModel`` proposes up to ``depth`` tokens autoregressively;
the target verifies the whole window in ONE step
(``model.verify_step_paged``, the paged-verify kernel on the card); the
leading run of drafts whose greedy argmax matches is committed with one
bonus token, and pages holding rejected-draft K/V are rolled back
(``KVPagePool.truncate``). Acceptance is the greedy chain rule, so the
committed stream is identical to non-speculative greedy decode.

``greedy_accept``, ``depth_bucket``, ``default_draft_config`` and
``draft_config_from_registry`` are copies of ``repro.serving.spec_decode``
with imports pointed at the port. ``DraftModel`` runs on the port's slot
cache (``step_graphs.slot_cache``) through the staged slot steps: the
masked decode over the slot array in place, where the JAX model gathers
the drafting rows into a compiled batch bucket and scatters them back
(the drafting rows compute the same tokens either way), and one catch-up
chunk step per power-of-two piece, as JAX's ``_chunk_jit[c]``; on the
card both are CUDA graphs. Where every slot is held, the draft reclaims
the slot of the task drafted least recently outside the current
``propose`` call; the JAX draft raises there (ROADMAP.md Queue C).
"""
from __future__ import annotations

import dataclasses
from typing import Collection, Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.models import model as M
from repro_torch.serving.step_graphs import (StepGraphs, chunk_step,
                                             masked_step, slot_cache)


def greedy_accept(drafts: Sequence[int], target_ids: Sequence[int]) -> int:
    """Greedy-equivalence acceptance: ``target_ids[i]`` is the target's
    argmax AFTER consuming window token i (the last committed token, then
    the drafts); draft i is accepted iff it equals ``target_ids[i]`` and
    every earlier draft was accepted. Returns the accepted count — the
    caller then commits that many drafts plus ``target_ids[n_acc]`` as the
    bonus token, which is exactly the token non-speculative greedy decode
    would have produced."""
    n = 0
    for d, t in zip(drafts, target_ids):
        if int(d) != int(t):
            break
        n += 1
    return n


def depth_bucket(depth: int, max_depth: int) -> int:
    """Smallest power-of-two >= depth, capped at max_depth — the verify-
    window sizes, mirroring the pow-2 decode batch buckets."""
    b = 1
    while b < depth:
        b *= 2
    return min(b, max_depth)


def pow2_pieces(n: int) -> List[int]:
    """The binary decomposition of n, largest power of two first: the
    piece sizes of a catch-up or a cache-hit suffix prefill."""
    return [1 << i for i in range(n.bit_length() - 1, -1, -1) if n >> i & 1]


def default_draft_config(cfg, n_layers: int = 1):
    """The zero-configuration draft: the target architecture cut to
    ``n_layers`` layers (same vocab by construction, so draft proposals
    are valid target token ids). Quality only affects the acceptance rate
    — never correctness — so a crude draft is a safe default."""
    return dataclasses.replace(cfg, name=cfg.name + "-draft",
                               n_layers=max(1, n_layers))


def draft_config_from_registry(name: str, target_cfg):
    """A draft from the tiny-config registry (reduced), reshaped onto the
    target's vocab so its proposals are valid target token ids."""
    from repro_torch.configs import get_config
    cfg = get_config(name).reduced()
    if not cfg.has_attention or cfg.has_ssm:
        raise ValueError(f"draft arch {name} must be pure-attention "
                         "(the draft cache is the slot KV layout)")
    return dataclasses.replace(cfg, name=cfg.name + "-draft",
                               vocab_size=target_cfg.vocab_size)


class DraftModel:
    """Autoregressive greedy proposer over a slot KV cache.

    The draft keeps its own K/V for each task's committed prefix
    (``valid_len``). ``propose`` first catches a task up — feeding the
    committed tokens the draft has not cached through the chunk step in
    power-of-two pieces (empty after an all-accepted window, whose K/V the
    draft wrote itself) — then drafts ``max(depths)`` tokens for the whole
    batch in lockstep, a masked decode step over the slot array per
    token, whose fused argmax is read once a token. Draft state is
    disposable: ``drop`` forgets a task (suspend/release, or a reclaimed
    slot) and the next propose re-prefills its committed prefix.
    """

    def __init__(self, cfg, params=None, max_slots: int = 16,
                 max_seq: int = 512, seed: int = 0, dtype=torch.float32,
                 device="cuda", cuda_graphs: bool = True):
        if not cfg.has_attention or cfg.has_ssm:
            raise ValueError("DraftModel needs a pure-attention arch "
                             "(slot KV cache + chunked catch-up)")
        self.device = M.resolve_device(device)
        self.cfg = cfg
        self.params = params if params is not None else M.init_params(
            cfg, seed=seed + 101, dtype=dtype, device=self.device)
        self.max_slots = max_slots
        self.max_seq = max_seq
        self.cache = slot_cache(cfg, max_slots, max_seq,
                                self.params["embed"].dtype, self.device)
        self.slot_of: Dict[int, int] = {}
        self.free: List[int] = list(range(max_slots))
        self.valid_len: Dict[int, int] = {}   # tid -> committed tokens cached
        self.drafted_tokens = 0
        self.reclaimed_slots = 0              # slots taken from idle tasks
        self._proposals = 0                   # propose calls so far
        self._drafted_at: Dict[int, int] = {}  # tid -> its last propose call
        # the masked decode step and the catch-up chunk steps
        self.graphs = StepGraphs(self.device, cuda_graphs)

    def make_steps(self) -> None:
        """Make (on the card: capture) every step ``propose`` can run: the
        masked decode step and a chunk step per power of two below
        max_seq. Idempotent; the engine calls it before its clock."""
        masked_step(self)
        c = 1
        while c < self.max_seq:
            chunk_step(self, c)
            c *= 2

    # -- slots --
    def _assign_slot(self, tid: int, protect: Collection[int]) -> int:
        """The task's slot, assigning a free one. With every slot held,
        the slot of the task drafted least recently among those not in
        ``protect`` (the current call's tasks) is reclaimed through
        ``drop``: its next propose re-prefills it."""
        if tid in self.slot_of:
            return self.slot_of[tid]
        if not self.free:
            idle = [t for t in self.slot_of if t not in protect]
            if not idle:
                raise RuntimeError("draft model out of KV slots")
            self.drop(min(idle, key=lambda t: self._drafted_at.get(t, -1)))
            self.reclaimed_slots += 1
        s = self.free.pop(0)
        self.slot_of[tid] = s
        return s

    def drop(self, tid: int) -> None:
        """Forget a task's draft state (suspend/release path): the slot is
        recycled and the next propose re-prefills from the committed
        prefix. Idempotent."""
        self.valid_len.pop(tid, None)
        self._drafted_at.pop(tid, None)
        s = self.slot_of.pop(tid, None)
        if s is not None:
            self.free.append(s)
            self.cache["length"][s] = 0
            self.cache["kv_pos"][s] = -1

    def note_commit(self, tid: int, committed_len: int) -> None:
        """Mark the draft's cache valid through ``committed_len`` tokens —
        called after verification: the accepted window's draft K/V was
        computed from committed tokens, the rejected tail was not (the
        next catch-up rewrites it)."""
        if tid in self.slot_of:
            self.valid_len[tid] = committed_len

    # -- drafting --
    def _catch_up(self, tid: int, committed: np.ndarray,
                  protect: Collection[int]) -> None:
        s = self._assign_slot(tid, protect)
        L = int(committed.shape[0])
        have = min(self.valid_len.get(tid, 0), L)
        # reset the row to the committed prefix: a stale draft tail beyond
        # it is abandoned (its kv_pos entries lie past the new length, so
        # attention masks them until they are overwritten); the first
        # piece's staged length does it, or, with nothing to feed, a write
        pieces = pow2_pieces(L - have)
        if not pieces:
            self.cache["length"][s] = have
        done = have
        for c in pieces:
            chunk_step(self, c).run({
                "idx": np.asarray([s]), "length": np.asarray([done]),
                "tokens": committed[None, done:done + c]})
            done += c
        self.valid_len[tid] = L

    def propose(self, items: Sequence[Tuple[int, np.ndarray, int]],
                depths: Sequence[int]) -> List[List[int]]:
        """items: (task_id, committed token ids [L], last committed token);
        depths: draft tokens wanted per item (>= 1). Returns the greedy
        draft continuations, ``depths[i]`` tokens each. All items step in
        lockstep to max(depths): a shallower item's extra steps write
        deeper draft K/V that the next catch-up abandons."""
        assert len(items) == len(depths) and items
        K = max(depths)
        self._proposals += 1
        protect = {tid for tid, _, _ in items}
        for (tid, committed, _last) in items:
            self._catch_up(tid, committed, protect)
            self._drafted_at[tid] = self._proposals
        slots = [self.slot_of[tid] for tid, _, _ in items]
        valid = np.zeros((self.max_slots,), bool)
        valid[slots] = True
        toks = np.zeros((self.max_slots,), np.int32)
        toks[slots] = [last for _, _, last in items]
        step_fn = masked_step(self)
        drafts: List[List[int]] = [[] for _ in items]
        for step in range(K):
            _, argmax = step_fn.run({"tokens": toks, "valid": valid})
            nxt = argmax.cpu().numpy()[slots]          # synchronises
            for i, d in enumerate(depths):
                if step < d:
                    drafts[i].append(int(nxt[i]))
            toks[slots] = nxt
        self.drafted_tokens += sum(depths)
        return drafts
