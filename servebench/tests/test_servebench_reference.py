"""The plain references against the port's paged engine on the CPU, in
float32: whole and chunked prefill, decode over pages, and the MoE's
routing with capacity drops, logits within float32 rounding."""
import numpy as np
import pytest
import torch

from helpers_servebench import TINY_DENSE, TINY_MOE
from servebench.harness import check, engine, registry, weights
from servebench.harness.traffic import SLO, Request

SEED = 2**31 + 5


def _skew(params, m):
    """Tilt every layer's router to expert 0 so prompts overflow its
    capacity and assignments are dropped."""
    if m["block_kind"] == "moe":
        params["blocks"]["moe"]["router"][:, :, 0] += 0.5


@pytest.mark.parametrize("model,chunk", [(TINY_DENSE, None),
                                         (TINY_DENSE, 16),
                                         (TINY_MOE, None)])
def test_reference_matches_the_engine_in_float32(model, chunk):
    eng = {"max_batch": 4, "max_seq": 256, "page_size": 16, "pages": 128,
           "prefill_chunk": chunk}
    params = weights.make(model, SEED, "cpu", torch.float32)
    _skew(params, model)
    ex = engine.executor(model, params, eng, SEED, "cpu", torch.float32)
    reqs = [Request(1_000_000 + i, 0.0, "qa", L, 6, SLO(False, 1.0, 1.0), 1.0)
            for i, L in enumerate([37, 64, 100])]
    tasks = [engine.task(r) for r in reqs]
    logits = {}
    for r, t in zip(reqs, tasks):
        if chunk:
            done = False
            while not done:
                n = min(chunk, t.prompt_len - ex.prompt_progress(t))
                _, done = ex.prefill_chunk(t, n)
        else:
            ex.prefill(t)
        t.prefill_done_ms = 0.0
        t.token_times_ms.append(0.0)
        logits[r.rid] = [ex.last_prefill_logits[0]]
    for _ in range(5):
        ex.decode(tasks)
        for r, t, row in zip(reqs, tasks, ex.last_logits):
            t.token_times_ms.append(0.0)
            logits[r.rid].append(row)
    served = {r.rid: ex.generated_tokens(t) for r, t in zip(reqs, tasks)}
    ref = registry.reference("moe_decoder" if model["block_kind"] == "moe"
                             else "dense_gqa")
    w = weights.make(model, SEED, "cpu", torch.float32)
    _skew(w, model)
    seqs, n_prompt, spans = [], [], []
    for r in reqs:
        toks = np.concatenate([
            check.prompt_tokens(SEED, r.rid, model["vocab_size"],
                                r.prompt_len),
            np.asarray(served[r.rid][:-1])])
        seqs.append(torch.as_tensor(toks))
        n_prompt.append(r.prompt_len)
        spans.append((len(toks), check.spans_of(r, eng)))
    got = {}
    ref.forward(model, w, seqs, n_prompt, spans,
                lambda i, lg: got.__setitem__(i, lg.numpy()))
    for i, r in enumerate(reqs):
        np.testing.assert_allclose(np.stack(logits[r.rid]), got[i],
                                   atol=2e-5, rtol=0)


def test_moe_reference_drops_past_capacity():
    mod = registry.reference("moe_decoder")
    ids = torch.tensor([[0, 1]] * 6 + [[2, 3]] * 2)
    # 8 tokens, top-2 of 4: C = int(8 * 2 / 4 * 1.25 + 0.999) = 5
    keep = mod.keep_mask(ids, 4, 2, [(0, 8)])
    assert keep[:5].all() and not keep[5:6].any() and keep[6:].all()
    # tokens outside every group (decoded ones) are never dropped
    assert mod.keep_mask(ids, 4, 2, []).all()
