"""Whether what the timed path served is right.

Once the window has closed, the peak memory has been read and the
program is gone, a sample of the requests the window finished, drawn
from the seed with the longest among them, is run through the plain
reference over each prompt and its served tokens. The number compared
is the widest gap by which a served token's logit lies below the
reference's best at its position (greedy serving: 0 when the engine
picked the reference's argmax, small where two logits lie within
rounding of each other). The reference remakes the weights from the
seed and draws the prompts in its own code; it reads the program's
served tokens only to judge them. Which readings are compared, and their
limits, is the cell's file's to say (``cells/<cell>.json``).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from servebench.harness import engine, registry, weights
from servebench.harness.traffic import Request


def prompt_tokens(seed: int, rid: int, vocab: int, length: int) -> np.ndarray:
    """The prompt the engine serves for task ``rid``: the port draws it
    from (seed, task id) (``serving/executor.py`` ``_prompt_tokens``,
    whose formula this repeats), so the benchmark draws the same."""
    rng = np.random.default_rng((seed + 1) * 100_003 + rid)
    return rng.integers(0, vocab, (length,))


def sample(requests: List[Request], served: Dict[int, List[int]],
           failed: Dict[int, float], seed: int, k: int) -> List[Request]:
    """The longest finished request and ``k - 1`` others drawn from the
    seed."""
    done = [r for r in requests if r.rid not in failed
            and len(served.get(r.rid, ())) == r.output_len]
    if not done:
        return []
    longest = max(done, key=lambda r: (r.prompt_len + r.output_len, -r.rid))
    rest = [r for r in done if r is not longest]
    rng = np.random.default_rng([int(seed), 7])
    pick = rng.choice(len(rest), size=min(k - 1, len(rest)), replace=False)
    return [longest] + [rest[i] for i in sorted(pick)]


def spans_of(r: Request, eng: Dict) -> List[Tuple[int, int]]:
    """The groups the engine's prefill ran the prompt's tokens in."""
    chunk = eng.get("prefill_chunk")
    if chunk is None:
        return [(0, r.prompt_len)]
    out, at = [], 0
    for n in engine.chunk_actions(r.prompt_len, chunk):
        for p in engine.chunk_pieces(n, chunk):
            out.append((at, at + p))
            at += p
    return out


def gaps(model: Dict, ref_name: str, seed: int, reqs: List[Request],
         served: Dict[int, List[int]], eng: Dict, device,
         dtype, control: bool = False) -> Dict[str, float]:
    """The readings of the served tokens against the reference in
    float32: ``max_logit_gap`` (the widest gap by which a served token's
    logit lies below the reference's best), ``mean_logit_gap`` (over
    every served token), ``mismatch_share`` (the share of served tokens
    that are not the reference's argmax) and ``tokens_compared``. With
    ``control``, the same three of the tokens the reference computed in
    float8 puts first, under ``control_`` names."""
    ref = registry.reference(ref_name)
    w = weights.make(model, seed, device, dtype)
    seqs, n_prompt, spans = [], [], []
    for r in reqs:
        toks = np.concatenate([
            prompt_tokens(seed, r.rid, model["vocab_size"], r.prompt_len),
            np.asarray(served[r.rid][:-1], dtype=np.int64)])
        seqs.append(torch.as_tensor(toks, device=device))
        n_prompt.append(r.prompt_len)
        spans.append((len(toks), spans_of(r, eng)))
    lp_first: Dict[int, torch.Tensor] = {}
    found: Dict[str, List[torch.Tensor]] = {"": [], "control_": []}

    def keep_first(i, logits):
        lp_first[i] = logits.argmax(-1)

    def judge(i, logits):
        best = logits.max(-1).values
        tok = torch.as_tensor(served[reqs[i].rid], device=logits.device)
        found[""].append(best - logits.gather(1, tok[:, None])[:, 0])
        if control:
            found["control_"].append(
                best - logits.gather(1, lp_first[i][:, None])[:, 0])
    with torch.no_grad():
        if control:
            ref.forward(model, w, seqs, n_prompt, spans, keep_first,
                        quant="fp8")
        ref.forward(model, w, seqs, n_prompt, spans, judge)
    out: Dict[str, float] = {}
    for pre, parts in found.items():
        if not parts:
            continue
        g = torch.cat(parts).double()
        out[pre + "max_logit_gap"] = float(g.max())
        out[pre + "mean_logit_gap"] = float(g.mean())
        out[pre + "mismatch_share"] = float((g > 0).double().mean())
        out["tokens_compared"] = int(g.numel())
    return out


def control_readings(readings: Dict[str, float]) -> Dict[str, float]:
    """The float8 control's readings under the engine's names, so that
    ``verdict`` judges the control by the cell's own limits."""
    out = {k[len("control_"):]: v for k, v in readings.items()
           if k.startswith("control_")}
    out["tokens_compared"] = readings["tokens_compared"]
    return out


def verdict(readings: Dict[str, float], spec: Dict) -> Tuple[bool, Dict]:
    """(correct, the numbers compared each beside its limit). The cell's
    file names the readings compared and their upper limits, and the
    least number of served tokens a run must compare."""
    checks = {name: {"value": readings[name], "limit": lim}
              for name, lim in spec["limits"].items()}
    checks["tokens_compared"] = {"value": readings["tokens_compared"],
                                 "limit": spec["min_tokens_compared"]}
    ok = (all(readings[n] <= lim for n, lim in spec["limits"].items())
          and readings["tokens_compared"] >= spec["min_tokens_compared"])
    return ok, checks
