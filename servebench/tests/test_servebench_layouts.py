"""The weight layouts (``layouts/``): for the configurations the cells
run, the same leaves and the same work counts as the harness had before
layouts existed (frozen copies below); for every causal token-input arch
of the port, the leaves of the port's own tree; for the SSM and hybrid
archs, weights drawn through the harness that the paged engine serves
as the port's full-sequence forward computes them."""
import dataclasses

import numpy as np
import pytest
import torch

from helpers_servebench import TINY_DENSE, TINY_MOE
from servebench.harness import check, engine, registry, weights
from servebench.harness.traffic import SLO, Request
from servebench.harness.weights import NORM_SCALE, padded_vocab

SEED = 2**31 + 41
CELL_CONFIGS = ["edge-6b", "granite-moe-3b-a800m"]
KEYS = [[1], [5, 1], [37, 300, 1024, 2], list(range(1, 33)),
        [383 + i for i in range(32)]]
CHUNKS = [(0, 1), (0, 37), (0, 383), (64, 64), (256, 127), (1000, 24)]


# -- the harness's functions before layouts, kept as they were --------

def frozen_leaves(m):
    L, D, F = m["n_layers"], m["d_model"], m["d_ff"]
    q, kv = m["n_heads"] * m["head_dim"], m["n_kv_heads"] * m["head_dim"]
    V = padded_vocab(m["vocab_size"])
    out = [("embed", (V, D), D ** -0.5), ("lm_head", (D, V), D ** -0.5),
           ("final_norm", (D,), NORM_SCALE),
           ("blocks.ln1", (L, D), NORM_SCALE),
           ("blocks.ln2", (L, D), NORM_SCALE),
           ("blocks.wq", (L, D, q), D ** -0.5),
           ("blocks.wk", (L, D, kv), D ** -0.5),
           ("blocks.wv", (L, D, kv), D ** -0.5),
           ("blocks.wo", (L, q, D), q ** -0.5)]
    if m["block_kind"] == "moe":
        E = m["n_experts"]
        out += [("blocks.moe.router", (L, D, E), D ** -0.5),
                ("blocks.moe.wg", (L, E, D, F), D ** -0.5),
                ("blocks.moe.wu", (L, E, D, F), D ** -0.5),
                ("blocks.moe.wd", (L, E, F, D), F ** -0.5)]
    else:
        out += [("blocks.wg", (L, D, F), D ** -0.5),
                ("blocks.wu", (L, D, F), D ** -0.5),
                ("blocks.wd", (L, F, D), F ** -0.5)]
    return out


def frozen_token_params(m):
    D, F, hd = m["d_model"], m["d_ff"], m["head_dim"]
    attn = D * m["n_heads"] * hd * 2 + D * m["n_kv_heads"] * hd * 2
    if m["block_kind"] == "moe":
        ffn = D * m["n_experts"] + m["top_k"] * 3 * D * F
    else:
        ffn = 3 * D * F
    return m["n_layers"] * (attn + ffn)


def frozen_attn_flops(m, keys):
    return 4 * m["head_dim"] * m["n_heads"] * m["n_layers"] * keys


def frozen_decode(m, keys):
    per = 2 * (frozen_token_params(m) + m["d_model"] * m["vocab_size"])
    return sum(per + frozen_attn_flops(m, k) for k in keys)


def frozen_chunk(m, start, n):
    keys = n * start + n * (n + 1) // 2
    return (2 * frozen_token_params(m) * n + 2 * m["d_model"]
            * m["vocab_size"] + frozen_attn_flops(m, keys))


def frozen_paged_work(m, keys, eb):
    hd, Hq, Hkv, L = (m["head_dim"], m["n_heads"], m["n_kv_heads"],
                      m["n_layers"])
    flops = sum(4 * hd * Hq * k for k in keys) * L
    nbytes = sum(2 * k * Hkv * hd + 2 * Hq * hd for k in keys) * eb * L
    return float(flops), float(nbytes)


def frozen_flash_work(m, L, eb):
    hd, Hq, Hkv, Ls = (m["head_dim"], m["n_heads"], m["n_kv_heads"],
                       m["n_layers"])
    flops = 2 * hd * Hq * L * (L + 1) * Ls
    nbytes = (2 * L * Hq * hd + 2 * L * Hkv * hd) * eb * Ls
    return float(flops), float(nbytes)


def frozen_chunk_work(m, start, n, eb):
    hd, Hq, Hkv, Ls = (m["head_dim"], m["n_heads"], m["n_kv_heads"],
                       m["n_layers"])
    flops = 4 * hd * Hq * (n * start + n * (n + 1) // 2) * Ls
    nbytes = (2 * n * Hq * hd + 2 * (start + n) * Hkv * hd) * eb * Ls
    return float(flops), float(nbytes)


# -- the cells' configurations: nothing moved --------------------------

def _flat(tree, prefix=""):
    """A nested dict's leaves under dotted paths."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "."))
        else:
            out[prefix + k] = v
    return out


def _cell_model(name):
    entry = next(c for c in registry.benchmark()["configs"]
                 if c["name"] == name)
    return registry.config(entry)["port"]


@pytest.mark.parametrize("name", CELL_CONFIGS)
def test_cell_configs_keep_their_leaves(name):
    m = _cell_model(name)
    assert registry.layout_of(m) is registry.layouts()["uniform"]
    assert weights.leaves(m) == frozen_leaves(m)


@pytest.mark.parametrize("model", [TINY_DENSE, TINY_MOE],
                         ids=["dense", "moe"])
def test_same_seed_draws_the_same_bytes(model):
    """``weights.make`` against the draw it made before layouts: one
    randn over the frozen leaves' sizes, each view scaled in place."""
    gen = torch.Generator().manual_seed(SEED)
    specs = frozen_leaves(model)
    flat = torch.randn(sum(int(np.prod(s)) for _, s, _ in specs),
                       generator=gen, dtype=torch.bfloat16)
    got = _flat(weights.make(model, SEED, "cpu"))
    at = 0
    for path, shape, scale in specs:
        n = int(np.prod(shape))
        want = flat[at:at + n].view(shape).mul_(scale)
        at += n
        assert torch.equal(got.pop(path), want), path
    assert not got


@pytest.mark.parametrize("name", CELL_CONFIGS)
def test_cell_configs_keep_their_work_counts(name):
    m = _cell_model(name)
    ms = registry.roofline("model_step")
    assert ms.token_params(m) == frozen_token_params(m)
    for keys in KEYS:
        got = ms.decode(m, keys)
        assert type(got) is int and got == frozen_decode(m, keys)
    for start, n in CHUNKS:
        got = ms.chunk(m, start, n)
        assert type(got) is int and got == frozen_chunk(m, start, n)
    pd = registry.roofline("paged_decode_attention")
    fp = registry.roofline("flash_prefill")
    fc = registry.roofline("flash_prefill_chunk")
    for eb in (2, 4):
        for keys in KEYS:
            assert pd.work(m, keys, eb) == frozen_paged_work(m, keys, eb)
        for start, n in CHUNKS:
            assert fp.work(m, n, eb) == frozen_flash_work(m, n, eb)
            assert fc.work(m, start, n, eb) == frozen_chunk_work(
                m, start, n, eb)


# -- every causal token-input arch: the port's own tree ----------------

def _archs():
    from repro_torch.configs import get_config, list_archs
    out = []
    for name in list_archs():
        cfg = get_config(name)
        if cfg.causal and not cfg.embedding_inputs:
            out += [name, name + "-smoke"]
    return out


def _port_dims(name):
    from repro_torch.configs import get_config
    cfg = get_config(name)
    return cfg, dataclasses.asdict(cfg)


@pytest.mark.parametrize("name", _archs())
def test_layout_leaves_are_the_ports_tree(name):
    from repro_torch.models import model as M
    cfg, m = _port_dims(name)
    got = [(path, shape) for path, shape, _ in weights.leaves(m)]
    assert len({p for p, _ in got}) == len(got)
    assert dict(got) == {p: tuple(s) for p, s in
                         _flat(M.param_shapes(cfg)).items()}
    assert all(scale > 0 for _, _, scale in weights.leaves(m))


# -- SSM and hybrid: drawn by the harness, served by the paged engine --

# float32 on both sides: the engine's scan and step kernels' plain
# versions against the forward's chunked SSD, whose sums run in another
# order (widest gap 7.3e-6 on mamba2, 5.0e-6 on hymba); decode steps that
# do not carry their state read 4.3 and 4.6
TOL = 5e-5


@pytest.mark.parametrize("name", ["mamba2-780m-smoke", "hymba-1.5b-smoke"])
def test_ssm_layout_serves_as_the_forward_computes(name):
    from repro_torch.models import model as M
    cfg, m = _port_dims(name)
    eng = {"max_batch": 4, "max_seq": 128, "page_size": 16, "pages": 64,
           "prefill_chunk": None}
    params = weights.make(m, SEED, "cpu", torch.float32)
    ex = engine.executor(m, params, eng, SEED, "cpu", torch.float32)
    # at most 64 positions: the forward's window (hymba's 64 in the smoke
    # config) would cut a longer sequence, and the paged engine has none
    reqs = [Request(1_000_000 + i, 0.0, "qa", L, 7, SLO(False, 1.0, 1.0), 1.0)
            for i, L in enumerate([5, 17, 40])]
    tasks = [engine.task(r) for r in reqs]
    logits = {}
    for r, t in zip(reqs, tasks):
        ex.prefill(t)
        t.prefill_done_ms = 0.0
        t.token_times_ms.append(0.0)
        logits[r.rid] = [ex.last_prefill_logits[0]]
    for _ in range(6):
        ex.decode(tasks)
        for r, t, row in zip(reqs, tasks, ex.last_logits):
            t.token_times_ms.append(0.0)
            logits[r.rid].append(row)
    worst = 0.0
    with torch.no_grad():
        for r, t in zip(reqs, tasks):
            served = ex.generated_tokens(t)
            assert len(served) == 7
            toks = np.concatenate([
                check.prompt_tokens(SEED, r.rid, m["vocab_size"],
                                    r.prompt_len),
                np.asarray(served[:-1])])
            full, _ = M.forward(cfg, params, torch.as_tensor(toks)[None])
            want = full[0, r.prompt_len - 1:].numpy()
            got = np.stack([np.asarray(x) for x in logits[r.rid]])
            assert np.isfinite(got).all()
            worst = max(worst, float(np.abs(got - want).max()))
    print(f"{name}: widest logit gap {worst:.3g}")
    assert worst <= TOL, worst


# -- which layout serves a block kind ----------------------------------

@pytest.mark.parametrize("kind,name", [("dense", "uniform"),
                                       ("moe", "uniform"), ("ssm", "ssm"),
                                       ("hybrid", "ssm")])
def test_each_block_kind_has_one_layout(kind, name):
    assert registry.layout_of({"block_kind": kind}) is registry.layouts()[name]


def test_a_block_kind_no_layout_serves_fails_at_once():
    with pytest.raises(KeyError, match="0 layouts serve block_kind 'mixed'; "
                       "served: ssm: ssm, hybrid; uniform: dense, moe"):
        weights.leaves({"block_kind": "mixed"})


# -- the SSM layout's counts by hand -----------------------------------

def test_ssm_layout_work_counts():
    ms = registry.roofline("model_step")
    pd = registry.roofline("paged_decode_attention")
    m = {"block_kind": "ssm", "n_layers": 2, "d_model": 8,
         "n_heads": 0, "n_kv_heads": 0, "head_dim": 0, "d_ff": 0,
         "vocab_size": 10, "ssm_state": 4, "ssm_expand": 2,
         "ssm_head_dim": 4, "ssm_conv": 3, "tied_embeddings": True}
    # di 16, H 4, N 4: in_proj 8 x (32 + 8 + 4), conv 24 x 3, out 16 x 8
    assert ms.token_params(m) == 2 * (352 + 72 + 128)
    lay = registry.layout_of(m)
    assert lay.attn_layers(m) == 0
    assert lay.recurrence_flops(m) == 2 * 5 * 16 * 4
    # one row: 2 x (weights + LM head 80) + the recurrence; no attention
    assert ms.decode(m, [5]) == 2 * (1104 + 80) + 640
    assert ms.chunk(m, 0, 3) == (2 * 1104 + 640) * 3 + 2 * 80
    assert pd.work(m, [5, 7], 2) == (0.0, 0.0)
    hybrid = {**m, "block_kind": "hybrid", "n_heads": 4, "n_kv_heads": 2,
              "head_dim": 2, "d_ff": 16, "tied_embeddings": False}
    # attention 8x8 x2 + 8x4 x2 = 192 and the MLP 3 x 8x16 = 384 a layer
    assert ms.token_params(hybrid) == 2 * (192 + 552 + 384)
    assert lay.attn_layers(hybrid) == 2
    assert ms.decode(hybrid, [5]) == (2 * (2256 + 80) + 640
                                      + 4 * 2 * 4 * 2 * 5)
    paths = [p for p, _, _ in weights.leaves(hybrid)]
    assert "lm_head" in paths and "lm_head" not in [
        p for p, _, _ in weights.leaves(m)]
