"""The port's model (``repro_torch.models.model``) held against the JAX
model on the same weights: the JAX package's ``init_params`` goes through
the weight bridge ``load_params``, then prefill logits and three
``decode_step_paged`` steps — with an inactive row and a pad row — must
match at atol 1e-5 (``tests/helpers.py`` contract), fp32 on the CPU.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from helpers import assert_logits_close  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402

ARCHS = ["edge-6b", "smollm-360m"]


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    jcfg = jax_config(request.param).reduced()
    cfg = get_config(request.param).reduced()
    jp = JM.init_params(jcfg, jax.random.PRNGKey(3))
    tree = jax.tree_util.tree_map(np.asarray, jp)
    return jcfg, cfg, jp, tree, TM.load_params(cfg, tree, device="cpu")


def test_configs_match_reference(pair):
    jcfg, cfg, *_ = pair
    import dataclasses
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)


def test_load_params_is_exact(pair):
    _, cfg, _, tree, params = pair
    assert params["embed"].dtype == torch.float32
    np.testing.assert_array_equal(params["embed"].numpy(), tree["embed"])
    np.testing.assert_array_equal(params["lm_head"].numpy(), tree["lm_head"])
    for k, v in tree["blocks"].items():
        np.testing.assert_array_equal(params["blocks"][k].numpy(), v)


def test_load_params_rejects_wrong_shapes(pair):
    _, cfg, _, tree, _ = pair
    bad = dict(tree, blocks=dict(tree["blocks"], wq=tree["blocks"]["wq"][:, :1]))
    with pytest.raises(ValueError, match="blocks.wq"):
        TM.load_params(cfg, bad, device="cpu")
    with pytest.raises(KeyError, match="lm_head"):
        TM.load_params(cfg, {k: v for k, v in tree.items() if k != "lm_head"},
                       device="cpu")


def test_init_params_shapes_and_scales(pair):
    _, cfg, _, tree, _ = pair
    p = TM.init_params(cfg, seed=1, device="cpu")
    shapes = jax.tree_util.tree_map(np.shape, tree)
    assert jax.tree_util.tree_map(lambda t: tuple(t.shape), p) == shapes
    D = cfg.d_model
    for name, want in (("wq", D ** -0.5), ("wo", cfg.q_dim ** -0.5),
                       ("wd", cfg.d_ff ** -0.5)):
        assert abs(p["blocks"][name].std().item() / want - 1) < 0.05, name
    assert torch.all(p["blocks"]["ln1"] == 0)
    again = TM.init_params(cfg, seed=1, device="cpu")
    assert torch.equal(again["blocks"]["wg"], p["blocks"]["wg"])


def _splice_jax(pages, cache, phys, psz):
    out = {}
    for name, src in (("k_pages", cache["k"]), ("v_pages", cache["v"])):
        n = len(phys)
        view = (src[:, 0, :, :n * psz, :]
                .reshape(src.shape[0], src.shape[2], n, psz, -1)
                .swapaxes(1, 2))
        out[name] = pages[name].at[:, jnp.asarray(phys)].set(view)
    return out


def _splice_torch(pages, cache, phys, psz):
    for name, src in (("k_pages", cache["k"]), ("v_pages", cache["v"])):
        n = len(phys)
        view = (src[:, 0, :, :n * psz, :]
                .reshape(src.shape[0], src.shape[2], n, psz, -1)
                .transpose(1, 2))
        pages[name][:, torch.as_tensor(phys)] = view
    return pages


def test_prefill_then_paged_decode_match_jax(pair):
    """Two prompts (5 and 11 tokens) prefilled, then 3 decode steps over a
    3-row batch: row 0 always active, row 1 inactive on the middle step,
    row 2 a pad row (table all -1). Active rows' logits and the pool's
    pages of the arena (inactive and pad rows write only the spare page
    past them, where JAX drops their writes) match JAX."""
    jcfg, cfg, jp, _, tp = pair
    psz, n_pages, maxp, buf = 4, 12, 6, 24
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, cfg.vocab_size, (1, n)) for n in (5, 11)]
    tables = [[3, 7], [0, 9, 2]]
    jpages = JM.init_paged_cache(jcfg, n_pages, psz)
    tpages = TM.init_paged_cache(cfg, n_pages, psz, device="cpu")
    toks = []
    for prompt, phys in zip(prompts, tables):
        jl, jc = JM.prefill(jcfg, jp, jnp.asarray(prompt), buf_len=buf)
        tl, tc = TM.prefill(cfg, tp, torch.from_numpy(prompt), buf_len=buf)
        assert_logits_close(tl.numpy(), np.asarray(jl), err_msg="prefill")
        assert_logits_close(tc["k"].numpy(), np.asarray(jc["k"]))
        np.testing.assert_array_equal(tc["kv_pos"].numpy(), jc["kv_pos"])
        jpages = _splice_jax(jpages, jc, phys, psz)
        tpages = _splice_torch(tpages, tc, phys, psz)
        toks.append(int(np.asarray(jl)[0].argmax()))
    lengths = [5, 11, 0]
    actives = [[True, True, False], [True, False, False], [True, True, False]]
    for step, act in enumerate(actives):
        pt = np.full((3, maxp), -1, np.int32)
        for r, ln in enumerate(lengths[:2]):
            need = ln // psz + 1           # the pool extends BEFORE the step
            while len(tables[r]) < need:
                tables[r].append(n_pages - 1 - len(tables[0]) - len(tables[1]))
            pt[r, :len(tables[r])] = tables[r]
        ln = np.asarray(lengths, np.int32)
        tk = np.asarray(toks + [0], np.int32)
        av = np.asarray(act)
        jl, jpages = JM.decode_step_paged(jcfg, jp, jpages, jnp.asarray(pt),
                                          jnp.asarray(ln), jnp.asarray(tk),
                                          jnp.asarray(av))
        tl, tpages = TM.decode_step_paged(cfg, tp, tpages, torch.from_numpy(pt),
                                          torch.from_numpy(ln),
                                          torch.from_numpy(tk),
                                          torch.from_numpy(av))
        assert tl.shape == (3, cfg.vocab_size)
        assert_logits_close(tl.numpy()[av], np.asarray(jl)[av],
                            err_msg=f"decode step {step}")
        for name in ("k_pages", "v_pages"):
            assert_logits_close(tpages[name][:, :n_pages].numpy(),
                                np.asarray(jpages[name]))
        nxt = np.asarray(jl).argmax(-1)
        for r in range(2):
            if act[r]:
                lengths[r] += 1
                toks[r] = int(nxt[r])


def _jax_cache(tc):
    return {k: jnp.asarray(v.numpy()) for k, v in tc.items()}


def test_slot_chunks_then_ring_decode_match_jax(pair):
    """Slot cache: a 13-token prompt appended as chunks of 8 and 5 to row
    0 (row 1 takes a 4-token chunk, then a 9-token one), then decode steps
    over a 16-slot ring, past its end, with row 1 inactive on some steps.
    Logits of active rows and the whole cache (k, v, kv_pos, length)
    match JAX's ``prefill_chunk`` and ``decode_step`` (kv_pos masking,
    ring slot q_pos % buf_len, the reduced config's window of 64)."""
    jcfg, cfg, jp, _, tp = pair
    buf = 16
    rng = np.random.default_rng(5)
    jc = JM.init_cache(jcfg, 2, buf)
    tc = TM.init_cache(cfg, 2, buf, device="cpu")
    for c0, c1 in ((8, 4), (5, 9)):
        toks = rng.integers(0, cfg.vocab_size, (2, max(c0, c1)))
        # the rows take chunks of different lengths, so each runs on a
        # view of its own row, as the slot engine does
        for rows, c in ((slice(0, 1), c0), (slice(1, 2), c1)):
            sub_t = {k: v[:, rows] if k in ("k", "v") else v[rows]
                     for k, v in tc.items()}
            sub_j = {k: v[:, rows] if k in ("k", "v") else v[rows]
                     for k, v in jc.items()}
            tl, _ = TM.prefill_chunk(cfg, tp, sub_t,
                                     torch.from_numpy(toks[rows, :c]))
            jl, sub_j = JM.prefill_chunk(jcfg, jp, sub_j,
                                         jnp.asarray(toks[rows, :c]))
            assert_logits_close(tl.numpy(), np.asarray(jl), err_msg="chunk")
            jc = {k: (v.at[:, rows].set(sub_j[k]) if k in ("k", "v")
                      else v.at[rows].set(sub_j[k])) for k, v in jc.items()}
    for name in ("k", "v"):
        assert_logits_close(tc[name].numpy(), np.asarray(jc[name]))
    for name in ("kv_pos", "length"):
        np.testing.assert_array_equal(tc[name].numpy(), np.asarray(jc[name]))
    toks = np.array([3, 7], np.int32)
    for step in range(12):                 # row 0 runs 13 -> 25 > buf
        av = np.array([True, step % 3 != 1])
        jl, jc = JM.decode_step(jcfg, jp, jc, jnp.asarray(toks),
                                jnp.asarray(av))
        tl, tc = TM.decode_step(cfg, tp, tc, torch.from_numpy(toks),
                                torch.from_numpy(av))
        assert_logits_close(tl.numpy()[av], np.asarray(jl)[av],
                            err_msg=f"decode step {step}")
        for name in ("k", "v"):
            assert_logits_close(tc[name].numpy(), np.asarray(jc[name]))
        for name in ("kv_pos", "length"):
            np.testing.assert_array_equal(tc[name].numpy(),
                                          np.asarray(jc[name]))
        toks = np.where(av, np.asarray(jl).argmax(-1), toks).astype(np.int32)
    assert int(tc["length"][0]) == 25 and tc["kv_pos"].max() == 24


def test_prefill_chunk_paged_matches_jax(pair):
    """Paged chunks: row 1 first takes 3 tokens alone, then rows 0 and 1
    take two chunks of 6 together at unequal lengths (pages crossed
    mid-chunk), with a pad row (table all -1) riding along. The tables
    cover every chunk, as the pool guarantees. Logits of the real rows
    and the pool's pages of the arena (the pad row writes nothing) match
    JAX."""
    jcfg, cfg, jp, _, tp = pair
    psz, n_pages, maxp = 4, 10, 6
    rng = np.random.default_rng(9)
    jpages = JM.init_paged_cache(jcfg, n_pages, psz)
    tpages = TM.init_paged_cache(cfg, n_pages, psz, device="cpu")
    steps = (([[8]], [0], 3),
             ([[2, 7], [8, 1, 5], []], [0, 3, 0], 6),
             ([[2, 7, 4], [8, 1, 5, 3], []], [6, 9, 0], 6))
    for step, (tables, lengths, c) in enumerate(steps):
        B = len(tables)
        pt = np.full((B, maxp), -1, np.int32)
        for r, row in enumerate(tables):
            pt[r, :len(row)] = row
        ln = np.asarray(lengths, np.int32)
        toks = rng.integers(0, cfg.vocab_size, (B, c))
        jl, jpages = JM.prefill_chunk_paged(jcfg, jp, jpages, jnp.asarray(pt),
                                            jnp.asarray(ln), jnp.asarray(toks))
        tl, tpages = TM.prefill_chunk_paged(cfg, tp, tpages,
                                            torch.from_numpy(pt),
                                            torch.from_numpy(ln),
                                            torch.from_numpy(toks))
        real = (pt >= 0).any(axis=1)
        assert_logits_close(tl.numpy()[real], np.asarray(jl)[real],
                            err_msg=f"chunk {step}")
        for name in ("k_pages", "v_pages"):
            assert_logits_close(tpages[name][:, :n_pages].numpy(),
                                np.asarray(jpages[name]))


def test_verify_step_paged_matches_jax(pair):
    """Verify windows over a seeded arena: rows of C = 3 and C = 5 queries
    at unequal lengths (a window crossing a page boundary), a pad row
    (table all -1) riding along. Logits of every position of the real
    rows and the pool's pages of the arena (the pad row writes only the
    spare page past them) match JAX."""
    jcfg, cfg, jp, _, tp = pair
    psz, n_pages, maxp = 4, 12, 6
    rng = np.random.default_rng(11)
    jpages = JM.init_paged_cache(jcfg, n_pages, psz)
    tpages = TM.init_paged_cache(cfg, n_pages, psz, device="cpu")
    seed_pt = np.array([[2, 7, 4, -1, -1, -1], [8, 1, 5, 3, -1, -1]],
                       np.int32)
    seed = rng.integers(0, cfg.vocab_size, (2, 9))
    _, jpages = JM.prefill_chunk_paged(jcfg, jp, jpages, jnp.asarray(seed_pt),
                                       jnp.zeros((2,), jnp.int32),
                                       jnp.asarray(seed))
    TM.prefill_chunk_paged(cfg, tp, tpages, torch.from_numpy(seed_pt),
                           torch.zeros(2, dtype=torch.int32),
                           torch.from_numpy(seed))
    for C, lengths in ((3, [9, 6, 0]), (5, [9, 7, 0])):
        pt = np.full((3, maxp), -1, np.int32)
        pt[:2] = seed_pt
        pt[0, 3] = 9                      # row 0's window crosses into page 9
        ln = np.asarray(lengths, np.int32)
        toks = rng.integers(0, cfg.vocab_size, (3, C))
        jl, jpages = JM.verify_step_paged(jcfg, jp, jpages, jnp.asarray(pt),
                                          jnp.asarray(ln), jnp.asarray(toks))
        tl, tpages = TM.verify_step_paged(cfg, tp, tpages,
                                          torch.from_numpy(pt),
                                          torch.from_numpy(ln),
                                          torch.from_numpy(toks))
        assert tl.shape == (3, C, cfg.vocab_size)
        assert_logits_close(tl.numpy()[:2], np.asarray(jl)[:2],
                            err_msg=f"C={C}")
        for name in ("k_pages", "v_pages"):
            assert_logits_close(tpages[name][:, :n_pages].numpy(),
                                np.asarray(jpages[name]))


def test_verify_pad_positions_past_table_write_nothing(pair):
    """A bucketed window near max_seq runs past the table: with 3 pages of
    4 and 10 cached tokens, a C = 4 window covers positions 10..13, and
    12, 13 have no page. They must write nothing, not wrap onto the last
    page's committed positions 8, 9: the pool's pages outside positions
    10, 11 stay bit for bit (the untabled positions write the spare page
    past them), and the tabled queries' logits equal a C = 2 window."""
    _, cfg, _, _, tp = pair
    pages = [TM.init_paged_cache(cfg, 5, 4, device="cpu") for _ in range(2)]
    pt = torch.tensor([[3, 0, 4]], dtype=torch.int32)
    seed = torch.from_numpy(np.random.default_rng(12).integers(
        0, cfg.vocab_size, (1, 10)))
    for p in pages:
        TM.prefill_chunk_paged(cfg, tp, p, pt, torch.zeros(1, dtype=torch.int32),
                               seed)
    before = {name: t.clone() for name, t in pages[0].items()}
    lengths = torch.tensor([10], dtype=torch.int32)
    tokens = torch.tensor([[7, 11, 13, 17]])
    got, _ = TM.verify_step_paged(cfg, tp, pages[0], pt, lengths, tokens)
    want, _ = TM.verify_step_paged(cfg, tp, pages[1], pt, lengths,
                                   tokens[:, :2])
    assert_logits_close(got[:, :2].numpy(), want.numpy())
    for name in ("k_pages", "v_pages"):
        pool = slice(0, 5)                        # the spare page is 5
        assert torch.equal(pages[0][name][:, pool], pages[1][name][:, pool])
        changed = pages[0][name][:, pool] != before[name][:, pool]
        changed[:, 4, :, 2:] = False              # positions 10, 11
        assert not changed.any()


def test_verify_single_token_matches_decode_step(pair):
    """A C = 1 verify (no drafts) gives decode_step_paged's logits and
    writes the same K/V: the identity greedy equivalence rests on."""
    _, cfg, _, _, tp = pair
    pages = [TM.init_paged_cache(cfg, 6, 4, device="cpu") for _ in range(2)]
    pt = torch.tensor([[0, 2, -1], [1, 3, -1]], dtype=torch.int32)
    seed = torch.tensor([[1, 2, 3, 4, 5], [9, 8, 7, 6, 5]])
    for p in pages:
        TM.prefill_chunk_paged(cfg, tp, p, pt, torch.zeros(2, dtype=torch.int32),
                               seed)
    lengths = torch.tensor([5, 3], dtype=torch.int32)
    tokens = torch.tensor([7, 11])
    want, _ = TM.decode_step_paged(cfg, tp, pages[0], pt, lengths, tokens)
    got, _ = TM.verify_step_paged(cfg, tp, pages[1], pt, lengths,
                                  tokens[:, None])
    assert_logits_close(got[:, 0].numpy(), want.numpy())
    for name in ("k_pages", "v_pages"):
        assert torch.equal(pages[0][name], pages[1][name])
