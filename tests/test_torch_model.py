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
    row 2 a pad row (table all -1). Active rows' logits and the whole page
    arena (inactive and pad rows write nothing) match JAX."""
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
            assert_logits_close(tpages[name].numpy(), np.asarray(jpages[name]))
        nxt = np.asarray(jl).argmax(-1)
        for r in range(2):
            if act[r]:
                lengths[r] += 1
                toks[r] = int(nxt[r])
