"""Every registry arch of the port held against the JAX package: the
copied configs equal the JAX registry's, and every causal arch (dense,
MoE, SSM and hybrid, reduced, on the same weights through
``load_params``) gives JAX's logits through the port's ``prefill`` and
``decode_step_paged``, at atol 1e-5 (``tests/helpers.py``), fp32 on the
CPU. Encoder-only hubert-xlarge is skipped with the JAX test's reason.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from helpers import assert_logits_close  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import list_archs as jax_archs  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402


def _pair(arch, seed=3):
    jcfg = jax_config(arch).reduced()
    cfg = get_config(arch).reduced()
    jp = JM.init_params(jcfg, jax.random.PRNGKey(seed))
    tree = jax.tree_util.tree_map(np.asarray, jp)
    return jcfg, cfg, jp, tree, TM.load_params(cfg, tree, device="cpu")


def test_registry_matches_jax():
    assert list_archs() == jax_archs()
    for a in list_archs():
        assert (dataclasses.asdict(get_config(a))
                == dataclasses.asdict(jax_config(a)))
        assert (dataclasses.asdict(get_config(a + "-smoke"))
                == dataclasses.asdict(jax_config(a + "-smoke")))


def _splice_jax(pages, cache, phys, slot, psz, cfg):
    """Write a one-row prefill cache into JAX pages and the state slot."""
    if cfg.has_attention:
        for name, key in (("k_pages", "k"), ("v_pages", "v")):
            src, n = cache[key], len(phys)
            view = src[:, 0, :, :n * psz, :].reshape(
                src.shape[0], src.shape[2], n, psz, -1).swapaxes(1, 2)
            pages[name] = pages[name].at[:, jnp.asarray(phys)].set(view)
    if cfg.has_ssm:
        for name, key in (("ssm_state", "ssm"), ("conv_state", "conv")):
            pages[name] = pages[name].at[:, slot].set(
                cache[key][:, 0].astype(pages[name].dtype))
    return pages


def _splice_torch(pages, cache, phys, slot, psz, cfg):
    if cfg.has_attention:
        for name, key in (("k_pages", "k"), ("v_pages", "v")):
            src, n = cache[key], len(phys)
            view = src[:, 0, :, :n * psz, :].reshape(
                src.shape[0], src.shape[2], n, psz, -1).transpose(1, 2)
            pages[name][:, torch.as_tensor(phys)] = view
    if cfg.has_ssm:
        for name, key in (("ssm_state", "ssm"), ("conv_state", "conv")):
            pages[name][:, slot] = cache[key][:, 0].to(pages[name].dtype)
    return pages


@pytest.mark.parametrize("arch", list_archs())
def test_model_prefill_and_paged_decode_match_jax(arch):
    """Two prompts (5 and 11 tokens) prefilled, then two decode steps over
    a 3-row batch: row 1 inactive on the second step, row 2 a pad row
    (table all -1, state slot -1). SSM archs use a shuffled 4-slot state
    arena. Active rows' logits and the arenas' pool pages and owned slots
    (inactive and pad rows write only the spare page and slot past them,
    where JAX drops their writes) match JAX: K/V and conv tails at atol
    1e-5, the fp32 SSD
    state at 1e-5 of its largest magnitude (it accumulates to ~10, where
    summation order moves the last bits)."""
    if not jax_config(arch).causal:
        pytest.skip(f"{arch}: bidirectional encoder — no causal decode "
                    "path, nothing to serve token-by-token")
    jcfg, cfg, jp, _, tp = _pair(arch)
    psz, n_pages, maxp, buf = 4, 12, 6, 24
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, cfg.vocab_size, (1, n)) for n in (5, 11)]
    tables, slots = [[3, 7], [0, 9, 2]], [2, 0]
    jpages = JM.init_paged_cache(jcfg, n_pages, psz)
    tpages = TM.init_paged_cache(cfg, n_pages, psz, device="cpu")
    if cfg.has_ssm:
        jpages.update(JM.init_state_arena(jcfg, 4))
        tpages.update(TM.init_state_arena(cfg, 4, device="cpu"))
    toks = []
    for prompt, phys, slot in zip(prompts, tables, slots):
        jl, jc = JM.prefill(jcfg, jp, jnp.asarray(prompt), buf_len=buf)
        tl, tc = TM.prefill(cfg, tp, torch.from_numpy(prompt), buf_len=buf)
        assert_logits_close(tl.numpy(), np.asarray(jl), err_msg="prefill")
        jpages = _splice_jax(jpages, jc, phys, slot, psz, cfg)
        tpages = _splice_torch(tpages, tc, phys, slot, psz, cfg)
        toks.append(int(np.asarray(jl)[0].argmax()))
    lengths = [5, 11, 0]
    for act in ([True, True, False], [True, False, False]):
        pt = np.full((3, maxp), -1, np.int32)
        for r, phys in enumerate(tables):
            pt[r, : len(phys)] = phys
        tk = np.array(toks + [0], np.int32)
        kw_j, kw_t = {}, {}
        if cfg.has_ssm:
            sl = np.array(slots + [-1], np.int32)
            kw_j["state_slots"] = jnp.asarray(sl)
            kw_t["state_slots"] = torch.from_numpy(sl)
        jl, jpages = JM.decode_step_paged(
            jcfg, jp, jpages, jnp.asarray(pt), jnp.asarray(lengths),
            jnp.asarray(tk), jnp.asarray(act), **kw_j)
        tl, tpages = TM.decode_step_paged(
            cfg, tp, tpages, torch.from_numpy(pt),
            torch.tensor(lengths, dtype=torch.int32), torch.from_numpy(tk),
            torch.tensor(act), **kw_t)
        live = np.array(act)
        assert_logits_close(tl.numpy()[live], np.asarray(jl)[live],
                            err_msg=f"{arch} decode")
        toks = [int(x) for x in np.asarray(jl)[:2].argmax(-1)]
        lengths = [n + a for n, a in zip(lengths, act)]
        for name in tpages:
            want = np.asarray(jpages[name])
            scale = max(1.0, float(np.abs(want).max(initial=0.0)))
            got = tpages[name][:, :want.shape[1]]     # without the spare
            assert_logits_close(got.float().numpy(), want,
                                atol=1e-5 * (scale if name == "ssm_state"
                                             else 1.0), err_msg=name)
