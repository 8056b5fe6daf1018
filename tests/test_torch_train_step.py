"""The port's AdamW, schedules and training step held against the JAX
package (``repro.training``), fp32 on the CPU (its checkpoints:
``test_torch_train_serving.py``).

- AdamW fed the same gradients for 3 updates: params, mu and nu within
  1e-6; the cosine and WSD schedules within 1e-7 of JAX's at every step.
- ``train_step`` against JAX's jitted ``train_step``, 3 steps on one
  batch, the port's state set to JAX's before each step (through the
  shared checkpoint keys), so each step starts from the same state. The
  loss within 1e-5 (relative). grad_norm within 1e-5 of the exact
  (float64) norm of JAX's gradients; JAX's own grad_norm is held to that
  norm at 2e-3 only, as its ``jnp.vdot`` on the CPU adds a leaf's
  squares one after another in fp32 (up to 1.2e-3 off here), where
  torch's dot adds pairwise. AdamW divides by sqrt(v) + eps, so a
  component whose gradient is near 0 moves by up to lr whatever the last
  bits of its gradient say: the updated parameters are compared at atol
  1e-5 on the components whose gradient is at least 1e-3 of their leaf's
  largest |g| (there the gradient fixes the update), and elsewhere within
  the most two diverging AdamW steps can be apart, 2 lr (1 + wd |p|).
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.training import checkpoint as jckpt  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402
from repro.training.trainer import make_train_step as jax_train_step  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.training import checkpoint as tckpt  # noqa: E402
from repro_torch.training import optimizer as topt  # noqa: E402
from repro_torch.training.trainer import make_train_step  # noqa: E402


def _pair(arch, seed=5):
    jcfg = jax_config(arch).reduced()
    cfg = get_config(arch).reduced()
    jp = JM.init_params(jcfg, jax.random.PRNGKey(seed))
    tree = jax.tree_util.tree_map(np.asarray, jp)
    return jcfg, cfg, jp, tree


def _flat_np(tree):
    return {k: np.asarray(v) for k, v in jckpt._flatten(tree)[0].items()}


def _flat_t(tree):
    return {k: v.detach().numpy() for k, v in tckpt._flatten(tree).items()}


@pytest.mark.parametrize("sched", ["const", "cosine", "wsd"])
def test_adamw_matches_jax(sched):
    """Three updates of granite-moe's (reduced) parameter tree with the
    same gradients (random, some components 0, bf16-free fp32)."""
    _, cfg, _, tree = _pair("granite-moe-3b-a800m")
    lr = {"const": (1e-2, 1e-2),
          "cosine": (jopt.cosine_schedule(1e-2, 2, 6),
                     topt.cosine_schedule(1e-2, 2, 6)),
          "wsd": (jopt.wsd_schedule(1e-2, 1, 1, 3),
                  topt.wsd_schedule(1e-2, 1, 1, 3))}[sched]
    j_init, j_update = jopt.adamw(lr[0])
    t_init, t_update = topt.adamw(lr[1])
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    tp = TM.load_params(cfg, tree, device="cpu")
    js, ts = j_init(jp), t_init(tp)
    rng = np.random.default_rng(0)
    for _ in range(3):
        g = jax.tree_util.tree_map(
            lambda a: (rng.standard_normal(a.shape)
                       * (rng.random(a.shape) < 0.9)).astype(np.float32),
            tree)
        jp, js = j_update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        tp, ts = t_update(TM.load_params(cfg, g, device="cpu"), ts, tp)
    assert int(ts.step) == int(js.step) == 3
    for got, want in ((tp, jp), (ts.mu, js.mu), (ts.nu, js.nu)):
        want = _flat_np(want)
        for k, v in _flat_t(got).items():
            np.testing.assert_allclose(v, want[k], rtol=0, atol=1e-6,
                                       err_msg=k)


@pytest.mark.parametrize("name", ["cosine", "wsd"])
def test_schedules_match_jax(name):
    args = {"cosine": (3e-4, 10, 100), "wsd": (3e-4, 10, 50, 30)}[name]
    jf = getattr(jopt, f"{name}_schedule")(*args)
    tf = getattr(topt, f"{name}_schedule")(*args)
    steps = np.arange(0, 130, dtype=np.int32)
    want = np.asarray(jax.vmap(jf)(jnp.asarray(steps)))
    got = tf(torch.from_numpy(steps)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7 * 3e-4 * 10)


@pytest.mark.parametrize("arch", ["smollm-360m", "mamba2-780m",
                                  "granite-moe-3b-a800m"])
def test_train_step_matches_jax(arch):
    jcfg, cfg, jp, tree = _pair(arch, seed=3)
    lr = 1e-2
    kw = dict(peak_lr=lr, warmup=1, total=10)
    _, j_step = jax_train_step(jcfg, JM.ModelOptions(remat=True), **kw)
    t_init, t_step = make_train_step(cfg, device="cpu", **kw)
    j_state = (jp, jopt.adamw(lr)[0](jp))
    t_state = t_init(TM.load_params(cfg, tree, device="cpu"))
    rng = np.random.default_rng(4)
    toks = rng.integers(0, cfg.vocab_size, (2, 24)).astype(np.int32)
    jb = {"inputs": jnp.asarray(toks), "labels": jnp.asarray(toks)}
    tb = {"inputs": torch.from_numpy(toks), "labels": torch.from_numpy(toks)}
    step = jax.jit(j_step)
    grad = jax.jit(jax.grad(lambda p: JM.loss_fn(
        jcfg, p, jb["inputs"], jb["labels"], JM.ModelOptions(remat=True))))
    losses = []
    for i in range(3):
        with torch.no_grad():
            for k, v in _flat_np(j_state).items():
                tckpt._flatten(t_state)[k].copy_(torch.from_numpy(np.array(v)))
        g = _flat_np(grad(j_state[0]))
        exact = np.sqrt(sum((a.astype(np.float64) ** 2).sum()
                            for a in g.values()))
        p0 = _flat_np(j_state[0])
        j_state, jm = step(j_state, jb)
        t_state, tm = t_step(t_state, tb)
        want = float(jm["loss"])
        assert abs(float(tm["loss"]) - want) <= 1e-5 * abs(want), i
        assert abs(float(tm["grad_norm"]) - exact) <= 1e-5 * exact, i
        assert abs(float(jm["grad_norm"]) - exact) <= 2e-3 * exact, i
        losses.append(want)
        got = _flat_t(t_state[0])
        for k, w in _flat_np(j_state[0]).items():
            big = np.abs(g[k]) >= 1e-3 * np.abs(g[k]).max()
            np.testing.assert_allclose(got[k][big], w[big], rtol=0,
                                       atol=1e-5, err_msg=f"{i} {k}")
            bound = 2 * lr * (1 + 0.1 * np.abs(p0[k])) + 1e-5
            assert (np.abs(got[k] - w) <= bound).all(), (i, k)
    assert losses[-1] < losses[0]
