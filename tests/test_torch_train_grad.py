"""The port's ``loss_fn`` and the gradient of every parameter leaf
(``training.trainer.loss_and_grads``, autograd) held against
``jax.value_and_grad`` of the JAX ``loss_fn``, on the same weights and
batch, fp32 on the CPU: the dense-attention registry archs, reduced,
embedding inputs among them, labels with -1 (ignored) entries; the SSM,
hybrid, MoE and encoder archs are in ``test_torch_train_grad_hetero.py``.

The loss agrees within 1e-5. Each leaf's gradient agrees within 1e-4 of
that leaf's largest |g| (a gradient is a sum over the batch and the
sequence, so its error scales with its leaf's magnitude, not with each
component's), and a leaf JAX leaves at zero (``embed`` of an
embedding-input arch with an untied head) is zero here too. Remat on and
off give the same loss and gradients, bit for bit (in the other file).
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.training.checkpoint import _flatten as jax_flatten  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.registry import list_archs  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.training.checkpoint import _flatten  # noqa: E402
from repro_torch.training.optimizer import leaves  # noqa: E402
from repro_torch.training.trainer import loss_and_grads  # noqa: E402

HETERO = ("hymba-1.5b", "granite-moe-3b-a800m", "llama4-scout-17b-a16e",
          "hubert-xlarge", "mamba2-780m")
ARCHS = [a for a in list_archs() if a not in HETERO]


def _setup(arch, B=2, S=20, seed=0):
    jcfg = jax_config(arch).reduced()
    cfg = get_config(arch).reduced()
    jp = JM.init_params(jcfg, jax.random.PRNGKey(11))
    tp = TM.load_params(cfg, jax.tree_util.tree_map(np.asarray, jp),
                        device="cpu")
    for p in leaves(tp):
        p.requires_grad_(True)
    rng = np.random.default_rng(seed)
    if cfg.embedding_inputs:
        x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    else:
        x = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels[rng.random((B, S)) < 0.25] = -1
    labels[0, -1] = -1
    return jcfg, cfg, jp, tp, x, labels


def _batch(x, labels):
    return {"inputs": torch.from_numpy(x), "labels": torch.from_numpy(labels)}


def check_loss_and_grads(arch):
    """Loss within 1e-5; each leaf's gradient within 1e-4 of the leaf's
    largest |g|; JAX's zero leaves zero here."""
    jcfg, cfg, jp, tp, x, labels = _setup(arch)
    jopts = JM.ModelOptions(remat=True)
    jl, jg = jax.value_and_grad(
        lambda p: JM.loss_fn(jcfg, p, jnp.asarray(x), jnp.asarray(labels),
                             jopts))(jp)
    tl, tg = loss_and_grads(cfg, tp, _batch(x, labels),
                            TM.ModelOptions(remat=True))
    assert abs(float(tl) - float(jl)) < 1e-5, (float(tl), float(jl))
    want, _ = jax_flatten(jax.tree_util.tree_map(np.asarray, jg))
    got = _flatten(tg)
    assert set(got) == set(want)
    for key, w in want.items():
        g = got[key].numpy()
        scale = float(np.abs(w).max())
        if scale == 0.0:
            assert key == "embed" and cfg.embedding_inputs, key
            assert not g.any(), key
            continue
        err = float(np.abs(g - w).max())
        assert err <= 1e-4 * scale, (key, err, scale)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch):
    check_loss_and_grads(arch)
