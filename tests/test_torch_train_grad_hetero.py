"""The port's ``loss_fn`` and per-leaf gradients held against
``jax.value_and_grad`` (the contract of ``test_torch_train_grad.py``) for
the SSM, hybrid, MoE and encoder-only registry archs, reduced; remat on
and off give the same loss and gradients, bit for bit; a batch whose
labels are all ignored leaves the MoE aux loss alone.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.models import model as JM  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.training.optimizer import leaves  # noqa: E402
from repro_torch.training.trainer import loss_and_grads  # noqa: E402
from test_torch_train_grad import (HETERO, _batch, _setup,  # noqa: E402
                                   check_loss_and_grads)


@pytest.mark.parametrize("arch", HETERO)
def test_loss_and_grads_match_jax(arch):
    check_loss_and_grads(arch)


@pytest.mark.parametrize("arch", ["smollm-360m", "hymba-1.5b",
                                  "granite-moe-3b-a800m", "hubert-xlarge"])
def test_remat_gives_the_same_loss_and_grads(arch):
    _, cfg, _, tp, x, labels = _setup(arch, seed=1)
    on = loss_and_grads(cfg, tp, _batch(x, labels),
                        TM.ModelOptions(remat=True))
    off = loss_and_grads(cfg, tp, _batch(x, labels),
                         TM.ModelOptions(remat=False))
    assert float(on[0]) == float(off[0])
    for a, b in zip(leaves(on[1]), leaves(off[1])):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_all_labels_ignored_gives_aux_only():
    """Every label -1: the cross-entropy's denominator is clamped to 1, so
    the loss is aux_weight * aux, as in JAX (granite-moe: aux > 0)."""
    jcfg, cfg, jp, tp, x, labels = _setup("granite-moe-3b-a800m", seed=2)
    labels[:] = -1
    jl = JM.loss_fn(jcfg, jp, jnp.asarray(x), jnp.asarray(labels))
    tl = TM.loss_fn(cfg, tp, torch.from_numpy(x), torch.from_numpy(labels))
    assert float(tl.detach()) > 0
    assert abs(float(tl.detach()) - float(jl)) < 1e-6
