"""The port's vectorized SLICE admission (``repro_torch.core.torch_impl``)
held against its counterpart ``repro.core.jax_impl`` and against the
reference Python implementation, as ``tests/test_property.py`` holds the
JAX one: ``task_selection`` (Algorithm 2) over the paper's Fig. 1 l(b)
curve and the numpy ``build_mask_matrix``. Task sets are made with numpy
from a seed. Rates, masks, counts and selections are integers or
booleans and must be equal; ``utility_rate`` and ``period_from_counts``
agree within fp32 rounding (rtol 1e-6).
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import jax_impl  # noqa: E402
from repro.core.latency_model import paper_fig1_model  # noqa: E402
from repro.core.mask_matrix import build_mask_matrix  # noqa: E402
from repro.core.selection import task_selection  # noqa: E402
from repro.core.task import SLOSpec, Task  # noqa: E402
from repro_torch.core import torch_impl  # noqa: E402

LAT = paper_fig1_model()
LAT_TABLE = np.asarray([0.0] + [LAT.decode_ms(b) for b in range(1, 128)],
                       np.float32)


def _tasks(seed):
    """30-2000 ms TPOTs, 0.1-100 utilities, as test_property's strategy;
    some seeds empty or with tied utility rates."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(0, 40))
    tpot = rng.uniform(30.0, 2000.0, n).astype(np.float32)
    util = rng.uniform(0.1, 100.0, n).astype(np.float32)
    if seed % 4 == 0 and n > 3:
        tpot[: n // 2] = 100.0
        util[: n // 2] = 1.0
    return util, tpot


@pytest.mark.parametrize("seed", range(12))
def test_select_tasks_matches_jax_and_reference(seed):
    """The task's effective utility goes in, as test_property passes it;
    one task is invalid, and the reference sees only the valid ones."""
    util, tpot = _tasks(seed)
    tasks = [Task(SLOSpec(tpot_ms=float(t)), utility=float(u))
             for u, t in zip(util, tpot)]
    util = np.asarray([t.effective_utility for t in tasks], np.float32)
    valid = np.ones(len(tasks), bool)
    if len(tasks) > 2:
        valid[1] = False
    sel, order = torch_impl.select_tasks(
        *map(torch.from_numpy, (util, tpot, valid, LAT_TABLE)), v_max=64)
    jsel, jorder = jax_impl.select_tasks(
        *map(jnp.asarray, (util, tpot, valid, LAT_TABLE)), v_max=64)
    np.testing.assert_array_equal(sel.numpy(), np.asarray(jsel))
    np.testing.assert_array_equal(order.numpy(), np.asarray(jorder))
    assert not sel.numpy()[~valid].any()
    ref, _ = task_selection([t for t, ok in zip(tasks, valid) if ok], LAT)
    got = [t for t, s in zip(tasks, sel.numpy()) if s]
    # tie-breaking between equal utility rates may differ: compare counts
    # and utility totals, as test_property does for JAX's
    assert len(got) == len(ref)
    assert sum(t.effective_utility for t in got) == pytest.approx(
        sum(t.effective_utility for t in ref), rel=1e-6)


@pytest.mark.parametrize("seed", range(6))
def test_mask_matrix_and_schedule_match_numpy(seed):
    rng = np.random.default_rng(100 + seed)
    v0 = int(rng.integers(1, 65))
    rates = np.sort(rng.integers(1, v0 + 1, int(rng.integers(1, 65))))[::-1]
    rates[0] = v0
    want = build_mask_matrix(rates.tolist())
    got = torch_impl.build_mask_matrix(torch.from_numpy(rates.copy()), v0)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax_impl.build_mask_matrix(
            jnp.asarray(rates.copy()), v0)))
    sched = torch_impl.cycle_token_schedule(got)
    assert sched.dtype == torch.bool
    np.testing.assert_array_equal(
        sched.numpy(), np.asarray(jax_impl.cycle_token_schedule(
            jnp.asarray(want))))


def test_rates_and_periods_match_jax():
    util, tpot = _tasks(3)
    np.testing.assert_allclose(
        torch_impl.utility_rate(torch.from_numpy(util),
                                torch.from_numpy(tpot)).numpy(),
        np.asarray(jax_impl.utility_rate(jnp.asarray(util),
                                         jnp.asarray(tpot))), rtol=1e-6)
    q = torch_impl.quantized_rates(torch.from_numpy(tpot))
    assert q.dtype == torch.int32
    np.testing.assert_array_equal(
        q.numpy(), np.asarray(jax_impl.quantized_rates(jnp.asarray(tpot))))
    counts = np.random.default_rng(4).integers(-2, 140, (5, 64))
    np.testing.assert_allclose(
        torch_impl.period_from_counts(torch.from_numpy(counts),
                                      torch.from_numpy(LAT_TABLE)).numpy(),
        np.asarray(jax_impl.period_from_counts(jnp.asarray(counts),
                                               jnp.asarray(LAT_TABLE))),
        rtol=1e-6)
