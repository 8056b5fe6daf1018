"""Where the port's training path meets the rest of it, on the CPU.

- The kernel wrappers (``kernels.ops``) refuse an input that requires
  grad under autograd, the same call under ``torch.no_grad()`` runs: no
  kernel has a backward, and on the card a launch would cut the graph.
- ``forward`` under autograd calls no wrapper (every wrapper patched to
  record its calls), for the SSM, hybrid and MoE archs and chunked
  attention.
- Both engines serve the parameters straight from ``train_step`` (they
  require grad), equal to an engine on a detached copy.
- The CLI trains a reduced model in a subprocess with no ``jax`` in
  ``sys.modules``.
- Checkpoints: a JAX ``save`` restores here equal to ``load_params`` bit
  for bit, a port ``save`` round-trips through JAX's ``restore``, the
  keys are JAX's (``blocks|moe|.wg``), a shape mismatch raises.
"""
from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.training import checkpoint as jckpt  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import task as ttask  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.serving.executor import (PagedTorchExecutor,  # noqa: E402
                                          TorchExecutor)
from repro_torch.training import checkpoint as tckpt  # noqa: E402
from repro_torch.training.optimizer import leaves  # noqa: E402
from repro_torch.training.trainer import (loss_and_grads,  # noqa: E402
                                          make_train_step)

ROOT = Path(__file__).resolve().parents[1]


def _f(*shape):
    return torch.randn(*shape)


def _i(*vals):
    return torch.tensor(vals, dtype=torch.int32)


# each wrapper's smallest valid CPU call: (float inputs, call)
WRAPPERS = {
    "paged_decode_attention": (
        lambda: (_f(1, 2, 8), _f(3, 1, 4, 8), _f(3, 1, 4, 8)),
        lambda q, k, v: ops.paged_decode_attention(q, k, v, _i([0, 1]),
                                                   _i(5))),
    "paged_verify_attention": (
        lambda: (_f(1, 2, 2, 8), _f(3, 1, 4, 8), _f(3, 1, 4, 8)),
        lambda q, k, v: ops.paged_verify_attention(q, k, v, _i([0, 1]),
                                                   _i(3))),
    "decode_attention": (
        lambda: (_f(1, 2, 8), _f(1, 1, 6, 8), _f(1, 1, 6, 8)),
        lambda q, k, v: ops.decode_attention(q, k, v, _i([0, 1, 2, 3, 4, 5]),
                                             _i(5))),
    "flash_prefill_chunk": (
        lambda: (_f(1, 2, 2, 8), _f(1, 6, 1, 8), _f(1, 6, 1, 8)),
        lambda q, k, v: ops.flash_prefill_chunk(q, k, v, _i(3))),
    "flash_prefill": (
        lambda: (_f(1, 4, 2, 8), _f(1, 4, 1, 8), _f(1, 4, 1, 8)),
        lambda q, k, v: ops.flash_prefill(q, k, v)),
    "ssd_scan": (
        lambda: (_f(1, 5, 2, 4), _f(1, 5, 2), _f(2), _f(1, 5, 3),
                 _f(1, 5, 3), _f(2), _f(2)),
        lambda *a: ops.ssd_scan(*a)),
    "ssd_decode_step": (
        lambda: (_f(1, 2, 4), _f(1, 2), _f(2), _f(1, 3), _f(1, 3), _f(2),
                 _f(2)),
        lambda *a: ops.ssd_decode_step(*a, torch.zeros(2, 2, 4, 3), _i(0),
                                       torch.tensor([True]))),
    "moe_grouped_ffn": (
        lambda: (_f(2, 3, 4), _f(2, 4, 5), _f(2, 4, 5), _f(2, 5, 4)),
        lambda *a: ops.moe_grouped_ffn(*a)),
    "add_rms_norm": (
        lambda: (_f(2, 8), _f(2, 8), _f(8)),
        lambda x, d, w: ops.add_rms_norm(x, d, w, 1e-5)),
    "rope_kv_write": (
        lambda: (_f(1, 2, 8), _f(1, 1, 8), _f(1, 1, 8), _f(4),
                 _f(3, 1, 4, 8), _f(3, 1, 4, 8)),
        lambda q, k, v, fr, kp, vp: ops.rope_kv_write(
            q, k, v, _i(5), fr, kp, vp, torch.tensor([1]),
            torch.tensor([2]))),
    "silu_mul": (
        lambda: (_f(2, 8), _f(2, 8)),
        lambda g, u: ops.silu_mul(g, u)),
}


def test_every_wrapper_is_listed():
    assert set(WRAPPERS) == set(ops.LAUNCHES)


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_wrapper_refuses_autograd(name):
    make, call = WRAPPERS[name]
    inputs = make()
    call(*inputs)                            # nothing requires grad: runs
    for i in range(len(inputs)):
        args = [t.clone().requires_grad_(j == i)
                for j, t in enumerate(inputs)]
        with pytest.raises(RuntimeError, match="has no backward"):
            call(*args)
        with torch.no_grad():
            call(*args)


@pytest.fixture
def no_wrapper_calls(monkeypatch):
    calls = []
    for name in ops.LAUNCHES:
        monkeypatch.setattr(ops, name,
                            lambda *a, _n=name, **k: calls.append(_n))
    return calls


@pytest.mark.parametrize("arch,S", [("mamba2-780m", 70), ("hymba-1.5b", 20),
                                    ("granite-moe-3b-a800m", 20),
                                    ("smollm-360m", 2100)])
def test_forward_under_grad_calls_no_wrapper(no_wrapper_calls, arch, S):
    """smollm at S = 2100 takes the chunked attention (``resolve_attn``)."""
    cfg = get_config(arch).reduced()
    params = make_train_step(cfg, device="cpu")[0](0)[0]
    toks = torch.randint(0, cfg.vocab_size, (1, S),
                         generator=torch.Generator().manual_seed(0))
    loss, grads = loss_and_grads(cfg, params,
                                 {"inputs": toks, "labels": toks},
                                 TM.ModelOptions(remat=True))
    assert torch.isfinite(loss)
    assert all(g.abs().sum() > 0 for g in leaves(grads))
    assert no_wrapper_calls == []


def _serve(ex, n_steps=3):
    tasks = [ttask.Task(ttask.SLOSpec(tpot_ms=100.0), 1.0, prompt_len=n,
                        output_len=8, task_id=i)
             for i, n in enumerate((5, 9))]
    logits = []
    for t in tasks:
        ex.prefill(t)
        logits.append(ex.last_prefill_logits)
    for _ in range(n_steps):
        ex.decode(tasks)
        logits.append(ex.last_logits)
    return logits


@pytest.mark.parametrize("arch", ["smollm-360m", "mamba2-780m"])
def test_engines_serve_params_from_train_step(arch):
    cfg = get_config(arch).reduced()
    init_state, train_step = make_train_step(cfg, device="cpu", peak_lr=1e-2,
                                             warmup=1)
    state = init_state(1)
    toks = torch.randint(0, cfg.vocab_size, (2, 16),
                         generator=torch.Generator().manual_seed(1))
    state, _ = train_step(state, {"inputs": toks, "labels": toks})
    params = state[0]
    assert all(p.requires_grad for p in leaves(params))
    copy = TM.load_params(cfg, _numpy(params), device="cpu")
    for make in (lambda p: TorchExecutor(cfg, params=p, max_slots=2,
                                         max_seq=32, device="cpu"),
                 lambda p: PagedTorchExecutor(cfg, params=p, n_pages=8,
                                              page_size=8, max_seq=32,
                                              max_batch=2, device="cpu")):
        got, want = _serve(make(params)), _serve(make(copy))
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def _numpy(tree):
    return {k: _numpy(v) if isinstance(v, dict) else v.detach().numpy()
            for k, v in tree.items()}


def test_cli_trains_without_jax():
    code = ("import sys; from repro_torch.launch import train; "
            "r = train.run(train.parse_args(['--reduced', '--device', 'cpu', "
            "'--steps', '3', '--batch', '2', '--seq', '16'])); "
            "assert len(r.losses) == 3 and r.peak_bytes is None; "
            "assert not [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'repro.'))], 'jax imported'")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "step    0 loss=" in out.stdout and "tokens/s" in out.stdout


def _pair(arch, seed=5):
    jcfg = jax_config(arch).reduced()
    cfg = get_config(arch).reduced()
    jp = JM.init_params(jcfg, jax.random.PRNGKey(seed))
    tree = jax.tree_util.tree_map(np.asarray, jp)
    return jcfg, cfg, jp, tree


def _flat_np(tree):
    return {k: np.asarray(v) for k, v in jckpt._flatten(tree)[0].items()}


def test_jax_checkpoint_restores_bit_for_bit(tmp_path):
    """JAX ``save`` of granite-moe's (reduced) params and AdamW state ->
    port ``restore`` equals ``load_params`` bit for bit, the state too."""
    _, cfg, jp, tree = _pair("granite-moe-3b-a800m")
    js = jopt.adamw(1e-3)[0](jp)
    path = str(tmp_path / "jax.npz")
    jckpt.save(path, (jp, js))
    like = make_train_step(cfg, device="cpu")[0](0)
    params, state = tckpt.restore(path, like)
    assert set(tckpt._flatten(like)) == set(jckpt._flatten((jp, js))[0])
    want = TM.load_params(cfg, tree, device="cpu")
    for a, b in zip(leaves(params), leaves(want)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert state.step.dtype == torch.int32 and int(state.step) == 0


def test_port_checkpoint_round_trips_through_jax(tmp_path):
    """Port ``save`` (hymba: SSM and attention groups) -> JAX ``restore``
    into JAX's own pytree, equal bit for bit; the keys carry the JAX
    NamedTuple fields' dots."""
    _, cfg, jp, tree = _pair("hymba-1.5b")
    tp = TM.load_params(cfg, tree, device="cpu")
    path = str(tmp_path / "port.npz")
    tckpt.save(path, tp)
    assert "blocks|ssm|.in_proj" in np.load(path).files
    got = jckpt.restore(path, jp)
    for k, v in _flat_np(got).items():
        np.testing.assert_array_equal(v, _flat_np(jp)[k], err_msg=k)
    back = tckpt.restore(path, tp)
    for a, b in zip(leaves(back), leaves(tp)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_moe_keys_are_jax_keys():
    _, cfg, jp, _ = _pair("granite-moe-3b-a800m")
    keys = set(tckpt._flatten(TM.init_params(cfg, device="cpu")))
    assert "blocks|moe|.wg" in keys
    assert keys == set(jckpt._flatten(jp)[0])


def test_checkpoint_shape_mismatch_raises(tmp_path):
    path = str(tmp_path / "ck.npz")
    tckpt.save(path, {"a": torch.ones(2)})
    with pytest.raises(ValueError, match="ckpt mismatch at a"):
        tckpt.restore(path, {"a": torch.ones(3)})
