"""The port's dry-run (``repro_torch.launch.{specs,dryrun,roofline,mesh}``)
held against the JAX package's (``repro.launch``).

- Every (arch x shape) cell's parameters and inputs have JAX's shapes and
  types (``repro.launch.specs``, abstract: no compile).
- ``model_flops_global`` equals JAX's exactly.
- ``argument_size_in_bytes_spec``, per leaf, equals the bytes JAX's
  ``param_specs``, ``cache_specs``, ``batch_spec`` and ``opt_state_specs``
  give a device, at the (16, 16) and (2, 16, 16) meshes; and its sum
  equals the ``argument_size_in_bytes`` of a compiled JAX record
  (smollm-360m decode_32k on the pod mesh, compiled in a subprocess with
  512 host devices on a mesh of Auto axes: ``jax.make_mesh``'s default
  Explicit axes make JAX's own dry-run fail under jax 0.9).
- For archs whose layers are all alike the extrapolation from 1- and
  2-layer variants equals the direct count (reduced configs, 3 layers,
  small shapes, a (2, 2) stand-in mesh).
- Meta tensors take the kernels' plain versions; meta mixed with the CPU
  raises. The multi-pod mesh folds ('pod', 'data') into one data axis.
"""
from __future__ import annotations

import dataclasses
import functools
import os
import subprocess
import sys
import types

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402
from jax.tree_util import DictKey, GetAttrKey, tree_flatten_with_path  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.launch import roofline as JR  # noqa: E402
from repro.launch import sharding as JS  # noqa: E402
from repro.launch import specs as JSP  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.training.optimizer import adamw as jax_adamw  # noqa: E402
from repro_torch.configs import (ASSIGNED_ARCHS, SHAPES, InputShape,  # noqa: E402
                                 get_config)
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch import roofline as TR  # noqa: E402
from repro_torch.launch import specs as SP  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh, make_stand_in_mesh  # noqa: E402
from repro_torch.models import partitioning as P  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELLS = [(a, s) for a in ASSIGNED_ARCHS for s in SHAPES]
RUN_CELLS = [(a, s) for a, s in CELLS
             if SP.skip_reason(get_config(a), s) is None]
MESHES = [(16, 16), (2, 16, 16)]
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "int32": torch.int32}


def fake_mesh(shape):
    axes = ("pod", "data", "model") if len(shape) == 3 else ("data", "model")
    return types.SimpleNamespace(shape=dict(zip(axes, shape)),
                                 axis_names=axes,
                                 coords=dict.fromkeys(axes, 0))


def jax_leaves(tree, prefix=""):
    """{dotted path: leaf} of a JAX tree (NamedTuple fields by name;
    PartitionSpecs are leaves)."""
    flat, _ = tree_flatten_with_path(tree,
                                     is_leaf=lambda x: isinstance(x, JP))
    out = {}
    for path, leaf in flat:
        keys = [k.key if isinstance(k, DictKey) else k.name
                if isinstance(k, GetAttrKey) else str(k) for k in path]
        out[prefix + ".".join(keys)] = leaf
    return out


@functools.lru_cache(maxsize=None)
def jax_params(arch):
    return jax.eval_shape(lambda: JM.init_params(
        jax_config(arch), jax.random.PRNGKey(0), JSP.PARAM_DTYPE))


def jax_cell(arch, shape, mesh):
    """JAX's build_cell argument tree and spec tree, by path."""
    cfg, B = jax_config(arch), shape.global_batch
    params = jax_params(arch)
    p_spec = JS.param_specs(cfg, mesh, train=shape.kind == "train")
    ins = JSP.input_specs(cfg, shape)
    if shape.kind == "train":
        opt = jax.eval_shape(jax_adamw(1e-4)[0], params)
        tree = {"params": params, "opt": opt, "inputs": ins["inputs"],
                "labels": ins["labels"]}
        specs = {"params": p_spec, "opt": JS.opt_state_specs(p_spec),
                 "inputs": JS.batch_spec(mesh, B, ins["inputs"].ndim),
                 "labels": JS.batch_spec(mesh, B, 2)}
    elif shape.kind == "prefill":
        tree = {"params": params, "inputs": ins["inputs"]}
        specs = {"params": p_spec,
                 "inputs": JS.batch_spec(mesh, B, ins["inputs"].ndim)}
    else:
        tree = {"params": params, "cache": ins["cache"],
                "tokens": ins["tokens"]}
        specs = {"params": p_spec, "tokens": JS.batch_spec(mesh, B, 1),
                 "cache": JS.cache_specs(
                     cfg, mesh, B, buf_len=JSP.decode_buf_len(cfg, shape))}
    return jax_leaves(tree), jax_leaves(specs)


def jax_spec_bytes(arch, shape, mesh):
    leaves, specs = jax_cell(arch, shape, mesh)
    out = {}
    for path, sds in leaves.items():
        ways = 1
        for axes in specs[path]:
            for a in ((axes,) if isinstance(axes, str) else axes or ()):
                ways *= mesh.shape[a]
        n = sds.size * sds.dtype.itemsize
        assert n % ways == 0, (path, sds.shape, specs[path])
        out[path] = n // ways
    return out


@pytest.mark.parametrize("arch,shape", CELLS,
                         ids=[f"{a}-{s.name}" for a, s in CELLS])
def test_cell_shapes_equal_jax(arch, shape):
    cfg, jcfg = get_config(arch), jax_config(arch)
    mine = dict(D._leaves({"params": SP.param_specs_struct(cfg)}))
    theirs = jax_leaves({"params": jax_params(arch)})
    if shape.kind == "decode" and cfg.is_encoder_only:
        with pytest.raises(AssertionError):
            JSP.input_specs(jcfg, shape)
        with pytest.raises(ValueError):
            SP.input_specs(cfg, shape)
        assert "encoder-only" in SP.skip_reason(cfg, shape)
    else:
        mine.update(D._leaves(SP.input_specs(cfg, shape)))
        theirs.update(jax_leaves(JSP.input_specs(jcfg, shape)))
    assert sorted(mine) == sorted(theirs)
    for path, t in mine.items():
        assert t.device.type == "meta", path
        assert tuple(t.shape) == tuple(theirs[path].shape), path
        assert t.dtype == DTYPES[str(theirs[path].dtype)], path


@pytest.mark.parametrize("arch,shape", CELLS,
                         ids=[f"{a}-{s.name}" for a, s in CELLS])
def test_model_flops_global_equal_jax(arch, shape):
    assert TR.model_flops_global(arch, shape.name) == \
        JR.model_flops_global(arch, shape.name)


@pytest.mark.parametrize("mesh_shape", MESHES,
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("arch,shape", RUN_CELLS,
                         ids=[f"{a}-{s.name}" for a, s in RUN_CELLS])
def test_spec_bytes_leaf_by_leaf_equal_jax(arch, shape, mesh_shape):
    mesh = fake_mesh(mesh_shape)
    cell = D.build_cell(get_config(arch), shape, mesh)
    assert D.spec_leaf_bytes(cell, mesh) == jax_spec_bytes(arch, shape,
                                                           mesh)


_JAX_RECORD = """
import repro.launch.dryrun as D   # forces 512 host devices before jax init
import jax
from jax.sharding import AxisType
from repro.configs import get_config, get_shape
from repro.launch.mesh import batch_axes
from repro.models.partitioning import activation_partitioning
mesh = jax.make_mesh((16, 16), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
fn, args, shard = D.build_cell(get_config("smollm-360m"),
                               get_shape("decode_32k"), mesh)
with mesh, activation_partitioning(batch_axes(mesh), "model"):
    c = jax.jit(fn, in_shardings=shard).lower(*args).compile()
print("ARG", c.memory_analysis().argument_size_in_bytes)
"""


def test_spec_bytes_equal_compiled_jax_record():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    cp = subprocess.run([sys.executable, "-c", _JAX_RECORD], env=env,
                        capture_output=True, text=True, timeout=600,
                        cwd=REPO)
    assert cp.returncode == 0, cp.stderr[-2000:]
    arg = int(cp.stdout.split("ARG")[-1])
    mesh = fake_mesh((16, 16))
    cell = D.build_cell(get_config("smollm-360m"),
                        dict((s.name, s) for s in SHAPES)["decode_32k"], mesh)
    assert sum(D.spec_leaf_bytes(cell, mesh).values()) == arg == 722_397_120


SMALL = (InputShape("t", 16, 4, "train"), InputShape("p", 16, 4, "prefill"),
         InputShape("d", 32, 4, "decode"))


@pytest.mark.parametrize("arch", ["smollm-360m", "granite-moe-3b-a800m",
                                  "mamba2-780m", "hymba-1.5b",
                                  "hubert-xlarge"])
def test_extrapolation_equals_direct_count(arch):
    cfg = dataclasses.replace(get_config(arch).reduced(), n_layers=3)
    with make_stand_in_mesh({"data": 2, "model": 2}) as mesh:
        for shape in SMALL:
            if SP.skip_reason(cfg, shape):
                continue
            rec = D.count_cell(cfg, shape, mesh)
            ext = D.cost_extrapolate(cfg, shape, mesh)
            assert rec["flops_per_device"] > 0, shape.kind
            assert ext["flops_per_device_extrap"] == rec["flops_per_device"]
            assert ext["bytes_per_device_extrap"] == rec["bytes_per_device"]
            assert ext["collective_bytes_extrap"] == \
                rec["collectives"]["total"]
            assert ext["flops_nonlayer"] >= 0
            # the batch of 4 splits over 2 data groups in JAX's specs: the
            # port's train step, encoder forward, slot prefill and decode
            # split it too (the rows, the cache's rows and slots: no
            # departure), and no step is a departure of its own any more
            deps = rec["departures"]
            assert not any(d.startswith(("train:", "forward")) for d in deps)
            assert not any(
                d.startswith(("cache.length", "cache.k", "cache.v",
                              "cache.kv_pos", "tokens", "inputs", "labels"))
                or "data > 1" in d for d in deps), deps
            assert rec["argument_size_in_bytes_spec"] > 0
    assert not torch.distributed.is_initialized()


def test_meta_tensors_take_the_plain_versions():
    meta = dict(device="meta", dtype=torch.bfloat16)
    q, k, v = (torch.empty(2, 37, h, 64, **meta) for h in (6, 2, 2))
    before = dict(ops.LAUNCHES)
    out = ops.flash_prefill(q, k, v, causal=True)
    assert out.device.type == "meta" and out.shape == q.shape
    assert ops.LAUNCHES == before
    with pytest.raises(ValueError, match="mixed devices"):
        ops.flash_prefill(q, torch.zeros_like(k, device="cpu"), v,
                          causal=True)


def test_production_mesh_folds_pod_into_data():
    with make_production_mesh(multi_pod=True) as mesh:
        assert mesh.shape == {"pod": 2, "data": 16, "model": 16}
        assert mesh.coords == {"pod": 0, "data": 0, "model": 0}
        dist = torch.distributed
        assert dist.get_world_size() == 512
        assert dist.get_world_size(mesh.model_group) == 16
        assert dist.get_world_size(mesh.data_group) == 32
        seen = []
        with P.activation_partitioning(mesh), P.recording(
                lambda *a: seen.append(a)):
            assert P.batch_rows(64) == slice(0, 2)
            assert P.batch_rows(48) is None
            (full,) = P.gather_data(torch.empty(2, 3, device="meta"))
        assert full.shape == (64, 3)
        assert [(k, ax, tuple(t.shape)) for k, ax, t in seen] == \
            [("all-gather", "data", (64, 3))]
    assert not torch.distributed.is_initialized()
    with make_production_mesh() as mesh:
        assert mesh.shape == {"data": 16, "model": 16}
        assert torch.distributed.get_world_size(mesh.data_group) == 16
