"""Tensor-parallel collectives of the model (the counterpart of
``repro.models.partitioning``).

In JAX, ``shard(x, dims)`` is a layout hint and GSPMD places the
collectives. In the port every rank runs its own program on its slab of
the weights (``launch.sharding.local_params``), so the hints become the
collectives themselves, Megatron-style:

- ``reduce_model(x)`` sums a partial product over the 'model' axis (after
  wo's and wd's row-parallel products, an MoE slab's share of the
  combine, and the vocabulary-sharded embedding lookup);
- ``gather_model(x, dim)`` puts the ranks' slabs of ``dim`` side by side
  (the vocabulary-sharded logits);
- ``embed_model(table, ids)`` looks ids up in a vocabulary slab;
- ``rms_norm_out_model(g, w, out_proj, width)`` is the SSM mixer's gated
  RMSNorm over a d_inner cut by heads (the rows' sums of squares summed
  over 'model'), then out_proj's row-parallel product, summed;
- ``combine_model_lse(out, lse)`` merges attention outputs over the
  ranks' slices of one sequence (the slot cache's K/V cut over 'model',
  JAX's ``cache_specs``; ``seq_slice(buf_len)`` is this rank's slots):
  an all-reduce MAX of the rows' log-sum-exps, then one all-reduce SUM
  of the reweighted outputs and their weights, packed in one buffer.

Training (``training.trainer.make_train_step(mesh=...)``) runs the same
functions under autograd, where each becomes one of Megatron's conjugate
pairs (``torch.autograd.Function``s; with no gradient to carry they are
the plain collectives above, so a serving step computes the same bits):

- ``enter_model(x)``: identity forward, sum over 'model' backward ("f",
  at the entry of each region cut over 'model': the rank's slab computes
  a partial gradient of its replicated input);
- ``reduce_model(x)``: sum forward, identity backward ("g", at the exit);
  ``enter_model(reduce_model(x))`` sums both ways (the gated norm's sums
  of squares, which every rank's slab reads);
- ``gather_model(x, dim)``: backward keeps the rank's slice;
- ``gather_fsdp(w, name)``: FSDP, the 'data' shards of the weight leaf
  ``name`` side by side (its dim from the installed ``fsdp`` map);
  backward sums the gradient over 'data' and keeps the rank's shard (a
  reduce-scatter: an all-reduce, then ``narrow``);
- ``sum_data(x)``: a sum over the data groups of a batch split over them
  (``split_batch``: the loss's numerator and count, the MoE load-balance
  statistics), identity backward.

The model asks ``cut(name)`` whether a leaf ("wo", "wd", "embed",
"lm_head", the MoE group's "moe.wg", the SSM group's "ssm.out_proj",
...) is cut over 'model' on this
engine, and calls these only where it is; ``model_index()`` is the rank's
place on 'model' (which experts an expert-parallel slab holds, which SSM
heads a rank's slab holds).

The batch over 'data' (JAX's ``batch_spec``): a decode or verify step of
B rows, or a slot prefill's batch, is cut into ``data`` row blocks when
B divides, and ``batch_rows(B)`` is then this rank's block (None: every
data group computes every row, as JAX's ``bshard = None``);
``gather_data(*xs)`` puts the blocks side by side on every rank, on
``mesh.data_group``. A
mesh with a 'pod' axis (``launch.mesh.make_production_mesh(multi_pod=
True)``) folds ('pod', 'data') into one data axis, pod-major, as
``launch.mesh.batch_axes`` shards a batch over both: its ``data_group``
spans both axes.

Without a context installed (``with activation_partitioning(mesh, cut):
...``, around a tensor-parallel engine's steps) nothing is cut and no
batch is split, so every model function is exactly the single-device
function. With one, the model's collectives run on ``mesh.model_group``
even over a single rank: a one-rank mesh cuts every leaf into one slab
and takes the collective path too.

A gather is an all-reduce of a zero-filled full-width buffer in which
each rank has written its slab: exact (x + 0 = x), and the one collective
gloo also runs on CUDA tensors.

``recording(fn)`` calls ``fn(kind, axis, tensor)`` before each collective
("all-reduce" for ``reduce_model``, ``enter_model``'s backward,
``sum_data``, ``sum_grads`` and each of ``rms_norm_out_model``'s and
``combine_model_lse``'s two, "all-gather" for the gathers, with the
full-width buffer the ranks all-reduce, "reduce-scatter" for
``gather_fsdp``'s backward), in either direction: what
``launch.collective_stats`` counts.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

_CTX = None     # the installed activation_partitioning
_RECORD = None  # the installed recording's fn(kind, axis, tensor)


class activation_partitioning:
    """Context manager: ``with activation_partitioning(mesh, cut): ...``
    installs ``mesh`` (a ``launch.mesh.ServingMesh``) for the collectives
    below and ``cut``, the names of the leaves cut over 'model'
    (``launch.sharding.cut_leaves``). A training step adds ``fsdp``, the
    dim (from the end) of each leaf, by the same names, that is cut over
    'data' (``launch.sharding.train_layout``), and ``split_batch``: the
    step's batch is this rank's rows of a batch split over the data
    groups, so its loss and MoE statistics are summed over them."""

    def __init__(self, mesh, cut=(), fsdp: Optional[Dict[str, int]] = None,
                 split_batch: bool = False):
        self.mesh = mesh
        self.cut = frozenset(cut)
        self.fsdp = dict(fsdp or {})
        self.split_batch = split_batch
        self._prev = None

    def __enter__(self):
        global _CTX
        self._prev, _CTX = _CTX, self
        return self

    def __exit__(self, *exc):
        global _CTX
        _CTX = self._prev
        return False


def cut(name: str) -> bool:
    """Whether the leaf ``name`` is cut over 'model' (never without a
    context)."""
    return _CTX is not None and name in _CTX.cut


def model_index() -> int:
    """This rank's place on the 'model' axis (0 without a context)."""
    return 0 if _CTX is None else _CTX.mesh.coords["model"]


class recording:
    """Context manager: ``with recording(fn): ...`` calls ``fn(kind, axis,
    tensor)`` before each collective of the functions below: kind
    "all-reduce" or "all-gather", axis "model" or "data", the tensor the
    ranks all-reduce."""

    def __init__(self, fn):
        self.fn = fn
        self._prev = None

    def __enter__(self):
        global _RECORD
        self._prev, _RECORD = _RECORD, self.fn
        return self

    def __exit__(self, *exc):
        global _RECORD
        _RECORD = self._prev
        return False


def data_axis(mesh) -> Tuple[int, int]:
    """(data groups, this rank's group) of ``mesh``: ('pod', 'data')
    folded, pod-major, where it has a 'pod' axis."""
    ways, index = 1, 0
    for a in ("pod", "data"):
        if a in mesh.shape:
            index = index * mesh.shape[a] + mesh.coords[a]
            ways *= mesh.shape[a]
    return ways, index


def batch_rows(batch: int):
    """This rank's rows of a batch of ``batch`` rows split over 'data' (a
    slice), or None where the batch is not split: without a context, with
    one data group, or when the groups do not divide it."""
    if _CTX is None:
        return None
    ways, d = data_axis(_CTX.mesh)
    if ways == 1 or batch % ways:
        return None
    n = batch // ways
    return slice(d * n, (d + 1) * n)


def seq_slice(buf_len: int):
    """This rank's slots of a slot cache of ``buf_len`` slots cut by
    sequence over 'model' (a slice; JAX's ``cache_specs``), or None where
    the sequence is not cut: without a context, or when 'model' does not
    divide ``buf_len``."""
    if _CTX is None:
        return None
    ways = _CTX.mesh.shape["model"]
    if buf_len % ways:
        return None
    n = buf_len // ways
    r = _CTX.mesh.coords["model"]
    return slice(r * n, (r + 1) * n)


def data_ways() -> int:
    """The data groups a training batch is split over (``split_batch``),
    1 otherwise."""
    if _CTX is None or not _CTX.split_batch:
        return 1
    return data_axis(_CTX.mesh)[0]


def _weighed(out: torch.Tensor, lse: torch.Tensor,
             m: torch.Tensor) -> torch.Tensor:
    """[out * w | w] in f32, w = exp(lse - m): one slice's share of a
    merge whose rows' largest log-sum-exp is ``m``."""
    w = torch.exp(lse - m)[..., None]
    return torch.cat([out.float() * w, w], -1)


def _merged(total: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The slices' shares summed -> sum(out * w) / max(sum(w), 1e-30)."""
    return (total[..., :-1] / total[..., -1:].clamp(min=1e-30)).to(dtype)


def merge_lse(parts) -> torch.Tensor:
    """``combine_model_lse``'s arithmetic over (out, lse) pairs held in one
    process (the slices' outputs side by side): what the tests and the
    card's check hold the collective version's arithmetic to."""
    m = torch.stack([lse for _, lse in parts]).amax(0)
    total = sum(_weighed(out, lse, m) for out, lse in parts)
    return _merged(total, parts[0][0].dtype)


def combine_model_lse(out: torch.Tensor, lse: torch.Tensor) -> torch.Tensor:
    """Attention over the ranks' slices of one sequence, put together:
    ``out`` [..., hd] this rank's output over its slots, ``lse`` [...] f32
    each row's log-sum-exp of the scores it kept (-1e30 where it kept
    none). With M the rows' largest lse over 'model' and weights
    w = exp(lse - M), the result is sum(out * w) / max(sum(w), 1e-30), in
    out's type: two all-reduces, MAX of lse, then SUM of [out * w | w]
    in one f32 buffer. A rank that kept nothing for a row weighs 0 there
    (whatever its out). ``out`` itself without a context."""
    if _CTX is None:
        return out
    group = _CTX.mesh.model_group
    m = lse.clone()
    if _RECORD is not None:
        _RECORD("all-reduce", "model", m)
    dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
    total = _weighed(out, lse, m)
    if _RECORD is not None:
        _RECORD("all-reduce", "model", total)
    dist.all_reduce(total, group=group)
    return _merged(total, out.dtype)


def _grad(x: torch.Tensor) -> bool:
    """Whether ``x`` carries a gradient here: the collectives are then
    autograd Functions, else the plain (in-place) ones."""
    return torch.is_grad_enabled() and x.requires_grad


def _all_reduce(x: torch.Tensor, axis: str, group,
                kind: str = "all-reduce") -> torch.Tensor:
    """Sum ``x`` over ``group`` in place (recorded as ``kind`` on
    ``axis``)."""
    if _RECORD is not None:
        _RECORD(kind, axis, x)
    dist.all_reduce(x, group=group)
    return x


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.clone(), "model", ctx.group), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        group = (_CTX.mesh.model_group if axis == "model"
                 else _CTX.mesh.data_group)
        return _all_reduce(x.clone(), axis, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def enter_model(x: torch.Tensor) -> torch.Tensor:
    """x itself; under autograd with a context, its gradient is summed
    over the 'model' axis in the backward (the entry of a region cut over
    'model', whose slabs each give a part of it)."""
    if _CTX is None or not _grad(x):
        return x
    return _Enter.apply(x, _CTX.mesh.model_group)


def reduce_model(x: torch.Tensor) -> torch.Tensor:
    """Sum of x over the 'model' axis (in place without a gradient to
    carry); x itself without a context. The backward passes the gradient
    of the sum through unchanged: every rank's copy of the sum feeds the
    same computation."""
    if _CTX is None:
        return x
    if _grad(x):
        return _Reduce.apply(x, "model")
    return _all_reduce(x, "model", _CTX.mesh.model_group)


def sum_data(x: torch.Tensor) -> torch.Tensor:
    """Sum of x over the data groups of a batch split over them
    (``split_batch``); x itself otherwise. Identity backward, as
    ``reduce_model``'s."""
    if data_ways() == 1:
        return x
    if _grad(x):
        return _Reduce.apply(x, "data")
    return _all_reduce(x, "data", _CTX.mesh.data_group)


def sum_grads(xs: List[torch.Tensor], axis: str) -> None:
    """Sum each of ``xs`` (gradients: no autograd) over ``axis`` ("model";
    "data", the data groups of the batch; "pod"), in place, in one
    collective over one flat buffer."""
    if _CTX is None or not xs:
        return
    mesh = _CTX.mesh
    group = {"model": mesh.model_group, "data": mesh.data_group,
             "pod": getattr(mesh, "pod_group", None)}[axis]
    flat = xs[0].new_empty(sum(x.numel() for x in xs))
    at = 0
    for x in xs:       # each copied in, views of strided slices included
        flat[at:at + x.numel()].view_as(x).copy_(x)
        at += x.numel()
    _all_reduce(flat, axis, group)
    at = 0
    for x in xs:
        x.copy_(flat[at:at + x.numel()].view_as(x))
        at += x.numel()


def _gather(x: torch.Tensor, dim: int, axis: str, ways: int, index: int,
            group) -> torch.Tensor:
    """The slabs of ``dim`` over ``axis`` (``ways`` of them, this rank's
    at ``index``) side by side, in axis order."""
    n = x.shape[dim]
    shape = list(x.shape)
    shape[dim] = n * ways
    full = x.new_zeros(shape)
    full.narrow(dim, index * n, n).copy_(x)
    if _RECORD is not None:
        _RECORD("all-gather", axis, full)
    dist.all_reduce(full, group=group)
    return full


class _Gather(torch.autograd.Function):
    """Forward: the slabs of ``dim`` over ``axis`` side by side. Backward:
    the rank's slice of the gradient, over 'model' as it is (every rank's
    copy feeds the same computation); over 'data' (FSDP) summed first,
    each data group having taken its own part of the batch."""

    @staticmethod
    def forward(ctx, x, dim, axis, ways, index, group):
        ctx.args = (dim, axis, x.shape[dim], index, group)
        return _gather(x, dim, axis, ways, index, group)

    @staticmethod
    def backward(ctx, g):
        dim, axis, n, index, group = ctx.args
        if axis == "data":
            g = _all_reduce(g.contiguous().clone(), axis, group,
                            "reduce-scatter")
        return (g.narrow(dim, index * n, n).contiguous(),
                None, None, None, None, None)


def gather_model(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The ranks' slabs of ``dim`` side by side, in rank order; x itself
    without a context."""
    if _CTX is None:
        return x
    mesh = _CTX.mesh
    args = (dim, "model", mesh.shape["model"], mesh.coords["model"],
            mesh.model_group)
    return _Gather.apply(x, *args) if _grad(x) else _gather(x, *args)


def gather_fsdp(x: torch.Tensor, name: str) -> torch.Tensor:
    """The weight leaf ``name`` (a whole stacked leaf or one layer of it)
    with its shards over 'data' side by side, where the installed
    ``fsdp`` map cuts it (FSDP); x itself otherwise. Over the 'data' axis
    alone: a mesh with a 'pod' axis keeps a copy of the weights a pod."""
    dim = None if _CTX is None else _CTX.fsdp.get(name)
    if dim is None:
        return x
    mesh = _CTX.mesh
    args = (dim, "data", mesh.shape["data"], mesh.coords["data"],
            mesh.fsdp_group)
    return _Gather.apply(x, *args) if _grad(x) else _gather(x, *args)


def sum_earlier_groups(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` (no gradient: counts) over the data groups before
    this rank's, in data order, of a batch split over them
    (``split_batch``): zeros in the first group, and without a split. One
    gather over the data groups."""
    ways = data_ways()
    if ways == 1:
        return torch.zeros_like(x)
    index = data_axis(_CTX.mesh)[1]
    every = _gather(x.detach()[None], 0, "data", ways, index,
                    _CTX.mesh.data_group)
    return every[:index].sum(0, dtype=x.dtype)


def gather_data(*xs: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Each of ``xs`` (one type; rows on dim 0, this data group's
    ``batch_rows``) with every data group's rows, in data order, all in
    one collective; ``xs`` themselves without a context."""
    if _CTX is None:
        return xs
    n = xs[0].shape[0]
    full = _gather(torch.cat([x.reshape(n, -1) for x in xs], 1), 0, "data",
                   *data_axis(_CTX.mesh), _CTX.mesh.data_group)
    out, at = [], 0
    for x in xs:
        w = x[0].numel()
        out.append(full[:, at:at + w].reshape(-1, *x.shape[1:]))
        at += w
    return tuple(out)


def embed_model(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Rows ``ids`` of an embedding whose vocabulary is cut over 'model':
    this rank's slab ``table`` holds ids [r*n, (r+1)*n); ids outside it
    look up zeros, and the sum over the axis puts every row together
    exactly. Without a context, a plain lookup."""
    if _CTX is None:
        return table[ids.long()]
    n = table.shape[0]
    local = ids.long() - _CTX.mesh.coords["model"] * n
    hit = (local >= 0) & (local < n)
    x = table[local.clamp(0, n - 1)].masked_fill(~hit[..., None], 0)
    return reduce_model(x)


def rms_norm_out_model(g: torch.Tensor, w: torch.Tensor,
                       out_proj: torch.Tensor, width: int,
                       eps: float = 1e-5) -> torch.Tensor:
    """``layers.rms_norm(g, w, eps) @ out_proj`` of a dim of ``width`` cut
    over 'model': ``g`` [..., n] and ``w`` [n] this rank's slab of it,
    ``out_proj`` [n, D] its rows. Two all-reduces: the rows' sums of
    squares of g (f32 [..., 1]), then, with the rank's slab normed as
    ``layers.rms_norm`` norms it (mean = sum / width), the partial product
    with out_proj, in g's type. The same arithmetic without a context.
    Every rank's slab reads the sums of squares, so under autograd their
    gradient is summed over 'model' too."""
    dt = g.dtype
    gf = g.float()
    ss = enter_model(reduce_model((gf * gf).sum(-1, keepdim=True)))
    y = (gf * torch.rsqrt(ss / width + eps) * (1.0 + w.float())).to(dt)
    return reduce_model(y @ out_proj)
