"""Tensor parallelism over the model group: the model axis of the port
(where the JAX package's ``logical(...)`` constraints and GSPMD split
parameters, activations and caches over ``model``).

A :class:`ModelAxis` is one rank's view of the model group: its ``Comm``,
the logical-axis rules (``distributed/sharding.py``) and, for a config, the
shard of every parameter (:class:`LeafShard`). Storage follows the rules
exactly; the computation may gather. The layers read the axis of the step
that runs them from :func:`current` (set by :func:`use`; process-wide, so
that a recomputation under ``torch.utils.checkpoint`` on autograd's device
thread sees it too). Without an axis every layer is the single-rank code.

With an axis, a dimension that the rules map to ``model`` and that the
group divides is split, a group of one included (:meth:`ModelAxis.splits`):
on one card a world of ``(1, 1)`` runs every collective of the model-axis
code through the backend, and each is an identity there, so the step keeps
the single-rank bits. Only the loss (``_ce_terms`` at one rank, the
vocab-parallel cross-entropy above) and the decode's attention (the
single-rank softmax at one rank, the split-sequence merge above) change
their arithmetic with the group's size.

The collectives as autograd functions (Megatron's conjugate pairs):

    copy_to_model       identity forward, all-reduce backward: a replicated
                        tensor entering computation split over the group
    reduce_from_model   all-reduce forward, identity backward: the sum of
                        the group's partial products (row-split weights)
    gather_from_model   all-gather along a dimension forward; backward
                        ``"sum"``: the rank's span of the group's summed
                        gradients (a reduce-scatter), when each rank's
                        gradient is a part; ``"slice"``: its span alone,
                        when each rank's gradient is the whole one
    vocab_parallel_embed  the masked lookup of the rank's vocabulary rows,
                        summed over the group

and :func:`vocab_parallel_ce`, the cross-entropy over logits split by
vocabulary: the local max and its max all-reduce, the sum of exponentials
and its all-reduce, the gold logit from the rank that holds it. Every sum
over ranks is in rank order (``distributed/comm.py``).

The model axis covers GQA and MLA attention, the dense FFN and the MoE FFN
(``heads``, ``mlp``, ``vocab``, ``kv_seq``, ``expert``). A config with an
SSM mixer (``d_inner``), a batch-1 cache (``long_seq``), or an optimizer
other than RMNP and AdamW raises ``NotImplementedError`` at a model group
above one (ROADMAP.md, item 14).
The optimizer reads the axis of the step as the layers do
(:func:`optimizer_axis`).
"""
from __future__ import annotations

import contextlib
import copy
from typing import Any, Dict, List, Mapping, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.distributed import sharding

ITEM = "ROADMAP.md, Queue 1, item 14 (logical-axis sharding over a model axis)"
# the logical names the port shards over model
SLICE_NAMES = ("heads", "mlp", "vocab", "kv_seq", "expert")
# the mixers and FFNs whose parameters the port computes on over a model group
MIXERS = ("gqa", "mla")
FFNS = ("dense", "moe", "none")

_STACK: List[Optional["ModelAxis"]] = []


@contextlib.contextmanager
def use(axis: Optional["ModelAxis"]):
    """Run the block under ``axis`` (None: the single-rank code)."""
    _STACK.append(axis)
    try:
        yield axis
    finally:
        _STACK.pop()


def current() -> Optional["ModelAxis"]:
    return _STACK[-1] if _STACK else None


class LeafShard(NamedTuple):
    """One parameter on the model axis: its whole and local shapes, the
    dimension split over the group (None: replicated), and whether its
    split columns are a fused ``[gate; up]`` pair (:func:`is_fused_pair`)."""
    whole: Tuple[int, ...]
    local: Tuple[int, ...]
    dim: Optional[int]
    names: Tuple
    fused_halves: bool

    @property
    def row_split(self) -> bool:
        """Split along ``d_in`` (axis -2): RMNP's column norm then spans the
        group."""
        return self.dim is not None and self.dim == len(self.whole) - 2


def check_rules(overrides: Optional[Mapping[str, Any]]) -> None:
    """The overrides the port takes: a name the port shards mapped to
    ``model`` or to nothing. Any other mapping raises."""
    for name, value in (overrides or {}).items():
        axes = (value,) if isinstance(value, str) else tuple(value or ())
        if name in SLICE_NAMES and axes in ((), ("model",)):
            continue
        if name not in SLICE_NAMES and value == sharding.DEFAULT_RULES.get(name):
            continue
        raise NotImplementedError(
            f"rule {name}={value!r}: the port maps only {', '.join(SLICE_NAMES)} to "
            f"'model' or to nothing; the rest keep their default ({ITEM})")


def is_fused_pair(names: Sequence, dim: Optional[int]) -> bool:
    """Whether a leaf named ``names`` and split along ``dim`` holds a fused
    ``[gate; up]`` pair there: its columns (the last dim) are the split dim
    and are named ``mlp`` (the dense FFN's ``w_in``, the shared experts'
    ``w_in_shared``). An expert stack is split along ``expert``, never so."""
    return dim is not None and dim == len(names) - 1 and names[dim] == "mlp"


def leaf_table(cfg, world) -> Dict[str, LeafShard]:
    """path -> :class:`LeafShard` of every parameter of ``cfg`` on
    ``world`` (a ``launch/mesh.World``), size-1 model groups split one way."""
    from repro_torch.core.types import map_with_path, tree_paths
    from repro_torch.models.model import build_param_specs

    out: Dict[str, LeafShard] = {}

    def visit(path, spec):
        dim = sharding.model_dim(spec.shape, spec.axes, world, True)
        out[path] = LeafShard(
            tuple(spec.shape), sharding.local_shape(spec.shape, spec.axes, world, True),
            dim, tuple(spec.axes), is_fused_pair(spec.axes, dim))
        return spec

    specs = build_param_specs(cfg)
    map_with_path(visit, specs)
    assert set(out) == {p for p, _ in tree_paths(specs)}
    return out


def check_supported(cfg, size: int) -> None:
    """Raise ``NotImplementedError`` (naming item 14) where ``cfg`` has a
    part the model axis does not shard yet and the model group has more than one
    rank. (A batch-1 cache's ``long_seq`` over data and model raises where
    its shape is cut: ``distributed/sharding.model_dim``.)"""
    if size <= 1:
        return
    mixers = {m for m, _ in cfg.pattern} - set(MIXERS)
    ffns = {f for _, f in cfg.pattern} - set(FFNS)
    why = []
    if mixers:
        why.append(f"mixers {sorted(mixers)}")
    if ffns:
        why.append(f"FFNs {sorted(ffns)}")
    if why:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(why)} are not sharded over a model group yet "
            f"({ITEM})")


def check_optimizer(kind: str, size: int) -> None:
    """RMNP and AdamW run on shards; the Newton-Schulz rules do not yet."""
    if size > 1 and kind not in ("rmnp", "adamw"):
        raise NotImplementedError(
            f"optimizer {kind!r} on a model group of {size}: Muon and the rest of the "
            f"Newton-Schulz rules are not sharded yet ({ITEM})")


def optimizer_axis(kind: str) -> Optional["ModelAxis"]:
    """The current model axis as the optimizer of rule ``kind`` reads it.
    RMNP reads it at any size: its row-split leaves take the cross-rank norm
    and the learning-rate scale the whole shapes. Another rule raises on a
    group above one (:func:`check_optimizer`) and, on a group of one, where
    every leaf is whole, runs the single-rank code (None)."""
    axis = current()
    if axis is None:
        return None
    check_optimizer(kind, axis.size)
    return axis if kind == "rmnp" else None


class ModelAxis:
    """One rank's model group: ``comm`` (a ``distributed.comm.Comm``), the
    world it belongs to, and the shards of ``cfg``'s parameters."""

    def __init__(self, comm, world, cfg=None):
        check_rules(world.rules)
        if comm.world != world.model_parallel:
            raise ValueError(f"a model group of {comm.world} ranks for a world whose "
                             f"model axis is {world.model_parallel}")
        self.comm = comm
        self.world = world
        self.size = comm.world
        self.rank = comm.rank
        self.rules = world.full_rules
        self.leaves = leaf_table(cfg, world) if cfg is not None else {}
        # what an optimizer's bucket plan reads of the axis
        self.plan_key = (self.size, tuple(sorted(
            (path, leaf.whole, leaf.dim) for path, leaf in self.leaves.items())))
        self.decode_len: Optional[int] = None

    def with_cache_len(self, n: Optional[int]) -> "ModelAxis":
        """This axis for decode steps over a cache of ``n`` positions (a
        rank holds ``n / M`` of them where the group divides ``n``)."""
        out = copy.copy(self)
        out.decode_len = n
        return out

    def cache_len(self, span: int) -> int:
        """The whole length of a decode cache of which this rank holds
        ``span`` positions."""
        if self.decode_len is None:
            if self.size == 1:
                return span
            raise ValueError("a decode step on a model group needs the cache's length: "
                             "make_serve_step(cfg, world, cache_len=...)")
        want = (self.decode_len // self.size if self.splits("kv_seq", self.decode_len)
                else self.decode_len)
        if span != want:
            raise ValueError(f"a rank's cache holds {span} positions; a cache of "
                             f"{self.decode_len} on {self.size} model ranks gives {want}")
        return self.decode_len

    def __repr__(self) -> str:
        return f"ModelAxis(rank={self.rank}, size={self.size})"

    def splits(self, name: str, dim: int) -> bool:
        """Whether the rules split a dimension of ``dim`` named ``name``
        over the group (a group of one too)."""
        mapped = self.rules.get(name)
        axes = (mapped,) if isinstance(mapped, str) else tuple(mapped or ())
        return axes == ("model",) and dim % self.size == 0

    def leaf(self, path: str) -> Optional[LeafShard]:
        return self.leaves.get(path)

    def is_split(self, path: str) -> bool:
        leaf = self.leaves.get(path)
        return leaf is not None and leaf.dim is not None


def axis_for(cfg, world_comm) -> Optional[ModelAxis]:
    """The model axis of a step built for ``world_comm`` (a
    ``distributed.comm.WorldComm``; None: the single-rank code)."""
    if world_comm is None:
        return None
    check_supported(cfg, world_comm.model.world)
    return ModelAxis(world_comm.model, world_comm.mesh, cfg)


# ---------------------------------------------------------------------------
# The collectives as autograd functions
# ---------------------------------------------------------------------------

class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.all_reduce(g.contiguous()), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm):
        return comm.all_reduce(x.contiguous())

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, dim, grad):
        ctx.comm, ctx.dim, ctx.grad, ctx.n = comm, dim % x.ndim, grad, x.shape[dim]
        return comm.all_gather_dim(x.contiguous(), dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        if ctx.grad == "sum":
            out = ctx.comm.reduce_scatter_dim(g.contiguous(), ctx.dim)
        else:
            out = g.narrow(ctx.dim, ctx.comm.rank * ctx.n, ctx.n)
        return out.contiguous(), None, None, None


class _VocabEmbed(torch.autograd.Function):
    """Rows ``ids - start`` of the rank's vocabulary shard ``table`` where
    they fall inside it, zeros elsewhere; the backward adds each gradient row
    into the table row it came from (``index_put_`` with accumulation, the
    op autograd runs for ``table[ids]``)."""

    @staticmethod
    def forward(ctx, table, ids, start):
        local = ids.long() - start
        inside = (local >= 0) & (local < table.shape[0])
        local = torch.where(inside, local, torch.zeros_like(local))
        ctx.save_for_backward(local, inside)
        ctx.shape = table.shape
        rows = table[local]
        return torch.where(inside[..., None], rows, torch.zeros_like(rows))

    @staticmethod
    def backward(ctx, g):
        local, inside = ctx.saved_tensors
        g = torch.where(inside[..., None], g, torch.zeros_like(g))
        grad = g.new_zeros(ctx.shape).index_put_((local,), g, accumulate=True)
        return grad, None, None


def copy_to_model(x: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
    return _CopyToModel.apply(x, axis.comm)


def reduce_from_model(x: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
    return _ReduceFromModel.apply(x, axis.comm)


def gather_from_model(x: torch.Tensor, axis: ModelAxis, dim: int,
                      grad: str = "sum") -> torch.Tensor:
    if grad not in ("sum", "slice"):
        raise ValueError(f"grad must be 'sum' or 'slice', got {grad!r}")
    return _GatherFromModel.apply(x, axis.comm, dim, grad)


def vocab_parallel_embed(table: torch.Tensor, ids: torch.Tensor,
                         axis: ModelAxis) -> torch.Tensor:
    """The embedding of ``ids`` from the vocabulary-split table: each rank
    looks up the ids it holds, the group sums."""
    start = axis.rank * table.shape[0]
    return reduce_from_model(_VocabEmbed.apply(table, ids, start), axis)


class _VocabCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels, mask, start, comm):
        lf = logits.float()
        m = comm.all_reduce_max(torch.amax(lf, dim=-1))
        e = torch.exp(lf - m[..., None])
        s = comm.all_reduce(torch.sum(e, dim=-1))
        logz = m + torch.log(s)
        local = labels.long() - start
        own = (local >= 0) & (local < lf.shape[-1])
        local = torch.where(own, local, torch.zeros_like(local))
        gold = torch.gather(lf, -1, local[..., None])[..., 0]
        gold = comm.all_reduce(torch.where(own, gold, torch.zeros_like(gold)))
        ctx.save_for_backward(e, s, local, own, mask)
        ctx.dtype = logits.dtype
        return torch.sum((logz - gold) * mask)

    @staticmethod
    def backward(ctx, g):
        e, s, local, own, mask = ctx.saved_tensors
        grad = e / s[..., None]
        grad.scatter_add_(-1, local[..., None], -own.float()[..., None])
        grad = grad * (g * mask)[..., None]
        return grad.to(ctx.dtype), None, None, None, None


def vocab_parallel_ce(logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor,
                      axis: ModelAxis) -> torch.Tensor:
    """``sum((logsumexp(logits) - logits[label]) * mask)`` over logits
    split by vocabulary (``models/model._ce_terms`` on the gathered
    logits)."""
    return _VocabCE.apply(logits, labels, mask, axis.rank * logits.shape[-1], axis.comm)


def complete_sums(paths: Sequence[str], values: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Per-leaf sums of squares (leaf ``paths[i]``'s in ``values[i]``) made
    whole over the current model axis: the entries of leaves split over the
    group are summed over it (one all-reduce, rank order), the replicated
    ones counted once as they are."""
    axis = current()
    values = list(values)
    idx = [i for i, p in enumerate(paths) if axis is not None and axis.is_split(p)]
    if not idx:
        return values
    total = axis.comm.all_reduce(torch.stack([values[i] for i in idx]))
    for j, i in enumerate(idx):
        values[i] = total[j]
    return values
