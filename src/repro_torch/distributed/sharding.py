"""Sharding of the port over its world: the logical-axis rules of the
model axis (counterpart of ``repro.distributed.sharding``) and the ZeRO
placement of a bucketed optimizer state over the data group.

**The rules.** Model code names each dimension of a parameter or cache
with a *logical* axis (``ParamSpec.axes``); ``DEFAULT_RULES`` maps each name
to mesh axes, and :func:`spec_for` resolves a shape's names on a world with
the JAX package's semantics: a mapping is dropped where the mesh axis does
not divide the dimension, a size-1 axis is ignored, and a mesh axis is used
once per tensor. The port shards only the ``model`` entries of a spec
(:func:`local_shape`, :func:`shard_leaf`, :func:`gather_leaf`); its data
entries keep the port's own meaning: ``batch`` is the rows of a data rank,
``bucket`` the ZeRO-2 shard of the stacked optimizer state over the data
group, and ``d_in`` over ``data`` (the JAX package's FSDP-like weight shard)
is not taken (ROADMAP item 14). ``distributed/tensor_parallel.py`` computes
on the shards.

**ZeRO.** In the JAX package a partition spec tells ``shard_map`` which
state leaves shard along their leading ``L``; here a rank simply holds its
rows. Only the state's top-level ``buckets`` (stacked momentum) and
``slots`` (the rules' ``(L, 1, d_out)`` stripes) shard; a buffer whose
``L`` the group size does not divide (a plan not padded by ``shard_size``)
stays whole on every rank, as the JAX rule table falls back to
replication. Everything else (params, AdamW moments) is replicated over
the data group.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Sequence, Tuple, Union

import torch

from repro_torch.core.types import map_with_path

LogicalAxis = Union[str, None, Tuple[str, ...]]

# logical name -> mesh axis (or tuple of mesh axes): the JAX package's table
# (src/repro/distributed/sharding.py:20-44)
DEFAULT_RULES = {
    "batch": ("pod", "data"),
    "seq": None,                  # activations: sequence replicated by default
    "res_seq": None,              # residual-stream seq axis
    "kv_seq": "model",            # decode KV caches: shard the long axis
    "long_seq": ("data", "model"),  # 500k decode, batch=1: use both axes
    "embed": None,                # d_model on activations
    "vocab": "model",
    "heads": "model",
    "kv_heads": None,             # often < mesh axis; replicate by default
    "mlp": "model",               # d_ff
    "expert": "model",            # expert parallelism
    "d_in": "data",               # FSDP-ish weight shard along fan-in
    "d_inner": "model",           # ssm inner dim
    "layers": None,
    "lora": None,
    "state": None,
    "bucket": "data",             # the stacked optimizer state's leading L
}


def merged_rules(overrides: Optional[Mapping[str, Any]] = None) -> Dict[str, Any]:
    """``DEFAULT_RULES`` with ``overrides`` on top (the JAX package's
    ``axis_rules(mesh, rules)``)."""
    return dict(DEFAULT_RULES, **dict(overrides or {}))


def resolve_axis(name: LogicalAxis, dim_size: int, axes: Mapping[str, int],
                 rules: Mapping[str, Any], used: set, keep_unit: bool = False):
    """The mesh axis (or tuple of axes) one dimension of ``dim_size`` named
    ``name`` is split over, or None (``_resolve_axis``): only axes that
    exist, are larger than 1, are unused in this tensor and divide the
    dimension are kept. ``keep_unit`` keeps size-1 axes too: the shape a
    computation takes when a group of one stands for the axis."""
    if name is None:
        return None
    mapped = rules.get(name, None) if isinstance(name, str) else name
    if mapped is None:
        return None
    chosen = []
    prod = 1
    for ax in ((mapped,) if isinstance(mapped, str) else tuple(mapped)):
        if (ax in axes and (axes[ax] > 1 or keep_unit) and ax not in used
                and dim_size % (prod * axes[ax]) == 0):
            chosen.append(ax)
            prod *= axes[ax]
    used.update(chosen)
    if not chosen:
        return None
    return chosen[0] if len(chosen) == 1 else tuple(chosen)


def spec_for(shape: Sequence[int], names: Sequence[LogicalAxis], axes: Mapping[str, int],
             rules: Optional[Mapping[str, Any]] = None, keep_unit: bool = False) -> tuple:
    """The partition spec of ``shape`` named ``names`` on a world of mesh
    ``axes`` (name -> size): one entry a dimension, None, an axis name or a
    tuple of them, as ``PartitionSpec`` holds them. ``rules`` are the whole
    table (:func:`merged_rules`); None means ``DEFAULT_RULES``."""
    if len(shape) != len(names):
        raise ValueError(f"{len(shape)} dims {tuple(shape)} but {len(names)} names {names}")
    rules = DEFAULT_RULES if rules is None else rules
    used: set = set()
    return tuple(resolve_axis(n, d, axes, rules, used, keep_unit)
                 for d, n in zip(shape, names, strict=True))


def model_dim(shape: Sequence[int], names: Sequence[LogicalAxis], world,
              keep_unit: bool = False) -> Optional[int]:
    """The dimension the rules split over ``model`` on ``world`` (a
    ``launch/mesh.World``), or None. The port takes a model entry alone:
    one that shares its dimension with another mesh axis (``long_seq``)
    raises, as item 14 of ROADMAP.md leaves it for later."""
    spec = spec_for(shape, names, world.axes, world.full_rules, keep_unit)
    found = None
    for i, entry in enumerate(spec):
        axes = (entry,) if isinstance(entry, str) else tuple(entry or ())
        if "model" in axes:
            if len(axes) > 1:
                raise NotImplementedError(
                    f"{names[i]!r} over {axes}: a dimension split over model and another "
                    f"axis together is not ported yet (ROADMAP.md, item 14)")
            found = i
    return found


def local_shape(shape: Sequence[int], names: Sequence[LogicalAxis], world,
                keep_unit: bool = False) -> Tuple[int, ...]:
    """A model rank's shard of ``shape``: the model entry's dimension
    divided by the model axis (data entries are not taken by the port)."""
    dim = model_dim(shape, names, world, keep_unit)
    out = list(shape)
    if dim is not None:
        out[dim] //= world.model_parallel
    return tuple(out)


def _spans(n: int, parts: int, rank: int, fused_halves: bool):
    """(start, length) spans of model rank ``rank``'s share of a dimension
    of ``n``: ``[r n / M, (r + 1) n / M)``, or, for a fused ``[gate; up]``
    dimension whose halves the group divides, the r-th span of each half."""
    if fused_halves and n % 2 == 0 and (n // 2) % parts == 0:
        h = n // 2 // parts
        return [(rank * h, h), (n // 2 + rank * h, h)]
    m = n // parts
    return [(rank * m, m)]


def shard_leaf(x: torch.Tensor, names: Sequence[LogicalAxis], world, rank: int,
               fused_halves: bool = False) -> torch.Tensor:
    """Model rank ``rank``'s shard of the whole tensor ``x`` (a copy; ``x``
    itself where the rules split nothing).
    ``fused_halves`` marks a fused ``[gate; up]`` pair of columns (the
    dense FFN's ``w_in``, the shared experts' ``w_in_shared``):
    rank r holds ``[gate_r; up_r]``, the r-th span of each half, where a
    plain cut would give rank 0 only gate columns."""
    dim = model_dim(tuple(x.shape), names, world)
    if dim is None:
        return x
    spans = _spans(x.shape[dim], world.model_parallel, rank, fused_halves)
    return torch.cat([x.narrow(dim, s, n) for s, n in spans], dim=dim)


def gather_leaf(shards: Sequence[torch.Tensor], names: Sequence[LogicalAxis], world,
                whole_shape: Sequence[int], fused_halves: bool = False) -> torch.Tensor:
    """Inverse of :func:`shard_leaf`: the whole tensor of ``whole_shape``
    from the model ranks' shards, in rank order."""
    dim = model_dim(tuple(whole_shape), names, world)
    if dim is None:
        return shards[0]
    if len(_spans(whole_shape[dim], world.model_parallel, 0, fused_halves)) == 1:
        return torch.cat(list(shards), dim=dim)
    halves = [torch.cat([s.narrow(dim, k * s.shape[dim] // 2, s.shape[dim] // 2)
                         for s in shards], dim=dim) for k in range(2)]
    return torch.cat(halves, dim=dim)


def _is_bucket_leaf(path: str, leaf) -> bool:
    # the state's top-level `buckets`/`slots` field (NamedTuple fields are
    # named `.buckets`); a *parameter* path containing 'buckets' under the
    # AdamW trees must not match
    head = path.split("/", 1)[0].lstrip(".")
    return head in ("buckets", "slots") and getattr(leaf, "ndim", 0) == 3


def bucket_specs(opt_state: Any, world: int) -> Any:
    """Per-leaf shard count of a full optimizer state: ``world`` for a
    stacked bucket or slot stripe whose ``L`` divides, 1 for the rest."""
    return map_with_path(
        lambda path, leaf: world if (_is_bucket_leaf(path, leaf)
                                     and leaf.shape[0] % world == 0) else 1,
        opt_state)


def shard_state(opt_state: Any, comm) -> Any:
    """This rank's view of a full optimizer state: rows ``[rank * L / N,
    (rank + 1) * L / N)`` of every leaf :func:`bucket_specs` shards (a copy,
    so the full buffer can be freed), the other leaves as they are."""
    specs = bucket_specs(opt_state, comm.world)

    def take(_path, leaf, n):
        if n == 1:
            return leaf
        rows = leaf.shape[0] // n
        return leaf[comm.rank * rows:(comm.rank + 1) * rows].clone()

    return map_with_path(take, opt_state, specs)


def gather_state(opt_state: Any, plan, comm) -> Any:
    """Inverse of :func:`shard_state`: the full state on every rank, each
    stacked buffer that holds fewer rows than ``plan`` pads it to
    all-gathered."""
    padded = {b.key: b.padded for b in plan.buckets}
    return map_with_path(
        lambda path, leaf: comm.all_gather(leaf) if (
            _is_bucket_leaf(path, leaf)
            and leaf.shape[0] != padded[path.rsplit("/", 1)[1]]) else leaf,
        opt_state)


def checkpoint_view(opt_state: Any, plan, comm) -> Any:
    """``opt_state`` as one rank of a sharded checkpoint sees it: a stacked
    buffer this rank holds a part of becomes a
    ``repro_torch.checkpoint.manager.Piece`` (its rows of the padded
    bucket), everything else stays a tensor (rank 0 writes it). The same
    tree serves as the restore template."""
    from repro_torch.checkpoint.manager import Piece

    padded = {b.key: b.padded for b in plan.buckets}

    def visit(path, leaf):
        if _is_bucket_leaf(path, leaf) and leaf.shape[0] != padded[path.rsplit("/", 1)[1]]:
            return Piece.rows(leaf, comm.rank, comm.world)
        return leaf

    return map_with_path(visit, opt_state)
