"""ZeRO placement of a bucketed optimizer state over the process group
(mirror of ``repro.distributed.sharding.bucket_specs``).

In the JAX package a partition spec tells ``shard_map`` which state leaves
shard along their leading ``L``; here a rank simply holds its rows. Only the
state's top-level ``buckets`` (stacked momentum) and ``slots`` (the rules'
``(L, 1, d_out)`` stripes) shard; a buffer whose ``L`` the group size does
not divide (a plan not padded by ``shard_size``) stays whole on every rank,
as the JAX rule table falls back to replication. Everything else (params,
AdamW moments) is replicated.
"""
from __future__ import annotations

from typing import Any

from repro_torch.core.types import map_with_path


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
