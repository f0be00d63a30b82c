"""Elastic restart: move a training state between process groups of
different size (mirror of ``repro.distributed.elastic``).

The checkpoint manager stores :func:`state_layout` beside the state: the
rule, its slots, the bucket plan and the shard size the state is laid out
for. The ZeRO-2 bucketed state is the one part of a checkpoint whose shapes
depend on the group size: every stacked momentum bucket and slot stripe is
allocated at ``padded = ceil(L / N) * N``. :func:`reshard_bucketed_state`
unpads each to its true ``L`` under the writing plan and repads it under
the plan for ``N'``; pad slices are zero, so not one real slice changes.
The int8 error-feedback residual, one row per writer rank, is re-laid by
``compression.reshard_error``. Layouts that differ in anything but the
shard size cannot be resharded, and :func:`validate_relayout` names both.
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.core import bucketing
from repro_torch.core.types import Optimizer, PyTree, map_with_path


class LayoutMismatchError(ValueError):
    """A checkpoint's state layout cannot be restored onto this run's."""


def plan_layout(plan: bucketing.BucketPlan) -> List[Dict[str, Any]]:
    """JSON-serializable signature of a bucket plan: bucket keys, true and
    padded sizes, and every entry's path and shape."""
    return [{"key": b.key, "d_in": b.d_in, "d_out": b.d_out,
             "size": b.size, "padded": b.padded,
             "entries": [{"path": e.path, "shape": list(e.shape)}
                         for e in b.entries]}
            for b in plan.buckets]


def state_layout(opt: Optimizer, params: PyTree, *, mesh_size: int,
                 rule: str, compress: bool = False,
                 opt_state: Any = None) -> Dict[str, Any]:
    """The layout manifest entry the checkpoint manager stores at save time,
    the same JSON as the JAX package's for the same optimizer and params."""
    plan = opt.bucket_plan(params) if opt.bucket_plan is not None else None
    slots = (sorted(getattr(opt_state, "slots", {}) or {})
             if opt_state is not None else [])
    return {"format": 1,
            "mesh_size": int(mesh_size),
            "shard_size": int(getattr(opt, "shard_size", 1) or 1),
            "rule": rule,
            "slots": slots,
            "compress": bool(compress),
            "plan": plan_layout(plan) if plan is not None else None}


def _reshardable_part(layout: Dict[str, Any]) -> Dict[str, Any]:
    """The layout minus what depends on the mesh size (``mesh_size``,
    ``shard_size``, per-bucket ``padded``) and minus ``compress``."""
    plan = layout.get("plan")
    return {"rule": layout.get("rule"),
            "slots": list(layout.get("slots") or []),
            "plan": ([{k: v for k, v in b.items() if k != "padded"}
                      for b in plan] if plan is not None else None)}


def validate_relayout(old: Optional[Dict[str, Any]],
                      new: Dict[str, Any]) -> None:
    """Raise :class:`LayoutMismatchError` unless ``old`` differs from
    ``new`` at most in the mesh/shard size. The error names both layouts in
    full: a checkpoint written by another rule or for another param tree is
    never coerced."""
    if old is None:
        raise LayoutMismatchError(
            "checkpoint has no layout manifest (written before elastic "
            "restart existed?) but the mesh size cannot be verified — "
            f"re-save it with a layout; this run's layout:\n"
            f"  {json.dumps(new, sort_keys=True)}")
    a, b = _reshardable_part(old), _reshardable_part(new)
    if a != b:
        fields = [k for k in a if a[k] != b[k]]
        raise LayoutMismatchError(
            f"checkpoint layout is not resharding-compatible with this run "
            f"— {', '.join(fields)} differ (only the mesh/shard size may):\n"
            f"  checkpoint layout: {json.dumps(old, sort_keys=True)}\n"
            f"  this run's layout: {json.dumps(new, sort_keys=True)}")


def check_restorable(old: Optional[Dict[str, Any]], new: Dict[str, Any]) -> bool:
    """The restore gate: True when the checkpoint restores as it is (no
    layout, or this run's shard size; the manager then checks every leaf's
    path, shape and dtype), False when it needs :func:`restore_resharded`.
    Raises only where :func:`validate_relayout` does: a checkpoint of another
    shard size that differs in anything else."""
    if old is None or int(old.get("shard_size", 1)) == int(new["shard_size"]):
        return True
    validate_relayout(old, new)
    return False


# ---------------------------------------------------------------------------
# the reshard transform itself
# ---------------------------------------------------------------------------

def _check_same_stacking(old_plan: bucketing.BucketPlan,
                         new_plan: bucketing.BucketPlan) -> None:
    def stacking(plan):
        return tuple((b.key, b.size, b.entries) for b in plan.buckets)

    if stacking(old_plan) != stacking(new_plan):
        raise LayoutMismatchError(
            "bucket plans stack different leaves — the state belongs to a "
            "different param tree and cannot be resharded:\n"
            f"  checkpoint plan: {json.dumps(plan_layout(old_plan))}\n"
            f"  this run's plan: {json.dumps(plan_layout(new_plan))}")


def reshard_bucketed_state(state: Any, old_plan: bucketing.BucketPlan,
                           new_plan: bucketing.BucketPlan) -> Any:
    """Re-lay a full bucketed optimizer state out for another shard size:
    every stacked buffer (momentum and each slot stripe) is unpadded under
    ``old_plan`` and repadded under ``new_plan``; the other fields (the
    AdamW moments) pass through, as does a state with no ``buckets``."""
    buckets = getattr(state, "buckets", None)
    if buckets is None:
        return state
    _check_same_stacking(old_plan, new_plan)
    new_buckets = bucketing.repad_buckets(
        new_plan, bucketing.unpad_buckets(old_plan, buckets))
    new_slots = {
        name: bucketing.repad_buckets(
            new_plan, bucketing.unpad_buckets(old_plan, per_bucket))
        for name, per_bucket in getattr(state, "slots", {}).items()}
    return state._replace(buckets=new_buckets, slots=new_slots)


def _old_mesh_comp_template(comp_state: Any, n_old: int) -> Any:
    """The writer group's residual as the checkpoint holds it: each leaf
    ``(n_old, *shape)``, one row per writer rank (shape-only tensors)."""
    import torch
    return map_with_path(lambda _p, e: torch.empty((n_old,) + tuple(e.shape),
                                                   dtype=e.dtype, device="meta"),
                         comp_state)


def restore_resharded(mgr: Any, step: int, params: PyTree, opt_state: Any,
                      comp_state: Any, *, opt_new: Optimizer, opt_old: Optimizer,
                      comm) -> Tuple[Any, int]:
    """Restore a ZeRO-2 ``(params, opt_state, comp_state)`` checkpoint
    written under ``opt_old``'s layout onto this rank of ``comm`` under
    ``opt_new``'s. ``params``, ``opt_state`` and ``comp_state`` are this
    rank's templates (their structure and devices); the bucketed state is
    read whole, resharded (:func:`reshard_bucketed_state`) and sliced to
    this rank's rows, and the residual rows are re-laid by
    ``compression.reshard_error`` (sum-preserving, zero to zero bit for
    bit). Returns ``((params, opt_state, comp_state), data_step)``."""
    import torch

    from repro_torch.checkpoint.manager import to_tensor
    from repro_torch.distributed import compression
    from repro_torch.distributed.sharding import shard_state

    n_old = int(getattr(opt_old, "shard_size", 1) or 1)
    n_new = int(getattr(opt_new, "shard_size", 1) or 1)
    by_path, data_step = mgr.read_arrays(step)

    def whole(prefix, tree):
        return map_with_path(
            lambda path, t: to_tensor(*by_path[f"{prefix}/{path}"], t.device), tree)

    params = whole("0", params)
    opt_state = shard_state(reshard_bucketed_state(
        whole("1", opt_state), opt_old.bucket_plan(params),
        opt_new.bucket_plan(params)), comm)
    if comp_state is not None:
        def stored(path, want):
            arr = by_path[f"2/{path}"][0]
            if tuple(arr.shape) != tuple(want.shape):
                raise LayoutMismatchError(
                    f"checkpoint step {step}: residual {path!r} has shape "
                    f"{tuple(arr.shape)}, expected {tuple(want.shape)} for "
                    f"{n_old} writer ranks")
            return arr
        errors = map_with_path(stored, _old_mesh_comp_template(comp_state, n_old))
        rows = compression.reshard_error(errors, n_old, n_new)
        comp_state = map_with_path(
            lambda _p, e, r: torch.from_numpy(r[comm.rank]).to(e.device),
            comp_state, rows)
    return (params, opt_state, comp_state), data_step
