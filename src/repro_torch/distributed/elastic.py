"""The state-layout manifest of a checkpoint (mirror of the layout half of
``repro.distributed.elastic``).

The checkpoint manager stores :func:`state_layout` beside the state: the
rule, its slots, the bucket plan and the shard size the state is laid out
for. A restore compares it with this run's layout. The port trains on one
device, so its shard size is 1; a checkpoint written for another shard size
would need its buckets resharded, which comes with ZeRO-2 (ROADMAP Queue 1,
item 6), so :func:`check_restorable` refuses it and never reshards.
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

from repro_torch.core import bucketing
from repro_torch.core.types import Optimizer, PyTree


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


def check_restorable(old: Optional[Dict[str, Any]], new: Dict[str, Any]) -> None:
    """The port's restore gate: a checkpoint with no layout, or one whose
    shard size equals this run's, restores as it is (the manager then checks
    every leaf's path, shape and dtype). A checkpoint written for another
    shard size is refused, after :func:`validate_relayout` has named any
    other difference: resharding it is ZeRO-2's work."""
    if old is None or int(old.get("shard_size", 1)) == int(new["shard_size"]):
        return
    validate_relayout(old, new)
    raise LayoutMismatchError(
        f"checkpoint was written for shard size {old.get('shard_size')} and "
        f"this run's is {new['shard_size']}; resharding the bucketed state is "
        f"not ported yet (ROADMAP Queue 1, item 6: ZeRO-2 data parallel)")
