"""Generic shape-bucketed optimizer engine (mirror of ``repro.core.engine``),
parameterized by a :class:`repro_torch.core.rules.MatrixUpdateRule`.

State layout (:class:`BucketedState`): ``buckets`` maps bucket key -> the
stacked ``(padded L, d_in, d_out)`` momentum; ``slots`` maps slot name ->
bucket key -> the rule's extra stripes. The port runs unsharded; the ZeRO
entry points (``bucket_apply_sharded``, ``sharded_apply``) come with ROADMAP
Queue 1, item 6.
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import torch

from repro_torch.core import bucketing
from repro_torch.core.rules import MatrixUpdateRule
from repro_torch.core.types import Optimizer, Schedule

_MOMENTUM_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class BucketedState(NamedTuple):
    """Uniform bucketed optimizer state for the whole rule family."""
    buckets: Dict[str, torch.Tensor]
    slots: Dict[str, Dict[str, torch.Tensor]] = {}


class BucketedEngine:
    """The rule-agnostic machinery of a bucketed matrix optimizer."""

    def __init__(self, rule: MatrixUpdateRule, lr: Schedule, *,
                 momentum_dtype: str = "float32",
                 predicate=None, strict: bool = False):
        if momentum_dtype not in _MOMENTUM_DTYPES:
            raise ValueError(f"momentum_dtype must be float32 or bfloat16, "
                             f"got {momentum_dtype!r}")
        self.rule = rule
        self.lr = lr
        self.mdtype = _MOMENTUM_DTYPES[momentum_dtype]
        self.predicate = predicate
        self.strict = strict
        self.plans = bucketing.PlanCache()

    # -- plan / state ---------------------------------------------------
    def plan(self, params) -> bucketing.BucketPlan:
        return self.plans.get(
            bucketing.plan_signature(params, self.predicate),
            lambda: bucketing.build_plan(params, predicate=self.predicate,
                                         strict=self.strict))

    def init_state(self, plan: bucketing.BucketPlan, device=None) -> BucketedState:
        buckets = bucketing.init_buckets(plan, self.mdtype, device=device)
        slots: Dict[str, Dict[str, torch.Tensor]] = {}
        for b in plan.buckets:
            for name, (shape, dtype) in self.rule.slot_shapes(
                    b.padded, b.d_in, b.d_out).items():
                slots.setdefault(name, {})[b.key] = torch.zeros(
                    shape, dtype=dtype, device=device)
        return BucketedState(buckets=buckets, slots=slots)

    def scale(self, bucket: bucketing.Bucket, step) -> torch.Tensor:
        """lr(step) * rms_lr_scale as a 0-d fp32 tensor on the CPU."""
        from repro_torch.core.rmnp import rms_lr_scale
        return self.lr(step) * rms_lr_scale((bucket.d_in, bucket.d_out))

    def _slots_of(self, slots, key) -> Dict[str, torch.Tensor]:
        return {name: per_bucket[key] for name, per_bucket in slots.items()}

    # -- two-pass (update + apply_updates) ------------------------------
    def update_buckets(self, plan, g_b, p32_b, buckets, slots, step):
        """Per-bucket fp32 updates for the two-pass path: ``(upd_b, v_b,
        slots_b)``."""
        upd_b, v_b = {}, {}
        slots_b: Dict[str, Dict[str, torch.Tensor]] = {n: {} for n in slots}
        for b in plan.buckets:
            sl = self._slots_of(slots, b.key)
            scale = self.scale(b, step)
            if self.rule.additive:
                d, v_new, sl_new = self.rule.precondition(
                    g_b[b.key], buckets[b.key], sl, step=step)
                upd = -scale * (d + self.rule.weight_decay * p32_b[b.key])
            else:
                w_new, v_new, sl_new = self.rule.apply(
                    g_b[b.key], buckets[b.key], p32_b[b.key], sl,
                    scale=scale, step=step)
                upd = w_new - p32_b[b.key]
            upd_b[b.key], v_b[b.key] = upd, v_new
            for name in sl_new:
                slots_b[name][b.key] = sl_new[name]
        return upd_b, v_b, slots_b

    # -- single-pass fused apply ----------------------------------------
    def bucket_apply(self, bucket, g, v, sl, w, step):
        """Fused apply of one stacked bucket: ``g``, ``v`` and ``w`` are full
        ``(padded L, ...)`` operands. Returns ``(w_new, v_new, sl_new)``."""
        for name, t in (("gradient", g), ("momentum", v), ("weight", w)):
            if t.shape[0] != bucket.padded:
                raise ValueError(
                    f"bucket {bucket.key!r}: {name} operand has {t.shape[0]} "
                    f"slices, expected the padded bucket size {bucket.padded}")
        return self.rule.apply(g, v, w, sl, scale=self.scale(bucket, step),
                               step=step)

    def apply_buckets(self, plan, g_b, p_b, buckets, slots, step):
        """Loop :meth:`bucket_apply` over the plan: ``(w_b, v_b, slots_b)``."""
        w_b, v_b = {}, {}
        slots_b: Dict[str, Dict[str, torch.Tensor]] = {n: {} for n in slots}
        for b in plan.buckets:
            w_b[b.key], v_new, sl_new = self.bucket_apply(
                b, g_b[b.key], buckets[b.key], self._slots_of(slots, b.key),
                p_b[b.key], step)
            v_b[b.key] = v_new
            for name in sl_new:
                slots_b[name][b.key] = sl_new[name]
        return w_b, v_b, slots_b


def _device_of(params):
    from repro_torch.core.types import tree_paths
    leaves = tree_paths(params)
    return leaves[0][1].device if leaves else None


def matrix_optimizer(rule: MatrixUpdateRule, lr: Schedule, *,
                     momentum_dtype: str = "float32",
                     fused_apply: bool = False) -> Optimizer:
    """Bucketed optimizer over a pure-matrix tree for any registered rule."""
    eng = BucketedEngine(rule, lr, momentum_dtype=momentum_dtype, strict=True)

    def init(params):
        return eng.init_state(eng.plan(params), device=_device_of(params))

    def update(grads, state, params, step):
        plan = eng.plan(params)
        g_b = bucketing.gather(plan, grads, dtype=torch.float32)
        p_b = bucketing.gather(plan, params, dtype=torch.float32)
        upd_b, v_b, s_b = eng.update_buckets(plan, g_b, p_b, state.buckets,
                                             state.slots, step)
        updates = bucketing.scatter(plan, upd_b, params)
        return updates, BucketedState(buckets=v_b, slots=s_b)

    def update_apply(grads, state, params, step):
        """Single-pass fused apply: params are gathered per bucket in their
        own dtype, updated in one rule pass, and scattered back."""
        plan = eng.plan(params)
        g_b = bucketing.gather(plan, grads, dtype=torch.float32)
        p_b = bucketing.gather(plan, params)
        w_b, v_b, s_b = eng.apply_buckets(plan, g_b, p_b, state.buckets,
                                          state.slots, step)
        new_params = bucketing.scatter(plan, w_b, params, cast=True)
        return new_params, BucketedState(buckets=v_b, slots=s_b)

    return Optimizer(init=init, update=update,
                     update_apply=update_apply if fused_apply else None,
                     bucket_plan=eng.plan)
