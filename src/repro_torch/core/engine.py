"""Generic shape-bucketed optimizer engine (mirror of ``repro.core.engine``),
parameterized by a :class:`repro_torch.core.rules.MatrixUpdateRule`.

State layout (:class:`BucketedState`): ``buckets`` maps bucket key -> the
stacked ``(padded L, d_in, d_out)`` momentum; ``slots`` maps slot name ->
bucket key -> the rule's extra ``(padded L, 1, d_out)`` stripes. Under ZeRO
a rank holds the ``(padded L / N, ...)`` rows of each that it owns
(``distributed/sharding.shard_state``): ``bucket_apply`` (ZeRO-1) slices
the full gradient to them, ``bucket_apply_sharded`` (ZeRO-2) takes the reduced
gradient shard, and both all-gather only the updated weight slices over the
engine's ``shard_axis`` (a ``repro_torch.distributed.comm.Comm``).

On the model axis of the step that runs the optimizer
(``distributed.tensor_parallel.current``; ``optimizer_axis`` reads it for
the rule) the buckets stack the rank's shards, and a bucket whose leaves'
``d_in`` rows are split over the model group (``Bucket.row_split``: ``wo``,
``w_out``, a vocabulary-split embedding) takes RMNP's norm across the
group: ``kernels/ops.rmnp_rownorm_split`` (the kernel's PARTIAL mode, one
all-reduce of the column sums in rank order, FINISH). The learning-rate
scale reads the leaves' whole shape. Only RMNP reads the axis; the other
rules raise on a model group above one and run the single-rank code on a
group of one. The state is planned under the axis too: ``opt.init`` runs
under ``tensor_parallel.use`` of the step's axis.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

from repro_torch.core import bucketing
from repro_torch.core.rules import MatrixUpdateRule
from repro_torch.core.types import Optimizer, Schedule
from repro_torch.distributed import tensor_parallel as tp

_MOMENTUM_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class BucketedState(NamedTuple):
    """Uniform bucketed optimizer state for the whole rule family."""
    buckets: Dict[str, torch.Tensor]
    slots: Dict[str, Dict[str, torch.Tensor]] = {}


class BucketedEngine:
    """The rule-agnostic machinery of a bucketed matrix optimizer."""

    def __init__(self, rule: MatrixUpdateRule, lr: Schedule, *,
                 momentum_dtype: str = "float32", shard_axis=None,
                 shard_size: int = 1, predicate=None, strict: bool = False):
        if momentum_dtype not in _MOMENTUM_DTYPES:
            raise ValueError(f"momentum_dtype must be float32 or bfloat16, "
                             f"got {momentum_dtype!r}")
        self.rule = rule
        self.lr = lr
        self.mdtype = _MOMENTUM_DTYPES[momentum_dtype]
        self.shard_axis = shard_axis
        self.shard_size = shard_size
        self.predicate = predicate
        self.strict = strict
        self.plans = bucketing.PlanCache()

    # -- plan / state ---------------------------------------------------
    def plan(self, params) -> bucketing.BucketPlan:
        """The plan of ``params`` on the current model axis (module
        docstring), cached per parameter signature and axis."""
        axis = tp.optimizer_axis(self.rule.name)
        return self.plans.get(
            (bucketing.plan_signature(params, self.predicate),
             None if axis is None else axis.plan_key),
            lambda: bucketing.build_plan(
                params, predicate=self.predicate, strict=self.strict,
                pad_multiple=self.shard_size,
                leaf_info=None if axis is None else axis.leaf))

    def state_plan(self, params, buckets) -> bucketing.BucketPlan:
        """:meth:`plan`, checked against the buckets of a state: a state
        initialised on another model axis than the step's raises."""
        plan = self.plan(params)
        want = sorted(b.key for b in plan.buckets)
        if sorted(buckets) != want:
            raise ValueError(
                f"the optimizer state holds buckets {sorted(buckets)} but the "
                f"parameters plan to {want} on the current model axis: initialise "
                f"the state on the step's axis (with tensor_parallel.use("
                f"tensor_parallel.axis_for(cfg, world)): opt.init(params))")
        return plan

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
        return self.lr(step) * rms_lr_scale(bucket.whole)

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
            if b.row_split:
                v_new, d = self._split(g_b[b.key], buckets[b.key])
                sl_new = {}
                upd = -scale * (d + self.rule.weight_decay * p32_b[b.key])
            elif self.rule.additive:
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

    # -- single-pass fused apply (replicated / ZeRO-1) ------------------
    def bucket_apply(self, bucket, g, v, sl, w, step):
        """Fused apply of one stacked bucket, ZeRO-1 aware: ``g`` and ``w``
        are full ``(padded L, ...)`` operands; ``v`` and the slot stripes are
        full or this rank's ``L/N`` shard. On a shard the rule runs over the
        rank's slices and the updated weights are all-gathered; momentum and
        slots stay sharded. Returns ``(w_new full, v_new, sl_new)``."""
        l_loc = v.shape[0]
        n_shards = bucketing.shard_count(bucket, l_loc)
        if g.shape[0] != bucket.padded or w.shape[0] != bucket.padded:
            raise ValueError(
                f"bucket {bucket.key!r}: gradient/weight operands have "
                f"{g.shape[0]}/{w.shape[0]} slices, expected the padded "
                f"bucket size {bucket.padded}")
        if n_shards > 1:
            if self.shard_axis is None:
                raise ValueError(
                    f"bucket {bucket.key!r}: momentum holds {l_loc} of "
                    f"{bucket.padded} slices but no shard_axis was given")
            lo = self.shard_axis.rank * l_loc
            g, w = g[lo:lo + l_loc], w[lo:lo + l_loc]
        w_new, v_new, sl_new = self._apply(bucket, g, v, w, sl, step)
        if n_shards > 1:
            w_new = self.shard_axis.all_gather(w_new)
        return w_new, v_new, sl_new

    def _split(self, g, v, w=None, scale=None):
        """RMNP across the model group over a row-split bucket: (v_new, d),
        or (v_new, w_new) given ``w`` and ``scale``."""
        from repro_torch.kernels import ops as kops
        rule = self.rule
        return kops.rmnp_rownorm_split(g, v, tp.current().comm, w, scale,
                                       None if w is None else rule.weight_decay,
                                       beta=rule.beta, eps=rule.eps)

    def _apply(self, bucket, g, v, w, sl, step):
        """The rule's fused apply of one bucket's rows: ``(w_new, v_new,
        sl_new)``, across the model group for a row-split bucket."""
        if bucket.row_split:
            v_new, w_new = self._split(g, v, w, self.scale(bucket, step))
            return w_new, v_new, {}
        return self.rule.apply(g, v, w, sl, scale=self.scale(bucket, step), step=step)

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

    # -- ZeRO-2 ---------------------------------------------------------
    def bucket_apply_sharded(self, bucket, g_shard, v, sl, w_shard, step,
                             clip_scale=None, async_op=False):
        """One bucket's whole ZeRO-2 chain: the clip scale folded into the
        reduced gradient shard, the rule's fused apply on this rank's
        slices, the all-gather of the updated weight slices. ``w_shard`` is
        this rank's ``(padded L / N, d_in, d_out)`` chunk of the weights
        (``gather_chunks(..., only=rank)``). Returns ``(w_new full padded
        bucket, v_new shard, sl_new shard)``; with ``async_op`` the first is
        a pending all-gather."""
        l_loc = v.shape[0]
        bucketing.shard_count(bucket, l_loc)
        if g_shard.shape[0] != l_loc or w_shard.shape[0] != l_loc:
            raise ValueError(
                f"bucket {bucket.key!r}: gradient/weight shards have "
                f"{g_shard.shape[0]}/{w_shard.shape[0]} slices but the "
                f"momentum shard has {l_loc}")
        g = g_shard if clip_scale is None else g_shard * clip_scale
        w_new, v_new, sl_new = self._apply(bucket, g, v, w_shard, sl, step)
        return (self.shard_axis.all_gather(w_new, async_op=async_op),
                v_new, sl_new)

    def sharded_n_dev(self, plan, buckets) -> Optional[int]:
        """Shard count implied by the momentum buffers (the same for every
        bucket, or it raises); None for an empty plan."""
        n_dev = None
        for b in plan.buckets:
            n_b = bucketing.shard_count(b, buckets[b.key].shape[0])
            if n_dev is None:
                n_dev = n_b
            elif n_b != n_dev:
                raise ValueError(
                    f"inconsistent shard counts across buckets: "
                    f"{n_dev} vs {n_b} (bucket {b.key!r})")
        return n_dev

    def sharded_apply(self, plan, g_shards, buckets, slots, params, step,
                      clip_scale=None, overlap=False):
        """:meth:`bucket_apply_sharded` over the plan. With ``overlap``
        every bucket's weight all-gather is issued before any is waited
        on. Returns ``(w_b, v_b, slots_b)``, or None for an empty plan."""
        n_dev = self.sharded_n_dev(plan, buckets)
        if n_dev is None:
            return None
        if n_dev != self.shard_axis.world:
            raise ValueError(f"momentum is sharded {n_dev} ways but the group "
                             f"has {self.shard_axis.world} ranks")
        w_loc = bucketing.gather_chunks(plan, params, n_dev,
                                        only=self.shard_axis.rank)
        w_b, v_b = {}, {}
        slots_b: Dict[str, Dict[str, torch.Tensor]] = {n: {} for n in slots}
        for b in plan.buckets:
            w_b[b.key], v_new, sl_new = self.bucket_apply_sharded(
                b, g_shards[b.key], buckets[b.key], self._slots_of(slots, b.key),
                w_loc[b.key], step, clip_scale, async_op=overlap)
            v_b[b.key] = v_new
            for name in sl_new:
                slots_b[name][b.key] = sl_new[name]
        if overlap:
            w_b = {k: p.wait() for k, p in w_b.items()}
        return w_b, v_b, slots_b


def check_shard_args(shard_axis, shard_size: int) -> None:
    """The JAX package's argument checks of the ZeRO constructors."""
    if shard_size < 1:
        raise ValueError(f"shard_size must be >= 1, got {shard_size}")
    if shard_size > 1 and shard_axis is None:
        raise ValueError("shard_size > 1 needs shard_axis (the process "
                         "group the padded buckets shard over)")


def _device_of(params):
    from repro_torch.core.types import tree_paths
    leaves = tree_paths(params)
    return leaves[0][1].device if leaves else None


def matrix_optimizer(rule: MatrixUpdateRule, lr: Schedule, *,
                     momentum_dtype: str = "float32",
                     fused_apply: bool = False, shard_axis=None,
                     shard_size: int = 1) -> Optimizer:
    """Bucketed optimizer over a pure-matrix tree for any registered rule.
    ``shard_axis`` (a ``Comm``) unlocks the ZeRO-1/2 entry points and
    implies ``fused_apply``; ``shard_size`` pads every bucket's ``L`` to a
    multiple so uneven buckets shard too. On a model axis as
    ``BucketedEngine``'s (module docstring)."""
    check_shard_args(shard_axis, shard_size)
    if shard_axis is not None:
        fused_apply = True
    eng = BucketedEngine(rule, lr, momentum_dtype=momentum_dtype,
                         shard_axis=shard_axis, shard_size=shard_size,
                         strict=True)

    def init(params):
        return eng.init_state(eng.plan(params), device=_device_of(params))

    def update(grads, state, params, step):
        plan = eng.state_plan(params, state.buckets)
        g_b = bucketing.gather(plan, grads, dtype=torch.float32)
        p_b = bucketing.gather(plan, params, dtype=torch.float32)
        upd_b, v_b, s_b = eng.update_buckets(plan, g_b, p_b, state.buckets,
                                             state.slots, step)
        updates = bucketing.scatter(plan, upd_b, params)
        return updates, BucketedState(buckets=v_b, slots=s_b)

    def update_apply(grads, state, params, step):
        """Single-pass fused apply: params are gathered per bucket in their
        own dtype, updated in one rule pass, and scattered back."""
        plan = eng.state_plan(params, state.buckets)
        g_b = bucketing.gather(plan, grads, dtype=torch.float32)
        p_b = bucketing.gather(plan, params)
        w_b, v_b, s_b = eng.apply_buckets(plan, g_b, p_b, state.buckets,
                                          state.slots, step)
        new_params = bucketing.scatter(plan, w_b, params, cast=True)
        return new_params, BucketedState(buckets=v_b, slots=s_b)

    def update_apply_bucket(bucket, g_shard, v_shard, w_shard, step,
                            clip_scale=None, *, slots=None, async_op=False):
        """Per-bucket ZeRO-2 entry point (see ``Optimizer``)."""
        return eng.bucket_apply_sharded(bucket, g_shard, v_shard, slots or {},
                                        w_shard, step, clip_scale, async_op)

    def update_apply_sharded(g_shards, grads, state, params, step,
                             clip_scale=None, overlap=False):
        """ZeRO-2 single-pass apply: independent per-bucket chains; ``grads``
        is unused (a pure-matrix tree)."""
        del grads
        plan = eng.state_plan(params, state.buckets)
        out = eng.sharded_apply(plan, g_shards, state.buckets, state.slots,
                                params, step, clip_scale, overlap)
        if out is None:
            return params, state
        w_b, v_b, s_b = out
        new_params = bucketing.scatter(plan, w_b, params, cast=True)
        return new_params, BucketedState(buckets=v_b, slots=s_b)

    zero2 = shard_axis is not None
    return Optimizer(init=init, update=update,
                     update_apply=update_apply if fused_apply else None,
                     update_apply_sharded=update_apply_sharded if zero2 else None,
                     update_apply_bucket=update_apply_bucket if zero2 else None,
                     bucket_plan=eng.plan, shard_size=shard_size)
