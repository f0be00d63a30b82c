"""Data-parallel train step with an explicit gradient reduction and ZeRO
sharding of the optimizer state and gradients (mirror of
``repro.train.dp_step``).

One process per rank (``repro_torch.distributed.comm``). The step takes the
global batch and trains on this rank's rows of it, ``rank * B / N`` to
``(rank + 1) * B / N`` (the JAX package's ``P("data")`` batch), so N ranks
see the same tokens as one. Params are replicated; every sum over ranks
runs in rank order.

Optimizer state has three modes:

* ``shard_state=False`` (ZeRO-0): state replicated, any optimizer works;
  the gradient is averaged leaf by leaf.
* ``shard_state=True`` (ZeRO-1): a rank holds its ``(padded L / N, ...)``
  rows of every stacked momentum bucket and slot stripe, runs the fused
  apply on them and all-gathers the updated weight slices. Needs a
  fused-apply optimizer built with ``shard_axis``.
* ``zero2=True`` (implies ``shard_state``): the matrix gradient is reduced
  straight into the rank's bucket shard (``gather_chunks``, then a
  reduce-scatter or the int8 all-to-all), so the full mean-gradient bucket
  never exists on any rank. Needs ``shard_size`` equal to the group size.

``compress`` picks the int8 error-feedback wire (``distributed/
compression.py``) over the exact fp32 one. ``accum`` splits the local
batch into microbatches. ``overlap`` picks the pipelined ZeRO-2 schedule
(``train/pipeline.make_pipelined_zero2_step``) over the serialized one;
both give the same bits. ``None`` resolves with :func:`resolve_overlap`.

``world`` (a ``distributed.comm.WorldComm``) puts the step on a ``data x
model`` world: ``comm`` is its data group, the model group splits the
parameters by the logical-axis rules (``distributed/tensor_parallel.py``),
and ZeRO-2 shards the buckets of the rank's shards over the data group.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.types import Optimizer, apply_updates, tree_map
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.distributed.comm import Comm
from repro_torch.distributed.compression import (
    CompressionState, compressed_mean, compressed_reduce_scatter_leaf, exact_mean,
    exact_reduce_scatter, init_compression_state, rollback_fold)
from repro_torch.train import faults, pipeline


def resolve_overlap(overlap: Optional[bool], *, accum: int, compress: bool) -> bool:
    """Explicit True/False wins; None picks the pipelined schedule except at
    ``accum == 1`` on the exact wire, the JAX package's choice (its one
    measured regression case)."""
    if overlap is not None:
        return overlap
    return not (accum == 1 and not compress)


def local_rows(batch, comm: Comm):
    """This rank's rows of the global batch."""
    out = {}
    for k, x in batch.items():
        if x.shape[0] % comm.world:
            raise ValueError(f"the global batch {x.shape[0]} does not split "
                             f"over {comm.world} ranks")
        n = x.shape[0] // comm.world
        out[k] = x[comm.rank * n:(comm.rank + 1) * n]
    return out


def make_dp_train_step(cfg: ModelConfig, opt: Optimizer, comm: Comm, *,
                       clip_norm: float = 1.0, compress: bool = True,
                       remat: str = "none", shard_state: bool = False,
                       zero2: bool = False, accum: int = 1,
                       overlap: Optional[bool] = None, guard: bool = False,
                       fault=None, world=None):
    """``(params, opt_state, comp_state, global batch, step) -> (params,
    opt_state, comp_state, metrics)``, run on every rank of ``comm``.
    ``opt_state`` is this rank's (:func:`init_dp_state`); ``comp_state`` its
    error-feedback residual (untouched, and may be None, on the exact
    wire). ``clip_norm <= 0`` disables clipping while ``grad_norm`` and
    ``clip_rate`` keep reporting. ``guard=True`` adds the non-finite guard:
    a step whose mean gradient holds a NaN/Inf leaves params, optimizer
    state and the residual bit for bit unchanged, and the metrics gain
    ``skipped`` and ``guard_flags``. ``fault`` injects a
    ``repro_torch.train.faults`` fault into the backward or the int8 wire.
    ``world``: the ``data x model`` world ``comm`` is the data group of
    (module docstring)."""
    if world is not None and world.data is not comm:
        raise ValueError("on a world, comm must be the world's data group")
    axis = tp.axis_for(cfg, world)
    n_dev = comm.world
    overlap = resolve_overlap(overlap, accum=accum, compress=compress)
    if zero2:
        shard_state = True
    if accum < 1:
        raise ValueError(f"accum must be >= 1, got {accum}")
    if shard_state and opt.update_apply is None:
        raise ValueError(
            "shard_state=True requires a fused-apply optimizer "
            "(fused_apply=True, shard_axis=comm): the sharded step runs the "
            "update kernel on local momentum slices and all-gathers the "
            "updated param slices")
    if zero2:
        if opt.update_apply_sharded is None or opt.bucket_plan is None:
            raise ValueError(
                "zero2=True requires an optimizer exposing "
                "update_apply_sharded (rmnp/mixed_optimizer built with "
                "shard_axis=comm and shard_size=the group size): the ZeRO-2 "
                "step reduce-scatters gradient buckets straight into the "
                "momentum shard")
        if opt.shard_size != n_dev:
            raise ValueError(
                f"zero2=True: the optimizer was built with shard_size="
                f"{opt.shard_size} but the group has {n_dev} ranks — ZeRO-2 "
                f"reduce-scatters each gradient bucket into exactly one "
                f"chunk per rank, so the optimizer must be built with "
                f"shard_size={n_dev}")

    if zero2 and overlap:
        piped = pipeline.make_pipelined_zero2_step(
            cfg, opt, comm, clip_norm=clip_norm, compress=compress, remat=remat,
            accum=accum, guard=guard, fault=fault)

        def pipelined_step(params, opt_state, comp_state, batch, step):
            with tp.use(axis):
                return piped(params, opt_state, comp_state, local_rows(batch, comm), step)
        return pipelined_step

    def zero2_reduce(grads, comp_state, step):
        """Serialized: every bucket's chunked reduce-scatter in turn, then
        the rest leaf by leaf. Returns (g_shards, rest-mean grads,
        comp_state, plan)."""
        from repro_torch.core.bucketing import gather_chunks, scatter_chunks
        plan = opt.bucket_plan(grads)
        mat = plan.paths

        def skip(path):
            return path in mat
        g_shards = {}
        if compress:
            v_tree = tree_map(lambda g, e: g.float() + e, grads, comp_state.error)
            chunks = gather_chunks(plan, v_tree, n_dev, dtype=torch.float32)
            resid = {}
            for b in plan.buckets:
                g_shards[b.key], resid[b.key] = compressed_reduce_scatter_leaf(
                    chunks[b.key], comm,
                    wire_fault=faults.wire_fault_for(fault, b.key, step, comm))
            grads, comp_state = compressed_mean(grads, comp_state, comm, skip=skip)
            comp_state = CompressionState(
                error=scatter_chunks(plan, resid, comp_state.error))
        else:
            chunks = gather_chunks(plan, grads, n_dev, dtype=torch.float32)
            for b in plan.buckets:
                g_shards[b.key] = exact_reduce_scatter(chunks[b.key], comm)
            grads = exact_mean(grads, comm, skip=skip)
        return g_shards, grads, comp_state, plan

    def local_step(params, opt_state, comp_state, batch, step):
        with tp.use(axis):
            return body(params, opt_state, comp_state, batch, step)

    def body(params, opt_state, comp_state, batch, step):
        prev = (params, opt_state, comp_state)
        grads, metrics = pipeline.microbatch_grads(
            cfg, params, local_rows(batch, comm), accum, remat, fault=fault, step=step)
        with torch.no_grad():
            if zero2:
                g_shards, grads, comp_state, plan = zero2_reduce(grads, comp_state, step)
                metrics = pipeline.pmean_metrics(metrics, comm)
                scale, rest32, clip_stats, ginfo = pipeline.two_phase_clip(
                    plan, g_shards, grads, clip_norm, comm)
                # the serialized order: scaled shard buffers, then the updates
                g_shards = {k: s * scale for k, s in g_shards.items()}
                grads = pipeline.scale_rest(grads, rest32, scale)
                params, opt_state = opt.update_apply_sharded(
                    g_shards, grads, opt_state, params, step)
            else:
                if compress:
                    grads, comp_state = compressed_mean(grads, comp_state, comm)
                else:
                    grads = exact_mean(grads, comm)
                metrics = pipeline.pmean_metrics(metrics, comm)
                plan = opt.bucket_plan(params) if opt.bucket_plan is not None else None
                grads, clip_stats, ginfo = pipeline.replicated_clip(plan, grads, clip_norm)
                if opt.update_apply is not None:
                    params, opt_state = opt.update_apply(grads, opt_state, params, step)
                else:
                    updates, opt_state = opt.update(grads, opt_state, params, step)
                    params = apply_updates(params, updates)
            if guard:
                params = pipeline.mask_updates(ginfo.ok, params, prev[0])
                opt_state = pipeline.mask_updates(ginfo.ok, opt_state, prev[1])
                if compress:
                    comp_state = rollback_fold(ginfo.ok, comp_state, prev[2])
        metrics = dict(metrics, grad_norm=clip_stats.global_norm,
                       clip_rate=clip_stats.clipped)
        if guard:
            metrics["skipped"] = (~ginfo.ok).float()
            metrics["guard_flags"] = ginfo.flags.float()
        return params, opt_state, comp_state, metrics

    return local_step


def init_dp_state(opt: Optimizer, params, comm: Comm, *, shard_state: bool = False):
    """``(opt_state, comp_state)`` of this rank: the optimizer state (with
    ``shard_state`` only this rank's ``(padded L / N, ...)`` rows of the
    stacked buffers) and a zero error-feedback residual like ``params``."""
    from repro_torch.distributed.sharding import shard_state as shard
    opt_state = opt.init(params)
    if shard_state:
        opt_state = shard(opt_state, comm)
    return opt_state, init_compression_state(params)
