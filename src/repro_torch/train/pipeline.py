"""Gradients, the two-phase clip, the non-finite guard and the ZeRO-2 step
(mirror of ``repro.train.pipeline``).

**Microbatch accumulation.** ``microbatch_grads`` accumulates every leaf in
fp32; ``microbatch_grads_chunked`` accumulates the matrix leaves straight
into the ``(N, padded L / N, d_in, d_out)`` chunks of ZeRO-2
(``core/bucketing.accumulate_chunks``), so the whole fp32 gradient bucket
never exists, ``accum > 1`` included. Chunking is slicing, so both give the
same bits.

**The two-phase clip.** Phase 1 reduces each gradient leaf's sum of squares
over the group once; phase 2 folds the resulting scalar scale into each
bucket's update chain. A leaf's sum of squares is the same sum wherever its
slices live: each ``(d_in, d_out)`` slice is summed on its own (one
``torch.sum`` of the same contiguous tensor on every path), the slices' sums
are all-gathered in slice order and a leaf adds its slices first to last. So
``grad_norm`` and the clip scale of a ZeRO-2 step equal the replicated
step's bit for bit, leaves split across ranks included. Beyond
``_EXACT_CLIP_MAX_RANKS`` ranks the partials are per bucket.

**The guard.** Those per-leaf sums are what a finite-ness check needs: any
NaN/Inf in a leaf makes its sum non-finite, so ``GuardInfo`` costs one
``isfinite`` over scalars that exist anyway. ``mask_updates`` then picks
``torch.where(ok, new, old)`` per leaf after the update: a skipped step
leaves every buffer bit for bit as it was. The verdict stays on the device.

**The pipelined ZeRO-2 step** (``make_pipelined_zero2_step``): every
bucket's reduce-scatter is issued at once (``async_op=True``), each waited
on when the clip reads its shard, then every bucket's update issues its
weight all-gather before any is waited on. The clip's scalar is the one
value every bucket's update needs from all the others; the result equals
the serialized order's bits.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import bucketing
from repro_torch.core.mixed import ClipStats
from repro_torch.core.types import Optimizer, PyTree, map_with_path, tree_paths
from repro_torch.distributed.tensor_parallel import complete_sums
from repro_torch.models.model import loss_fn, torch_dtype
from repro_torch.train import faults as faults_mod

# above this group size the clip drops from per-leaf to per-bucket partials
_EXACT_CLIP_MAX_RANKS = 32


def split_microbatches(batch, accum: int):
    """(B, ...) tensors -> ``accum`` microbatches of B / accum rows."""
    out = []
    for name, x in batch.items():
        if x.shape[0] % accum:
            raise ValueError(
                f"accum={accum} does not divide the (local) batch "
                f"{x.shape[0]}; pick a batch divisible by accum * ranks")
        for i, part in enumerate(torch.chunk(x, accum, dim=0)):
            if len(out) <= i:
                out.append({})
            out[i][name] = part
    return out


def grads_of(cfg: ModelConfig, params, batch, remat: str, fault=None,
             step=0, mb_idx: int = 0, grad_dtype: Optional[str] = None):
    """One backward pass: ``(grads like params, metrics)``. ``fault``
    poisons the gradients at its step and microbatch; ``grad_dtype`` casts
    them."""
    leaves = {path: t.detach().requires_grad_(True)
              for path, t in tree_paths(params)}
    live = map_with_path(lambda path, _t: leaves[path], params)
    loss, metrics = loss_fn(cfg, live, batch, remat=remat)
    paths = list(leaves)
    # a leaf the loss never reads (musicgen's token embedding when the batch
    # carries frames) gets a zero gradient, as under jax.grad
    grads = {p: torch.zeros_like(leaves[p]) if g is None else g
             for p, g in zip(paths, torch.autograd.grad(
                 loss, [leaves[p] for p in paths], allow_unused=True), strict=True)}
    grads = faults_mod.apply_grad_fault(fault, grads, step, mb_idx)
    if grad_dtype:
        dt = torch_dtype(grad_dtype)
        grads = {p: g.to(dt) for p, g in grads.items()}
    grads = map_with_path(lambda path, _t: grads[path], params)
    return grads, {k: v.detach() for k, v in metrics.items()}


def _mean_metrics(ms):
    return {k: torch.mean(torch.stack([m[k] for m in ms]), dim=0) for k in ms[0]}


def microbatch_grads(cfg: ModelConfig, params, batch, accum: int,
                     remat: str = "none", fault=None, step=0):
    """Per-leaf accumulation: fp32 accumulators like ``params``, the mean
    over ``accum`` microbatches; ``accum == 1`` returns the raw backward
    leaves."""
    if accum == 1:
        return grads_of(cfg, params, batch, remat, fault, step, 0)
    acc, ms = None, []
    for mb_idx, mb in enumerate(split_microbatches(batch, accum)):
        g, m = grads_of(cfg, params, mb, remat, fault, step, mb_idx)
        with torch.no_grad():
            if acc is None:
                acc = map_with_path(lambda _p, x: torch.zeros(
                    x.shape, dtype=torch.float32, device=x.device), params)
            acc = map_with_path(lambda _p, a, x: a + x.float(), acc, g)
        ms.append(m)
    return map_with_path(lambda _p, a: a / accum, acc), _mean_metrics(ms)


def microbatch_grads_chunked(cfg: ModelConfig, plan, params, batch,
                             accum: int, n_chunks: int, remat: str = "none",
                             fault=None, step=0):
    """Backward passes with the matrix gradients accumulated in the chunked
    ZeRO-2 layout. Returns ``(chunk_means, rest_grads, metrics)``:
    ``chunk_means`` maps bucket key -> ``(n_chunks, padded L / n_chunks,
    d_in, d_out)`` fp32, the local mean matrix gradient already chunked;
    ``rest_grads`` is like params with the fp32 local mean on the other
    leaves (matrix leaves hold ``(1,)*ndim`` placeholders for ``accum > 1``
    and the raw backward leaves for ``accum == 1``; nothing reads them)."""
    mat = plan.paths
    if accum == 1:
        grads, metrics = grads_of(cfg, params, batch, remat, fault, step, 0)
        with torch.no_grad():
            chunks = bucketing.gather_chunks(plan, grads, n_chunks,
                                             dtype=torch.float32)
        return chunks, grads, metrics
    chunk_acc = rest_acc = None
    ms = []
    for mb_idx, mb in enumerate(split_microbatches(batch, accum)):
        g, m = grads_of(cfg, params, mb, remat, fault, step, mb_idx)
        with torch.no_grad():
            if chunk_acc is None:
                dev = next(iter(dict(tree_paths(params)).values())).device
                chunk_acc = bucketing.init_chunk_acc(plan, n_chunks, device=dev)
                rest_acc = map_with_path(lambda path, p: torch.zeros(
                    (1,) * p.ndim if path in mat else p.shape,
                    dtype=torch.float32, device=p.device), params)
            chunk_acc = bucketing.accumulate_chunks(plan, g, chunk_acc, n_chunks)
            rest_acc = map_with_path(
                lambda path, a, x: a if path in mat else a + x.float(), rest_acc, g)
        ms.append(m)
    chunk_means = {k: v / accum for k, v in chunk_acc.items()}
    rest = map_with_path(lambda path, a: a if path in mat else a / accum, rest_acc)
    return chunk_means, rest, _mean_metrics(ms)


# ---------------------------------------------------------------------------
# sums of squares, the guard and the clip
# ---------------------------------------------------------------------------

def slice_square_sums(x3: torch.Tensor) -> List[torch.Tensor]:
    """The fp32 sum of squares of each ``(d_in, d_out)`` slice of ``x3``,
    each its own ``torch.sum``: a slice's sum does not depend on the stack
    it sits in."""
    return [torch.sum(torch.square(x3[i].float())) for i in range(x3.shape[0])]


def _ordered_sum(terms):
    acc = terms[0]
    for t in terms[1:]:
        acc = acc + t
    return acc


def leaf_square_sums(plan, grads) -> Dict[str, torch.Tensor]:
    """Each gradient leaf's fp32 sum of squares, for a tree of whole leaves
    (the replicated and ZeRO-1 steps): a planned (matrix) leaf as the sum of
    its slices' sums, first to last; any other leaf by one ``torch.sum``.
    The same numbers :func:`two_phase_clip` reads off the shards."""
    mat = plan.paths if plan is not None else frozenset()
    entries = ({e.path: (b, e) for b in plan.buckets for e in b.entries}
               if plan is not None else {})
    out = {}
    for path, g in tree_paths(grads):
        if path in mat:
            b, e = entries[path]
            out[path] = _ordered_sum(slice_square_sums(
                g.reshape(e.lead, b.d_in, b.d_out)))
        else:
            out[path] = torch.sum(torch.square(g.float()))
    return out


def _matrix_leaf_sq(plan, g_shards, comm) -> Dict[str, torch.Tensor]:
    """Per-leaf sums of squares of the sharded matrix partition: each rank
    sums the slices it holds, one all-gather brings every slice's sum to
    every rank in slice order, and each leaf adds its slices first to last:
    the numbers :func:`leaf_square_sums` gives on whole leaves."""
    if not plan.buckets:
        return {}
    local = torch.stack([s for b in plan.buckets
                         for s in slice_square_sums(g_shards[b.key])])
    every = comm.all_gather(local).reshape(comm.world, -1)
    out, col = {}, 0
    for b in plan.buckets:
        l_loc = g_shards[b.key].shape[0]
        per_slice = every[:, col:col + l_loc].reshape(-1)  # padded L, in order
        col += l_loc
        for e in b.entries:
            out[e.path] = _ordered_sum([per_slice[i] for i in
                                     range(e.offset, e.offset + e.lead)])
    return out


class GuardInfo(NamedTuple):
    """Per-step finite-ness verdict. ``flags[i]`` is True when flag unit
    ``i``'s sum of squares is finite (units and order:
    :func:`guard_flag_names`); ``ok`` is all of them and the global norm,
    so ``ok=False`` means the update must not be applied."""
    ok: torch.Tensor     # () bool
    flags: torch.Tensor  # (n_flags,) bool


def guard_flag_names(tree: PyTree, plan=None, n_dev: int = 1) -> List[str]:
    """Names of ``GuardInfo.flags``, index-aligned: the gradient-leaf paths
    in tree order up to ``_EXACT_CLIP_MAX_RANKS`` ranks, else
    ``bucket:<key>`` per bucket followed by the other leaves' paths."""
    if plan is None or n_dev <= _EXACT_CLIP_MAX_RANKS:
        return [path for path, _ in tree_paths(tree)]
    mat = plan.paths
    return ([f"bucket:{b.key}" for b in plan.buckets]
            + [p for p, _ in tree_paths(tree) if p not in mat])


def finite_guard(grads: PyTree) -> GuardInfo:
    """One fp32 sum of squares per leaf, the same partials the global-norm
    clip sums, and ``isfinite`` over them."""
    leaves = tree_paths(grads)
    sqs = complete_sums([p for p, _ in leaves],
                        [torch.sum(torch.square(g.float())) for _, g in leaves])
    if not sqs:
        flags = torch.ones((0,), dtype=torch.bool)
        return GuardInfo(ok=torch.ones((), dtype=torch.bool), flags=flags)
    flags = torch.isfinite(torch.stack(sqs))
    return GuardInfo(ok=torch.all(flags), flags=flags)


def mask_updates(ok: torch.Tensor, new: PyTree, old: PyTree) -> PyTree:
    """Bitwise step skip: ``torch.where(ok, new, old)`` on every leaf.
    ``ok=True`` yields ``new``'s bits (a guarded healthy step equals an
    unguarded one), ``ok=False`` ``old``'s. ``old`` must be untouched by the
    step: every optimizer of the port returns new tensors and writes none of
    its inputs."""
    return map_with_path(lambda _p, n, o: torch.where(ok, n, o), new, old)


def _clip_from(sqs, flags_from, clip_norm: float, device):
    """Global norm, scale and verdict from the per-unit sums ``sqs`` (tree
    order; the total starts at 0 as Python's ``sum`` does)."""
    sq = torch.zeros((), dtype=torch.float32, device=device)
    for t in sqs:
        sq = sq + t
    gnorm = torch.sqrt(sq)
    if clip_norm > 0:
        scale = torch.clamp(clip_norm / (gnorm + 1e-12), max=1.0)
        clipped = (gnorm > clip_norm).float()
    else:
        scale = torch.ones((), dtype=torch.float32, device=device)
        clipped = torch.zeros((), dtype=torch.float32, device=device)
    flags = (torch.isfinite(flags_from) if flags_from.numel()
             else torch.ones((0,), dtype=torch.bool, device=device))
    guard = GuardInfo(ok=torch.logical_and(torch.all(flags), torch.isfinite(gnorm)),
                      flags=flags)
    return scale, ClipStats(global_norm=gnorm, clipped=clipped), guard


def replicated_clip(plan, grads, clip_norm: float):
    """The global-norm clip of the replicated and ZeRO-1 dp steps, from
    :func:`leaf_square_sums`. ``clip_norm <= 0`` leaves the grads
    untouched. Returns ``(grads, stats, guard)``."""
    sums = leaf_square_sums(plan, grads)
    sqs = complete_sums(list(sums), list(sums.values()))
    dev = sqs[0].device if sqs else None
    scale, stats, guard = _clip_from(sqs, torch.stack(sqs) if sqs else
                                     torch.zeros(0), clip_norm, dev)
    if clip_norm > 0:
        grads = map_with_path(lambda _p, g: (g.float() * scale).to(g.dtype), grads)
    return grads, stats, guard


def two_phase_clip(plan, g_shards, grads, clip_norm: float, comm):
    """Two-phase global-norm clip over the ZeRO-2 sharded matrix partition
    and the replicated rest. Phase 1: the per-leaf sums of squares
    (:func:`_matrix_leaf_sq` for the matrix leaves, one ``torch.sum`` for
    each other leaf, cast to fp32 once), added in tree order; matrix leaves
    of ``grads`` are never read. Phase 2 is the caller's: ``scale`` is
    folded into each bucket's chain. ``clip_norm <= 0`` pins ``scale`` to
    1.0 and ``clipped`` to 0. Beyond ``_EXACT_CLIP_MAX_RANKS`` ranks the
    matrix partials are per bucket. Returns ``(scale, rest32, stats,
    guard)``, ``rest32`` mapping each other leaf's path to its fp32 cast."""
    mat = plan.paths
    rest32 = {path: g.float() for path, g in tree_paths(grads) if path not in mat}
    dev = comm.device
    if comm.world <= _EXACT_CLIP_MAX_RANKS:
        leaf_sq = _matrix_leaf_sq(plan, g_shards, comm)
        paths = [path for path, _ in tree_paths(grads)]
        sqs = complete_sums(paths, [leaf_sq[path] if path in mat
                                    else torch.sum(torch.square(rest32[path]))
                                    for path in paths])
        flags_from = torch.stack(sqs) if sqs else torch.zeros(0)
    else:
        sq_mat = (comm.all_reduce(torch.stack(
            [torch.sum(torch.square(g_shards[b.key])) for b in plan.buckets]))
            if plan.buckets else torch.zeros(0))
        if plan.buckets:   # a bucket's leaves are all split over the model axis, or none
            sq_mat = torch.stack(complete_sums([b.entries[0].path for b in plan.buckets],
                                               list(sq_mat)))
        rest_sqs = complete_sums(list(rest32), [torch.sum(torch.square(g))
                                                for g in rest32.values()])
        sqs = rest_sqs + [_ordered_sum(list(sq_mat))] if plan.buckets else rest_sqs
        flags_from = torch.cat([sq_mat] + ([torch.stack(rest_sqs)] if rest_sqs else []))
    scale, stats, guard = _clip_from(sqs, flags_from, clip_norm, dev)
    return scale, rest32, stats, guard


def scale_rest(grads, rest32, scale):
    """The clip scale on the once-cast fp32 rest leaves (matrix leaves pass
    through; the sharded optimizer does not read them)."""
    return map_with_path(
        lambda path, g: rest32[path] * scale if path in rest32 else g, grads)


def pmean_metrics(metrics, comm):
    """Each 0-d metric's mean over the group, in one collective."""
    names = sorted(metrics)
    if not names:
        return metrics
    vec = comm.all_reduce(torch.stack([metrics[k].float() for k in names]))
    vec = vec / comm.world
    return {k: vec[i] for i, k in enumerate(names)}


def make_pipelined_zero2_step(cfg: ModelConfig, opt: Optimizer, comm, *,
                              clip_norm: float, compress: bool, remat: str,
                              accum: int, guard: bool = False, fault=None):
    """The bucket-pipelined ZeRO-2 local step: the chunked backward, one
    reduce-scatter issued per bucket before any is waited on, the two-phase
    clip, the updates through ``update_apply_sharded`` with the clip scale
    folded per bucket and their weight all-gathers in flight together.
    ``guard=True`` masks params, optimizer state and (int8 wire) the folded
    residual with the clip's verdict. ``(params, opt_state, comp_state,
    local batch, step) -> (params, opt_state, comp_state, metrics)``."""
    from repro_torch.distributed.compression import (
        CompressionState, compressed_mean, compressed_reduce_scatter_leaf,
        exact_mean, exact_reduce_scatter, fold_error_chunks, rollback_fold)
    n_dev = comm.world

    def local_step(params, opt_state, comp_state, batch, step):
        plan = opt.bucket_plan(params)
        mat = plan.paths
        prev = (params, opt_state, comp_state)
        chunk_means, rest, metrics = microbatch_grads_chunked(
            cfg, plan, params, batch, accum, n_dev, remat, fault=fault, step=step)
        with torch.no_grad():
            pending = {}

            def skip(path):
                return path in mat
            if compress:
                v_chunks = fold_error_chunks(plan, chunk_means, comp_state, n_dev)
                resid = {}
                for b in plan.buckets:
                    pending[b.key], resid[b.key] = compressed_reduce_scatter_leaf(
                        v_chunks[b.key], comm, async_op=True,
                        wire_fault=faults_mod.wire_fault_for(fault, b.key, step, comm))
                del v_chunks
                rest, comp_state = compressed_mean(rest, comp_state, comm, skip=skip)
                comp_state = CompressionState(
                    error=bucketing.scatter_chunks(plan, resid, comp_state.error))
            else:
                for b in plan.buckets:
                    pending[b.key] = exact_reduce_scatter(chunk_means[b.key], comm,
                                                          async_op=True)
                rest = exact_mean(rest, comm, skip=skip)
            del chunk_means
            metrics = pmean_metrics(metrics, comm)
            g_shards = {k: p.wait() for k, p in pending.items()}
            scale, rest32, clip_stats, ginfo = two_phase_clip(
                plan, g_shards, rest, clip_norm, comm)
            rest = scale_rest(rest, rest32, scale)
            params, opt_state = opt.update_apply_sharded(
                g_shards, rest, opt_state, params, step, clip_scale=scale,
                overlap=True)
            if guard:
                params = mask_updates(ginfo.ok, params, prev[0])
                opt_state = mask_updates(ginfo.ok, opt_state, prev[1])
                if compress:
                    comp_state = rollback_fold(ginfo.ok, comp_state, prev[2])
        metrics = dict(metrics, grad_norm=clip_stats.global_norm,
                       clip_rate=clip_stats.clipped)
        if guard:
            metrics["skipped"] = (~ginfo.ok).float()
            metrics["guard_flags"] = ginfo.flags.float()
        return params, opt_state, comp_state, metrics

    return local_step
