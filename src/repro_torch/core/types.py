"""Optimizer interface of the PyTorch port (mirror of ``repro.core.types``).

Parameter, gradient and state trees are nested dicts of tensors. Optimizers
are functional, as in the JAX package:

    state = opt.init(params)
    updates, state = opt.update(grads, state, params, step)
    params = apply_updates(params, updates)

or, for the single-pass engine, ``params, state = opt.update_apply(...)``.
``updates`` already hold the (negative) learning-rate scaling.

Tree order: ``jax.tree_util`` flattens dicts in sorted-key order, and that
order decides bucket entry offsets, bucket order and the summation order of
the global-norm clip. :func:`tree_paths` walks dicts in the same sorted
order and joins keys with ``/``; a NamedTuple field is named ``.field`` and
a sequence item by its index, as ``repro.core.types.path_str`` names them,
so the port's paths and their order equal the JAX package's (the checkpoint
manifest keys every leaf by its path).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Tuple

import torch

PyTree = Any
Schedule = Callable[[int], torch.Tensor]  # step -> fp32 0-d lr tensor


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[PyTree], PyTree]
    update: Callable[..., Any]  # (grads, state, params, step) -> (updates, state)
    # single-pass fused apply: (grads, state, params, step) -> (new_params,
    # state); the weight update is folded into the per-bucket kernel, so no
    # updates tree exists. None means two-pass update + apply_updates.
    update_apply: Optional[Callable[..., Any]] = None
    # ZeRO-2 fused apply: (g_shards, grads, state, params, step,
    # clip_scale=None, overlap=False) -> (new_params, state). ``g_shards``
    # maps bucket key -> this rank's (padded L / N, d_in, d_out) fp32
    # mean-gradient shard; matrix leaves of ``grads`` are ignored, the rest
    # must already be mean-reduced and clip-scaled (``clip_scale`` applies
    # to the matrix shards only, folded into each bucket's chain).
    # ``overlap`` issues every bucket's weight all-gather before waiting on
    # any. Exposed by the fused-apply optimizers built with shard_axis.
    update_apply_sharded: Optional[Callable[..., Any]] = None
    # per-bucket ZeRO-2 entry point: (bucket, g_shard, v_shard, w_shard,
    # step, clip_scale=None, *, slots=None, async_op=False) -> (w_new full
    # padded bucket, v_new shard, slots_new shard); ``w_shard`` is this
    # rank's chunk of the weights (the JAX package passes every rank's
    # chunks and indexes its own). With ``async_op`` the first element is
    # a pending all-gather (``.wait()`` gives the bucket).
    update_apply_bucket: Optional[Callable[..., Any]] = None
    # params -> repro_torch.core.bucketing.BucketPlan of the matrix partition
    bucket_plan: Optional[Callable[[PyTree], Any]] = None
    # the pad multiple of every bucket's stacked L (the intended ZeRO shard
    # count); the dp step checks it against the group's size up front
    shard_size: int = 1


def _child_keys(tree) -> List[str]:
    """Path components of a sequence's items: ``.field`` for a NamedTuple,
    the index otherwise."""
    if hasattr(tree, "_fields"):
        return [f".{f}" for f in tree._fields]
    return [str(i) for i in range(len(tree))]


def _walk(tree, prefix: Tuple[str, ...], out: List):
    if isinstance(tree, dict):
        for k in sorted(tree):
            _walk(tree[k], prefix + (str(k),), out)
    elif isinstance(tree, (list, tuple)):
        for key, x in zip(_child_keys(tree), tree, strict=True):
            _walk(x, prefix + (key,), out)
    elif tree is not None:
        out.append(("/".join(prefix), tree))


def tree_paths(tree: PyTree) -> List[Tuple[str, Any]]:
    """[(path_string, leaf)] in JAX's flattening order: dict keys sorted,
    NamedTuple fields as ``.field``, other sequences by index, ``None``
    leaves dropped."""
    out: List = []
    _walk(tree, (), out)
    return out


def map_with_path(fn: Callable[[str, Any], Any], tree: PyTree,
                  *rest: PyTree) -> PyTree:
    """Rebuild ``tree`` with ``fn(path, leaf, *matching leaves of rest)`` at
    every leaf; the structure (dict keys, sequence lengths) is ``tree``'s."""
    def go(t, rs, prefix):
        if isinstance(t, dict):
            return {k: go(t[k], [r[k] for r in rs], prefix + (str(k),))
                    for k in t}
        if isinstance(t, (list, tuple)):
            vals = [go(x, [r[i] for r in rs], prefix + (key,))
                    for i, (key, x) in enumerate(zip(_child_keys(t), t, strict=True))]
            return type(t)(vals) if not hasattr(t, "_fields") else type(t)(*vals)
        if t is None:
            return None
        return fn("/".join(prefix), t, *rs)
    return go(tree, list(rest), ())


def tree_map(fn: Callable[..., Any], tree: PyTree, *rest: PyTree) -> PyTree:
    return map_with_path(lambda _path, *leaves: fn(*leaves), tree, *rest)


def map_unzip(fn: Callable[..., Tuple], n: int, tree: PyTree,
              *rest: PyTree) -> Tuple[PyTree, ...]:
    """:func:`map_with_path` for an ``fn`` returning an ``n``-tuple: ``n``
    trees shaped like ``tree``."""
    out = map_with_path(fn, tree, *rest)
    return tuple(map_with_path(lambda _p, _leaf, r, i=i: r[i], tree, out)
                 for i in range(n))


def apply_updates(params: PyTree, updates: PyTree) -> PyTree:
    return tree_map(lambda p, u: p + u.to(p.dtype), params, updates)
