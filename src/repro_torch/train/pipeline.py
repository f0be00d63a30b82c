"""The non-finite guard of the train step (mirror of the replicated half of
``repro.train.pipeline``: ``GuardInfo``, ``finite_guard``, ``mask_updates``
and ``guard_flag_names``).

The verdict stays on the device: ``ok`` is a 0-d bool tensor and the mask is
``torch.where(ok, new, old)`` per leaf, so the step never waits on the host
for it. The bucketed flag form, ``two_phase_clip`` and the rest of the
ZeRO-2 pipeline come with ROADMAP Queue 1, item 6.
"""
from __future__ import annotations

from typing import List, NamedTuple

import torch

from repro_torch.core.types import PyTree, map_with_path, tree_paths


class GuardInfo(NamedTuple):
    """Per-step finite-ness verdict. ``flags[i]`` is True when gradient leaf
    ``i``'s sum of squares (tree order, :func:`guard_flag_names`) is finite;
    ``ok`` is all of them, so ``ok=False`` means the update must not be
    applied."""
    ok: torch.Tensor     # () bool
    flags: torch.Tensor  # (n_leaves,) bool


def guard_flag_names(tree: PyTree) -> List[str]:
    """Names of ``GuardInfo.flags``, index-aligned: the gradient-leaf paths
    in tree order (the replicated form; the per-bucket form belongs to
    ZeRO-2)."""
    return [path for path, _ in tree_paths(tree)]


def finite_guard(grads: PyTree) -> GuardInfo:
    """One fp32 sum of squares per leaf, the same partials the global-norm
    clip sums, and ``isfinite`` over them."""
    sqs = [torch.sum(torch.square(g.float())) for _, g in tree_paths(grads)]
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
