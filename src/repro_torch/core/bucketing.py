"""Shape-bucketed fused update engine (mirror of ``repro.core.bucketing``).

Transformer parameter trees hold only a handful of distinct matrix shapes,
so every matrix leaf is grouped by its trailing ``(d_in, d_out)`` after its
leading scan/expert axes are flattened, each bucket is stacked into one
``(L, d_in, d_out)`` operand, and the RMNP kernel runs once per bucket
instead of once per leaf. The plan is static metadata computed once; its
bucket order (``sorted`` by integer ``(d_in, d_out)``) and entry offsets
(tree order, see ``core/types.py``) equal the JAX package's.

The ZeRO chunk functions (``gather_chunks`` and friends) come with the
data-parallel slice (ROADMAP Queue 1, item 6).
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.core.types import PyTree, map_with_path, tree_paths
from repro_torch.kernels import ops as kops


class BucketEntry(NamedTuple):
    path: str                  # '/'-joined tree path of the leaf
    shape: Tuple[int, ...]     # full leaf shape, leading axes included
    lead: int                  # prod(shape[:-2]) — slices this leaf occupies
    offset: int                # first slice of this leaf in the stacked bucket


class Bucket(NamedTuple):
    key: str                   # "d_inxd_out", e.g. "768x3072"
    d_in: int
    d_out: int
    size: int                  # L — total stacked slices across all entries
    entries: Tuple[BucketEntry, ...]
    # L rounded up to the plan's pad multiple; pad slices carry zero
    # grad/momentum and are dropped by scatter. 0 means "no padding".
    padded_size: int = 0

    @property
    def padded(self) -> int:
        return self.padded_size or self.size


class BucketPlan(NamedTuple):
    buckets: Tuple[Bucket, ...]

    @property
    def n_leaves(self) -> int:
        return sum(len(b.entries) for b in self.buckets)

    @property
    def paths(self) -> frozenset:
        """Leaf paths the plan covers (the matrix partition)."""
        return frozenset(e.path for b in self.buckets for e in b.entries)


class PlanCache:
    """Tiny LRU for leaf->bucket plans keyed on :func:`plan_signature`."""

    def __init__(self, maxsize: int = 8):
        if maxsize < 1:
            raise ValueError(f"PlanCache needs maxsize >= 1, got {maxsize}")
        self.maxsize = maxsize
        self._plans: OrderedDict = OrderedDict()

    def __len__(self) -> int:
        return len(self._plans)

    def get(self, key, build: Callable[[], "BucketPlan"]) -> "BucketPlan":
        if key in self._plans:
            self._plans.move_to_end(key)
            return self._plans[key]
        plan = build()
        self._plans[key] = plan
        while len(self._plans) > self.maxsize:
            self._plans.popitem(last=False)
        return plan


def bucket_key(d_in: int, d_out: int) -> str:
    return f"{d_in}x{d_out}"


def _lead(shape) -> int:
    n = 1
    for s in shape[:-2]:
        n *= s
    return n


def plan_signature(params: PyTree,
                   predicate: Optional[Callable[[str, torch.Tensor], bool]] = None):
    """Hashable description of the leaves a plan depends on (for caching)."""
    return tuple((path, tuple(leaf.shape))
                 for path, leaf in tree_paths(params)
                 if predicate is None or predicate(path, leaf))


def build_plan(params: PyTree,
               predicate: Optional[Callable[[str, torch.Tensor], bool]] = None,
               strict: bool = False, pad_multiple: int = 1) -> BucketPlan:
    """Group leaves selected by ``predicate`` (default: ``ndim >= 2``) into
    ``(d_in, d_out)`` buckets. ``strict=True`` raises on any rejected leaf.
    ``pad_multiple`` rounds every bucket's stacked ``L`` up to a multiple
    (pad slices are zero-filled by :func:`gather`, stay zero through the
    RMNP update and are never read back by :func:`scatter`)."""
    if pad_multiple < 1:
        raise ValueError(f"pad_multiple must be >= 1, got {pad_multiple}")
    groups: Dict[Tuple[int, int], list] = {}
    for path, leaf in tree_paths(params):
        is_mat = (predicate(path, leaf) if predicate is not None
                  else getattr(leaf, "ndim", 0) >= 2)
        if not is_mat:
            if strict:
                raise ValueError(
                    f"fused RMNP requires matrix leaves; {path!r} has shape "
                    f"{tuple(getattr(leaf, 'shape', ()))}")
            continue
        d_in, d_out = int(leaf.shape[-2]), int(leaf.shape[-1])
        groups.setdefault((d_in, d_out), []).append((path, tuple(leaf.shape)))
    buckets = []
    for (d_in, d_out) in sorted(groups):
        entries, offset = [], 0
        for path, shape in groups[(d_in, d_out)]:
            lead = _lead(shape)
            entries.append(BucketEntry(path=path, shape=shape,
                                       lead=lead, offset=offset))
            offset += lead
        padded = -(-offset // pad_multiple) * pad_multiple
        buckets.append(Bucket(key=bucket_key(d_in, d_out), d_in=d_in,
                              d_out=d_out, size=offset,
                              entries=tuple(entries), padded_size=padded))
    return BucketPlan(buckets=tuple(buckets))


def init_buckets(plan: BucketPlan, dtype=torch.float32,
                 device=None) -> Dict[str, torch.Tensor]:
    """Zero-initialised stacked momentum, one ``(padded L, d_in, d_out)``
    buffer per bucket (the whole matrix-partition optimizer state)."""
    return {b.key: torch.zeros((b.padded, b.d_in, b.d_out), dtype=dtype,
                               device=device)
            for b in plan.buckets}


def _bucket_parts(bucket: Bucket, by_path, dtype=None):
    """The planned leaves of one bucket as ``(lead, d_in, d_out)`` slabs (in
    entry order, shapes validated) plus the dtype pads are created in."""
    parts = []
    for e in bucket.entries:
        leaf = by_path.get(e.path)
        if leaf is None:
            raise ValueError(
                f"bucket plan references leaf {e.path!r} (bucket "
                f"{bucket.key!r}) but the tree has no such path — was the "
                f"plan built for a different params tree?")
        if tuple(leaf.shape) != e.shape:
            raise ValueError(f"leaf {e.path!r} changed shape: plan has "
                             f"{e.shape}, tree has {tuple(leaf.shape)}")
        part = leaf.reshape(e.lead, bucket.d_in, bucket.d_out)
        parts.append(part.to(dtype) if dtype is not None else part)
    pad_dtype = dtype if dtype is not None else parts[0].dtype
    for p in parts[1:]:
        pad_dtype = torch.promote_types(pad_dtype, p.dtype)
    return parts, pad_dtype


def gather(plan: BucketPlan, tree: PyTree, dtype=None) -> Dict[str, torch.Tensor]:
    """Stack the planned leaves of ``tree`` into per-bucket operands (a new
    contiguous buffer per bucket). Pad slices are zero-filled."""
    by_path = dict(tree_paths(tree))
    out = {}
    for b in plan.buckets:
        parts, pad_dtype = _bucket_parts(b, by_path, dtype)
        if b.padded > b.size:
            parts.append(torch.zeros((b.padded - b.size, b.d_in, b.d_out),
                                     dtype=pad_dtype, device=parts[0].device))
        parts = [p.to(pad_dtype) for p in parts]
        out[b.key] = (parts[0].contiguous() if len(parts) == 1
                      else torch.cat(parts, dim=0))
    return out


def scatter(plan: BucketPlan, stacked: Dict[str, torch.Tensor],
            base: PyTree, cast: bool = False) -> PyTree:
    """Inverse of :func:`gather`: slice each bucket back into the planned
    leaves of ``base`` (non-planned leaves pass through untouched). The
    leaves are views of the bucket buffers. ``cast=True`` restores each
    base leaf's dtype (the fused-apply path scatters params; the two-pass
    path scatters fp32 updates and must not cast)."""
    slices = {}
    for b in plan.buckets:
        for e in b.entries:
            slices[e.path] = (b.key, e)

    def visit(path, leaf):
        hit = slices.get(path)
        if hit is None:
            return leaf
        key, e = hit
        out = stacked[key][e.offset:e.offset + e.lead].reshape(e.shape)
        return out.to(leaf.dtype) if cast else out

    return map_with_path(visit, base)


def fused_rownorm_update(plan: BucketPlan,
                         grad_buckets: Dict[str, torch.Tensor],
                         mom_buckets: Dict[str, torch.Tensor],
                         *, beta: float, eps: float):
    """One fused momentum-EMA + row-normalize pass per bucket.

    Returns ``(d_buckets fp32, new_mom_buckets)`` with momentum kept in its
    storage dtype. Each bucket goes through ``kernels/ops.py``: one
    precondition-kernel launch on CUDA tensors, the plain version on CPU
    tensors."""
    d_out, v_out = {}, {}
    for b in plan.buckets:
        v_out[b.key], d_out[b.key] = kops.rmnp_bucket_update(
            grad_buckets[b.key], mom_buckets[b.key], beta=beta, eps=eps)
    return d_out, v_out


def _apply_one(g, v, w, scale, weight_decay, beta, eps):
    """Single-pass apply of one stacked bucket through ``kernels/ops.py``:
    the apply kernel on CUDA tensors, its plain version on CPU tensors."""
    return kops.rmnp_bucket_update_apply(g, v, w, scale, weight_decay,
                                         beta=beta, eps=eps)
