"""Shape-bucketed fused update engine (mirror of ``repro.core.bucketing``).

Transformer parameter trees hold only a handful of distinct matrix shapes,
so every matrix leaf is grouped by its trailing ``(d_in, d_out)`` after its
leading scan/expert axes are flattened, each bucket is stacked into one
``(L, d_in, d_out)`` operand, and the RMNP kernel runs once per bucket
instead of once per leaf. The plan is static metadata computed once; its
bucket order (``sorted`` by integer ``(d_in, d_out)``) and entry offsets
(tree order, see ``core/types.py``) equal the JAX package's.

ZeRO layout: a plan built with ``pad_multiple=N`` stacks every bucket at
``padded L``, a multiple of ``N``, and rank ``r`` owns slices ``[r * padded
L / N, (r + 1) * padded L / N)`` of it. ``gather_chunks`` lays a tree out
as ``(N, padded L / N, d_in, d_out)`` chunks (chunk ``j`` is rank ``j``'s)
without building the whole bucket, ``accumulate_chunks`` adds microbatches
in that layout, ``scatter_chunks`` reads leaves back from it, and
``unpad_buckets``/``repad_buckets`` move stacked state between shard sizes.

Model axis: where the model group holds shards of the leaves
(``distributed/tensor_parallel.py``), buckets are formed from the local
shards, and a leaf's whole shape and whether its ``d_in`` rows are split
over the group (``leaf_info``) join its ``(d_in, d_out)`` in the grouping:
the learning-rate scale reads the whole shape, and a row-split bucket
(``Bucket.row_split``) takes RMNP's cross-rank norm (``core/engine.py``).
Without a model axis every key and order is the single-rank one.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

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
    # the model axis: the leaves' whole (d_in, d_out) (0: the local one)
    # and whether their d_in rows are split over the model group
    whole_in: int = 0
    whole_out: int = 0
    row_split: bool = False

    @property
    def padded(self) -> int:
        return self.padded_size or self.size

    @property
    def whole(self) -> Tuple[int, int]:
        """The leaves' whole ``(d_in, d_out)``, for the learning-rate scale."""
        return (self.whole_in or self.d_in, self.whole_out or self.d_out)


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


def bucket_key(d_in: int, d_out: int, whole=None, row_split: bool = False) -> str:
    """``"d_inxd_out"``; on the model axis ``_of_<whole>`` where the leaves
    are shards of larger ones and ``_rows`` where their rows are split."""
    key = f"{d_in}x{d_out}"
    if whole is not None and tuple(whole) != (d_in, d_out):
        key += f"_of_{whole[0]}x{whole[1]}"
    return key + ("_rows" if row_split else "")


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


def _grouping(leaf_info, path, d_in, d_out):
    """(whole d_in, whole d_out, row-split) of a leaf; its own shape and
    False without a model axis."""
    info = leaf_info(path) if leaf_info is not None else None
    if info is None:
        return d_in, d_out, False
    return int(info.whole[-2]), int(info.whole[-1]), bool(info.row_split)


def build_plan(params: PyTree,
               predicate: Optional[Callable[[str, torch.Tensor], bool]] = None,
               strict: bool = False, pad_multiple: int = 1,
               leaf_info: Optional[Callable[[str], Any]] = None) -> BucketPlan:
    """Group leaves selected by ``predicate`` (default: ``ndim >= 2``) into
    ``(d_in, d_out)`` buckets. ``strict=True`` raises on any rejected leaf.
    ``pad_multiple`` rounds every bucket's stacked ``L`` up to a multiple
    (pad slices are zero-filled by :func:`gather`, stay zero through the
    RMNP update and are never read back by :func:`scatter`). ``leaf_info``
    (path -> ``tensor_parallel.LeafShard`` or None) adds each leaf's whole
    shape and row split to its group, on the model axis."""
    if pad_multiple < 1:
        raise ValueError(f"pad_multiple must be >= 1, got {pad_multiple}")
    groups: Dict[Tuple[int, int, int, int, bool], list] = {}
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
        group = (d_in, d_out) + _grouping(leaf_info, path, d_in, d_out)
        groups.setdefault(group, []).append((path, tuple(leaf.shape)))
    buckets = []
    for group in sorted(groups):
        d_in, d_out, w_in, w_out, rows = group
        entries, offset = [], 0
        for path, shape in groups[group]:
            lead = _lead(shape)
            entries.append(BucketEntry(path=path, shape=shape,
                                       lead=lead, offset=offset))
            offset += lead
        padded = -(-offset // pad_multiple) * pad_multiple
        local = (w_in, w_out) == (d_in, d_out)
        buckets.append(Bucket(key=bucket_key(d_in, d_out, (w_in, w_out), rows), d_in=d_in,
                              d_out=d_out, size=offset,
                              entries=tuple(entries), padded_size=padded,
                              whole_in=0 if local else w_in, whole_out=0 if local else w_out,
                              row_split=rows))
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


def _chunk_size(bucket: Bucket, n_chunks: int) -> int:
    """Per-chunk slice count of a bucket split ``n_chunks`` ways; raises
    (naming the fix) when the padded size does not divide."""
    if bucket.padded % n_chunks:
        raise ValueError(
            f"bucket {bucket.key!r}: padded size {bucket.padded} is not "
            f"divisible by n_chunks={n_chunks} — build the plan with "
            f"pad_multiple=n_chunks (optimizer shard_size)")
    return bucket.padded // n_chunks


def _chunk_of(bucket: Bucket, parts, j: int, csize: int, pad_dtype):
    """Slices ``[j * csize, (j + 1) * csize)`` of the bucket, from the leaf
    slabs ``parts`` (zeros past the last entry)."""
    lo, hi = j * csize, (j + 1) * csize
    pieces = []
    for e, part in zip(bucket.entries, parts, strict=True):
        s, t = max(lo, e.offset), min(hi, e.offset + e.lead)
        if s < t:
            pieces.append(part[s - e.offset:t - e.offset].to(pad_dtype))
    filled = sum(p.shape[0] for p in pieces)
    if filled < csize:  # tail pad of the last chunk(s)
        pieces.append(torch.zeros((csize - filled, bucket.d_in, bucket.d_out),
                                  dtype=pad_dtype, device=parts[0].device))
    return pieces


def gather_chunks(plan: BucketPlan, tree: PyTree, n_chunks: int,
                  dtype=None, only: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """Stack the planned leaves of ``tree`` into ``(n_chunks, padded L /
    n_chunks, d_in, d_out)`` per-bucket operands: :func:`gather` split along
    ``L`` into the chunks of an ``n_chunks``-way ZeRO axis (chunk ``j`` is
    rank ``j``'s shard; pad slices zero-filled). The whole ``(padded L,
    d_in, d_out)`` bucket is never built apart from its chunks.

    ``only=j`` returns chunk ``j`` alone, ``(padded L / n_chunks, d_in,
    d_out)``: the slices a rank updates."""
    by_path = dict(tree_paths(tree))
    out = {}
    for b in plan.buckets:
        csize = _chunk_size(b, n_chunks)
        parts, pad_dtype = _bucket_parts(b, by_path, dtype)
        if only is not None:
            pieces = _chunk_of(b, parts, only, csize, pad_dtype)
            out[b.key] = (pieces[0].contiguous() if len(pieces) == 1
                          else torch.cat(pieces, dim=0))
            continue
        buf = torch.empty((n_chunks, csize, b.d_in, b.d_out), dtype=pad_dtype,
                          device=parts[0].device)
        for j in range(n_chunks):
            row = 0
            for p in _chunk_of(b, parts, j, csize, pad_dtype):
                buf[j, row:row + p.shape[0]] = p
                row += p.shape[0]
        out[b.key] = buf
    return out


def init_chunk_acc(plan: BucketPlan, n_chunks: int, dtype=torch.float32,
                   device=None) -> Dict[str, torch.Tensor]:
    """Zero chunked gradient accumulators, one ``(n_chunks, padded L /
    n_chunks, d_in, d_out)`` buffer per bucket (:func:`accumulate_chunks`)."""
    return {b.key: torch.zeros((n_chunks, _chunk_size(b, n_chunks), b.d_in,
                                b.d_out), dtype=dtype, device=device)
            for b in plan.buckets}


def accumulate_chunks(plan: BucketPlan, tree: PyTree,
                      acc: Dict[str, torch.Tensor], n_chunks: int,
                      dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """Add one microbatch's planned leaves of ``tree`` into the chunked
    accumulators ``acc`` (from :func:`init_chunk_acc`), in place, and return
    them. The leaves are chunked first, so accumulation never builds the
    whole ``(padded L, d_in, d_out)`` bucket; chunking is slicing, so the
    accumulated chunks are the chunks of the accumulated leaves, bit for
    bit."""
    chunks = gather_chunks(plan, tree, n_chunks, dtype=dtype)
    for k in acc:
        acc[k] += chunks[k]
    return acc


def scatter_chunks(plan: BucketPlan, chunks: Dict[str, torch.Tensor],
                   base: PyTree) -> PyTree:
    """Inverse of :func:`gather_chunks`: rebuild each planned leaf of
    ``base`` from its pieces across the chunk axis (pad slices dropped,
    other leaves passed through)."""
    slices = {}
    for b in plan.buckets:
        for e in b.entries:
            slices[e.path] = (b, e)

    def visit(path, leaf):
        hit = slices.get(path)
        if hit is None:
            return leaf
        b, e = hit
        stacked = chunks[b.key]
        csize = stacked.shape[1]
        pieces = []
        for j in range(stacked.shape[0]):
            lo, hi = j * csize, (j + 1) * csize
            s, t = max(lo, e.offset), min(hi, e.offset + e.lead)
            if s < t:
                pieces.append(stacked[j, s - lo:t - lo])
        out = pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim=0)
        return out.reshape(e.shape)

    return map_with_path(visit, base)


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


def unpad_buckets(plan: BucketPlan,
                  bufs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Strip the pad slices from per-bucket stacked buffers: ``(padded L,
    ...)`` -> ``(true L, ...)`` (momentum and slot stripes alike). With
    :func:`repad_buckets` this is the elastic reshard: ``padded_size`` is
    the one quantity of the layout that depends on the shard size, and pad
    slices are zero, so unpad then repad under the new plan moves no real
    slice."""
    out = {}
    for b in plan.buckets:
        buf = bufs[b.key]
        if buf.shape[0] != b.padded:
            raise ValueError(
                f"bucket {b.key!r}: buffer holds {buf.shape[0]} slices but "
                f"the plan stacks {b.size} padded to {b.padded} — was this "
                f"buffer produced under a different plan / shard_size?")
        out[b.key] = buf[:b.size]
    return out


def repad_buckets(plan: BucketPlan,
                  bufs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`unpad_buckets` under ``plan``: zero-pad each true
    ``(L, ...)`` buffer to the plan's padded size."""
    out = {}
    for b in plan.buckets:
        buf = torch.as_tensor(bufs[b.key])
        if buf.shape[0] != b.size:
            raise ValueError(
                f"bucket {b.key!r}: buffer holds {buf.shape[0]} slices but "
                f"the plan stacks {b.size} — unpad under the writing plan "
                f"before repadding under this one")
        if b.padded > b.size:
            pad = torch.zeros((b.padded - b.size,) + tuple(buf.shape[1:]),
                              dtype=buf.dtype, device=buf.device)
            buf = torch.cat([buf, pad], dim=0)
        out[b.key] = buf
    return out


def shard_count(bucket: Bucket, l_loc: int) -> int:
    """Number of ZeRO shards implied by a local momentum buffer of ``l_loc``
    slices: 1 (the full padded buffer) or ``padded_size / l_loc``. Any other
    ``l_loc`` is a mismatched buffer (state restored for another shard size,
    or a plan with another ``pad_multiple``) and raises."""
    psize = bucket.padded
    if l_loc < 1 or psize % l_loc:
        raise ValueError(
            f"bucket {bucket.key!r}: momentum buffer holds {l_loc} slices "
            f"but the bucket stacks {bucket.size} (padded to {psize}); "
            f"expected the full padded buffer or an exact 1/N shard with "
            f"{psize} % l_loc == 0 — was the optimizer state restored from "
            f"a different mesh or built with a different shard_size?")
    return psize // l_loc


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


def bucket_update_apply(bucket: Bucket, g: torch.Tensor, v: torch.Tensor,
                        w: torch.Tensor, *, scale, weight_decay: float,
                        beta: float, eps: float, shard_axis=None):
    """Single-pass RMNP update of one stacked bucket, ZeRO-1 aware. ``g``
    and ``w`` are the full ``(padded L, d_in, d_out)`` operands; ``v`` is
    the full momentum or this rank's ``(padded L / N, ...)`` shard. On a
    shard the kernel runs over the rank's slices and ``shard_axis`` (a
    :class:`repro_torch.distributed.comm.Comm`) all-gathers the updated
    weight slices. Returns ``(w_new full, v_new in v's layout)``."""
    l_loc = v.shape[0]
    n_shards = shard_count(bucket, l_loc)
    if g.shape[0] != bucket.padded or w.shape[0] != bucket.padded:
        raise ValueError(
            f"bucket {bucket.key!r}: gradient/weight operands have "
            f"{g.shape[0]}/{w.shape[0]} slices, expected the padded bucket "
            f"size {bucket.padded}")
    if n_shards > 1:
        if shard_axis is None:
            raise ValueError(
                f"bucket {bucket.key!r}: momentum holds {l_loc} of "
                f"{bucket.padded} slices but no shard_axis was given")
        lo = shard_axis.rank * l_loc
        g, w = g[lo:lo + l_loc], w[lo:lo + l_loc]
    v_new, w_new = _apply_one(g, v, w, scale, weight_decay, beta, eps)
    if n_shards > 1:
        w_new = shard_axis.all_gather(w_new)
    return w_new, v_new


def bucket_update_apply_sharded(bucket: Bucket, g_shard: torch.Tensor,
                                v: torch.Tensor, w_shard: torch.Tensor, *,
                                scale, weight_decay: float, beta: float,
                                eps: float, shard_axis):
    """ZeRO-2 single-pass RMNP update of one stacked bucket: the gradient
    arrives reduced and sharded (this rank's ``(padded L / N, d_in, d_out)``
    mean-gradient shard), ``v`` and ``w_shard`` are the matching shards. The
    kernel runs shard in, shard out, and only the updated weight slices are
    all-gathered. Returns ``(w_new full padded bucket, v_new shard)``."""
    l_loc = v.shape[0]
    shard_count(bucket, l_loc)
    if g_shard.shape[0] != l_loc or w_shard.shape[0] != l_loc:
        raise ValueError(
            f"bucket {bucket.key!r}: gradient/weight shards have "
            f"{g_shard.shape[0]}/{w_shard.shape[0]} slices but the momentum "
            f"shard has {l_loc}")
    v_new, w_new = _apply_one(g_shard, v, w_shard, scale, weight_decay, beta, eps)
    return shard_axis.all_gather(w_new), v_new
