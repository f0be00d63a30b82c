"""FLOPs, transcendentals, bytes, collective wire bytes and device memory of
one step, counted over the ops it dispatches (counterpart of
``repro.launch.hlo_cost``).

The JAX package parses the compiled HLO of a step. Eager PyTorch has no
HLO, but each dispatched op is one kernel on the card, so the count here
runs over the ops that run the real step on **meta tensors**: the step runs
under :class:`StepCounter`, a dispatch mode (a ``analysis.trace.Recorder``
that counts instead of keeping), under ``kernels/introspect.recording()``,
and, for a rank of a group, with a :class:`CostComm` (a
``RecordingComm``). Nothing is allocated on a device and no kernel is built.

Per op:

* **FLOPs.** ``2 * M * N * K`` for the matmul family (``mm``, ``bmm``,
  ``addmm``, ``baddbmm``; ``linear``, ``matmul`` and ``einsum`` reach the
  dispatcher as these), and the same rule for a convolution. One FLOP per
  element for elementwise arithmetic and per input element for a
  reduction, as ``hlo_cost.py:1-20`` counts them; a composite op (softmax,
  SiLU, layer norm, their backwards) counts the elementwise ops XLA would
  see for it (``_ELEMENTWISE``). Transcendentals (exp, log, tanh, sqrt,
  rsqrt, sigmoid, erf, pow, sin, cos) are also counted apart.
* **Bytes.** Each operand read once and each result written once, at the
  elements it spans (a broadcast dimension counts once). A view, an alias,
  an allocation or a metadata-only op moves nothing. A gather or an index
  reads only what it gathers, and a write into a slice or by an index
  (``copy_`` into a view, ``index_put_``) moves only the slice: the rule
  of ``hlo_cost.py`` for ``dynamic-slice`` and ``dynamic-update-slice``.
* **The port's own kernels**, from their launch records (a wrapper on meta
  tensors dispatches only its output allocations, so a kernel is counted
  once), through the formulas of ``launch/roofline.py``: ``rmnp_bytes``,
  ``attention_flops`` and ``gemm_counts``.
* **Collectives**, per kind: count, result bytes and ring wire bytes
  (:func:`wire_bytes`, ``hlo_cost.py:97``), and their local reads and
  writes in ``bytes``.

**Which peak a FLOP is held against** (``UNITS``; ``launch/roofline.
unit_seconds``): a bf16 (or fp16) product, the bf16 tensor-core peak; an
fp32 product, the CUDA cores' FFMA peak, since the port leaves TF32 off
(``torch.backends.cuda.matmul.allow_tf32 = False``); the 3xTF32 GEMM and
fp32 flash kernels, three TF32 products per fp32 product at the TF32
tensor-core peak; elementwise work, reductions and transcendentals, FFMA.

The JAX module multiplies a ``while`` body by its trip count because XLA
counts it once. Eager dispatch runs every iteration of every loop (layers,
microbatches, chunks, decode steps), so there are no loop multipliers here.

**Memory.** The counter also keeps the bytes of a rank as the card's
caching allocator would: each new storage adds its bytes, rounded up to 512,
when an op makes it, and gives them back when it dies (a ``weakref`` on the
storage), on the same Python lifetimes as a run on the card. Its origin
(an argument's name, ``forward`` or ``backward``: made inside the autograd
engine) is kept with it, so the peak comes with what it is made of. The
allocator's other rounding (a large block it does not split keeps up to
1 MB more than asked) is not modelled.

**Speed.** PyTorch's meta kernels are mostly Python, and a loop over time
(sLSTM) or over layers repeats the same ops on the same shapes. The first
call of an op with given argument metadata runs its meta kernel and keeps
how its outputs follow from its inputs (each a new storage of a shape and
strides, the input itself, or a view of an input at an offset from it)
with its count; a later call with the same metadata makes its outputs so
and adds the same count. An op whose outputs do not follow so (one that
changes an input's shape in place, a storage larger than its tensor) is
run every time. Counts and memory are the same either way
(``tests/test_torch_dryrun.py``).
"""
from __future__ import annotations

import contextlib
import heapq
import math
import weakref
from collections import Counter
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.analysis.trace import Recorder, RecordingComm, _flat
from repro_torch.distributed.comm import Pending, rank_order_sum
from repro_torch.kernels import introspect
from repro_torch.launch import roofline as rl

BF16_TC, TF32X3_TC, FP32_FFMA = "bf16_tensor_core", "tf32x3_tensor_core", "fp32_ffma"
UNITS = (BF16_TC, TF32X3_TC, FP32_FFMA)
COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
ROUND = 512  # the caching allocator's smallest block and rounding
_KEEP_TOP = 64

_MATMUL = {"mm", "bmm", "addmm", "baddbmm", "addbmm", "mv", "addmv", "dot", "vdot"}
# (FLOPs, transcendentals) per output element
_ELEMENTWISE = {
    **{n: (1, 0) for n in (
        "add", "sub", "rsub", "mul", "div", "neg", "abs", "maximum", "minimum", "clamp",
        "clamp_min", "clamp_max", "sign", "floor", "ceil", "round", "trunc", "remainder",
        "fmod", "reciprocal", "square", "relu", "hardtanh", "leaky_relu", "threshold_backward",
        "floor_divide")},
    **{n: (1, 1) for n in (
        "exp", "exp2", "expm1", "log", "log2", "log10", "log1p", "tanh", "sqrt", "rsqrt", "pow",
        "atan2", "sigmoid", "erf", "erfinv", "cos", "sin")},
    "lerp": (3, 0), "addcmul": (2, 0), "addcdiv": (2, 0),
    "silu": (2, 1),                       # x * logistic(x)
    "softplus": (2, 2),                   # log1p(exp(x))
    "logaddexp": (4, 2),                  # max + log1p(exp(-|a - b|))
    "gelu": (5, 1),                       # x * 0.5 * (1 + erf(x / sqrt 2))
    "tanh_backward": (3, 0), "sigmoid_backward": (3, 0),
    "silu_backward": (5, 1), "gelu_backward": (8, 2), "softplus_backward": (3, 1),
    "_softmax": (5, 1),                   # max, subtract, exp, sum, divide
    "_log_softmax": (5, 1),               # max, subtract, exp, sum, subtract
    "_softmax_backward_data": (4, 0),     # g * y, sum, subtract, multiply
    "_log_softmax_backward_data": (4, 1),  # exp(y), sum, multiply, subtract
    "native_layer_norm": (8, 0), "native_layer_norm_backward": (12, 0),
    "nll_loss_forward": (1, 0), "nll_loss_backward": (1, 0),
    "embedding_dense_backward": (1, 0),   # an add per gradient element
    "_fused_rms_norm": (5, 0),
}
# FLOPs (and transcendentals) per input element
_REDUCE = {
    **{n: (1, 0) for n in (
        "sum", "mean", "amax", "amin", "max", "min", "prod", "argmax", "argmin", "cumsum",
        "cumprod", "any", "all", "topk", "sort", "nansum", "count_nonzero")},
    "linalg_vector_norm": (2, 0), "norm": (2, 0), "var": (3, 0), "var_mean": (3, 0),
    "std": (3, 0), "std_mean": (3, 0), "logsumexp": (3, 1),
}
# ops that read what they gather: source read at the result's size
_GATHER = {"index", "index_select", "gather", "embedding", "take", "masked_select"}
# ops that write into ``self`` only where their update lands
_SCATTER = {"index_put", "index_copy", "scatter", "scatter_add", "index_add",
            "masked_scatter", "index_fill"}
# ops that write ``self`` without reading it
_OVERWRITE = {"copy", "fill", "zero", "normal", "uniform", "random", "bernoulli",
              "exponential", "set"}
# allocations and metadata: no traffic
_FREE = {"empty", "empty_like", "new_empty", "empty_strided", "new_empty_strided",
         "resize", "detach", "alias", "lift_fresh", "lift_fresh_copy", "_local_scalar_dense",
         "sym_size", "sym_stride", "sym_numel", "sym_storage_offset", "is_same_size",
         "_has_compatible_shallow_copy_type", "record_stream", "set_"}
# ops that only move or make data: no FLOPs by design
_MOVES = {"cat", "stack", "clone", "_to_copy", "copy", "constant_pad_nd", "repeat",
          "repeat_interleave", "where", "masked_fill", "fill", "zero", "zeros", "zeros_like",
          "ones", "ones_like", "full", "full_like", "new_zeros", "new_ones", "new_full",
          "arange", "eq", "ne", "lt", "le", "gt", "ge", "logical_not", "logical_and",
          "logical_or", "bitwise_and", "bitwise_or", "bitwise_not", "isnan", "isinf",
          "isfinite", "tril", "triu", "flip", "roll", "randn", "rand", "randint", "normal",
          "uniform", "scalar_tensor", "_unsafe_view", "split_with_sizes_copy", "unbind_copy",
          "slice_scatter", "select_scatter", "diagonal_scatter", "one_hot", "bucketize",
          "searchsorted", "nonzero", "unique", "tensor", "as_strided_scatter",
          "_pin_memory", "view_copy", "expand_copy", "permute_copy", "_reshape_copy",
          "_foreach_zero", "_index_put_impl", "_assert_async",
          "_assert_tensor_metadata", "_functional_assert_async", "lift", "bitwise_xor",
          "select_backward", "slice_backward", "index_select_backward", "unfold_backward"}
_MOVES |= _GATHER | _SCATTER | _FREE


def wire_bytes(kind: str, result_bytes: float, g: int) -> float:
    """Ring-schedule wire bytes per participant (``hlo_cost.py:97``
    ``_wire_bytes``, ``dryrun.py:79`` ``parse_collectives``)."""
    if kind == "all-gather":
        return result_bytes * (g - 1) / g
    if kind == "all-reduce":
        return 2 * result_bytes * (g - 1) / g
    if kind == "reduce-scatter":
        return result_bytes * (g - 1)   # the result is the local shard
    if kind == "all-to-all":
        return result_bytes * (g - 1) / g
    return float(result_bytes)          # collective-permute


def _base(name: str) -> str:
    """``add`` for the in-place ``add_``."""
    return name[:-1] if name.endswith("_") and not name.endswith("__") else name


def span_bytes(t: torch.Tensor) -> int:
    """The bytes of the elements a (possibly strided) tensor spans, each
    once: a dimension of stride 0 (a broadcast) counts one element."""
    n = 1
    for size, stride in zip(t.shape, t.stride(), strict=True):
        if size == 0:
            return 0
        if stride != 0:
            n *= size
    return n * t.element_size()


def _rounded(n: int) -> int:
    return 0 if n == 0 else -(-n // ROUND) * ROUND


def _is_float16(t: torch.Tensor) -> bool:
    return t.dtype in (torch.bfloat16, torch.float16)


def matmul_flops(name: str, args) -> Tuple[float, float, Optional[torch.Tensor]]:
    """(``2 M N K``, the epilogue's elementwise FLOPs, the left operand) of
    a matmul-family op."""
    ts = [a for a in args if isinstance(a, torch.Tensor)]
    if name in ("mm", "bmm"):
        a, b = ts[0], ts[1]
        return 2.0 * a.numel() * b.shape[-1], 0.0, a
    if name in ("addmm", "baddbmm", "addbmm"):
        c, a, b = ts[0], ts[1], ts[2]
        prod = 2.0 * a.numel() * b.shape[-1]
        return prod, float(a.numel() // a.shape[-1] * b.shape[-1]), a
    if name in ("mv", "addmv"):
        a = ts[0] if name == "mv" else ts[1]
        return 2.0 * a.numel(), 0.0 if name == "mv" else float(a.shape[0]), a
    return 2.0 * ts[0].numel(), 0.0, ts[0]  # dot, vdot


def conv_flops(name: str, args, kwargs, out) -> Tuple[float, Optional[torch.Tensor]]:
    """``2 * output elements * (C_in / groups * kernel elements)`` a pass;
    the backward counts it once per gradient it makes (input, weight) and
    an add per element for the bias's."""
    if name == "convolution":
        weight = args[1]
        return 2.0 * out.numel() * math.prod(weight.shape[1:]), args[0]
    grad, weight = args[0], args[2]
    mask = args[10] if len(args) > 10 else kwargs.get("output_mask", (True, True, True))
    one = 2.0 * grad.numel() * math.prod(weight.shape[1:])
    return one * (int(mask[0]) + int(mask[1])) + grad.numel() * int(mask[2]), grad


class Totals:
    """The cost of everything counted so far."""

    def __init__(self):
        self.flops_by_unit = {u: 0.0 for u in UNITS}
        self.transcendentals = 0.0
        self.bytes = 0.0
        self.matmul_flops = 0.0
        self.coll = {k: {"count": 0, "result_bytes": 0.0, "wire_bytes": 0.0}
                     for k in COLLECTIVES}
        # the same, by group: "data" (ZeRO-2, the batch) and "model"
        self.coll_by_group: Dict[str, Dict[str, Dict[str, float]]] = {}
        self.kernel_launches: Counter = Counter()
        self.unclassified: Counter = Counter()
        self.by_op: Dict[str, Dict[str, float]] = {}
        self._top: List[Tuple[float, int, str, str]] = []
        self._n = 0

    def add(self, name: str, flops: float, unit: str, transcendentals: float, nbytes: float,
            shapes: str = "", matmul: float = 0.0, extra_ffma: float = 0.0):
        self.flops_by_unit[unit] += flops
        self.flops_by_unit[FP32_FFMA] += extra_ffma
        self.transcendentals += transcendentals
        self.bytes += nbytes
        self.matmul_flops += matmul
        agg = self.by_op.setdefault(name, {"count": 0, "flops": 0.0, "bytes": 0.0})
        agg["count"] += 1
        agg["flops"] += flops + extra_ffma
        agg["bytes"] += nbytes
        self._n += 1
        row = (nbytes, self._n, name, shapes)
        if len(self._top) < _KEEP_TOP:
            heapq.heappush(self._top, row)
        elif nbytes > self._top[0][0]:
            heapq.heapreplace(self._top, row)

    @property
    def flops(self) -> float:
        return sum(self.flops_by_unit.values())

    def as_dict(self) -> Dict[str, Any]:
        """``analyze_hlo``'s keys, and beside them the FLOPs by unit, the
        matmul FLOPs, the compute time at the units' peaks, the kernels'
        launches and the ops no rule counted FLOPs for."""
        return {
            "flops": self.flops,
            "transcendentals": self.transcendentals,
            "bytes_accessed": self.bytes,
            "collectives": {k: dict(v) for k, v in self.coll.items()},
            "collective_wire_bytes": sum(v["wire_bytes"] for v in self.coll.values()),
            "collectives_by_group": {g: {k: dict(v) for k, v in c.items()}
                                     for g, c in self.coll_by_group.items()},
            "collective_wire_bytes_by_group": {
                g: sum(v["wire_bytes"] for v in c.values())
                for g, c in self.coll_by_group.items()},
            "flops_by_unit": dict(self.flops_by_unit),
            "matmul_flops": self.matmul_flops,
            "compute_s": rl.unit_seconds(self.flops_by_unit),
            "kernel_launches": dict(self.kernel_launches),
            "unclassified_ops": dict(self.unclassified),
        }

    def top(self, n: int) -> List[Tuple[float, str, str]]:
        return [(b, name, shapes) for b, _, name, shapes in sorted(self._top, reverse=True)[:n]]


class Memory:
    """Live bytes of the storages made on the planned device, rounded as the
    caching allocator rounds them, with the peak and its make-up."""

    def __init__(self):
        self.live = 0
        self.peak = 0
        self.by_origin: Counter = Counter()
        self.by_maker: Counter = Counter()
        self.at_peak: Dict[str, int] = {}
        self.makers_at_peak: Dict[str, int] = {}
        self._alive: Dict[int, Tuple[weakref.ref, int, str, str]] = {}
        self._peak_dirty = False  # a new peak whose make-up is not taken yet

    def track(self, t: torch.Tensor, origin: str, maker: str = "") -> bool:
        """Count ``t``'s storage from now until it dies, under ``origin``
        and the op that made it; False if it is counted already."""
        st = t.untyped_storage()
        key = id(st)
        if key in self._alive:
            return False
        n = _rounded(st.nbytes())
        maker = f"{origin}:{maker}" if maker else origin
        self._alive[key] = (weakref.ref(st, lambda _r, k=key: self._free(k)), n, origin, maker)
        self.live += n
        self.by_origin[origin] += n
        self.by_maker[maker] += n
        if self.live > self.peak:
            self.peak = self.live
            self._peak_dirty = True
        return True

    def _free(self, key: int) -> None:
        entry = self._alive.pop(key, None)
        if entry is not None:
            if self._peak_dirty:  # the live set is at its peak until this free
                self._snapshot()
            self.live -= entry[1]
            self.by_origin[entry[2]] -= entry[1]
            self.by_maker[entry[3]] -= entry[1]

    def _snapshot(self) -> None:
        self.at_peak = {k: v for k, v in self.by_origin.items() if v}
        self.makers_at_peak = dict(sorted(((k, v) for k, v in self.by_maker.items() if v),
                                          key=lambda kv: -kv[1])[:12])
        self._peak_dirty = False

    def settle(self) -> None:
        """Take the peak's make-up if the live set still stands at it."""
        if self._peak_dirty:
            self._snapshot()


class StepCounter(Recorder):
    """Counts the FLOPs, bytes and collectives of every op dispatched on the
    planned device (``meta``), and the device memory its storages hold.
    Use :meth:`run`; arguments made before it are counted with
    :meth:`register`."""

    def __init__(self, world: int = 1):
        super().__init__()
        self.world = world
        self.device = torch.device("meta")
        self.totals = Totals()
        self.memory = Memory()
        self._launches: Optional[List[introspect.KernelLaunch]] = None
        self._drained = 0
        self._quiet = 0
        self._seen: Dict[Any, Tuple] = {}

    # -- set-up ---------------------------------------------------------
    def comm(self, rank: int = 0, world: Optional[int] = None,
             group: str = "data") -> "CostComm":
        """Rank ``rank`` of a recording group of ``world`` ranks (the
        counter's by default) whose collectives count under ``group``."""
        return CostComm(self, rank=rank, world=world, group=group)

    def register(self, tree, origin: str) -> int:
        """Count the storages of ``tree``'s tensors (made before the
        counted window) under ``origin``; returns their own bytes (the
        allocator's rounding is in ``memory``)."""
        n = 0
        for t in _flat(tree):
            if t.device == self.device and self.memory.track(t, origin):
                n += t.untyped_storage().nbytes()
        return n

    def run(self, fn, *args, **kwargs):
        """``fn(*args, **kwargs)`` under the counter and a kernel recording."""
        with introspect.recording() as launches, self:
            self._launches, self._drained = launches, 0
            try:
                return fn(*args, **kwargs)
            finally:
                self._drain()
                self._launches = None
                self.memory.settle()

    # -- the dispatch mode ----------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        self._drain()
        ins, key = _scan(func, args, kwargs)
        entry = self._seen.get(key) if key is not None else None
        if entry is None:
            return self._first(func, args, kwargs, ins, key)
        recipe, structure, counted = entry
        outs = self._replay(recipe, ins)
        origin = "backward" if torch._C._current_graph_task_id() != -1 else "forward"
        for t, r in zip(outs, recipe, strict=True):
            if r[0] == "new":
                self.memory.track(t, origin, counted[0])
        self._add(counted)
        return outs[0] if structure is None else structure(outs)

    def _first(self, func, args, kwargs, ins, key):
        """Run ``func`` on its meta inputs and count it; where the op's
        outputs follow from the inputs' metadata alone, keep how to make
        them (``_seen``), so that the next call with the same metadata
        skips the meta kernel (PyTorch's meta kernels are mostly Python)."""
        before = [(t.shape, t.stride(), t.storage_offset()) for t in ins]
        out = func(*args, **kwargs)
        outs = list(_flat(out))
        if not any(t.device == self.device for t in ins + outs):
            return out  # host work
        recipe = self._recipe(ins, outs)
        origin = "backward" if torch._C._current_graph_task_id() != -1 else "forward"
        name = _base(introspect.op_name(func))
        for t, r in zip(outs, recipe, strict=True):
            if r[0] == "new":
                self.memory.track(t, origin, name)
        # an output on an input's storage that is not the input itself is a
        # view, whatever the schema says (``_unsafe_view``)
        aliased = bool(recipe) and all(r[0] in ("in", "out") for r in recipe)
        counted = self._count(func, args, kwargs, ins, outs, out, aliased)
        self._add(counted)
        mutated = any((t.shape, t.stride(), t.storage_offset()) != b
                      for t, b in zip(ins, before, strict=True))
        structure = (None if isinstance(out, torch.Tensor)
                     else type(out) if isinstance(out, (tuple, list))
                     and len(outs) == len(out) else False)
        if key is not None and not mutated and structure is not False and all(
                r[0] != "host" for r in recipe):
            self._seen[key] = (recipe, structure, counted)
        return out

    def _recipe(self, ins, outs):
        """Per output: ``("new", size, stride, dtype)`` (its own storage),
        ``("self", j)`` (input j itself), ``("in" or "out", j, size, stride,
        offset from j's)`` (a view of input or earlier output j), or
        ``("host",)``."""
        def sid(t):
            return t.untyped_storage()._cdata
        in_ids = [sid(t) for t in ins]
        recipe, out_ids = [], []
        for t in outs:
            if t.device != self.device:
                recipe.append(("host",))
                out_ids.append(None)
                continue
            i = sid(t)
            out_ids.append(i)
            same = [j for j, x in enumerate(ins) if x is t]
            if same:
                recipe.append(("self", same[0]))
            elif i in in_ids:
                src = ins[in_ids.index(i)]
                recipe.append(("in", in_ids.index(i), tuple(t.shape), t.stride(),
                               t.storage_offset() - src.storage_offset())
                              if src.dtype == t.dtype else ("host",))
            elif i in out_ids[:-1]:
                m = out_ids.index(i)
                recipe.append(("out", m, tuple(t.shape), t.stride(),
                               t.storage_offset() - outs[m].storage_offset()))
            elif (t.storage_offset() == 0 and t.untyped_storage().nbytes()
                  == _span(t.shape, t.stride()) * t.element_size()):
                recipe.append(("new", tuple(t.shape), t.stride(), t.dtype))
            else:
                recipe.append(("host",))  # storage beyond the tensor: not replayed
        return recipe

    def _replay(self, recipe, ins):
        outs = []
        for r in recipe:
            if r[0] == "new":
                outs.append(torch.empty_strided(r[1], r[2], dtype=r[3], device=self.device))
            elif r[0] == "self":
                outs.append(ins[r[1]])
            else:
                src = (ins if r[0] == "in" else outs)[r[1]]
                outs.append(torch.ops.aten.as_strided.default(
                    src, r[2], r[3], src.storage_offset() + r[4]))
        return outs

    def _add(self, counted):
        base, flops, unit, tr, nbytes, shapes, matmul, extra, unclassified = counted
        if unclassified:
            self.totals.unclassified[base] += 1
        self.totals.add(base, flops, unit, tr, nbytes, shapes, matmul, extra)

    def _count(self, func, args, kwargs, ins, outs, out, aliased=False):
        """(name, FLOPs, unit, transcendentals, bytes, shapes, matmul FLOPs,
        FFMA FLOPs, unclassified) of one op; ``aliased``: every output is a
        view of an input."""
        name = introspect.op_name(func)
        base = _base(name)
        returns = func._schema.returns
        aliases = [r.alias_info for r in returns]
        views = aliased or (returns and all(a is not None and not a.is_write
                                            for a in aliases))
        shapes = f"{base}{[tuple(t.shape) for t in ins][:3]}"
        nbytes = 0.0
        if not (views or base in _FREE):
            nbytes = self._bytes(base, ins, outs, aliases)
        flops = tr = matmul = extra = 0.0
        unit = FP32_FFMA
        unclassified = False
        if base in _MATMUL:
            matmul, extra, lhs = matmul_flops(base, args)
            flops = matmul
            unit = BF16_TC if _is_float16(lhs) else FP32_FFMA
        elif base in ("convolution", "convolution_backward"):
            flops, lhs = conv_flops(base, args, kwargs, out)
            matmul = flops
            unit = BF16_TC if _is_float16(lhs) else FP32_FFMA
        elif base in _REDUCE and not (base in ("max", "min") and len(ins) > 1):
            per, per_tr = _REDUCE[base]
            n = ins[0].numel() if ins else 0
            flops, tr = per * n, per_tr * n
        elif base in _ELEMENTWISE or base in ("max", "min"):
            per, per_tr = _ELEMENTWISE.get(base, (1, 0))
            n = max((t.numel() for t in outs), default=0)
            flops, tr = per * n, per_tr * n
        elif not views and base not in _MOVES:
            unclassified = True
        return base, flops, unit, tr, nbytes, shapes, matmul, extra, unclassified

    def _bytes(self, base, ins, outs, aliases) -> float:
        written = {id(t) for t, a in zip(outs, aliases) if a is not None and a.is_write}
        if base in _GATHER:
            src, rest = ins[:1], ins[1:]
            return 2 * sum(span_bytes(t) for t in outs) + _unique_bytes(rest)
        if base in _SCATTER:
            # self (ins[0]) is written where the update lands; the values and
            # the indices are read, and the values' size written
            rest = ins[1:]
            values = max((span_bytes(t) for t in rest if t.is_floating_point()), default=0)
            rmw = values if base in ("index_add", "scatter_add") else 0
            return _unique_bytes(rest) + values + rmw
        reads = [t for t in ins if not (base in _OVERWRITE and id(t) in written)]
        return _unique_bytes(reads) + sum(span_bytes(t) for t in outs)

    # -- kernels and collectives ------------------------------------------
    def _drain(self) -> None:
        if self._launches is None:
            return
        while self._drained < len(self._launches):
            self._kernel(self._launches[self._drained])
            self._drained += 1

    def _kernel(self, launch: introspect.KernelLaunch) -> None:
        flops, unit, tr, nbytes, matmul, extra = kernel_cost(launch)
        self.totals.kernel_launches[launch.name] += 1
        shapes = f"{launch.signature}{[o.shape for o in launch.operands][:3]}"
        self.totals.add(f"kernel:{launch.name}", flops, unit, tr, nbytes, shapes, matmul,
                        extra)

    def collective(self, name: str, x: torch.Tensor, out: torch.Tensor,
                   world: Optional[int] = None, group: str = "data") -> None:
        """A collective of ``kind`` (``all_to_all``/``all_gather`` as
        ``RecordingComm`` names them, or a ``COLLECTIVES`` kind) with operand
        ``x`` and result ``out``, on ``group`` of ``world`` ranks (the
        counter's by default)."""
        if self._quiet:
            return
        kind = name.replace("_", "-")
        rb = float(span_bytes(out))
        wire = wire_bytes(kind, rb, self.world if world is None else world)
        by_group = self.totals.coll_by_group.setdefault(
            group, {k: {"count": 0, "result_bytes": 0.0, "wire_bytes": 0.0}
                    for k in COLLECTIVES})
        for c in (self.totals.coll[kind], by_group[kind]):
            c["count"] += 1
            c["result_bytes"] += rb
            c["wire_bytes"] += wire
        self.totals.add(f"collective:{kind}", 0.0, FP32_FFMA, 0.0, span_bytes(x) + rb,
                        f"{kind}{[tuple(x.shape)]}")

    @contextlib.contextmanager
    def quiet(self):
        """Collectives issued inside are parts of one already counted."""
        self._quiet += 1
        try:
            yield
        finally:
            self._quiet -= 1

    # -- results ----------------------------------------------------------
    def cost(self) -> Dict[str, Any]:
        return self.totals.as_dict()

    def breakdown(self, top: int = 12):
        """(per op name: count, FLOPs, bytes; the ``top`` ops by bytes)."""
        agg = dict(sorted(self.totals.by_op.items(), key=lambda kv: -kv[1]["bytes"]))
        return agg, self.totals.top(top)


class CostComm(RecordingComm):
    """Rank ``rank`` of a recording group of ``world`` ranks (``group``:
    ``"data"`` or ``"model"``) whose collectives are counted by kind and
    group: a reduce-scatter (the port's is an all-to-all and a rank-order
    sum) and an all-reduce (a reduce-scatter and an all-gather) count once
    as themselves, at their ring wire bytes; the local sums they run are
    counted as ops."""

    def __init__(self, counter: StepCounter, rank: int = 0, world: Optional[int] = None,
                 group: str = "data"):
        super().__init__(counter, rank=rank, world=counter.world if world is None else world)
        self.group_name = group

    def _note(self, kind, x, out):
        self.recorder.collective(kind, x, out, world=self.world, group=self.group_name)

    def all_to_all(self, x, async_op=False):
        self._rows(x)
        out = torch.empty_like(x, memory_format=torch.contiguous_format)
        self._note("all_to_all", x, out)
        return Pending([], lambda: out) if async_op else out

    def all_gather(self, x, async_op=False):
        out = x.new_empty((self.world * x.shape[0],) + tuple(x.shape[1:]))
        self._note("all_gather", x, out)
        return Pending([], lambda: out) if async_op else out

    def reduce_scatter(self, x, async_op=False):
        self._rows(x)
        self._note("reduce-scatter", x, x[0])
        with self.recorder.quiet():
            recv = self.all_to_all(x)
        out = rank_order_sum(recv)
        return Pending([], lambda: out) if async_op else out

    def all_reduce(self, x):
        self._note("all-reduce", x, x)
        with self.recorder.quiet():
            return super().all_reduce(x)


def _unique_bytes(ts) -> float:
    """Each tensor's bytes once, however often it is passed."""
    seen, n = set(), 0
    for t in ts:
        if id(t) not in seen:
            seen.add(id(t))
            n += span_bytes(t)
    return n


def _span(shape, stride) -> int:
    """Elements of storage a tensor of ``shape`` and ``stride`` needs."""
    if any(n == 0 for n in shape):
        return 0
    return 1 + sum((n - 1) * st for n, st in zip(shape, stride, strict=True))


_ATOMS = (int, float, bool, str, type(None), torch.dtype, torch.device, torch.layout,
          torch.memory_format)


def _scan(func, args, kwargs):
    """(the tensors among an op's arguments, in order, repeats kept; the
    key its outputs and count follow from: the op, its non-tensor
    arguments, each tensor's shape, strides, dtype and device, and which
    arguments are one tensor), the key None where an argument cannot be
    part of one. (No closure here: a recursive one would be a reference
    cycle holding the op's tensors until the next garbage collection.)"""
    ins, first, metas = [], {}, []
    try:
        parts = tuple(_walk(a, ins, first, metas) for a in args)
        parts += tuple((k, _walk(v, ins, first, metas)) for k, v in kwargs.items())
        key = (func, parts, tuple(metas))
        hash(key)
    except TypeError:
        return list(_flat((args, kwargs))), None
    return ins, key


def _walk(x, ins, first, metas):
    if isinstance(x, torch.Tensor):
        ins.append(x)
        i = first.setdefault(id(x), len(first))
        if i == len(metas):
            metas.append((tuple(x.shape), x.stride(), x.dtype, x.device.type))
        return ("T", i)
    tx = type(x)
    if tx is list or tx is tuple:
        if all(type(v) is int for v in x):  # a size: the common case
            return (tx, tuple(x))
        return tuple(_walk(v, ins, first, metas) for v in x)
    if isinstance(x, _ATOMS):
        return (tx, x)
    if isinstance(x, (list, tuple)):
        return tuple(_walk(v, ins, first, metas) for v in x)
    if isinstance(x, dict):
        return tuple((k, _walk(v, ins, first, metas)) for k, v in x.items())
    raise TypeError(f"not part of a key: {tx}")


_DTYPE_BYTES = {"float32": 4, "bfloat16": 2, "float16": 2}


def kernel_cost(launch: introspect.KernelLaunch):
    """(FLOPs, unit, transcendentals, bytes, matmul FLOPs, FFMA FLOPs) of
    one launch of the port's kernels, from its record."""
    ops = {o.name: o for o in launch.operands}
    work = dict(launch.work)
    if launch.kernel == "rmnp_kernel":
        g = ops["g"]
        apply = launch.name == "rmnp_apply"
        n = math.prod(g.shape)
        w_bytes = _DTYPE_BYTES[ops["w"].dtype] if apply else 0
        nbytes = rl.rmnp_bytes(g.shape, _DTYPE_BYTES[ops["v"].dtype], w_bytes, apply)
        # EMA (3), square and add (2), scale (1); apply: w + (-s) (d + wd w) (4);
        # one square root a column of a slice
        flops = n * (10 if apply else 6)
        return float(flops), FP32_FFMA, float(n // g.shape[-2]), float(nbytes), 0.0, 0.0
    if launch.kernel == "rmnp_split_kernel":
        g, v = ops["g"], ops["v"]
        n = math.prod(g.shape)
        vb = _DTYPE_BYTES[v.dtype]
        cols = 4 * math.prod(ops["colsum"].shape)
        if launch.name == "rmnp_partial":   # read g, v; write the sums
            return float(5 * n), FP32_FFMA, 0.0, float(n * (4 + vb) + cols), 0.0, 0.0
        apply = "w" in ops
        w_bytes = _DTYPE_BYTES[ops["w"].dtype] if apply else 0
        # the one-pass form's traffic and work, the sums read in place of formed
        nbytes = rl.rmnp_bytes(g.shape, vb, w_bytes, apply) + cols
        return (float(n * (8 if apply else 4)), FP32_FFMA, float(cols // 4), float(nbytes),
                0.0, 0.0)
    if launch.kernel == "gemm_kernel":
        L, M, K = ops["a"].shape
        N = ops["b"].shape[2]
        prod, nbytes = rl.gemm_counts(L, M, N, K, work["reads"])
        epilogue = 2.0 * L * M * N if "c" in ops else 0.0
        return prod, TF32X3_TC, 0.0, nbytes, prod, epilogue
    if launch.kernel in ("fa_fwd_tc", "fa_fwd_tf32_kernel"):
        B, S, H, hd = ops["q"].shape
        Kh, hdv = ops["k"].shape[2], ops["v"].shape[3]
        causal = work.get("causal", True)
        flops = float(rl.attention_flops(B, S, H, hd, causal, hdv))
        pairs = B * H * (S * (S + 1) // 2 if causal else S * S)
        size = _DTYPE_BYTES[ops["q"].dtype]
        nbytes = (B * S * H * (hd + hdv) + B * S * Kh * (hd + hdv)) * size
        unit = BF16_TC if size == 2 else TF32X3_TC
        # the online softmax: scale and subtract, max, sum, rescale an entry
        return flops, unit, float(pairs), float(nbytes), flops, 4.0 * pairs
    raise ValueError(f"no cost rule for the kernel {launch.kernel}")


def analyze_step(fn, *args, world: int = 1, **kwargs) -> Dict[str, Any]:
    """Cost of one call of ``fn`` on meta tensors, in ``analyze_hlo``'s
    keys (``flops``, ``transcendentals``, ``bytes_accessed``,
    ``collectives``, ``collective_wire_bytes``) and the extras of
    :meth:`Totals.as_dict`. A step that takes a group is built with
    ``StepCounter.comm`` and counted with :meth:`StepCounter.run`."""
    counter = StepCounter(world)
    counter.run(fn, *args, **kwargs)
    return counter.cost()


def breakdown(fn, *args, world: int = 1, top: int = 12, **kwargs):
    """Profiling view of one call: per op name count, FLOPs and bytes, and
    the ``top`` ops by bytes (``hlo_cost.breakdown``'s counterpart)."""
    counter = StepCounter(world)
    counter.run(fn, *args, **kwargs)
    return counter.breakdown(top)
