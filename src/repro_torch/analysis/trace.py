"""Record (never run on a device) one real training step per combo.

Counterpart of ``repro.analysis.lowering`` and ``repro.analysis.hlo``:
where the JAX package lowers ``make_dp_train_step`` on an abstract 4-device
mesh and parses the compiled HLO, this module runs the port's
``train/dp_step.make_dp_train_step`` on reduced gpt2-60m (at its own
vocabulary of 50304) as rank 0 of a
group of four, on **meta tensors**, under a dispatch mode that records every
op with the tensors it read and wrote and their storages, and under
``kernels/introspect.recording()``, so every kernel entry records its launch.
The group is a :class:`RecordingComm`: a ``distributed/comm.Comm`` whose
collectives record their operand and return a meta tensor of the right
shape. No process group is made, nothing is allocated on a device and no
kernel is built.

Engine semantics as in the JAX package: ``bucketed`` is the
replicated-state shape-bucketed engine (two-pass update, ZeRO-0 dp step);
``single-pass`` is the fused ZeRO-2 step (``shard_size=4``, gradient shards
reduce-scattered, the pipelined schedule forced with ``overlap=True`` so
that the serialized one never masks a pipelining regression). Wire
``int8-ef`` is the int8 error-feedback gradient compression.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.analysis.donation import BIG_LEAF_BYTES
from repro_torch.analysis.framework import (
    ENGINES, WIRES, Artifacts, BucketMeta, Combo, Leaf, OpRecord, TensorInfo,
)
from repro_torch.distributed.comm import Comm, Pending
from repro_torch.kernels import introspect

N_DEV = 4
_LR = 1e-2
BREAK_MODES = ("gather-momentum", "defensive-copy")

_FIXTURE: Dict[str, object] = {}


def build_combos(optimizers: Optional[List[str]] = None,
                 engines: Optional[List[str]] = None,
                 wires: Optional[List[str]] = None,
                 accums: Optional[List[int]] = None) -> List[Combo]:
    """The JAX package's matrix: every registry optimizer x engine x wire
    at ``accum=1``; the rmnp ZeRO-2 accumulation points on both wires; the
    guarded rmnp and normuon ZeRO-2 steps on both wires and guarded rmnp at
    ``accum=4``. Filters narrow it."""
    from repro_torch.core import optimizer_names

    names = list(optimizers) if optimizers else list(optimizer_names())
    combos = [Combo(n, e, w, 1)
              for n in names for e in ENGINES for w in WIRES]
    if not optimizers or "rmnp" in names:
        combos.append(Combo("rmnp", "single-pass", "fp32", 4))
        combos.append(Combo("rmnp", "single-pass", "int8-ef", 4))
    for n in ("rmnp", "normuon"):
        if not optimizers or n in names:
            combos += [Combo(n, "single-pass", w, 1, guard=True) for w in WIRES]
    if not optimizers or "rmnp" in names:
        combos.append(Combo("rmnp", "single-pass", "fp32", 4, guard=True))
    if engines:
        combos = [c for c in combos if c.engine in engines]
    if wires:
        combos = [c for c in combos if c.wire in wires]
    if accums:
        combos = [c for c in combos if c.accum in accums]
    return combos


def _flat(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _flat(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _flat(v)


class Recorder(TorchDispatchMode):
    """Records every dispatched op: its input and output tensor ids (a
    tensor's id is fixed for the recording: every tensor seen is kept
    alive), and which outputs have new storage."""

    def __init__(self):
        super().__init__()
        self.ops: List[OpRecord] = []
        self.tensors: Dict[int, TensorInfo] = {}
        self._keep: List[torch.Tensor] = []

    def tid(self, t: torch.Tensor) -> int:
        key = id(t)
        if key not in self.tensors:
            self._keep.append(t)
            self.tensors[key] = TensorInfo(tuple(t.shape), t.dtype,
                                           t.untyped_storage()._cdata)
        return key

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        fresh = introspect.new_storage_outputs(func, out)
        self.ops.append(OpRecord(
            len(self.ops), "op", introspect.op_name(func),
            tuple(self.tid(t) for t in _flat((args, kwargs))),
            tuple(self.tid(t) for t in _flat(out)),
            tuple(self.tid(t) for t in fresh)))
        return out

    def collective(self, name: str, x: torch.Tensor, out: torch.Tensor) -> None:
        self.ops.append(OpRecord(len(self.ops), "collective", name,
                                 (self.tid(x),), (self.tid(out),), ()))


class RecordingComm(Comm):
    """Rank ``rank`` of a group of ``world`` that exists only in the
    record: ``all_to_all`` and ``all_gather`` note their operand and return
    a tensor of their result's shape (``reduce_scatter`` and ``all_reduce``
    are built from them, as in ``Comm``). No process group is made."""

    def __init__(self, recorder: Recorder, rank: int = 0, world: int = N_DEV):
        super().__init__(None, rank, world, torch.device("meta"))
        self.recorder = recorder

    def all_to_all(self, x, async_op=False):
        self._rows(x)
        out = torch.empty_like(x, memory_format=torch.contiguous_format)
        self.recorder.collective("all_to_all", x, out)
        return Pending([], lambda: out) if async_op else out

    def all_gather(self, x, async_op=False):
        out = x.new_empty((self.world * x.shape[0],) + tuple(x.shape[1:]))
        self.recorder.collective("all_gather", x, out)
        return Pending([], lambda: out) if async_op else out

    def barrier(self) -> None:
        pass


def _fixture():
    from repro_torch.configs import get_config
    from repro_torch.launch.specs import param_specs

    if not _FIXTURE:
        # at the model's own vocabulary, so that the embedding (50304 x 64
        # fp32, 12.9 MB) and its state are leaves the donation pass checks
        cfg = get_config("gpt2-60m").reduced(vocab=50304)
        toks = torch.empty((4 * N_DEV, 16), dtype=torch.int32, device="meta")
        _FIXTURE.update(cfg=cfg, params=param_specs(cfg),
                        batch={"tokens": toks, "labels": toks})
    return _FIXTURE


def make_combo_optimizer(combo: Combo, comm: Comm):
    """The registry optimizer a combo runs with."""
    from repro_torch.core import make_optimizer

    config = {"lr_matrix": _LR}
    if combo.zero2:
        config.update(shard_axis=comm, shard_size=N_DEV)
    else:
        config.update(fused=True)
    return make_optimizer(combo.optimizer, config)


def _leaves(params, opt_state) -> tuple:
    from repro_torch.core.types import tree_paths

    out = []
    for prefix, tree in (("params", params), ("opt_state", opt_state)):
        for path, t in tree_paths(tree):
            if isinstance(t, torch.Tensor):
                out.append(Leaf(f"{prefix}/{path}", tuple(t.shape), t.dtype,
                                t.untyped_storage()._cdata, t.numel() * t.element_size()))
    return tuple(out)


def bucket_meta(opt, params) -> tuple:
    """The plan's buckets with their slot stripes at full shape."""
    if opt.bucket_plan is None:
        return ()
    full = opt.init(params)
    slots = getattr(full, "slots", {}) or {}
    out = []
    for b in opt.bucket_plan(params).buckets:
        shapes = {name: ((b.padded,) + tuple(per[b.key].shape[1:]), per[b.key].dtype)
                  for name, per in slots.items() if b.key in per}
        out.append(BucketMeta(b.key, b.d_in, b.d_out, b.size, b.padded, shapes,
                              tuple(tuple(e.shape) for e in b.entries)))
    return tuple(out)


def record_combo(combo: Combo, *, break_mode: Optional[str] = None) -> Artifacts:
    """Record one step of the combo into :class:`Artifacts`.

    ``break_mode`` degrades the step on purpose, so the tests can show that
    the passes catch a real regression: ``"gather-momentum"`` all-gathers
    every momentum shard back to the full bucket after the update (memory
    and sharding must fire); ``"defensive-copy"`` copies every parameter of
    at least ``BIG_LEAF_BYTES`` before the step updates it (donation must
    fire)."""
    from repro_torch.core.types import map_with_path
    from repro_torch.train.dp_step import init_dp_state, make_dp_train_step

    if break_mode not in (None,) + BREAK_MODES:
        raise ValueError(f"break_mode must be one of {BREAK_MODES}, got {break_mode!r}")
    fx = _fixture()
    rec = Recorder()
    comm = RecordingComm(rec)
    opt = make_combo_optimizer(combo, comm)
    params = introspect.to_meta(fx["params"])
    opt_state, comp_state = init_dp_state(opt, params, comm, shard_state=combo.zero2)
    kwargs = dict(compress=combo.compress, accum=combo.accum, guard=combo.guard)
    if combo.zero2:
        kwargs.update(zero2=True, overlap=True)
    base = make_dp_train_step(fx["cfg"], opt, comm, **kwargs)

    if break_mode == "gather-momentum":
        def step(p, s, c, b, t):
            p2, s2, c2, m = base(p, s, c, b, t)
            # the regression under test: every momentum bucket rebuilt on
            # every rank after the update
            m = dict(m, _gathered_momentum_norm=sum(
                torch.sum(comm.all_gather(v).float() ** 2) for v in s2.buckets.values()))
            return p2, s2, c2, m
    elif break_mode == "defensive-copy":
        def step(p, s, c, b, t):
            return base(map_with_path(
                lambda _path, x: x.clone()
                if x.numel() * x.element_size() >= BIG_LEAF_BYTES else x, p), s, c, b, t)
    else:
        step = base

    before = _leaves(params, opt_state)
    with introspect.recording() as launches, rec:
        new_params, new_state, _, _ = step(params, opt_state, comp_state, fx["batch"], 0)
    return Artifacts(
        combo=combo, ops=tuple(rec.ops), tensors=rec.tensors, launches=tuple(launches),
        buckets=bucket_meta(opt, params), before=before,
        after=_leaves(new_params, new_state), n_dev=N_DEV)
