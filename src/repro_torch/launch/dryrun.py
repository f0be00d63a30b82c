"""The dry run: every (architecture x input shape x world) cell recorded on
meta tensors, nothing run on a device (counterpart of
``repro.launch.dryrun``).

Where the JAX package lowers and compiles each cell against its production
mesh on 512 fake CPU devices, this module runs each cell's step once on
**meta tensors**, as rank (0, 0) of the world ``launch/mesh.py`` gives,
under ``launch/cost.StepCounter``: the FLOPs, bytes and collectives of
every op and kernel launch, and the device memory of the rank as the card's
caching allocator would hold it. No kernel is built, no process group is
made, and nothing touches a device; the card is never asked for, so nothing
can fall back to the CPU in its place.

**Worlds.** An architecture the model axis covers (GQA and MLA attention,
dense and MoE FFNs: ``tensor_parallel.check_supported``) is recorded on
the production world itself, ``16 x 16`` (data x model, 256 ranks) or ``2 x 16 x 16``:
the rank holds its shards of the parameters, state and cache by the
logical-axis rules, computes its part of the step with the model group's
collectives, and runs ZeRO-2 over its data group; the record's
``collectives_by_group`` keeps the two groups apart. Any other architecture
(the SSM archs, jamba and xlstm, whose ``d_inner`` the model axis does not
split yet) keeps the data axes alone (16 or 32 ranks of whole parameters),
its record ``"model_parallel": 1`` with a ``reason`` that names ROADMAP
item 14.

Per cell:

* ``train``: the JAX dry run's optimizer, mixed RMNP with
  ``cosine_with_warmup(2e-3, 10_000)`` on the matrices and ``(3e-4,
  10_000)`` on the rest. At world 1, ``make_train_step(...,
  num_microbatches=4, remat="full")``; at world > 1,
  ``make_dp_train_step(..., zero2=True, accum=4, compress=False,
  remat="full")`` as rank 0 of a ``CostComm`` group (the exact wire, as
  GSPMD's reduction in the JAX dry run is exact), which takes the global
  batch and trains on its rows.
* ``prefill``: ``make_prefill_step``; ``decode``: ``make_serve_step`` at
  the last position of the cache. Each rank is a replica with
  ``global_batch / world`` of the prompts and of the cache.

A cell whose batch does not split over the world, whose per-rank batch does
not split into the microbatches, or that ``shape_applicable`` refuses, is a
``"skipped"`` record with its reason.

The record (``artifacts/dryrun/<arch>__<shape>__<single|multi>.json``):
``cell``, ``status``, ``arch``, ``shape``, ``kind``, ``world`` (with
``model_parallel``, the JAX mesh and axes, and whether the collective term
is a lower bound), ``record_s``, ``memory``, ``cost``, ``collectives``,
``collective_wire_bytes`` and ``model_flops``. ``memory`` is the rank's:
``bytes_per_device`` (the peak), ``argument_bytes`` (parameters, optimizer
state, batch and cache: ``params_bytes``, ``state_bytes``, ``batch_bytes``,
``cache_bytes``), ``temp_bytes`` (the peak less the arguments),
``at_peak`` (the peak's bytes by origin: each argument, ``forward``,
``backward``), ``output_bytes`` and ``fits`` (the peak within the card's
80 GB). Every number is predicted from meta tensors, none measured.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-4b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all   # every cell, both worlds
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
import traceback
from pathlib import Path
from typing import Any, Dict, Optional

from repro_torch.configs import SHAPES, ShapeConfig, get_config, shape_applicable
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.cost import StepCounter
from repro_torch.launch.roofline import ARTIFACTS, HBM_BYTES, model_flops

ARG_NAMES = {"train": ("params", "opt_state", "batch"), "prefill": ("params", "batch"),
             "decode": ("params", "cache", "batch")}


def cell_tag(arch: str, shape_name: str, multi_pod: bool) -> str:
    return f"{arch}__{shape_name}__{'multi' if multi_pod else 'single'}"


def skip_reason(cfg, shape: ShapeConfig, world: int, microbatches: int = 4) -> Optional[str]:
    """Why the cell cannot be built for ``world`` data ranks, or None."""
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        return why
    if shape.global_batch % world:
        return (f"skipped: the global batch {shape.global_batch} does not split over "
                f"{world} ranks; the port splits a batch by rows over its data ranks and "
                f"does not yet take long_seq, the JAX package's split of a batch-1 cache "
                f"over its data and model axes (ROADMAP.md, item 14)")
    if shape.kind == "train" and (shape.global_batch // world) % microbatches:
        return (f"skipped: a rank's batch {shape.global_batch // world} does not split "
                f"into {microbatches} microbatches")
    return None


def make_optimizer_for(optimizer: str = "rmnp", comm=None, **config):
    """The JAX dry run's mixed optimizer (``mixed_optimizer(name,
    cosine_with_warmup(2e-3, 10_000), cosine_with_warmup(3e-4, 10_000))``),
    ZeRO-sharded over ``comm`` when given; ``config`` adds
    ``mixed_optimizer`` keyword arguments (``fused_apply=True`` for the
    single-pass engine)."""
    from repro_torch.core import cosine_with_warmup, mixed_optimizer
    if comm is not None:
        config = dict(config, shard_axis=comm, shard_size=comm.world)
    return mixed_optimizer(optimizer, cosine_with_warmup(2e-3, 10_000),
                           cosine_with_warmup(3e-4, 10_000), **config)


def recording_world(counter: StepCounter, mesh):
    """Rank (0, 0) of ``mesh`` as recording groups of the counter: a
    ``distributed.comm.WorldComm`` whose data group has the counter's ranks
    and whose model group has the mesh's model axis."""
    from repro_torch.distributed.comm import WorldComm
    return WorldComm(mesh, 0, counter.comm(),
                     counter.comm(world=mesh.model_parallel, group="model"))


def build_cell(cfg, shape: ShapeConfig, world: int, counter: StepCounter, *,
               optimizer: str = "rmnp", opt_config: Optional[Dict[str, Any]] = None,
               microbatches: int = 4, remat: str = "full", grad_dtype=None, mesh=None):
    """(step function, its arguments, their names) of one cell for rank 0 of
    ``world`` data ranks, its inputs as ``launch/specs.input_specs`` makes
    them (a serving rank's at its share of the batch). ``mesh`` (a
    ``launch/mesh.World``) puts the rank on a model axis: its shards, the
    steps built for a recording ``WorldComm`` of the mesh."""
    from repro_torch.launch.specs import input_specs
    from repro_torch.train.step import make_prefill_step, make_serve_step, make_train_step

    from repro_torch.distributed import tensor_parallel as tp
    opt_config = dict(opt_config or {})
    wc = None if mesh is None else recording_world(counter, mesh)
    axis = tp.axis_for(cfg, wc)
    if shape.kind == "train":
        if world == 1:
            opt = make_optimizer_for(optimizer, **opt_config)
            fn = make_train_step(cfg, opt, num_microbatches=microbatches, remat=remat,
                                 grad_dtype=grad_dtype, world=wc)
            params, opt_state, batch, _ = input_specs(cfg, shape, mesh=mesh)
            if optimizer != "rmnp" or opt_config:
                with tp.use(axis):
                    opt_state = opt.init(params)  # another state than the specs'
            return fn, (params, opt_state, batch, 0), ARG_NAMES["train"]
        if grad_dtype:
            raise ValueError("grad_dtype is not an option of the ZeRO-2 step")
        from repro_torch.train.dp_step import make_dp_train_step
        comm = counter.comm() if wc is None else wc.data
        opt = make_optimizer_for(optimizer, comm, **opt_config)
        step = make_dp_train_step(cfg, opt, comm, zero2=True, accum=microbatches,
                                  compress=False, remat=remat, world=wc)
        params, opt_state, _, batch, _ = input_specs(cfg, shape, world, mesh=mesh)
        if optimizer != "rmnp" or opt_config:
            from repro_torch.distributed.sharding import shard_state
            with tp.use(axis):
                opt_state = shard_state(opt.init(params), comm)

        def fn(p, s, b, t):  # the exact wire keeps no residual
            return step(p, s, None, b, t)
        return fn, (params, opt_state, batch, 0), ARG_NAMES["train"]
    local = dataclasses.replace(shape, global_batch=shape.global_batch // world)
    if shape.kind == "prefill":
        params, batch = input_specs(cfg, local, mesh=mesh)
        return make_prefill_step(cfg, wc), (params, batch), ARG_NAMES["prefill"]
    params, cache, tokens, _ = input_specs(cfg, local, mesh=mesh)
    return (make_serve_step(cfg, wc, cache_len=shape.seq_len),
            (params, cache, tokens, shape.seq_len - 1), ARG_NAMES["decode"])


def memory_record(counter: StepCounter, argument_bytes: Dict[str, int]) -> Dict[str, Any]:
    """The rank's memory: the peak and the arguments as the allocator holds
    them (rounded), each argument's own bytes (``params_bytes``, ...)."""
    mem = counter.memory
    args = sum(mem.by_origin[k] for k in argument_bytes)
    return {"bytes_per_device": mem.peak, "argument_bytes": args,
           **{f"{'state' if k == 'opt_state' else k}_bytes": v
              for k, v in argument_bytes.items()},
           "temp_bytes": mem.peak - args,
           "at_peak": dict(mem.at_peak),
           "makers_at_peak": dict(mem.makers_at_peak),
           "output_bytes": mem.live - sum(mem.by_origin[k] for k in argument_bytes),
           "fits": mem.peak <= HBM_BYTES, "hbm_bytes": HBM_BYTES}


def record(cfg, shape: ShapeConfig, world: int = 1, *, cell: str = "",
           jax_world: Optional[mesh_lib.World] = None, keep_counter: bool = False,
           **build) -> Dict[str, Any]:
    """The record of one cell: ``cfg`` at ``shape`` on rank 0 of ``world``
    data ranks (``jax_world``: the JAX mesh it stands for; where its model
    axis is above one, the rank holds its model shards). ``build`` goes to
    :func:`build_cell`; ``keep_counter`` leaves the ``StepCounter`` in the
    record under ``counter``."""
    counter = StepCounter(world)
    t0 = time.perf_counter()
    if jax_world is not None and jax_world.model_parallel > 1:
        build = dict(build, mesh=jax_world)
    fn, args, names = build_cell(cfg, shape, world, counter, **build)
    argument_bytes = {name: counter.register(a, name) for name, a in zip(names, args)}
    out = counter.run(fn, *args)
    record_s = time.perf_counter() - t0
    mem = memory_record(counter, argument_bytes)
    state_shapes = {}
    if shape.kind == "train" and hasattr(args[1], "buckets"):
        state_shapes = {k: list(v.shape) for k, v in args[1].buckets.items()}
    del out, args, fn
    cost = counter.cost()
    if jax_world is None:
        jax_world = (mesh_lib.make_local_world() if world == 1
                     else mesh_lib.World(world, (world, 1), ("data", "model")))
    rec = {
        "cell": cell or f"{cfg.name}__{shape.name}__w{world}",
        "status": "ok", "arch": cfg.name, "shape": shape.name, "kind": shape.kind,
        **jax_world.describe(),
        "seq_len": shape.seq_len, "global_batch": shape.global_batch,
        "settings": {k: (str(v) if v is not None else None) for k, v in build.items()
                     if k != "mesh"},
        "record_s": record_s,
        "memory": dict(mem, momentum_buckets=state_shapes),
        "cost": {k: v for k, v in cost.items() if k not in ("collectives",
                                                             "collective_wire_bytes")},
        "collectives": cost["collectives"],
        "collective_wire_bytes": cost["collective_wire_bytes"],
        "collectives_by_group": cost["collectives_by_group"],
        "collective_wire_bytes_by_group": cost["collective_wire_bytes_by_group"],
        "model_flops": model_flops(cfg, shape),
    }
    if keep_counter:
        rec["counter"] = counter
    return rec


def record_window(fn, *args, arguments: Optional[Dict[str, Any]] = None, world: int = 1,
                  world_mesh=None, **kwargs) -> Dict[str, Any]:
    """Memory and cost of ``fn(*args, **kwargs)`` on meta tensors: a window
    of a program (a served batch of prefill, cache placement and decode
    steps; several train steps) rather than one step. The trees in
    ``arguments`` (made before the window) count as its arguments; every
    tensor ``fn`` makes counts from when it makes it. ``world_mesh`` (a
    ``launch/mesh.World``) passes ``fn`` a recording ``WorldComm`` of it as
    ``world``."""
    counter = StepCounter(world)
    if world_mesh is not None:
        kwargs["world"] = recording_world(counter, world_mesh)
    t0 = time.perf_counter()
    argument_bytes = {name: counter.register(tree, name)
                      for name, tree in (arguments or {}).items()}
    out = counter.run(fn, *args, **kwargs)
    rec = {"memory": memory_record(counter, argument_bytes), "cost": counter.cost(),
           "record_s": time.perf_counter() - t0}
    del out
    return rec


def production_world(cfg, multi_pod: bool, rules=None):
    """(world, reason): the production world with its model axis where the
    slice covers ``cfg``, else its data axes alone and why."""
    from repro_torch.distributed.tensor_parallel import check_supported
    try:
        check_supported(cfg, 16)
    except NotImplementedError as e:
        return mesh_lib.make_production_world(multi_pod=multi_pod, model_axis=False,
                                              rules=rules), str(e)
    return mesh_lib.make_production_world(multi_pod=multi_pod, rules=rules), None


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: Path) -> dict:
    """One cell of the production world (``src/repro/launch/dryrun.py:118``
    ``run_cell``), written to ``out_dir/<cell>.json`` when recorded: rank
    (0, 0) of ``16 x 16`` (``2 x 16 x 16``) for an architecture the model
    axis covers, else rank 0 of the data axes with the reason."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    world, data_only = production_world(cfg, multi_pod)
    tag = cell_tag(arch, shape_name, multi_pod)
    why = skip_reason(cfg, shape, world.data_parallel)
    extra = {} if data_only is None else {"reason": f"data axes only: {data_only}"}
    if why:
        return {"cell": tag, "status": "skipped", "reason": why, "arch": arch,
                "shape": shape_name, **world.describe()}
    rec = record(cfg, shape, world.data_parallel, cell=tag, jax_world=world)
    rec.update(extra)
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / f"{tag}.json").write_text(json.dumps(rec, indent=1))
    return rec


def main(argv=None):
    from repro_torch.configs.all_archs import ASSIGNED

    ap = argparse.ArgumentParser(description="the dry run on meta tensors")
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=str(ARTIFACTS))
    args = ap.parse_args(argv)
    out_dir = Path(args.out)
    if not args.all and not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --all")

    if args.all:
        cells = [(arch, shape, mp) for arch in ASSIGNED for shape in SHAPES
                 for mp in (False, True)]
    else:
        cells = [(args.arch, args.shape, args.multi_pod)]

    failures = 0
    for arch, shape, mp in cells:
        tag = cell_tag(arch, shape, mp)
        path = out_dir / f"{tag}.json"
        if path.exists() and args.all:
            print(f"[dryrun] {tag}: cached", flush=True)
            continue
        try:
            rec = run_cell(arch, shape, mp, out_dir)
            if rec["status"] == "ok":
                m = rec["memory"]["bytes_per_device"] / 2**30
                print(f"[dryrun] {tag}: OK mem={m:.2f}GiB/dev "
                      f"flops={rec['cost']['flops']:.3e} "
                      f"record={rec['record_s']:.1f}s", flush=True)
            else:
                print(f"[dryrun] {tag}: SKIP ({rec['reason'][:60]})", flush=True)
                out_dir.mkdir(parents=True, exist_ok=True)
                path.write_text(json.dumps(rec, indent=1))
        except Exception:
            failures += 1
            print(f"[dryrun] {tag}: FAIL", flush=True)
            traceback.print_exc()
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
