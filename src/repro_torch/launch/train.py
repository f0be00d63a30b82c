"""Training driver of the port (mirror of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch gpt2-small --full \\
        --optimizer rmnp --engine single-pass --use-kernel --steps 3 \\
        --batch 8 --seq 1024
    # the SSM architectures: xlstm-350m whole; jamba cut in depth to fit one card
    PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-350m --full \
        --engine single-pass --steps 3 --batch 8 --seq 1024
    PYTHONPATH=src python -m repro_torch.launch.train --arch jamba-v0.1-52b --full \
        --layers 3:5 --engine single-pass --steps 3 --batch 8 --seq 1024
    # ZeRO-2 data parallel, one process per rank (NCCL; gloo with --device cpu)
    PYTHONPATH=src torchrun --nproc_per_node 4 -m repro_torch.launch.train \\
        --arch gpt2-small --zero2 [--no-compress] [--accum A] [--overlap on]

Wires config -> synthetic data -> mixed optimizer -> train step (or the
data-parallel step, ``train/dp_step.py``) -> checkpoint manager (resume on
restart, an elastic reshard when the group size changed) -> metrics log,
with the non-finite guard and its anomaly ladder, fault injection and the
hang watchdog. It runs on ``cuda`` unless ``device="cpu"`` (``--device
cpu``) is passed.
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import time
import warnings
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import cut_layers, get_config
from repro_torch.core import (cosine_with_warmup, global_dominance, make_optimizer,
                              momentum_for_diagnostics, optimizer_names)
from repro_torch.core.types import tree_paths
from repro_torch.data.pipeline import make_stream
from repro_torch.distributed import compression, elastic, sharding
from repro_torch.distributed.monitor import AnomalyMonitor, HangGuard
from repro_torch.kernels import LAUNCHES
from repro_torch.models import init_params
from repro_torch.train import faults, pipeline
from repro_torch.train.step import make_train_step


def batch_to_device(np_batch, device):
    return {k: torch.from_numpy(v).to(device) for k, v in np_batch.items()}


def train(arch: str, optimizer: str = "rmnp", steps: int = 100,
          batch: int = 8, seq: int = 128, lr_matrix: float = 2e-3,
          lr_adamw: float = 1e-3, reduced: bool = True, seed: int = 0,
          ckpt_dir: str = "", ckpt_every: int = 0, log_every: int = 10,
          dominance_every: int = 0, matrix_embed: bool = True,
          use_kernel: bool = False, fused: bool = False,
          momentum_dtype: str = "float32", fused_apply: bool = False,
          zero2: bool = False, compress: bool = True, accum: int = 1,
          overlap: Optional[bool] = None, log_file: str = "",
          stop_at: int = 0, kill_at: int = 0,
          watchdog_deadline: float = 0.0, dump_params: str = "",
          clip_norm: float = 1.0, guard: bool = False,
          inject_fault: str = "", anomaly_spike_k: float = 6.0,
          anomaly_skip_budget: int = 3, anomaly_rewind_budget: int = 2,
          anomaly_lr_backoff: float = 0.5, anomaly_health_window: int = 2,
          anomaly_skip_batch: bool = False, device: str = "cuda", layers: str = ""):
    """Train ``arch`` for ``steps`` steps; returns (params, opt_state,
    history). ``fused`` routes matrix parameters through the shape-bucketed
    engine, ``fused_apply`` folds the weight update into the per-bucket
    kernel (the single-pass engine). ``use_kernel`` is accepted for the JAX
    driver's signature and selects nothing: on ``cuda`` every RMNP update
    and Newton-Schulz iteration runs the Hopper kernels, on ``cpu`` their
    plain versions. ``dominance_every`` adds the momentum's diagonal
    dominance (``r_avg``, ``r_min``, ``r_max``) to the logged steps it
    divides. Each history entry also holds the kernel launches of its step
    (``launches``). ``layers`` ("START:STOP") keeps only those layers of the
    pattern at full width (``configs.cut_layers``).

    **Checkpoints.** With ``ckpt_dir`` the run resumes from the newest
    committed checkpoint there (the data stream from its ``data_step``),
    saves every ``ckpt_every`` steps (async) and saves the final state.
    ``stop_at`` simulates a crash: train to that step (schedules still span
    ``steps``) and exit without the final checkpoint. ``kill_at`` SIGKILLs
    the process after that step, with any async save still in flight.
    ``watchdog_deadline`` (seconds) arms the hang/straggler ladder: the
    state is snapshotted to host memory after every step, and a step that
    exceeds the deadline or is flagged as a straggler writes that snapshot
    as an emergency checkpoint.

    **Numerical resilience.** ``guard=True`` arms the non-finite guard (a
    NaN/Inf step leaves every buffer bit for bit unchanged) and the
    anomaly ladder (``repro_torch.distributed.monitor.AnomalyMonitor``):
    more than ``anomaly_skip_budget`` consecutive skipped steps, or a finite
    loss spike, rewinds to the last-known-good checkpoint with both learning
    rates multiplied by ``anomaly_lr_backoff`` and the data stream replayed
    from the checkpoint's position (``anomaly_skip_batch`` also drops the
    batches of skipped steps on replay); more than ``anomaly_rewind_budget``
    rewinds aborts, naming the step and the leaves. A periodic checkpoint is
    promoted to last-known-good after ``anomaly_health_window`` further
    anomaly-free steps. With the guard, each logged entry holds ``skipped``,
    the ladder's ``action`` and the ``nonfinite`` gradient leaves, and a
    rewind appends an entry with ``rewind_to``. ``inject_fault``
    (``kind:leaf:step[:microbatch]``, ``repro_torch.train.faults``) poisons
    a gradient; an injected fault is disarmed on rewind. ``clip_norm <= 0``
    disables clipping.

    **ZeRO-2.** ``zero2`` (implies ``fused_apply``) trains with the
    data-parallel step on every process of the group
    (``repro_torch.distributed.comm.init_comm``: ``torchrun``'s, or one rank
    on its own): ``batch`` is the global batch, each rank trains on its
    rows, and the stacked matrix momentum and gradient buckets are sharded
    over the ranks (``compress`` picks the int8 error-feedback wire over the
    exact fp32 one; ``overlap`` the pipelined schedule, None resolving with
    ``train.dp_step.resolve_overlap``). Every rank writes its shard of each
    checkpoint; a checkpoint written by another number of ranks is
    resharded on resume (``distributed/elastic.py``). Only rank 0 prints and
    writes ``log_file`` and ``dump_params``."""
    comm = None
    if zero2:
        from repro_torch.distributed.comm import init_comm
        comm = init_comm(device)
        device = comm.device
    n_dev = comm.world if comm is not None else 1
    main_rank = comm is None or comm.rank == 0
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    if layers:
        cfg = cut_layers(cfg, layers)
    fault_spec = faults.parse_fault(inject_fault) if inject_fault else None
    if fault_spec is not None and main_rank:
        print(f"[train] fault injection armed: {fault_spec.describe()}", flush=True)

    def build_opt(shard_size: int, lr_scale: float = 1.0):
        return make_optimizer(optimizer, dict(
            lr_matrix=cosine_with_warmup(lr_matrix * lr_scale, steps),
            lr_adamw=cosine_with_warmup(lr_adamw * lr_scale, steps),
            matrix_embed=matrix_embed, use_kernel=use_kernel, fused=fused,
            momentum_dtype=momentum_dtype, fused_apply=fused_apply or zero2,
            shard_axis=comm, shard_size=shard_size))

    def build_step(opt_, fault):
        remat = "none" if reduced else "full"
        if zero2:
            from repro_torch.train.dp_step import make_dp_train_step
            return make_dp_train_step(cfg, opt_, comm, shard_state=True, zero2=True,
                                      compress=compress, accum=accum, overlap=overlap,
                                      clip_norm=clip_norm, guard=guard, fault=fault,
                                      remat=remat)
        single = make_train_step(cfg, opt_, num_microbatches=accum,
                                 clip_norm=clip_norm, guard=guard, fault=fault,
                                 remat=remat)

        def single_step(p, o, c, b, t):
            p, o, m = single(p, o, b, t)
            return p, o, c, m
        return single_step

    def fresh_state(opt_):
        params_ = init_params(cfg, seed=seed, device=device)
        if zero2:
            from repro_torch.train.dp_step import init_dp_state
            return (params_,) + init_dp_state(opt_, params_, comm, shard_state=True)
        return params_, opt_.init(params_), None

    def saved(p, o, c):
        """The tree a checkpoint holds (each rank's part of it under ZeRO-2)."""
        if not zero2:
            return p, o
        return (p, sharding.checkpoint_view(o, opt.bucket_plan(p), comm),
                compression.checkpoint_view(c, comm))

    def unpack(state):
        return tuple(state) if zero2 else tuple(state) + (None,)

    opt = build_opt(n_dev)
    params, opt_state, comp_state = fresh_state(opt)
    start_step, data_step = 0, 0
    layout = elastic.state_layout(opt, params, mesh_size=n_dev, rule=optimizer,
                                  compress=compress and zero2, opt_state=opt_state)

    if main_rank and log_every and (fused or fused_apply or zero2 or use_kernel):
        # what one step will launch, from a run on meta tensors; the logged
        # ``launches`` are counted where the kernels really launch
        from repro_torch.train.step import optimizer_launches
        n = optimizer_launches(opt, params)
        detail = (f" ({len(opt_state.buckets)} shape buckets)"
                  if hasattr(opt_state, "buckets") else "")
        print(f"[train] preconditioner kernel launches/step: {n}{detail}", flush=True)

    mgr = CheckpointManager(ckpt_dir, comm=comm) if ckpt_dir else None
    latest = mgr.latest_step() if mgr is not None else None
    if latest is not None:
        old_layout = mgr.read_layout(latest)
        if not elastic.check_restorable(old_layout, layout):
            old_n = int(old_layout["shard_size"])
            if not zero2:
                raise elastic.LayoutMismatchError(
                    f"checkpoint step {latest} holds a {old_n}-way sharded "
                    f"state; resume it with zero2 (--zero2)")
            (params, opt_state, comp_state), data_step = elastic.restore_resharded(
                mgr, latest, params, opt_state, comp_state, opt_new=opt,
                opt_old=build_opt(old_n), comm=comm)
            start_step = latest
            if main_rank:
                print(f"[train] resumed from step {latest} (elastic reshard "
                      f"{old_n}-way -> {n_dev}-way)", flush=True)
        else:
            restored = mgr.restore_latest(saved(params, opt_state, comp_state))
            if restored is None:
                raise RuntimeError(f"no committed checkpoint in {ckpt_dir} is readable; "
                                   f"refusing to start over in a directory that has some")
            state, start_step, data_step = restored
            params, opt_state, comp_state = unpack(state)
            if main_rank:
                print(f"[train] resumed from step {start_step}", flush=True)

    stream = make_stream(cfg, seq, batch, seed=seed, start_step=data_step)
    step_fn = build_step(opt, fault_spec)

    hang_guard = None
    if watchdog_deadline:
        def emergency_save():
            if mgr is None:
                print("[watchdog] no checkpoint dir — nothing to save", flush=True)
                return
            # from the host snapshot filled after every step: no device access
            saved = mgr.emergency_save()
            if saved is None:
                print("[watchdog] no snapshot newer than the last committed "
                      "checkpoint — nothing to save", flush=True)
            else:
                print(f"[watchdog] emergency checkpoint written at step {saved}",
                      flush=True)
        hang_guard = HangGuard(watchdog_deadline, emergency_save)

    monitor = None
    if guard:
        monitor = AnomalyMonitor(spike_k=anomaly_spike_k,
                                 skip_budget=anomaly_skip_budget,
                                 rewind_budget=anomaly_rewind_budget,
                                 leaf_names=pipeline.guard_flag_names(
                                     params, opt.bucket_plan(params) if zero2 else None,
                                     n_dev))
    lr_scale = 1.0
    pending_good: list = []      # checkpoint steps awaiting the health window
    bad_data_steps: set = set()  # data positions of skipped steps (replay)

    history = []
    t0 = time.time()
    end_step = min(steps, stop_at) if stop_at else steps
    step = start_step
    while step < end_step:
        if anomaly_skip_batch and stream.step in bad_data_steps:
            bad_data_steps.discard(stream.step)
            next(stream)  # drop the offending batch on replay
            print(f"[train] replay: dropped the batch of skipped data step "
                  f"{stream.step - 1}", flush=True)
        before = dict(LAUNCHES)
        if hang_guard is not None:
            hang_guard.arm()
            t_step = time.time()
        params, opt_state, comp_state, metrics = step_fn(
            params, opt_state, comp_state, batch_to_device(next(stream), device), step)
        if hang_guard is not None:
            # the host snapshot comes first: the emergency save reads only it
            if mgr is not None:
                mgr.snapshot(step + 1, saved(params, opt_state, comp_state),
                             data_step=stream.step, layout=layout)
            if torch.device(device).type != "cpu":
                torch.cuda.synchronize()
            hang_guard.record(step, time.time() - t_step)
        action = None
        if monitor is not None:
            gflags = metrics.pop("guard_flags").cpu().numpy()
            was_skipped = bool(float(metrics["skipped"]))
            action = monitor.record(step, float(metrics["loss"]),
                                    skipped=was_skipped, flags=gflags)
            if action != "ok":
                pending_good.clear()  # nothing in flight becomes last-known-good
            if action == "skip":
                leaves = ", ".join(monitor.bad_leaves(gflags)) or "<loss non-finite>"
                bad_data_steps.add(stream.step - 1)
                if main_rank:
                    print(f"[train] guard: step {step} SKIPPED bitwise (non-finite: "
                          f"{leaves}; {monitor.consecutive_skips}/{anomaly_skip_budget} "
                          f"consecutive)", flush=True)
            elif action == "rewind":
                lr_scale *= anomaly_lr_backoff
                opt = build_opt(n_dev, lr_scale)
                if mgr is not None:
                    mgr.wait()
                    if comm is not None:
                        comm.barrier()  # rank 0's last GOOD marker has landed
                good = mgr.latest_good_step() if mgr is not None else None
                if good is not None:
                    state, data_step = mgr.restore(
                        good, saved(params, opt_state, comp_state))
                    params, opt_state, comp_state = unpack(state)
                    rewind_to = good
                else:  # no good checkpoint yet: restart from init
                    params, opt_state, comp_state = fresh_state(opt)
                    rewind_to, data_step = 0, 0
                if fault_spec is not None:
                    if main_rank:
                        print("[train] rewind: disarming the injected fault "
                              "(transient-fault model)", flush=True)
                    fault_spec = None
                step_fn = build_step(opt, fault_spec)
                stream = make_stream(cfg, seq, batch, seed=seed, start_step=data_step)
                if main_rank:
                    print(f"[train] anomaly ladder: rewind #{monitor.rewinds} to step "
                          f"{rewind_to} (lr x{lr_scale:g}, data step {data_step}; "
                          f"{monitor.post_mortem()})", flush=True)
                history.append({"step": step, "action": action, "rewind_to": rewind_to,
                                "lr_scale": lr_scale, "data_step": data_step})
                step = rewind_to
                continue
            elif action == "abort":
                raise RuntimeError(
                    f"[train] numerical-anomaly escalation ladder exhausted at "
                    f"step {step}: {monitor.post_mortem()}")
        if log_every and (step % log_every == 0 or step == steps - 1):
            m = {k: float(v) for k, v in metrics.items()}
            m["step"] = step
            m["wall_s"] = round(time.time() - t0, 2)
            m["launches"] = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
            if action is not None:
                m["action"] = action
                m["nonfinite"] = monitor.bad_leaves(gflags)
            if dominance_every and step % dominance_every == 0 and optimizer != "adamw":
                whole = (sharding.gather_state(opt_state, opt.bucket_plan(params), comm)
                         if zero2 else opt_state)
                dom = global_dominance(momentum_for_diagnostics(
                    whole, params, matrix_embed=matrix_embed))
                m.update({k: float(v) for k, v in dom.items()})
            history.append(m)
            if main_rank:
                print(f"[train] step={step} loss={m['loss']:.4f} "
                      f"gnorm={m['grad_norm']:.3f} clip={m['clip_rate']:.0f}"
                      + (f" r_avg={m['r_avg']:.2f}" if "r_avg" in m else "")
                      + f" launches={m['launches']}", flush=True)
        if mgr is not None and ckpt_every and (step + 1) % ckpt_every == 0:
            mgr.save(step + 1, saved(params, opt_state, comp_state),
                     data_step=stream.step, layout=layout)
            if monitor is not None:
                pending_good.append(step + 1)
        if monitor is not None and pending_good:
            # promote the checkpoints that survived the health window
            for s in [s for s in pending_good if step + 1 - s >= anomaly_health_window]:
                mgr.mark_good(s)
                pending_good.remove(s)
                if main_rank:
                    print(f"[train] checkpoint step {s} promoted to last-known-good",
                          flush=True)
        if kill_at and step + 1 == kill_at:
            print(f"[train] fault injection: SIGKILL at step {step + 1}", flush=True)
            os.kill(os.getpid(), signal.SIGKILL)
        step += 1
    if hang_guard is not None:
        hang_guard.stop()
    if mgr is not None and end_step == steps:
        mgr.save(steps, saved(params, opt_state, comp_state), data_step=stream.step,
                 block=True, layout=layout)
        mgr.wait()
    elif mgr is not None:
        mgr.wait()  # crash simulation: the last periodic checkpoint survives
    if log_file and main_rank:
        Path(log_file).parent.mkdir(parents=True, exist_ok=True)
        Path(log_file).write_text(json.dumps(history, indent=1))
    if dump_params and main_rank:
        Path(dump_params).parent.mkdir(parents=True, exist_ok=True)
        np.savez(dump_params, **{p: v.float().cpu().numpy()
                                 for p, v in tree_paths(params)})
    return params, opt_state, history


def main(argv=None):
    # segments that grow in place: a full-width paligemma-3b step asks for
    # its 257280-column head's 7.85 GiB fp32 logits while fixed segments
    # hold enough free memory only in smaller pieces (set before the card's
    # allocator starts; a value the caller set is kept)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--optimizer", default="rmnp", choices=list(optimizer_names()),
                    help="matrix update rule (everything else gets AdamW); "
                         "'adamw' is the everything-through-AdamW baseline")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr-matrix", type=float, default=2e-3)
    ap.add_argument("--lr-adamw", type=float, default=1e-3)
    ap.add_argument("--full", action="store_true", help="full-size config")
    ap.add_argument("--layers", default="",
                    help="START:STOP, keep only these layers of the pattern "
                         "(a depth cut; every width is kept)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'; never chosen for you")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--dominance-every", type=int, default=0)
    ap.add_argument("--use-kernel", action="store_true",
                    help="accepted for the JAX driver's command line; the "
                         "port always runs its kernels on cuda")
    ap.add_argument("--engine", default=None,
                    choices=["per-leaf", "bucketed", "single-pass"],
                    help="matrix-partition engine: 'per-leaf' (one "
                         "preconditioner pass per parameter), 'bucketed' "
                         "(one pass per distinct matrix shape), "
                         "'single-pass' (bucketed with the weight apply "
                         "folded into the per-bucket pass)")
    ap.add_argument("--momentum-dtype", default="float32",
                    choices=["float32", "bfloat16"],
                    help="bucketed matrix-momentum storage dtype")
    ap.add_argument("--fused", action="store_true",
                    help="DEPRECATED alias for --engine bucketed")
    ap.add_argument("--fused-apply", action="store_true",
                    help="DEPRECATED alias for --engine single-pass")
    ap.add_argument("--zero2", action="store_true",
                    help="ZeRO-2 data parallel over the process group (torchrun's, "
                         "or one rank): momentum and gradient buckets sharded, "
                         "--batch is the global batch")
    ap.add_argument("--no-compress", action="store_true",
                    help="with --zero2: the exact fp32 wire instead of int8 "
                         "error feedback")
    ap.add_argument("--accum", type=int, default=1,
                    help="microbatch gradient-accumulation factor")
    ap.add_argument("--overlap", default="auto", choices=["auto", "on", "off"],
                    help="with --zero2: the pipelined schedule (per-bucket "
                         "collectives in flight together) or the serialized one")
    ap.add_argument("--no-overlap", action="store_true",
                    help="DEPRECATED alias for --overlap off")
    ap.add_argument("--no-matrix-embed", action="store_true",
                    help="AdamW on LM-head/embeddings (paper App D.4 ablation)")
    ap.add_argument("--stop-at", type=int, default=0,
                    help="stop at this step (schedules span --steps)")
    ap.add_argument("--kill-at", type=int, default=0,
                    help="fault injection: SIGKILL the process after this step, "
                         "with any async save in flight")
    ap.add_argument("--watchdog-deadline", type=float, default=0.0,
                    help="arm the hang/straggler watchdog: a step exceeding "
                         "this many seconds (or flagged by the step-time "
                         "monitor) writes an emergency checkpoint of the last "
                         "completed step")
    ap.add_argument("--dump-params", default="",
                    help="write the final params to this npz (fp32)")
    ap.add_argument("--log-file", default="")
    ap.add_argument("--clip-norm", type=float, default=1.0,
                    help="global gradient-norm clip; <= 0 disables clipping")
    ap.add_argument("--guard", action="store_true",
                    help="non-finite guard (a NaN/Inf step is skipped with every "
                         "buffer bit for bit unchanged) and the anomaly ladder "
                         "(skip -> rewind to last-known-good -> abort)")
    ap.add_argument("--inject-fault", default="",
                    help="kind:leaf:step[:microbatch], kind nan|inf (leaf a "
                         "gradient-leaf path, '*' = first) or bitflip (leaf a "
                         "bucket key, the int8 wire of --zero2); a trailing '+' "
                         "on step makes it sticky; e.g. nan:*:6+")
    ap.add_argument("--anomaly-spike-k", type=float, default=6.0,
                    help="loss-spike threshold of the anomaly ladder (EWMA sigmas)")
    ap.add_argument("--anomaly-skip-budget", type=int, default=3,
                    help="consecutive skipped steps tolerated before a rewind")
    ap.add_argument("--anomaly-rewind-budget", type=int, default=2,
                    help="rewinds tolerated before aborting")
    ap.add_argument("--anomaly-lr-backoff", type=float, default=0.5,
                    help="multiply both learning rates by this on every rewind")
    ap.add_argument("--anomaly-health-window", type=int, default=2,
                    help="anomaly-free steps before a checkpoint becomes "
                         "last-known-good")
    ap.add_argument("--anomaly-skip-batch", action="store_true",
                    help="on replay, drop the batches of skipped steps")
    args = ap.parse_args(argv)
    engine = args.engine
    if args.fused or args.fused_apply:
        alias = "--fused-apply" if args.fused_apply else "--fused"
        mapped = "single-pass" if args.fused_apply else "bucketed"
        warnings.warn(f"{alias} is deprecated; use --engine {mapped}",
                      DeprecationWarning, stacklevel=2)
        engine = engine or mapped
    engine = engine or "per-leaf"
    overlap = {"auto": None, "on": True, "off": False}[args.overlap]
    if args.no_overlap:
        warnings.warn("--no-overlap is deprecated; use --overlap off",
                      DeprecationWarning, stacklevel=2)
        overlap = False
    train(args.arch, args.optimizer, args.steps, args.batch, args.seq,
          args.lr_matrix, args.lr_adamw, reduced=not args.full, seed=args.seed,
          ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
          log_every=args.log_every, dominance_every=args.dominance_every,
          matrix_embed=not args.no_matrix_embed, use_kernel=args.use_kernel,
          fused=engine in ("bucketed", "single-pass"),
          momentum_dtype=args.momentum_dtype,
          fused_apply=engine == "single-pass", zero2=args.zero2,
          compress=not args.no_compress, accum=args.accum,
          overlap=overlap,
          log_file=args.log_file, stop_at=args.stop_at, kill_at=args.kill_at,
          watchdog_deadline=args.watchdog_deadline, dump_params=args.dump_params,
          clip_norm=args.clip_norm, guard=args.guard,
          inject_fault=args.inject_fault, anomaly_spike_k=args.anomaly_spike_k,
          anomaly_skip_budget=args.anomaly_skip_budget,
          anomaly_rewind_budget=args.anomaly_rewind_budget,
          anomaly_lr_backoff=args.anomaly_lr_backoff,
          anomaly_health_window=args.anomaly_health_window,
          anomaly_skip_batch=args.anomaly_skip_batch, device=args.device,
          layers=args.layers)


if __name__ == "__main__":
    main()
