"""Training driver of the port (mirror of ``repro.launch.train``), single
process, one device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch gpt2-small --full \\
        --optimizer rmnp --engine single-pass --use-kernel --steps 3 \\
        --batch 8 --seq 1024

Wires config -> synthetic data -> mixed optimizer -> train step -> metrics
log. It runs on ``cuda`` unless ``device="cpu"`` (``--device cpu``) is
passed. Flags of features the port does not have yet raise and name their
ROADMAP item.
"""
from __future__ import annotations

import argparse
import json
import time
import warnings
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import (cosine_with_warmup, global_dominance, make_optimizer,
                              momentum_for_diagnostics, optimizer_names)
from repro_torch.core.types import tree_paths
from repro_torch.data.pipeline import make_stream
from repro_torch.kernels import LAUNCHES
from repro_torch.models import init_params
from repro_torch.train.step import make_train_step

# flag -> the ROADMAP item that brings it
_NOT_PORTED = {
    "zero2": "Queue 1, item 6 (ZeRO-2 data parallel)",
    "ckpt_dir": "Queue 1, item 7 (checkpointing and resilience)",
    "guard": "Queue 1, item 7 (checkpointing and resilience)",
    "inject_fault": "Queue 1, item 7 (checkpointing and resilience)",
    "kill_at": "Queue 1, item 7 (checkpointing and resilience)",
    "watchdog_deadline": "Queue 1, item 7 (checkpointing and resilience)",
}


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
          anomaly_skip_batch: bool = False, device: str = "cuda"):
    """Train ``arch`` for ``steps`` steps; returns (params, opt_state,
    history). ``fused`` routes matrix parameters through the shape-bucketed
    engine, ``fused_apply`` folds the weight update into the per-bucket
    kernel (the single-pass engine). ``use_kernel`` is accepted for the JAX
    driver's signature and selects nothing: on ``cuda`` every RMNP update
    and Newton-Schulz iteration runs the Hopper kernels, on ``cpu`` their
    plain versions. ``dominance_every`` adds the momentum's diagonal
    dominance (``r_avg``, ``r_min``, ``r_max``) to the logged steps it
    divides.
    ``stop_at`` trains to that step with the schedules still spanning
    ``steps``. Each history entry also holds the kernel launches of its step
    (``launches``). ``compress``, ``overlap`` and the ``anomaly_*`` settings
    belong to ZeRO-2 and the guard and are accepted for the JAX driver's
    signature."""
    del ckpt_every, compress, overlap, anomaly_spike_k, anomaly_skip_budget
    del anomaly_rewind_budget, anomaly_lr_backoff, anomaly_health_window
    del anomaly_skip_batch
    asked = {"zero2": zero2, "ckpt_dir": ckpt_dir, "guard": guard,
             "inject_fault": inject_fault, "kill_at": kill_at,
             "watchdog_deadline": watchdog_deadline}
    for flag, value in asked.items():
        if value:
            raise NotImplementedError(
                f"{flag} is not ported yet (ROADMAP {_NOT_PORTED[flag]})")
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()

    opt = make_optimizer(optimizer, dict(
        lr_matrix=cosine_with_warmup(lr_matrix, steps),
        lr_adamw=cosine_with_warmup(lr_adamw, steps),
        matrix_embed=matrix_embed, use_kernel=use_kernel, fused=fused,
        momentum_dtype=momentum_dtype, fused_apply=fused_apply))
    params = init_params(cfg, seed=seed, device=device)
    opt_state = opt.init(params)
    step_fn = make_train_step(cfg, opt, num_microbatches=accum,
                              clip_norm=clip_norm,
                              remat="none" if reduced else "full")
    stream = make_stream(cfg, seq, batch, seed=seed)

    history = []
    t0 = time.time()
    end_step = min(steps, stop_at) if stop_at else steps
    for step in range(end_step):
        before = dict(LAUNCHES)
        params, opt_state, metrics = step_fn(
            params, opt_state, batch_to_device(next(stream), device), step)
        if log_every and (step % log_every == 0 or step == steps - 1):
            m = {k: float(v) for k, v in metrics.items()}
            m["step"] = step
            m["wall_s"] = round(time.time() - t0, 2)
            m["launches"] = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
            if dominance_every and step % dominance_every == 0 and optimizer != "adamw":
                dom = global_dominance(momentum_for_diagnostics(
                    opt_state, params, matrix_embed=matrix_embed))
                m.update({k: float(v) for k, v in dom.items()})
            history.append(m)
            print(f"[train] step={step} loss={m['loss']:.4f} "
                  f"gnorm={m['grad_norm']:.3f} clip={m['clip_rate']:.0f}"
                  + (f" r_avg={m['r_avg']:.2f}" if "r_avg" in m else "")
                  + f" launches={m['launches']}", flush=True)
    if log_file:
        Path(log_file).parent.mkdir(parents=True, exist_ok=True)
        Path(log_file).write_text(json.dumps(history, indent=1))
    if dump_params:
        Path(dump_params).parent.mkdir(parents=True, exist_ok=True)
        np.savez(dump_params, **{p: v.float().cpu().numpy()
                                 for p, v in tree_paths(params)})
    return params, opt_state, history


def main(argv=None):
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
    ap.add_argument("--zero2", action="store_true", help="not ported yet")
    ap.add_argument("--no-compress", action="store_true", help="with --zero2")
    ap.add_argument("--accum", type=int, default=1,
                    help="microbatch gradient-accumulation factor")
    ap.add_argument("--overlap", default="auto", choices=["auto", "on", "off"],
                    help="with --zero2")
    ap.add_argument("--no-matrix-embed", action="store_true",
                    help="AdamW on LM-head/embeddings (paper App D.4 ablation)")
    ap.add_argument("--stop-at", type=int, default=0,
                    help="stop at this step (schedules span --steps)")
    ap.add_argument("--kill-at", type=int, default=0, help="not ported yet")
    ap.add_argument("--watchdog-deadline", type=float, default=0.0,
                    help="not ported yet")
    ap.add_argument("--dump-params", default="",
                    help="write the final params to this npz (fp32)")
    ap.add_argument("--log-file", default="")
    ap.add_argument("--clip-norm", type=float, default=1.0,
                    help="global gradient-norm clip; <= 0 disables clipping")
    ap.add_argument("--guard", action="store_true", help="not ported yet")
    ap.add_argument("--inject-fault", default="", help="not ported yet")
    args = ap.parse_args(argv)
    engine = args.engine
    if args.fused or args.fused_apply:
        alias = "--fused-apply" if args.fused_apply else "--fused"
        mapped = "single-pass" if args.fused_apply else "bucketed"
        warnings.warn(f"{alias} is deprecated; use --engine {mapped}",
                      DeprecationWarning, stacklevel=2)
        engine = engine or mapped
    engine = engine or "per-leaf"
    train(args.arch, args.optimizer, args.steps, args.batch, args.seq,
          args.lr_matrix, args.lr_adamw, reduced=not args.full, seed=args.seed,
          ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
          log_every=args.log_every, dominance_every=args.dominance_every,
          matrix_embed=not args.no_matrix_embed, use_kernel=args.use_kernel,
          fused=engine in ("bucketed", "single-pass"),
          momentum_dtype=args.momentum_dtype,
          fused_apply=engine == "single-pass", zero2=args.zero2,
          compress=not args.no_compress, accum=args.accum,
          overlap={"auto": None, "on": True, "off": False}[args.overlap],
          log_file=args.log_file, stop_at=args.stop_at, kill_at=args.kill_at,
          watchdog_deadline=args.watchdog_deadline, dump_params=args.dump_params,
          clip_norm=args.clip_norm, guard=args.guard,
          inject_fault=args.inject_fault, device=args.device)


if __name__ == "__main__":
    main()
