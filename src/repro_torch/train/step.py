"""Training step of the port (mirror of ``repro.train.step.make_train_step``).

``make_train_step`` builds ``(params, opt_state, batch, step) -> (params,
opt_state, metrics)`` with optional microbatch gradient accumulation (fp32
accumulators), global-norm clipping and the optional non-finite guard.
Parameters stay plain tensors: the step differentiates the loss with
``torch.autograd.grad`` on detached leaves that share their storage, and the
optimizer returns new parameters, as the JAX package's functional step does.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.mixed import clip_by_global_norm
from repro_torch.core.types import Optimizer, apply_updates, map_with_path, tree_paths
from repro_torch.models.model import loss_fn, torch_dtype
from repro_torch.train import faults
from repro_torch.train import pipeline


def split_microbatches(batch, accum: int):
    """(B, ...) tensors -> ``accum`` microbatches of B / accum rows."""
    out = []
    for name, x in batch.items():
        if x.shape[0] % accum:
            raise ValueError(f"accum={accum} does not divide the batch {x.shape[0]}")
        for i, part in enumerate(torch.chunk(x, accum, dim=0)):
            if len(out) <= i:
                out.append({})
            out[i][name] = part
    return out


def make_train_step(cfg: ModelConfig, opt: Optimizer, *, clip_norm: float = 1.0,
                    remat: str = "full", num_microbatches: int = 1,
                    grad_dtype: Optional[str] = None, guard: bool = False,
                    fault=None):
    """``clip_norm <= 0`` disables clipping while ``grad_norm`` and
    ``clip_rate`` keep reporting. ``grad_dtype`` casts the gradients before
    accumulation and clipping. ``guard=True`` adds the non-finite guard: a
    step with any NaN/Inf gradient leaf leaves params and optimizer state
    bit for bit unchanged, and the metrics gain ``skipped`` and
    ``guard_flags`` (one per gradient leaf, tree order). The verdict stays
    on the device. ``fault`` (``repro_torch.train.faults.FaultSpec``)
    poisons a gradient for the resilience checks, per microbatch; a
    ``bitflip`` fault belongs to the int8 wire of ZeRO-2 and raises."""
    if fault is not None:
        faults.wire_fault_for(fault, fault.leaf, 0, "data")

    def grads_of(params, batch, step, mb_idx=0):
        leaves = {path: t.detach().requires_grad_(True)
                  for path, t in tree_paths(params)}
        live = map_with_path(lambda path, _t: leaves[path], params)
        loss, metrics = loss_fn(cfg, live, batch, remat=remat)
        paths = list(leaves)
        grads = dict(zip(paths, torch.autograd.grad(loss, [leaves[p] for p in paths]),
                         strict=True))
        grads = faults.apply_grad_fault(fault, grads, step, mb_idx)
        if grad_dtype:
            dt = torch_dtype(grad_dtype)
            grads = {p: g.to(dt) for p, g in grads.items()}
        grads = map_with_path(lambda path, _t: grads[path], params)
        return grads, {k: v.detach() for k, v in metrics.items()}

    def train_step(params, opt_state, batch, step):
        prev = (params, opt_state)
        if num_microbatches > 1:
            acc, ms = None, []
            for mb_idx, mb in enumerate(split_microbatches(batch, num_microbatches)):
                g, m = grads_of(params, mb, step, mb_idx)
                if acc is None:
                    acc = map_with_path(
                        lambda _p, x: torch.zeros(x.shape, dtype=torch.float32,
                                                  device=x.device), params)
                acc = map_with_path(lambda _p, a, x: a + x.float(), acc, g)
                ms.append(m)
            grads = map_with_path(lambda _p, a: a / num_microbatches, acc)
            metrics = {k: torch.mean(torch.stack([m[k] for m in ms]), dim=0)
                       for k in ms[0]}
        else:
            grads, metrics = grads_of(params, batch, step)

        with torch.no_grad():
            # the flags come from the unclipped gradients
            ginfo = pipeline.finite_guard(grads) if guard else None
            grads, clip_stats = clip_by_global_norm(grads, clip_norm)
            if opt.update_apply is not None:
                # single-pass fused apply: the kernel emits the new weights
                params, opt_state = opt.update_apply(grads, opt_state, params, step)
            else:
                updates, opt_state = opt.update(grads, opt_state, params, step)
                params = apply_updates(params, updates)
            if guard:
                # masked after the update is applied: no host read of the verdict
                params = pipeline.mask_updates(ginfo.ok, params, prev[0])
                opt_state = pipeline.mask_updates(ginfo.ok, opt_state, prev[1])
        metrics = dict(metrics, grad_norm=clip_stats.global_norm,
                       clip_rate=clip_stats.clipped)
        if guard:
            metrics["skipped"] = (~ginfo.ok).float()
            metrics["guard_flags"] = ginfo.flags.float()
        return params, opt_state, metrics

    return train_step
