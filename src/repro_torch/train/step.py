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
from repro_torch.core.types import Optimizer, apply_updates, map_with_path
from repro_torch.train import pipeline


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
    ``bitflip`` fault belongs to the int8 wire of the ZeRO-2 step
    (``train/dp_step.py``) and leaves this step's gradients alone, as in the
    JAX package."""

    def grads_of(params, batch, step, mb_idx=0):
        return pipeline.grads_of(cfg, params, batch, remat, fault, step, mb_idx,
                                 grad_dtype)

    def train_step(params, opt_state, batch, step):
        prev = (params, opt_state)
        if num_microbatches > 1:
            acc, ms = None, []
            for mb_idx, mb in enumerate(pipeline.split_microbatches(batch, num_microbatches)):
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
