"""Training step of the port (mirror of ``repro.train.step.make_train_step``).

``make_train_step`` builds ``(params, opt_state, batch, step) -> (params,
opt_state, metrics)`` with optional microbatch gradient accumulation (fp32
accumulators) and global-norm clipping. Parameters stay plain tensors: the
step differentiates the loss with ``torch.autograd.grad`` on detached leaves
that share their storage, and the optimizer returns new parameters, as the
JAX package's functional step does.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.mixed import clip_by_global_norm
from repro_torch.core.types import Optimizer, apply_updates, map_with_path, tree_paths
from repro_torch.models.model import loss_fn, torch_dtype


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
    accumulation and clipping. The non-finite guard and fault injection
    (``guard``, ``fault``) are not ported yet."""
    if guard or fault is not None:
        raise NotImplementedError(
            "the non-finite guard and fault injection are not ported yet "
            "(ROADMAP Queue 1, item 7: checkpointing and resilience)")

    def grads_of(params, batch):
        leaves = {path: t.detach().requires_grad_(True)
                  for path, t in tree_paths(params)}
        live = map_with_path(lambda path, _t: leaves[path], params)
        loss, metrics = loss_fn(cfg, live, batch, remat=remat)
        paths = list(leaves)
        grads = dict(zip(paths, torch.autograd.grad(loss, [leaves[p] for p in paths]),
                         strict=True))
        if grad_dtype:
            dt = torch_dtype(grad_dtype)
            grads = {p: g.to(dt) for p, g in grads.items()}
        grads = map_with_path(lambda path, _t: grads[path], params)
        return grads, {k: v.detach() for k, v in metrics.items()}

    def train_step(params, opt_state, batch, step):
        if num_microbatches > 1:
            acc, ms = None, []
            for mb in split_microbatches(batch, num_microbatches):
                g, m = grads_of(params, mb)
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
            grads, metrics = grads_of(params, batch)

        with torch.no_grad():
            grads, clip_stats = clip_by_global_norm(grads, clip_norm)
            if opt.update_apply is not None:
                # single-pass fused apply: the kernel emits the new weights
                params, opt_state = opt.update_apply(grads, opt_state, params, step)
            else:
                updates, opt_state = opt.update(grads, opt_state, params, step)
                params = apply_updates(params, updates)
        metrics = dict(metrics, grad_norm=clip_stats.global_norm,
                       clip_rate=clip_stats.clipped)
        return params, opt_state, metrics

    return train_step
