"""Training, serving and evaluation steps of the port (mirror of
``repro.train.step``: ``make_train_step``, ``make_serve_step``,
``make_prefill_step``, ``eval_step``, ``optimizer_launches`` and
``optimizer_fp32_buffers``).

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
from repro_torch.models.model import forward, lm_head, loss_fn
from repro_torch.train import pipeline


def _meta_step(opt: Optimizer, params, step: int):
    """(step function, args) of one optimizer step on meta copies of
    ``params``: ``opt.update_apply`` where the optimizer has the single-pass
    path, else ``opt.update``; the gradients are meta tensors like the
    parameters and the state is ``opt.init`` of the meta parameters."""
    from repro_torch.kernels.introspect import to_meta
    meta = to_meta(params)
    fn = opt.update_apply if opt.update_apply is not None else opt.update
    return fn, (meta, opt.init(meta), meta, step)


def optimizer_launches(opt: Optimizer, params, step: int = 0) -> int:
    """Kernel launches one optimizer step makes: the per-leaf engine
    launches once per matrix parameter, the bucketed ones once per shape
    bucket (three per Newton-Schulz iteration and bucket under Muon). The
    step runs on meta tensors under ``kernels/introspect.recording()``:
    nothing is launched, allocated on a device or built."""
    from repro_torch.kernels.ops import count_kernel_launches
    fn, args = _meta_step(opt, params, step)
    return count_kernel_launches(fn, *args)


def optimizer_fp32_buffers(opt: Optimizer, params, shape, step: int = 0) -> int:
    """fp32 buffers of exactly ``shape`` that one optimizer step allocates
    (op outputs with new storage, on meta tensors): the two-pass engine
    writes the fp32 ``d`` bucket and the update, the single-pass kernel
    neither."""
    from repro_torch.kernels.ops import count_buffer_allocs
    fn, args = _meta_step(opt, params, step)
    return count_buffer_allocs(fn, shape, torch.float32, *args)


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


def make_serve_step(cfg: ModelConfig):
    """One decode step: (params, cache, tokens (B,1), pos) -> (next_token
    (B,1) int32, logits (B,1,padded_vocab), cache). The cache passed in is
    updated in place and returned (``forward``'s decode mode); the greedy
    token is the argmax over the real vocabulary, padding excluded."""

    @torch.no_grad()
    def serve_step(params, cache, tokens, pos):
        logits, new_cache, _ = forward(cfg, params, {"tokens": tokens}, "decode",
                                       cache=cache, pos=pos)
        next_tok = torch.argmax(logits[:, -1, :cfg.vocab], dim=-1).to(torch.int32)
        return next_tok[:, None], logits, new_cache

    return serve_step


def make_prefill_step(cfg: ModelConfig):
    """Prompt ingestion: (params, batch) -> (last-token logits (B,
    padded_vocab), prompt cache). The LM head is applied to the last
    position only, so the (B, S, padded_vocab) logits are never formed; each
    logit is the same dot product as in the full forward, summed in the
    order the matmul picks for its shape."""

    @torch.no_grad()
    def prefill_step(params, batch):
        hidden, cache, _ = forward(cfg, params, batch, "prefill", return_hidden=True)
        return hidden[:, -1] @ lm_head(cfg, params), cache

    return prefill_step


@torch.no_grad()
def eval_step(cfg: ModelConfig, params, batch):
    _, metrics = loss_fn(cfg, params, batch, remat="none")
    return metrics
