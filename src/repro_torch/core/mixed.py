"""The paper's mixed update strategy (mirror of ``repro.core.mixed``): matrix
parameters -> any registered matrix update rule (RMNP, Muon, NorMuon, Muown,
Nora; ``core/rules.py``), everything else (norms, biases, optionally
embeddings and the LM head) -> AdamW, with global-norm gradient clipping.

The per-leaf path keeps one state tree shaped like ``params`` (momentum for
matrix leaves, Adam ``(mu, nu)`` for the rest); the fused path runs the
matrix partition through the bucketed engine (core/engine.py) and AdamW leaf
by leaf.
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import torch

from repro_torch.core import bucketing
from repro_torch.core.rmnp import rms_lr_scale
from repro_torch.core.rules import MatrixUpdateRule, make_rule, rule_names
from repro_torch.core.types import (Optimizer, PyTree, Schedule, map_unzip, map_with_path,
                                    tree_paths)

# parameter path fragments always handled by AdamW regardless of rank
_NON_MATRIX_TOKENS = ("norm", "bias", "scale", "a_log", "dt_", "conv")


def is_matrix_param(path: str, leaf, matrix_embed: bool = True) -> bool:
    """True when the leaf gets the matrix (RMNP/Muon) optimizer."""
    lp = path.lower()
    if any(tok in lp for tok in _NON_MATRIX_TOKENS):
        return False
    if not matrix_embed and ("embed" in lp or "lm_head" in lp):
        return False
    if not hasattr(leaf, "ndim") or leaf.ndim < 2:
        return False
    return leaf.shape[-1] > 1 and leaf.shape[-2] > 1


class ClipStats(NamedTuple):
    global_norm: torch.Tensor
    clipped: torch.Tensor  # 1.0 when the step was clipped


def clip_by_global_norm(grads: PyTree, max_norm: float):
    """Global-norm clip. The sum of squares runs over the leaves in tree
    order, as in the JAX package. ``max_norm <= 0`` disables clipping: the
    grads pass through untouched while ``global_norm`` is still measured and
    ``clipped`` pins to 0.0."""
    leaves = [g for _, g in tree_paths(grads)]
    sq = None
    for g in leaves:
        term = torch.sum(torch.square(g.float()))
        sq = term if sq is None else sq + term
    gnorm = torch.sqrt(sq)
    if max_norm <= 0:
        return grads, ClipStats(global_norm=gnorm, clipped=torch.zeros_like(gnorm))
    scale = torch.clamp(max_norm / (gnorm + 1e-12), max=1.0)
    clipped = map_with_path(lambda _p, g: (g.float() * scale).to(g.dtype), grads)
    return clipped, ClipStats(global_norm=gnorm, clipped=(gnorm > max_norm).float())


class MixedState(NamedTuple):
    momentum: PyTree  # fp32; matrix-optimizer momentum OR Adam mu per leaf
    nu: PyTree        # fp32; Adam second moment ((1,)*ndim on matrix leaves)


class FusedMixedState(NamedTuple):
    """State of the shape-bucketed fused path: matrix momentum stacked per
    bucket; the per-leaf trees keep ``(1,)*ndim`` placeholders on matrix
    leaves so their structure mirrors ``params``."""
    momentum: PyTree                     # AdamW first moment
    nu: PyTree                           # AdamW second moment
    buckets: Dict[str, torch.Tensor]     # stacked matrix momentum per bucket
    slots: Dict[str, Dict[str, torch.Tensor]] = {}


def _adam_scalars(step, b1, b2):
    t = torch.as_tensor(step, dtype=torch.float32) + 1.0
    return 1.0 - b1 ** t, 1.0 - b2 ** t


def mixed_optimizer(
    matrix_kind: str,                      # any rules.rule_names() | "adamw"
    lr_matrix: Schedule,
    lr_adamw: Schedule,
    beta: float = 0.95,
    weight_decay: float = 0.1,
    adam_betas=(0.9, 0.95),
    adam_eps: float = 1e-8,
    rn_eps: float = 1e-8,
    matrix_embed: bool = True,
    ns_steps: int = 5,
    use_kernel: bool = False,
    fused: bool = False,
    momentum_dtype: str = "float32",
    fused_apply: bool = False,
    shard_axis=None,
    shard_size: int = 1,
) -> Optimizer:
    """Build the paper's mixed optimizer: any registered matrix update rule
    (``rules.rule_names()``: rmnp, muon, normuon, muown, nora) on matrix
    parameters and AdamW on the rest, or ``'adamw'`` on everything.
    ``fused=True`` routes the matrix partition through the bucketed engine
    (one rule pass per ``(d_in, d_out)`` bucket: one RMNP kernel launch, or
    one Newton-Schulz launch sequence per iteration, on the card).
    NorMuon, Muown and Nora keep slot stripes or a non-additive apply that
    exist only in the bucketed layout, so they imply ``fused=True``.
    ``fused_apply=True`` (implies ``fused``) exposes ``update_apply``, the
    single-pass path. ``momentum_dtype`` sets the fused matrix-momentum
    storage type (math is fp32). ``shard_axis`` (a
    ``repro_torch.distributed.comm.Comm``) is the group the stacked matrix
    momentum may be ZeRO-sharded over and implies ``fused_apply``;
    ``shard_size`` (the group's size) pads bucket ``L`` to a multiple so
    uneven buckets shard too, and with it ``Optimizer.update_apply_sharded``
    takes reduce-scattered mean-gradient shards (AdamW leaves still read
    their mean grads from the per-leaf tree).

    ``use_kernel`` is accepted for the JAX package's signature and selects
    nothing: the port has one path per device, and every RMNP update and
    Newton-Schulz iteration goes through ``kernels/ops.py``, which launches
    the Hopper kernels on CUDA tensors and runs their plain versions on CPU
    tensors."""
    del use_kernel
    from repro_torch.core.engine import check_shard_args
    if matrix_kind not in rule_names() + ("adamw",):
        raise ValueError(
            f"unknown matrix optimizer {matrix_kind!r}; expected one of "
            f"{', '.join(rule_names() + ('adamw',))}")
    check_shard_args(shard_axis, shard_size)
    if shard_axis is not None:
        fused_apply = True  # sharded state needs the single-pass path
    if fused_apply:
        fused = True
    if matrix_kind not in ("rmnp", "muon", "adamw"):
        fused = True  # slot stripes / non-additive apply are bucketed-only
    b1, b2 = adam_betas

    def _is_mat(path, leaf):
        return matrix_kind != "adamw" and is_matrix_param(path, leaf, matrix_embed)

    # adamw has no matrix partition, so any rule serves as a placeholder
    rule = make_rule("rmnp" if matrix_kind == "adamw" else matrix_kind,
                     beta=beta, weight_decay=weight_decay, eps=rn_eps, ns_steps=ns_steps)
    if fused:
        return _fused_mixed(
            rule, lr_matrix, lr_adamw, is_mat=_is_mat,
            weight_decay=weight_decay, b1=b1, b2=b2, adam_eps=adam_eps,
            momentum_dtype=momentum_dtype, fused_apply=fused_apply,
            shard_axis=shard_axis, shard_size=shard_size)

    def init(params):
        momentum = map_with_path(
            lambda _p, p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
            params)
        nu = map_with_path(
            lambda path, p: torch.zeros(
                p.shape if not _is_mat(path, p) else (1,) * p.ndim,
                dtype=torch.float32, device=p.device), params)
        return MixedState(momentum=momentum, nu=nu)

    def update(grads, state, params, step):
        eta_m = lr_matrix(step)
        eta_a = lr_adamw(step)
        bc1, bc2 = _adam_scalars(step, b1, b2)

        def upd(path, g, v, nu, p):
            g32 = g.float()
            p32 = p.float()
            if _is_mat(path, p):
                # rmnp or muon (the others imply fused): the rule's direction
                # on one leaf, through the same kernel entries as a bucket
                d, v_new, _ = rule.precondition(g32, v, {}, step=step)
                scale = eta_m * rms_lr_scale(p.shape)
                return -scale * (d + weight_decay * p32), v_new, nu
            mu_new = b1 * v + (1 - b1) * g32
            nu_new = b2 * nu + (1 - b2) * torch.square(g32)
            d = (mu_new / bc1) / (torch.sqrt(nu_new / bc2) + adam_eps)
            return -eta_a * (d + weight_decay * p32), mu_new, nu_new

        updates, momentum, nu = map_unzip(upd, 3, grads, state.momentum,
                                          state.nu, params)
        return updates, MixedState(momentum=momentum, nu=nu)

    return Optimizer(init=init, update=update)


def momentum_for_diagnostics(opt_state, params, matrix_embed: bool = True) -> PyTree:
    """Per-leaf momentum tree for dominance logging (the paper's Eq. 14-16
    average per parameter). The fused state keeps matrix momentum stacked
    per bucket, so the buckets are scattered back onto the parameter tree
    first; a per-leaf state passes through unchanged."""
    if not hasattr(opt_state, "buckets"):
        return opt_state.momentum
    plan = bucketing.build_plan(
        params, predicate=lambda path, leaf: is_matrix_param(path, leaf, matrix_embed))
    return bucketing.scatter(plan, opt_state.buckets, opt_state.momentum)


def _fused_mixed(rule: MatrixUpdateRule, lr_matrix: Schedule,
                 lr_adamw: Schedule, *, is_mat,
                 weight_decay: float, b1: float, b2: float,
                 adam_eps: float, momentum_dtype: str,
                 fused_apply: bool = False, shard_axis=None,
                 shard_size: int = 1) -> Optimizer:
    """Mixed optimizer with the matrix partition on the bucketed engine under
    ``rule``; AdamW leaves stay per-leaf."""
    from repro_torch.core.engine import BucketedEngine, _device_of

    eng = BucketedEngine(rule, lr_matrix, momentum_dtype=momentum_dtype,
                         shard_axis=shard_axis, shard_size=shard_size,
                         predicate=is_mat)

    def init(params):
        bucketed = eng.init_state(eng.plan(params), device=_device_of(params))

        def placeholder(path, p):
            return torch.zeros((1,) * p.ndim if is_mat(path, p) else p.shape,
                               dtype=torch.float32, device=p.device)
        return FusedMixedState(momentum=map_with_path(placeholder, params),
                               nu=map_with_path(placeholder, params),
                               buckets=bucketed.buckets, slots=bucketed.slots)

    def adam_sweep(grads, state, params, step, emit):
        """Shared per-leaf AdamW pass. ``emit(u, p)`` turns the fp32 update
        (``u=None`` on matrix leaves, which the bucket scatter overwrites)
        into the output leaf — the only place the two-pass and single-pass
        paths differ. Returns (emitted tree, momentum, nu)."""
        eta_a = lr_adamw(step)
        bc1, bc2 = _adam_scalars(step, b1, b2)

        def upd_adam(path, g, mu, nu, p):
            if is_mat(path, p):
                return emit(None, p), mu, nu
            g32 = g.float()
            mu_new = b1 * mu + (1 - b1) * g32
            nu_new = b2 * nu + (1 - b2) * torch.square(g32)
            d = (mu_new / bc1) / (torch.sqrt(nu_new / bc2) + adam_eps)
            u = -eta_a * (d + weight_decay * p.float())
            return emit(u, p), mu_new, nu_new

        return map_unzip(upd_adam, 3, grads, state.momentum, state.nu, params)

    def update(grads, state, params, step):
        plan = eng.plan(params)
        updates, momentum, nu = adam_sweep(
            grads, state, params, step,
            emit=lambda u, p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device) if u is None else u)
        g_b = bucketing.gather(plan, grads, dtype=torch.float32)
        p_b = bucketing.gather(plan, params, dtype=torch.float32)
        upd_b, v_b, s_b = eng.update_buckets(plan, g_b, p_b, state.buckets,
                                             state.slots, step)
        updates = bucketing.scatter(plan, upd_b, updates)
        return updates, FusedMixedState(momentum=momentum, nu=nu,
                                        buckets=v_b, slots=s_b)

    def update_apply(grads, state, params, step):
        """Single-pass fused apply -> (new_params, state): AdamW leaves
        compute their new params directly; matrix buckets run the apply
        kernel (gather g, v, w; one pass; scatter the new weights), one
        bucket at a time, so that a single bucket's gathered fp32 gradient
        and weights exist at once."""
        plan = eng.plan(params)
        new_params, momentum, nu = adam_sweep(
            grads, state, params, step,
            emit=lambda u, p: p if u is None else p + u.to(p.dtype))
        v_b, s_b = {}, {name: {} for name in state.slots}
        for bucket in plan.buckets:
            one = bucketing.BucketPlan(buckets=(bucket,))
            w_one, v_one, s_one = eng.apply_buckets(
                one, bucketing.gather(one, grads, dtype=torch.float32),
                bucketing.gather(one, params), state.buckets, state.slots, step)
            new_params = bucketing.scatter(one, w_one, new_params, cast=True)
            v_b.update(v_one)
            for name, per_bucket in s_one.items():
                s_b[name].update(per_bucket)
        return new_params, FusedMixedState(momentum=momentum, nu=nu,
                                           buckets=v_b, slots=s_b)

    def update_apply_bucket(bucket, g_shard, v_shard, w_shard, step,
                            clip_scale=None, *, slots=None, async_op=False):
        """One matrix bucket's whole ZeRO-2 chain (see ``Optimizer``)."""
        return eng.bucket_apply_sharded(bucket, g_shard, v_shard, slots or {},
                                        w_shard, step, clip_scale, async_op)

    def update_apply_sharded(g_shards, grads, state, params, step,
                             clip_scale=None, overlap=False):
        """ZeRO-2 single-pass apply: matrix buckets take this rank's
        reduce-scattered ``(padded L / N, d_in, d_out)`` fp32 mean-gradient
        shards from ``g_shards`` (their leaves in ``grads`` are ignored);
        AdamW leaves read their mean grads from ``grads``, already
        clip-scaled, and update whole on every rank. ``clip_scale`` folds the
        global-norm clip into each bucket's chain; only the updated weight
        slices are all-gathered."""
        plan = eng.plan(params)
        new_params, momentum, nu = adam_sweep(
            grads, state, params, step,
            emit=lambda u, p: p if u is None else p + u.to(p.dtype))
        out = eng.sharded_apply(plan, g_shards, state.buckets, state.slots,
                                params, step, clip_scale, overlap)
        if out is None:
            return new_params, FusedMixedState(momentum=momentum, nu=nu,
                                               buckets={}, slots={})
        w_b, v_b, s_b = out
        new_params = bucketing.scatter(plan, w_b, new_params, cast=True)
        return new_params, FusedMixedState(momentum=momentum, nu=nu,
                                           buckets=v_b, slots=s_b)

    zero2 = shard_axis is not None
    return Optimizer(init=init, update=update,
                     update_apply=update_apply if fused_apply else None,
                     update_apply_sharded=update_apply_sharded if zero2 else None,
                     update_apply_bucket=update_apply_bucket if zero2 else None,
                     bucket_plan=eng.plan, shard_size=shard_size)
