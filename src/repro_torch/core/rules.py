"""Matrix-update rules for the shape-bucketed engine (mirror of
``repro.core.rules``).

A :class:`MatrixUpdateRule` holds only the per-bucket math: ``slot_shapes``
(extra per-bucket state), ``precondition`` (the two-pass direction ``d``;
the update is then ``-scale * (d + wd * w)``) and ``apply`` (the fused
single-pass form, by default derived from ``precondition`` in the RMNP
kernel's op order, ``w32 + (-scale) * (d + wd * w32)``). Every rule works on
stacked ``(L, d_in, d_out)`` operands whose ``L`` slices are independent
matrices, reducing over dim -2, and the Newton-Schulz family batches its
products over ``L`` (one kernel sequence per bucket on the card).

The rules are the JAX package's proxy reproductions of their sources: RMNP
(the paper), Muon (Jordan et al.), NorMuon (arXiv 2510.05491, neuron-wise
second moment), Muown (arXiv 2605.10797, weight-norm control) and Nora
(row-norm EMA variant of the RMNP family).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Tuple

import torch

from repro_torch.core.types import (Optimizer, PyTree, Schedule, map_unzip,
                                    map_with_path, tree_map, tree_paths)
from repro_torch.kernels import ops as kops

RULES: Dict[str, type] = {}


def _register(cls):
    RULES[cls.name] = cls
    return cls


def rule_names() -> Tuple[str, ...]:
    return tuple(sorted(RULES))


def make_rule(name: str, **hyper) -> "MatrixUpdateRule":
    """Construct a registered rule, keeping only the hyperparameters the
    rule declares (callers pass the shared pool: beta, weight_decay, eps,
    ns_steps, ...)."""
    if name not in RULES:
        raise ValueError(
            f"unknown matrix update rule {name!r}; registered: "
            f"{', '.join(rule_names())}")
    cls = RULES[name]
    fields = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in hyper.items() if k in fields})


def _ema32(g, v, beta: float):
    """Momentum EMA in fp32, the shared first stage of every rule."""
    return beta * v.float() + (1.0 - beta) * g.float()


def _frobenius(x):
    """Per-slice Frobenius norm over the last two dims, kept as (..., 1, 1)."""
    return torch.linalg.vector_norm(x, dim=(-2, -1), keepdim=True)


def _bias_correction(beta2: float, step):
    t = torch.as_tensor(step, dtype=torch.float32) + 1.0
    return 1.0 - beta2 ** t


@dataclasses.dataclass(frozen=True)
class MatrixUpdateRule:
    """Base rule: hyperparameters shared by the whole family."""
    beta: float = 0.95
    weight_decay: float = 0.1
    eps: float = 1e-8

    name = "base"
    # True when update() + apply_updates() is bitwise-equal (fp32 params) to
    # update_apply(): additive in w with the canonical op order.
    additive = True

    def slot_shapes(self, rows: int, d_in: int, d_out: int):
        """Extra per-bucket state: slot name -> (shape, dtype)."""
        del rows, d_in, d_out
        return {}

    def precondition(self, g, v, slots, *, step):
        """(d fp32, v_new in v.dtype, slots_new) from a stacked fp32 gradient
        ``g`` and stacked momentum ``v`` (fp32 or bf16; math fp32)."""
        raise NotImplementedError

    def apply(self, g, v, w, slots, *, scale, step):
        """Fused per-bucket apply: ``(w_new in w.dtype, v_new, slots_new)``.
        ``scale`` already folds lr * rms_lr_scale."""
        d, v_new, slots_new = self.precondition(g, v, slots, step=step)
        w32 = w.float()
        w_new = w32 + (-scale) * (d + self.weight_decay * w32)
        return w_new.to(w.dtype), v_new, slots_new


@_register
@dataclasses.dataclass(frozen=True)
class RmnpRule(MatrixUpdateRule):
    """The paper's rule: momentum EMA + row (fan-in) l2 normalize, through
    ``kernels/ops.py``: on CUDA tensors the precondition kernel for the
    two-pass path and the apply kernel for the single-pass path, on CPU
    tensors their plain versions."""
    name = "rmnp"

    def precondition(self, g, v, slots, *, step):
        del step
        v_new, d = kops.rmnp_bucket_update(g, v, beta=self.beta, eps=self.eps)
        return d, v_new, {}

    def apply(self, g, v, w, slots, *, scale, step):
        del step
        from repro_torch.core.bucketing import _apply_one
        v_new, w_new = _apply_one(g, v, w, scale, self.weight_decay,
                                  self.beta, self.eps)
        return w_new, v_new, {}


@_register
@dataclasses.dataclass(frozen=True)
class MuonRule(MatrixUpdateRule):
    """Muon: momentum EMA + quintic Newton-Schulz orthogonalization, batched
    over the bucket's leading ``L`` axis: one three-launch sequence per
    bucket per iteration on the card (``kernels/ops.ns_step``)."""
    ns_steps: int = 5

    name = "muon"

    def precondition(self, g, v, slots, *, step):
        del step
        from repro_torch.core.muon import newton_schulz
        v32 = _ema32(g, v, self.beta)
        d = newton_schulz(v32, steps=self.ns_steps)
        return d, v32.to(v.dtype), {}


@_register
@dataclasses.dataclass(frozen=True)
class NorMuonRule(MuonRule):
    """NorMuon (proxy): Muon plus a neuron-wise second moment of the
    orthogonalized update, one ``(L, 1, d_out)`` stripe per bucket (EMA of
    each output neuron's mean square of ``O = NS(V)``, bias-corrected). The
    normalized update is rescaled to keep each matrix's update norm."""
    beta2: float = 0.999

    name = "normuon"

    def slot_shapes(self, rows, d_in, d_out):
        del d_in
        return {"nu": ((rows, 1, d_out), torch.float32)}

    def precondition(self, g, v, slots, *, step):
        o, v_new, _ = super().precondition(g, v, slots, step=step)
        nu = self.beta2 * slots["nu"] + (1.0 - self.beta2) * torch.mean(
            torch.square(o), dim=-2, keepdim=True)
        nu_hat = nu / _bias_correction(self.beta2, step)
        o_norm = o / (torch.sqrt(nu_hat) + self.eps)
        # keep each matrix's update norm (per L slice); the tiny floor keeps
        # zero pad slices at exactly 0 / (0 + floor) == 0
        d = o_norm * (_frobenius(o) / (_frobenius(o_norm) + 1e-12))
        return d, v_new, {"nu": nu}


@_register
@dataclasses.dataclass(frozen=True)
class MuownRule(MuonRule):
    """Muown (proxy): Muon with multiplicative weight-norm control. After the
    orthogonalized step each output neuron's fan-in vector is rescaled to
    its pre-step norm decayed by ``1 - scale * wd``, in place of additive
    weight decay; so the rule is not additive in w."""
    name = "muown"
    additive = False

    def apply(self, g, v, w, slots, *, scale, step):
        d, v_new, _ = self.precondition(g, v, slots, step=step)
        w32 = w.float()
        n_old = torch.sqrt(torch.sum(torch.square(w32), dim=-2, keepdim=True))
        w_tmp = w32 + (-scale) * d
        n_new = torch.sqrt(torch.sum(torch.square(w_tmp), dim=-2, keepdim=True))
        decay = 1.0 - scale * self.weight_decay
        w_out = w_tmp * (decay * n_old / (n_new + self.eps))
        return w_out.to(w.dtype), v_new, {}


@_register
@dataclasses.dataclass(frozen=True)
class NoraRule(MatrixUpdateRule):
    """Nora: the RMNP row-norm family with a temporal EMA of the row norms,
    one ``(L, 1, d_out)`` stripe per bucket tracking each output neuron's
    momentum norm over time (bias-corrected), so a transient norm spike does
    not at once rescale the direction. It runs no kernel."""
    beta2: float = 0.999

    name = "nora"

    def slot_shapes(self, rows, d_in, d_out):
        del d_in
        return {"r": ((rows, 1, d_out), torch.float32)}

    def precondition(self, g, v, slots, *, step):
        v32 = _ema32(g, v, self.beta)
        rn = torch.sqrt(torch.sum(torch.square(v32), dim=-2, keepdim=True))
        r = self.beta2 * slots["r"] + (1.0 - self.beta2) * rn
        r_hat = r / _bias_correction(self.beta2, step)
        d = v32 / (r_hat + self.eps)
        return d, v32.to(v.dtype), {"r": r}


# ---------------------------------------------------------------------------
# Per-leaf reference: the same rule math over individual leaves (each
# reshaped to (lead, d_in, d_out)). Stacking slices into a bucket changes no
# values, so reference and engine agree bit for bit on fp32 params.
# ---------------------------------------------------------------------------

class PerLeafRefState(NamedTuple):
    momentum: PyTree                     # fp32, leaf-shaped
    slots: Dict[str, PyTree]             # slot name -> leaf-shaped stripes


def per_leaf_reference(rule: MatrixUpdateRule, lr: Schedule) -> Optimizer:
    """Per-leaf reference optimizer for ``rule`` (pure matrix trees)."""
    from repro_torch.core.rmnp import rms_lr_scale

    def _as3(x):
        return x.reshape((-1,) + tuple(x.shape[-2:]))

    def init(params):
        momentum = tree_map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
            params)
        slots = {}
        for name in rule.slot_shapes(1, 2, 2):
            def build(p, name=name):
                shape, dtype = rule.slot_shapes(
                    _as3(p).shape[0], p.shape[-2], p.shape[-1])[name]
                return torch.zeros(shape, dtype=dtype, device=p.device)
            slots[name] = tree_map(build, params)
        return PerLeafRefState(momentum=momentum, slots=slots)

    def update_apply(grads, state, params, step):
        eta = lr(step)
        s_flat = {name: dict(tree_paths(state.slots[name])) for name in state.slots}
        new_s = {name: {} for name in state.slots}

        def leaf(path, g, v, p):
            scale = eta * rms_lr_scale(p.shape)
            sl = {name: s_flat[name][path] for name in s_flat}
            w_new, v_new, sl_new = rule.apply(
                _as3(g).float(), _as3(v), _as3(p), sl,
                scale=scale, step=step)
            for name in sl_new:
                new_s[name][path] = sl_new[name]
            return w_new.reshape(p.shape).to(p.dtype), v_new.reshape(v.shape)

        new_p, new_v = map_unzip(leaf, 2, grads, state.momentum, params)
        slots = {name: map_with_path(lambda path, _x, name=name: new_s[name][path],
                                     state.slots[name])
                 for name in state.slots}
        return new_p, PerLeafRefState(momentum=new_v, slots=slots)

    def update(grads, state, params, step):
        p32 = tree_map(lambda p: p.float(), params)
        new_p, new_state = update_apply(grads, state, p32, step)
        updates = tree_map(lambda a, b: a - b, new_p, p32)
        return updates, new_state

    return Optimizer(init=init, update=update, update_apply=update_apply)
