"""RMNP — Row-Momentum Normalized Preconditioning (mirror of ``repro.core.rmnp``).

Algorithm 2:
    V_t = beta * V_{t-1} + (1 - beta) * G_t
    D_t = RN(V_t) = (diag(V_t V_t^T))^{-1/2} V_t      (row-wise l2 normalize)
    W_{t+1} = W_t - eta * (D_t + wd * W_t)

Storage convention: every matmul parameter is stored ``(..., d_in, d_out)``
and used as ``x @ W``, exactly as in the JAX package. The paper's "row" (one
output neuron's fan-in) is a *column* of the stored matrix, so the
normalization runs over dim -2. A ``torch.nn.Linear`` stores ``(d_out,
d_in)``; loading such a weight without transposing would silently move the
reduction to the other axis, so the port never uses ``nn.Linear`` weights.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.types import Optimizer, PyTree, Schedule, map_unzip, tree_map
from repro_torch.kernels import ops as kops


def row_normalize(v: torch.Tensor, eps: float = 1e-8, in_axis: int = -2) -> torch.Tensor:
    """(diag(V V^T))^{-1/2} V: l2-normalize each output neuron's fan-in."""
    norm = torch.sqrt(torch.sum(torch.square(v.float()), dim=in_axis, keepdim=True))
    return (v / (norm + eps)).to(v.dtype)


def rms_lr_scale(shape) -> float:
    """Muon/RMNP RMS scaling: lr * max(1, sqrt(d_out / d_in)) (Eq. 17/18)."""
    d_in, d_out = shape[-2], shape[-1]
    return max(1.0, (d_out / d_in) ** 0.5)


class RmnpState(NamedTuple):
    momentum: PyTree


def rmnp(lr: Schedule, beta: float = 0.95, weight_decay: float = 0.1,
         eps: float = 1e-8, fused: bool = False,
         momentum_dtype: str = "float32", fused_apply: bool = False,
         shard_axis=None, shard_size: int = 1) -> Optimizer:
    """RMNP for pure-matrix trees. ``fused=True`` shape-buckets the leaves
    (core/bucketing.py); ``fused_apply=True`` (implies ``fused``) exposes
    ``Optimizer.update_apply``, the single-pass update. ``shard_axis`` (a
    ``repro_torch.distributed.comm.Comm``, implies ``fused_apply``) unlocks
    the ZeRO-1/2 entry points; ``shard_size`` pads every bucket's ``L`` to a
    multiple so uneven buckets shard. Every leaf or bucket goes through
    ``kernels/ops.py``: the kernels on CUDA tensors, their plain versions on
    CPU tensors."""
    from repro_torch.core.engine import check_shard_args
    check_shard_args(shard_axis, shard_size)
    if fused_apply or fused or shard_axis is not None:
        from repro_torch.core.engine import matrix_optimizer
        from repro_torch.core.rules import RmnpRule
        return matrix_optimizer(
            RmnpRule(beta=beta, weight_decay=weight_decay, eps=eps), lr,
            momentum_dtype=momentum_dtype, fused_apply=fused_apply,
            shard_axis=shard_axis, shard_size=shard_size)

    def init(params):
        return RmnpState(momentum=tree_map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
            params))

    def update(grads, state, params, step):
        eta = lr(step)

        def upd(_path, g, v, p):
            v_new, d = kops.rmnp_momentum_rownorm(g.float(), v, beta=beta, eps=eps)
            scale = eta * rms_lr_scale(p.shape)
            return -scale * (d + weight_decay * p.float()), v_new

        updates, momentum = map_unzip(upd, 2, grads, state.momentum, params)
        return updates, RmnpState(momentum=momentum)

    return Optimizer(init=init, update=update)
