"""Muon baseline (mirror of ``repro.core.muon``, Algorithm 1): Newton-Schulz
orthogonalization of the momentum.

Reference coefficients from Jordan et al.; 5 iterations by default. One
iteration costs O(mn * min(m, n)), the quantity RMNP removes. Every
iteration goes through ``kernels/ops.ns_step``: the GEMM kernel on CUDA
tensors (three launches per iteration, one sequence per stacked bucket),
its plain version on CPU tensors.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.rmnp import rms_lr_scale
from repro_torch.core.types import Optimizer, PyTree, Schedule, map_unzip, tree_map
from repro_torch.kernels import ops as kops

_NS_COEFFS = (3.4445, -4.7750, 2.0315)


def newton_schulz(v: torch.Tensor, steps: int = 5, eps: float = 1e-7,
                  use_kernel: bool = False) -> torch.Tensor:
    """Approximate (V V^T)^{-1/2} V by the quintic Newton-Schulz iteration.

    Works on the last two dims; leading dims are batched. Always iterates on
    the smaller Gram side (transposes if rows > cols). ``use_kernel`` is
    accepted for the JAX package's signature and selects nothing."""
    del use_kernel
    a, b, c = _NS_COEFFS
    orig_dtype = v.dtype
    x = v.float()
    transpose = x.shape[-2] > x.shape[-1]
    if transpose:
        x = x.transpose(-1, -2)
    # contiguous, so that the kernels' loads of X run along its rows
    x = (x / (torch.linalg.vector_norm(x, dim=(-2, -1), keepdim=True) + eps)).contiguous()
    for _ in range(steps):
        x = kops.ns_step(x, a, b, c)
    if transpose:
        x = x.transpose(-1, -2)
    return x.to(orig_dtype)


class MuonState(NamedTuple):
    momentum: PyTree


def muon(lr: Schedule, beta: float = 0.95, weight_decay: float = 0.1,
         ns_steps: int = 5, use_kernel: bool = False, fused: bool = False,
         momentum_dtype: str = "float32", fused_apply: bool = False) -> Optimizer:
    """Muon for pure-matrix trees. The flag cascade mirrors ``rmnp()``:
    ``fused=True`` shape-buckets the leaves so Newton-Schulz batches over each
    bucket's stacked ``L`` axis; ``fused_apply`` (implies ``fused``) exposes
    ``Optimizer.update_apply``. The ZeRO arguments of the JAX signature come
    with the data-parallel slice. ``use_kernel`` selects nothing."""
    del use_kernel
    if fused_apply:
        fused = True
    if fused:
        from repro_torch.core.engine import matrix_optimizer
        from repro_torch.core.rules import MuonRule
        return matrix_optimizer(
            MuonRule(beta=beta, weight_decay=weight_decay, ns_steps=ns_steps), lr,
            momentum_dtype=momentum_dtype, fused_apply=fused_apply)

    def init(params):
        return MuonState(momentum=tree_map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
            params))

    def update(grads, state, params, step):
        eta = lr(step)

        def upd(_path, g, v, p):
            v_new = beta * v + (1.0 - beta) * g.float()
            d = newton_schulz(v_new, steps=ns_steps)
            scale = eta * rms_lr_scale(p.shape)
            return -scale * (d + weight_decay * p.float()), v_new

        updates, momentum = map_unzip(upd, 2, grads, state.momentum, params)
        return updates, MuonState(momentum=momentum)

    return Optimizer(init=init, update=update)
