"""AdamW for non-matrix parameters (and as a paper baseline): the port's
counterpart of ``repro.core.adamw``, with the same state and arithmetic."""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.types import Optimizer, PyTree, Schedule, map_unzip, tree_map


class AdamWState(NamedTuple):
    mu: PyTree
    nu: PyTree


def adamw(lr: Schedule, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.1) -> Optimizer:
    def init(params):
        def z(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return AdamWState(mu=tree_map(z, params), nu=tree_map(z, params))

    def update(grads, state, params, step):
        eta = lr(step)
        t = torch.as_tensor(step, dtype=torch.float32) + 1.0
        bc1 = 1.0 - b1 ** t
        bc2 = 1.0 - b2 ** t

        def upd(_path, g, mu, nu, p):
            g = g.float()
            mu_new = b1 * mu + (1 - b1) * g
            nu_new = b2 * nu + (1 - b2) * torch.square(g)
            d = (mu_new / bc1) / (torch.sqrt(nu_new / bc2) + eps)
            return -eta * (d + weight_decay * p.float()), mu_new, nu_new

        updates, mu, nu = map_unzip(upd, 3, grads, state.mu, state.nu, params)
        return updates, AdamWState(mu=mu, nu=nu)

    return Optimizer(init=init, update=update)
