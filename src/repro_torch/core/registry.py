"""Constructor registry (mirror of ``repro.core.registry``).

``make_optimizer(name, config)``: the name is any registered matrix update
rule (rmnp, muon, normuon, muown, nora) or ``adamw``; the config is a dict of
``mixed_optimizer`` keyword arguments plus ``lr_matrix`` and ``lr_adamw``
(floats become constant schedules).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

from repro_torch.core.mixed import mixed_optimizer
from repro_torch.core.rules import rule_names
from repro_torch.core.schedule import constant
from repro_torch.core.types import Optimizer


def optimizer_names() -> Tuple[str, ...]:
    """Every name ``make_optimizer`` accepts."""
    return rule_names() + ("adamw",)


def _as_schedule(lr):
    return lr if callable(lr) else constant(float(lr))


def make_optimizer(name: str, config: Optional[Dict[str, Any]] = None,
                   **overrides) -> Optimizer:
    """Build a mixed optimizer by registry name. ``config`` (updated by
    ``overrides``) holds ``lr_matrix`` (required), ``lr_adamw`` (defaults to
    ``lr_matrix``) and further ``mixed_optimizer`` keyword arguments."""
    if name not in optimizer_names():
        raise ValueError(
            f"unknown optimizer {name!r}; registered: "
            f"{', '.join(optimizer_names())}")
    cfg = dict(config or {})
    cfg.update(overrides)
    if "lr_matrix" not in cfg:
        raise ValueError("make_optimizer config needs 'lr_matrix' "
                         "(float or schedule)")
    lr_matrix = _as_schedule(cfg.pop("lr_matrix"))
    lr_adamw = _as_schedule(cfg.pop("lr_adamw", lr_matrix))
    return mixed_optimizer(name, lr_matrix, lr_adamw, **cfg)
