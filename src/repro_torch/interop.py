"""Load the JAX package's parameters and optimizer state into the port.

``torch.Generator`` cannot reproduce ``jax.random``, so every comparison of
the port with the JAX package starts from state exported there as nested
dicts of numpy arrays (``np.asarray`` on each leaf; a NamedTuple state as
its ``_asdict()``). Paths stay identical and the layout stays ``(d_in,
d_out)``: nothing is transposed, and an MoE expert stack keeps its
``(n_units, E, d_in, d_out)`` layout, so RMNP reduces over ``d_in``. A
bf16 array arrives as ``ml_dtypes.bfloat16``, which ``torch.from_numpy``
rejects, so its bits go through a ``uint16`` view and
``Tensor.view(torch.bfloat16)``, never through float32.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.core.mixed import FusedMixedState, MixedState
from repro_torch.core.types import tree_map


def to_tensor(a, device="cpu") -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        return bits.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def tree_from_numpy(tree, device="cpu"):
    """Nested dict of numpy arrays -> the same nested dict of tensors."""
    return tree_map(lambda a: to_tensor(a, device), tree)


def mixed_state_from_numpy(state: Dict[str, Any], device="cpu"):
    """The JAX ``FusedMixedState`` (keys momentum, nu, buckets, slots) or
    ``MixedState`` (keys momentum, nu), as a dict of numpy trees, -> the
    port's state of the same kind."""
    momentum = tree_from_numpy(state["momentum"], device)
    nu = tree_from_numpy(state["nu"], device)
    if "buckets" in state:
        return FusedMixedState(
            momentum=momentum, nu=nu,
            buckets=tree_from_numpy(state["buckets"], device),
            slots=tree_from_numpy(state.get("slots", {}), device))
    return MixedState(momentum=momentum, nu=nu)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as a float32 numpy array (for comparisons)."""
    return t.detach().float().cpu().numpy()
