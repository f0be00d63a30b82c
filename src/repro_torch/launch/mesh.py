"""The world the dry run plans for (counterpart of ``repro.launch.mesh``).

The JAX package's production mesh is ``(16, 16)`` over ``("data",
"model")``, or ``(2, 16, 16)`` over ``("pod", "data", "model")`` with
``multi_pod``: parameters and activations are split over ``model`` and the
batch over the data axes. The port has no ``model`` axis: it shards only
the optimizer state and the gradients, over a data-parallel ZeRO-2 group
(``distributed/sharding.py``, ``train/dp_step.py``). So the port's world
is the JAX mesh's data axes alone, 16 ranks or 32 (pod x data), and every
rank holds whole parameters and the whole activations of its share of the
batch. A record says so with ``"model_parallel": 1``, the JAX mesh's shape
beside it.

The link rate of the collective term is ``launch/roofline.LINK_BW``
(NVLink, inside one node of ``NODE_CARDS`` cards); a world larger than one
node crosses a network the repo rates nowhere, so its collective term is a
lower bound (``World.collective_lower_bound``).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

from repro_torch.launch.roofline import NODE_CARDS


class World(NamedTuple):
    """A data-parallel group of ``size`` ranks, and the JAX mesh it stands
    for (``jax_mesh`` over ``jax_axes``)."""
    size: int
    jax_mesh: Tuple[int, ...]
    jax_axes: Tuple[str, ...]
    model_parallel: int = 1

    @property
    def collective_lower_bound(self) -> bool:
        """Whether the group crosses NVLink nodes, so that ``LINK_BW``
        bounds its collective time from below only."""
        return self.size > NODE_CARDS

    def describe(self) -> dict:
        return {"world": self.size, "model_parallel": self.model_parallel,
                "jax_mesh": list(self.jax_mesh), "jax_axes": list(self.jax_axes),
                "collective_lower_bound": self.collective_lower_bound}


def make_production_world(*, multi_pod: bool = False) -> World:
    """The JAX production mesh's data axes as a ZeRO-2 group: 16 ranks, or
    32 (pod x data) with ``multi_pod``."""
    if multi_pod:
        return World(2 * 16, (2, 16, 16), ("pod", "data", "model"))
    return World(16, (16, 16), ("data", "model"))


def make_local_world() -> World:
    """One rank (tests, one card)."""
    return World(1, (1, 1), ("data", "model"))
