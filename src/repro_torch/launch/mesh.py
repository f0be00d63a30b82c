"""The worlds of the port (counterpart of ``repro.launch.mesh``).

The JAX package's production mesh is ``(16, 16)`` over ``("data",
"model")``, or ``(2, 16, 16)`` over ``("pod", "data", "model")`` with
``multi_pod``: parameters, activations and caches are split over ``model``
by the logical-axis rules (``distributed/sharding.py``) and the batch over
the data axes. A :class:`World` of the port is the same mesh of ranks, one
process a rank, laid out as ``jax.make_mesh`` lays devices out: the model
axis minor, so rank ``d * model + m`` is data rank ``d`` and model rank
``m``. Its model group (a mesh row) splits what the rules map to ``model``
(``distributed/tensor_parallel.py``); its data group (a mesh column; pod
and data together) takes the batch by rows and shards the optimizer state
and gradients ZeRO-2 (``train/dp_step.py``). ``rules`` carries the
overrides of the JAX package's ``axis_rules(mesh, rules)``.

The port shards only the ``model`` entries of a spec: ``d_in`` over
``data`` (the JAX package's FSDP-like weight shard) is not taken
(ROADMAP.md, item 14), and a record says so (``weight_shard``). An
architecture the model axis does not cover yet keeps the data axes alone
(``make_production_world(model_axis=False)``: 16 or 32 ranks, every rank
holding whole parameters), as ``"model_parallel": 1`` in its record.

The link rate of the collective term is ``launch/roofline.LINK_BW``
(NVLink, inside one node of ``NODE_CARDS`` cards); a world larger than one
node crosses a network the repo rates nowhere, so its collective term is a
lower bound (``World.collective_lower_bound``).
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

from repro_torch.launch.roofline import NODE_CARDS


class World(NamedTuple):
    """``size`` ranks standing for the JAX mesh ``jax_mesh`` over
    ``jax_axes``, ``model_parallel`` of them a model group; ``rules`` the
    overrides of the logical-axis rules."""
    size: int
    jax_mesh: Tuple[int, ...]
    jax_axes: Tuple[str, ...]
    model_parallel: int = 1
    rules: Optional[Dict[str, Any]] = None

    @property
    def data_parallel(self) -> int:
        return self.size // self.model_parallel

    @property
    def axes(self) -> Dict[str, int]:
        """The port's mesh axes and their sizes (the JAX mesh's, with
        ``model`` at the port's model group)."""
        out = dict(zip(self.jax_axes, self.jax_mesh, strict=True))
        out["model"] = self.model_parallel
        return out

    @property
    def full_rules(self) -> Dict[str, Any]:
        from repro_torch.distributed.sharding import merged_rules
        return merged_rules(self.rules)

    def ranks(self, rank: int) -> Tuple[int, int]:
        """(data rank, model rank) of global rank ``rank``."""
        return divmod(rank, self.model_parallel)

    @property
    def collective_lower_bound(self) -> bool:
        """Whether the world crosses NVLink nodes, so that ``LINK_BW``
        bounds its collective time from below only."""
        return self.size > NODE_CARDS

    def describe(self) -> dict:
        return {"world": self.size, "data_parallel": self.data_parallel,
                "model_parallel": self.model_parallel,
                "jax_mesh": list(self.jax_mesh), "jax_axes": list(self.jax_axes),
                "rules": dict(self.rules or {}),
                "weight_shard": "d_in over data not taken (ROADMAP.md, item 14)",
                "collective_lower_bound": self.collective_lower_bound}


def make_production_world(*, multi_pod: bool = False, model_axis: bool = True,
                          rules: Optional[Dict[str, Any]] = None) -> World:
    """The JAX production mesh: ``16 x 16`` (data x model, 256 ranks), or
    ``2 x 16 x 16`` with ``multi_pod``. ``model_axis=False`` gives its data
    axes alone, 16 or 32 ranks of whole parameters."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if not model_axis:
        return World(shape[0] * shape[1] if multi_pod else 16, shape, axes, 1, rules)
    return World(shape[0] * shape[1] * (shape[2] if multi_pod else 1), shape, axes,
                 16, rules)


def make_local_world(data: int = 1, model: int = 1,
                     rules: Optional[Dict[str, Any]] = None) -> World:
    """``data x model`` ranks (tests; one card is ``(1, 1)``): the
    counterpart of ``make_local_mesh``."""
    return World(data * model, (data, model), ("data", "model"), model, rules)
