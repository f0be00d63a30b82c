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

On the model axis, :func:`shard_params` cuts a whole parameter tree (the
JAX package's as numpy, or the port's own) into one model rank's shards by
the logical-axis rules, and :func:`gather_params` rebuilds the whole tree
from every rank's shards.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.core.mixed import FusedMixedState, MixedState
from repro_torch.core.types import map_with_path, tree_map


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


def shard_params(tree, cfg, world, rank: int, device="cpu"):
    """Model rank ``rank``'s shards of the whole parameter tree ``tree``
    (numpy arrays or tensors) of ``cfg`` on ``world`` (a
    ``launch/mesh.World``): each leaf cut along the dimension the rules map
    to ``model`` (``distributed/sharding.shard_leaf``), the rest copied.

    A fused ``[gate; up]`` pair split over ``mlp`` (the dense FFN's
    ``w_in``, ``(d, 2 f)`` with f = d_ff, and the shared experts'
    ``w_in_shared``, f = their width; ``tensor_parallel.is_fused_pair``) is
    permuted: where the group of M divides f, rank r holds columns ``[r f /
    M, (r + 1) f / M)`` and ``[f + r f / M, f + (r + 1) f / M)`` of JAX's
    layout, ``[gate_r; up_r]``, where a plain cut would give it ``[2 r f /
    M, 2 (r + 1) f / M)`` (rank 0 only gate columns). The routed experts'
    stacks ``w_in`` and ``w_out`` are cut along ``expert``: rank r holds
    experts ``[r E / M, (r + 1) E / M)`` of both. MLA's per-head columns
    (``wq`` or ``wq_b``, ``wkv_b``) and ``wo``'s rows are cut over
    ``heads``; ``wq_a``, ``q_a_norm``, ``wkv_a``, ``kv_a_norm`` and the
    router stay whole."""
    from repro_torch.distributed import sharding
    from repro_torch.distributed.tensor_parallel import leaf_table
    table = leaf_table(cfg, world)

    def visit(path, leaf):
        t = leaf if isinstance(leaf, torch.Tensor) else to_tensor(leaf, device)
        sh = table[path]
        if tuple(t.shape) != sh.whole:
            raise ValueError(f"{path}: shape {tuple(t.shape)}, the config's {sh.whole}")
        return sharding.shard_leaf(t, sh.names, world, rank, sh.fused_halves)

    return map_with_path(visit, tree)


def gather_params(shards, cfg, world):
    """Inverse of :func:`shard_params`: the whole tree from ``shards``, one
    tree a model rank in rank order."""
    from repro_torch.distributed import sharding
    from repro_torch.distributed.tensor_parallel import leaf_table
    table = leaf_table(cfg, world)

    def visit(path, *leaves):
        sh = table[path]
        return sharding.gather_leaf(leaves, sh.names, world, sh.whole, sh.fused_halves)

    return map_with_path(visit, *shards)
