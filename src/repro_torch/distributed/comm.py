"""The process groups of the port: where ``repro.launch.mesh`` and the
``jax.lax`` collectives over the ``data`` and ``model`` axes stand in the
JAX package.

One process per rank. :class:`Comm` holds the group, ``rank`` and ``world``
and the four collectives the ZeRO step needs, on tensors:

    reduce_scatter(x)  (N, *c) -> (*c)      sum over ranks of row ``rank``
    all_gather(x)      (l, *s) -> (N*l, *s) rank order
    all_to_all(x)      (N, *c) -> (N, *c)   row j of the result is rank j's
                                            row ``rank``
    all_reduce(x)      any shape            sum over ranks

**Sums in rank order.** NCCL's and gloo's own reductions add an element's
addends in an order set by the element's place in the ring, so the same
gradient reduced as a leaf (``all_reduce``) and as a chunk of a bucket
(``reduce_scatter``) rounds differently. Here ``reduce_scatter`` is an
``all_to_all_single`` followed by a local sum in rank order, and
``all_reduce`` is that reduce-scatter over a flat, padded view followed by
``all_gather_into_tensor``: every element is ``((x_0 + x_1) + x_2) + ...``
wherever it lies and whichever collective carried it, which is what lets a
ZeRO-2 step equal the replicated one bit for bit. The bytes on the wire are
a ring's: ``(N - 1) / N`` of the operand a rank for the reduce-scatter,
twice that for the all-reduce.

Beside them, for the model axis (``distributed/tensor_parallel.py``):
``all_gather_dim`` and ``reduce_scatter_dim`` along any dimension (the same
collectives, in rank order), and ``all_reduce_max`` (an all-gather and a
max, which any order gives exactly).

No branch skips a collective at ``world == 1``: a one-rank group still
moves every operand through the backend.

A ``data x model`` world (``launch/mesh.World``) is one process a rank,
model minor: :func:`world_groups` makes its model groups (the mesh's rows)
and data groups (its columns) with ``dist.new_group``, every rank making
every group in the same order, and returns this rank's pair as a
:class:`WorldComm`. :func:`file_world` does so for ``torch.multiprocessing``
workers on a ``FileStore``, :func:`init_world` for a card.

:func:`init_comm` makes the group: from ``RANK``/``WORLD_SIZE``/
``LOCAL_RANK`` and ``MASTER_ADDR``/``MASTER_PORT`` when ``torchrun`` set
them, else a group of one on a ``FileStore`` in a temporary directory (no
network). The backend is NCCL for ``cuda`` and gloo for ``cpu``.
"""
from __future__ import annotations

import os
import tempfile
from typing import Callable, NamedTuple, Optional

import torch
import torch.distributed as dist


class Pending:
    """An issued collective: :meth:`wait` blocks until it has landed and
    returns its result (``finish`` runs once, after the wait)."""

    def __init__(self, works, finish: Callable[[], torch.Tensor]):
        self._works = [w for w in works if w is not None]
        self._finish = finish
        self._out: Optional[torch.Tensor] = None

    def wait(self) -> torch.Tensor:
        if self._finish is not None:
            for w in self._works:
                w.wait()
            self._out, self._finish = self._finish(), None
        return self._out


def rank_order_sum(rows: torch.Tensor) -> torch.Tensor:
    """``((rows[0] + rows[1]) + rows[2]) + ...`` along dim 0, in fp32 where
    the rows are fp32: the one order every reduction of the port uses."""
    acc = rows[0].clone()
    for j in range(1, rows.shape[0]):
        acc += rows[j]
    return acc


class Comm:
    """A process group of ``world`` ranks seen from ``rank``."""

    def __init__(self, group, rank: int, world: int, device: torch.device):
        self.group = group
        self.rank = rank
        self.world = world
        self.device = torch.device(device)

    def __repr__(self) -> str:
        return f"Comm(rank={self.rank}, world={self.world}, device={self.device})"

    # -- the four collectives ------------------------------------------
    def all_to_all(self, x: torch.Tensor, async_op: bool = False):
        """``(N, *c)`` -> ``(N, *c)``: row j of the result is rank j's row
        ``rank``."""
        self._rows(x)
        x = x.contiguous()
        out = torch.empty_like(x)
        work = dist.all_to_all_single(out, x, group=self.group, async_op=async_op)
        return Pending([work], lambda: out) if async_op else out

    def reduce_scatter(self, x: torch.Tensor, async_op: bool = False):
        """Sum over ranks of row ``rank`` of ``(N, *c)``, in rank order."""
        if async_op:
            recv = self.all_to_all(x, async_op=True)
            return Pending([], lambda: rank_order_sum(recv.wait()))
        return rank_order_sum(self.all_to_all(x))

    def all_gather(self, x: torch.Tensor, async_op: bool = False):
        """``(l, *s)`` from every rank -> ``(N*l, *s)`` in rank order."""
        x = x.contiguous()
        out = torch.empty((self.world * x.shape[0],) + tuple(x.shape[1:]),
                          dtype=x.dtype, device=x.device)
        work = dist.all_gather_into_tensor(out, x, group=self.group,
                                           async_op=async_op)
        return Pending([work], lambda: out) if async_op else out

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """Sum over ranks of ``x``, every element in rank order: a
        reduce-scatter of the flat, zero-padded tensor, then an all-gather."""
        n = x.numel()
        flat = x.reshape(-1)
        pad = (-n) % self.world
        if pad:
            flat = torch.cat([flat, flat.new_zeros(pad)])
        part = self.reduce_scatter(flat.reshape(self.world, -1))
        return self.all_gather(part)[:n].reshape(x.shape)

    # -- along a dimension, for the model axis ---------------------------
    def all_gather_dim(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's ``x`` concatenated along ``dim`` in rank order."""
        dim %= x.ndim
        return self.all_gather(x.movedim(dim, 0)).movedim(0, dim)

    def reduce_scatter_dim(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The sum over ranks, in rank order, of this rank's ``1 / N`` span
        of ``x`` along ``dim``."""
        dim %= x.ndim
        rows = x.movedim(dim, 0)
        n = rows.shape[0]
        if n % self.world:
            raise ValueError(f"dimension {dim} of {tuple(x.shape)} does not split "
                             f"over {self.world} ranks")
        rows = rows.reshape((self.world, n // self.world) + tuple(rows.shape[1:]))
        return self.reduce_scatter(rows).movedim(0, dim)

    def all_reduce_max(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise maximum over ranks of ``x`` (exact in any order)."""
        every = self.all_gather(x.reshape(1, -1))
        return torch.amax(every, dim=0).reshape(x.shape)

    def barrier(self) -> None:
        dist.barrier(group=self.group)

    def _rows(self, x: torch.Tensor) -> None:
        if x.ndim < 1 or x.shape[0] != self.world:
            raise ValueError(f"expected a leading axis of the group size "
                             f"{self.world}, got shape {tuple(x.shape)}")


def init_comm(device: str = "cuda") -> Comm:
    """Join (or create) the default process group for ``device``.

    Under ``torchrun`` the rank, world size and rendezvous come from its
    environment and ``cuda`` ranks take card ``LOCAL_RANK``; otherwise the
    group has one rank, on a ``FileStore`` in a new temporary directory. An
    existing default group is reused."""
    dev = torch.device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        if "WORLD_SIZE" in os.environ and "MASTER_ADDR" in os.environ:
            dist.init_process_group(backend, device_id=dev if dev.type == "cuda" else None)
        else:
            store_dir = tempfile.mkdtemp(prefix="repro_torch_pg_")
            store = dist.FileStore(os.path.join(store_dir, "store"), 1)
            dist.init_process_group(backend, store=store, rank=0, world_size=1)
    return Comm(dist.group.WORLD, dist.get_rank(), dist.get_world_size(), dev)


class WorldComm(NamedTuple):
    """One rank of a ``data x model`` world: ``mesh`` its
    ``launch/mesh.World``, ``rank`` its global rank, ``data`` and
    ``model`` its groups."""
    mesh: object
    rank: int
    data: Comm
    model: Comm


def world_groups(mesh, rank: int, device) -> WorldComm:
    """Rank ``rank``'s data and model groups of the world ``mesh`` (every
    rank calls this, after the default group is up): model groups are the
    rows ``[d M, (d + 1) M)``, data groups the columns ``{d M + m}``."""
    M, D = mesh.model_parallel, mesh.data_parallel
    if dist.get_world_size() != mesh.size:
        raise ValueError(f"the process group has {dist.get_world_size()} ranks, "
                         f"the world {mesh.size}")
    data_rank, model_rank = mesh.ranks(rank)
    model = data = None
    for d in range(D):
        g = dist.new_group([d * M + m for m in range(M)])
        if d == data_rank:
            model = g
    for m in range(M):
        g = dist.new_group([d * M + m for d in range(D)])
        if m == model_rank:
            data = g
    dev = torch.device(device)
    return WorldComm(mesh, rank, Comm(data, data_rank, D, dev), Comm(model, model_rank, M, dev))


def init_world(mesh, device: str = "cuda") -> WorldComm:
    """:func:`init_comm`, then this rank's groups of ``mesh``."""
    comm = init_comm(device)
    return world_groups(mesh, comm.rank, comm.device)


def file_world(path: str, rank: int, mesh, device: str = "cpu") -> WorldComm:
    """:func:`file_comm` over every rank of ``mesh``, then this rank's data
    and model groups."""
    comm = file_comm(path, rank, mesh.size, device)
    return world_groups(mesh, rank, comm.device)


def file_comm(path: str, rank: int, world: int, device: str = "cpu") -> Comm:
    """A group of ``world`` ranks that meet on the ``FileStore`` at ``path``
    (the form ``torch.multiprocessing`` workers use); a collective waits at
    most two minutes for a rank that has died, so a failed worker does not
    hang the others."""
    import datetime
    dev = torch.device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    store = dist.FileStore(path, world)
    dist.init_process_group(backend, store=store, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    return Comm(dist.group.WORLD, rank, world, dev)
