"""Gradient compression for the cross-replica reduction (mirror of
``repro.distributed.compression``).

int8 error-feedback schedule of a mean over the group (a rank's addend is
its gradient plus its error accumulator):

    a) quantize (g + error) to blockwise int8               [local]
    b) all_to_all the int8 chunks and their fp32 block scales
    c) dequantize and sum the received chunks in fp32         [local]
    d) all_gather the summed chunk in bf16

Both lossy stages feed the next step's error accumulator: the int8
residual of (a), and the bf16 rounding of (d) at this rank's own chunk (the
one rank that knows the fp32 value it rounded), so the accumulated update
is unbiased.

ZeRO-2 (``exact_reduce_scatter`` / ``compressed_reduce_scatter_leaf``)
reduces a bucket's gradient into its shard: stage (d) disappears, rank ``r``
keeps chunk ``r`` in fp32, and the whole mean-gradient bucket never exists
on any rank.

Rounding is round-half-to-even, deterministic, so a restart is bitwise. A
rank's error accumulator is its own, shaped like the params; a checkpoint
stores it as row ``rank`` of the JAX package's ``(N, *shape)`` leaf.
Every sum over ranks runs in rank order (``repro_torch.distributed.comm``).
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.types import PyTree, map_unzip, map_with_path, tree_map
from repro_torch.distributed.comm import Comm, Pending, rank_order_sum

_BLOCK = 512  # quantization block (elements), one fp32 scale per block


class CompressionState(NamedTuple):
    error: PyTree  # fp32 error-feedback accumulators of this rank, like params


def init_compression_state(params: PyTree) -> CompressionState:
    """Zero error-feedback accumulators of one rank, like ``params``."""
    return CompressionState(error=tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        params))


def reshard_error(errors, n_old: int, n_new: int):
    """Re-lay the ``(n_old, *shape)`` stacked residuals of a checkpoint for
    ``n_new`` ranks: the applied bias is ``sum_r err_r / n`` in mean-gradient
    units, so row 0 gets ``sum(err) * (n_new / n_old)`` and the other rows
    zero. Outstanding mass is kept exactly; zero residuals map to zeros bit
    for bit. ``errors`` is a tree of numpy arrays; returns one."""
    def leaf(_path, e):
        e = np.asarray(e)
        out = np.zeros((n_new,) + e.shape[1:], np.float32)
        out[0] = e.sum(axis=0) * (float(n_new) / float(n_old))
        return out

    return map_with_path(leaf, errors)


# ---------------------------------------------------------------------------
# quantizer
# ---------------------------------------------------------------------------

def quantize_blockwise(flat: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 ``(n,)`` with ``n % _BLOCK == 0`` -> (int8 ``(n,)``, fp32 scales
    ``(n / _BLOCK,)``): ``scale = max|x| / 127`` per block, ``q =
    round_half_even(x / max(scale, 1e-30))`` clipped to [-127, 127]."""
    xb = flat.reshape(-1, _BLOCK)
    amax = torch.amax(torch.abs(xb), dim=1, keepdim=True)
    # 127 as a tensor on the data's device: CUDA turns a division by a host
    # scalar into a multiplication by its reciprocal, which rounds otherwise
    scale = amax / amax.new_tensor(127.0)
    q = torch.clamp(torch.round(xb / torch.clamp(scale, min=1e-30)), -127, 127)
    return q.to(torch.int8).reshape(-1), scale[:, 0]


def dequantize_blockwise(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    xb = q.reshape(-1, _BLOCK).float() * scale[:, None]
    return xb.reshape(-1)


def quantization_residual(x: torch.Tensor, q: torch.Tensor,
                          scale: torch.Tensor) -> torch.Tensor:
    """``x - dequantize(q, scale)`` rounded once to fp32: the exact error of
    the int8 stage (``q * scale`` is exact in fp64, and so is the
    difference). XLA contracts the JAX package's ``x - q * scale`` into a
    fused multiply-add, which rounds once the same way; two rounded fp32
    operations would differ from it in the last bit."""
    rows = x.reshape(-1, _BLOCK).double()
    deq = q.reshape(-1, _BLOCK).double() * scale.reshape(-1, 1).double()
    return (rows - deq).float().reshape(x.shape)


def _quantize_rows(flat: torch.Tensor):
    """:func:`quantize_blockwise` of each row of ``(N, n)``."""
    q, s = quantize_blockwise(flat.reshape(-1))
    return q.reshape(flat.shape), s.reshape(flat.shape[0], -1)


def _dequantize_rows(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return dequantize_blockwise(q.reshape(-1), scale.reshape(-1)).reshape(q.shape)


# ---------------------------------------------------------------------------
# compressed mean over the group
# ---------------------------------------------------------------------------

def _pad_to(x: torch.Tensor, mult: int) -> torch.Tensor:
    pad = (-x.shape[0]) % mult
    return torch.cat([x, x.new_zeros(pad)]) if pad else x


def compressed_mean_leaf(g: torch.Tensor, err: torch.Tensor, comm: Comm):
    """Mean of ``g`` over the group with an int8 all-to-all and a bf16
    all-gather. Returns ``(mean like g in fp32, new_err)``."""
    n_dev = comm.world
    v = g.float() + err
    n = v.numel()
    flat = _pad_to(v.reshape(-1), n_dev * _BLOCK)
    q, scale = quantize_blockwise(flat)
    err_flat = quantization_residual(flat, q, scale)  # stage (a) residual

    # b) row j of the result is sender j's chunk for this rank
    q_recv = comm.all_to_all(q.reshape(n_dev, -1))
    s_recv = comm.all_to_all(scale.reshape(n_dev, -1))
    # c) dequantize and sum in fp32, rank order
    chunk_sum = rank_order_sum(_dequantize_rows(q_recv, s_recv))
    # d) share it in bf16; the rounding goes into this rank's accumulator at
    # its own chunk, so the next step's chunk sum carries it exactly once
    chunk_bf16 = chunk_sum.to(torch.bfloat16)
    clen = flat.numel() // n_dev
    own = slice(comm.rank * clen, (comm.rank + 1) * clen)
    err_flat[own] = err_flat[own] + (chunk_sum - chunk_bf16.float())
    new_err = err_flat[:n].reshape(g.shape)
    gathered = comm.all_gather(chunk_bf16).float()
    mean = gathered[:n].reshape(g.shape) / n_dev
    return mean, new_err


def compressed_mean(grads: PyTree, state: CompressionState, comm: Comm,
                    skip: Optional[Callable[[str], bool]] = None):
    """Tree-wide compressed mean. Leaves whose path matches ``skip`` pass
    through unreduced with their error untouched (the ZeRO-2 step reduces
    the matrix leaves bucket by bucket instead)."""
    def leaf(path, g, e):
        if skip is not None and skip(path):
            return g, e
        return compressed_mean_leaf(g, e, comm)

    mean, error = map_unzip(leaf, 2, grads, state.error)
    return mean, CompressionState(error=error)


def exact_mean(grads: PyTree, comm: Comm,
               skip: Optional[Callable[[str], bool]] = None):
    """fp32 mean of every leaf over the group (the sum in rank order)."""
    def leaf(path, g):
        if skip is not None and skip(path):
            return g
        return comm.all_reduce(g.float()) / comm.world

    return map_with_path(leaf, grads)


# ---------------------------------------------------------------------------
# ZeRO-2: reduce-scatter straight into the bucket shard. Operands are the
# (N, chunk, d_in, d_out) layout of repro_torch.core.bucketing.gather_chunks:
# chunk j is rank j's shard.
# ---------------------------------------------------------------------------

def exact_reduce_scatter(chunks: torch.Tensor, comm: Comm, async_op: bool = False):
    """fp32 mean of a chunked bucket operand, left scattered: this rank's
    chunk of the mean, ``chunks.shape[1:]``. With ``async_op`` a
    :class:`Pending` whose ``wait()`` gives it."""
    n_dev = chunks.shape[0]
    summed = comm.reduce_scatter(chunks.float(), async_op=async_op)
    if async_op:
        return Pending([], lambda: summed.wait() / n_dev)
    return summed / n_dev


def fold_error_chunks(plan, chunk_means, state: CompressionState, n_dev: int):
    """Fold the per-leaf fp32 error accumulators into chunked per-bucket
    mean-gradient operands (the accumulation path holds the matrix gradients
    only chunked). Chunking is slicing and pad-slice error is zero, so this
    is the chunking of the per-leaf ``g + err``, bit for bit."""
    from repro_torch.core.bucketing import gather_chunks

    err = gather_chunks(plan, state.error, n_dev, dtype=torch.float32)
    return {k: chunk_means[k] + err[k] for k in chunk_means}


def rollback_fold(ok: torch.Tensor, new_state: CompressionState,
                  old_state: CompressionState) -> CompressionState:
    """Undo the error-feedback fold of a rejected step: ``torch.where(ok,
    new, old)`` per leaf, the new bits on a healthy step and the pre-step
    bits on a skipped one."""
    return CompressionState(error=tree_map(
        lambda n, o: torch.where(ok, n, o), new_state.error, old_state.error))


def compressed_reduce_scatter_leaf(v_chunks: torch.Tensor, comm: Comm,
                                   wire_fault=None, async_op: bool = False):
    """int8 error-feedback reduce-scatter of one chunked bucket operand.

    ``v_chunks``: ``(N, chunk, d_in, d_out)`` fp32, this rank's addend with
    its error accumulator already folded in. Stages (a)-(c): quantize each
    chunk, all-to-all the int8 chunks and the fp32 block scales, dequantize
    and sum in fp32; the result stays sharded, so there is no bf16 stage.

    ``wire_fault`` (``repro_torch.train.faults.wire_fault_for``) is an
    optional ``(q, scale) -> (q, scale)`` hook on the outgoing wire data,
    applied after the sender's residual: its error feedback stays honest
    and only the receivers see the corruption.

    Returns ``(mean_shard fp32 (chunk, d_in, d_out), resid like v_chunks)``,
    ``resid`` being the quantization residual that goes back into this
    rank's error state; with ``async_op`` the first is a :class:`Pending`."""
    n_dev = comm.world
    if v_chunks.shape[0] != n_dev:
        raise ValueError(
            f"chunked operand has leading dim {v_chunks.shape[0]}, expected "
            f"the group size {n_dev} — gather_chunks(n_chunks=world)?")
    cshape = tuple(v_chunks.shape[1:])
    n = 1
    for s in cshape:
        n *= s
    flat = v_chunks.float().reshape(n_dev, -1)
    pad = (-n) % _BLOCK
    if pad:
        flat = torch.cat([flat, flat.new_zeros(n_dev, pad)], dim=1)
    q, scale = _quantize_rows(flat)
    resid = quantization_residual(flat, q, scale)[:, :n].reshape(v_chunks.shape)

    if wire_fault is not None:
        q, scale = wire_fault(q, scale)
    q_recv = comm.all_to_all(q, async_op=async_op)
    s_recv = comm.all_to_all(scale, async_op=async_op)

    def finish(qr, sr):
        chunk_sum = rank_order_sum(_dequantize_rows(qr, sr))
        return chunk_sum[:n].reshape(cshape) / n_dev

    if async_op:
        return Pending([], lambda: finish(q_recv.wait(), s_recv.wait())), resid
    return finish(q_recv, s_recv), resid


def checkpoint_view(state: CompressionState, comm: Comm) -> CompressionState:
    """This rank's residual as row ``rank`` of the ``(N, *shape)`` leaves a
    checkpoint holds (``repro_torch.checkpoint.manager.Piece``); the same
    tree serves as the restore template."""
    from repro_torch.checkpoint.manager import Piece
    return CompressionState(error=tree_map(
        lambda e: Piece.row(e, comm.rank, comm.world), state.error))
