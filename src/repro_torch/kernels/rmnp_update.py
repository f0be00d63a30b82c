"""Fused RMNP update kernel for Hopper, in Triton: precondition and apply.

Replaces the TPU kernels ``repro/kernels/rmnp_update.py::_kernel3d``
(precondition: ``v_new``, ``d``) and ``::_kernel3d_apply`` (single-pass
apply: ``v_new``, ``w_new``). Per stacked bucket ``(L, d_in, d_out)``:

    v_new = beta * v + (1 - beta) * g
    d     = v_new / (||v_new||_col + eps)        (norm over d_in, per column)
    w_new = w + (-scale) * (d + wd * w)          (APPLY only)

Why Triton and not CUDA C++: the work is a fused elementwise pass plus a
column reduction. It is memory-bound, needs no tensor core, and Triton's
masked block loads express it directly.

What bounds it on the card: bytes. It does a handful of fp32 operations per
element and needs no tensor core, so its least time is the bytes it must
move over the memory rate: at gpt2-small full width, with fp32 gradient and
momentum and bf16 weights, about 16 B per matrix parameter (g read, v read
and written, w read and written), 2.4 GB a step, about 0.7 ms at 3.35 TB/s.

What the design does about it. One program owns ``(l, BLOCK_N columns)``;
loads are coalesced along ``d_out``. The TPU kernel holds a whole
``(d_in, block_n)`` stripe in VMEM; an SM cannot, so the program loops over
``d_in`` in ``BLOCK_M``-row tiles: one sweep accumulates the fp32 sum of
squares, a second recomputes ``v_new`` from ``g`` and ``v`` and writes. That
loop is what lets the ``50432 x 768`` embedding bucket run on the kernel (the
JAX package sends fan-in above 32768 to its jnp reference; the port has no
such fallback). The second sweep reads every element before it writes it, so
``v_out`` may alias ``v``. Ragged edges are masked, never padded. ``scale``
and ``wd`` arrive as a device tensor, so the step reads no scalar back to
the host. Every element's math is fp32, as in the TPU kernel.

Launches per program grid: ``L * ceil(d_out / BLOCK_N)`` programs; the
``L = 1`` embedding bucket has few programs in flight (recorded in PERF.md,
not tuned here).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.ref import rmnp_momentum_rownorm_ref, rmnp_rownorm_apply_ref

BLOCK_M = 64
BLOCK_N = 64
NUM_WARPS = 4

_KERNEL = None
tl = None  # triton.language, bound when the kernel is first built


def _rmnp_kernel(g_ptr, v_ptr, w_ptr, v_out_ptr, out_ptr, scal_ptr,
                 d_in, d_out, beta, one_minus_beta, eps,
                 APPLY: tl.constexpr, BLOCK_M: tl.constexpr,
                 BLOCK_N: tl.constexpr):
    pid_l = tl.program_id(0)
    pid_n = tl.program_id(1)
    cols = pid_n * BLOCK_N + tl.arange(0, BLOCK_N)
    col_ok = cols < d_out
    base = pid_l.to(tl.int64) * d_in * d_out

    # sweep 1: fp32 sum of squares of v_new down each column
    sumsq = tl.zeros([BLOCK_N], dtype=tl.float32)
    for m0 in range(0, d_in, BLOCK_M):
        rows = m0 + tl.arange(0, BLOCK_M)
        mask = (rows[:, None] < d_in) & col_ok[None, :]
        offs = base + rows[:, None] * d_out + cols[None, :]
        g = tl.load(g_ptr + offs, mask=mask, other=0.0).to(tl.float32)
        v = tl.load(v_ptr + offs, mask=mask, other=0.0).to(tl.float32)
        v_new = beta * v + one_minus_beta * g
        sumsq += tl.sum(v_new * v_new, axis=0)
    denom = tl.sqrt_rn(sumsq) + eps

    if APPLY:
        scale = tl.load(scal_ptr)
        wd = tl.load(scal_ptr + 1)
    # sweep 2: recompute v_new (never re-read a rounded v_out), write
    for m0 in range(0, d_in, BLOCK_M):
        rows = m0 + tl.arange(0, BLOCK_M)
        mask = (rows[:, None] < d_in) & col_ok[None, :]
        offs = base + rows[:, None] * d_out + cols[None, :]
        g = tl.load(g_ptr + offs, mask=mask, other=0.0).to(tl.float32)
        v = tl.load(v_ptr + offs, mask=mask, other=0.0).to(tl.float32)
        v_new = beta * v + one_minus_beta * g
        d = tl.div_rn(v_new, denom[None, :])
        tl.store(v_out_ptr + offs, v_new.to(v_out_ptr.dtype.element_ty), mask=mask)
        if APPLY:
            w = tl.load(w_ptr + offs, mask=mask, other=0.0).to(tl.float32)
            # op order of the two-pass reference: w + (-scale) * (d + wd * w)
            w_new = w + (-scale) * (d + wd * w)
            tl.store(out_ptr + offs, w_new.to(out_ptr.dtype.element_ty), mask=mask)
        else:
            tl.store(out_ptr + offs, d, mask=mask)


def _kernel():
    global _KERNEL, tl
    if _KERNEL is None:
        from repro_torch.kernels.build import triton_cache_dir
        triton_cache_dir()
        import triton
        import triton.language as triton_language
        tl = triton_language
        _KERNEL = triton.jit(_rmnp_kernel)
    return _KERNEL


_FLOATS = (torch.float32, torch.bfloat16)


def _check(g, v, w=None, scalars=None):
    if not g.is_cuda:
        raise ValueError("the RMNP kernel takes CUDA tensors")
    if g.ndim < 2:
        raise ValueError(f"RMNP operands are (..., d_in, d_out); got {tuple(g.shape)}")
    if g.dtype != torch.float32:
        raise TypeError(f"gradient must be float32, got {g.dtype}")
    if v.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"momentum must be float32 or bfloat16, got {v.dtype}")
    operands = [("gradient", g), ("momentum", v)]
    if w is not None:
        if w.dtype not in _FLOATS:
            raise TypeError(f"weights must be float32 or bfloat16, got {w.dtype}")
        operands.append(("weights", w))
    for name, t in operands:
        if t.shape != g.shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, gradient "
                             f"{tuple(g.shape)}")
        if t.device != g.device:
            raise ValueError(f"{name} is on {t.device}, gradient on {g.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if scalars is not None and (scalars.shape != (2,) or scalars.dtype != torch.float32
                                or scalars.device != g.device):
        raise ValueError("scalars must be a (2,) float32 [scale, wd] tensor on "
                         "the gradient's device")


def _launch(g, v, w, v_out, out, scalars, *, beta, eps, apply):
    d_in, d_out = g.shape[-2], g.shape[-1]
    L = g.numel() // (d_in * d_out) if g.numel() else 0
    if L == 0:
        return
    grid = (L, -(-d_out // BLOCK_N))
    with torch.cuda.device(g.device):
        _kernel()[grid](g, v, w, v_out, out, scalars, d_in, d_out,
                        float(beta), 1.0 - float(beta), float(eps),
                        APPLY=apply, BLOCK_M=BLOCK_M, BLOCK_N=BLOCK_N,
                        num_warps=NUM_WARPS)
    LAUNCHES["rmnp_apply" if apply else "rmnp_precondition"] += 1


def rmnp_rownorm(g, v, *, beta: float, eps: float = 1e-8):
    """Precondition kernel. g: (..., d_in, d_out) fp32; v: same shape, fp32
    or bf16 -> (v_new in v.dtype, d fp32)."""
    _check(g, v)
    v_new = torch.empty_like(v)
    d = torch.empty_like(g)
    _launch(g, v, g, v_new, d, g, beta=beta, eps=eps, apply=False)
    return v_new, d


def rmnp_rownorm_apply(g, v, w, scalars, *, beta: float, eps: float = 1e-8):
    """Single-pass apply kernel. g fp32; v fp32 or bf16; w fp32 or bf16;
    scalars (2,) fp32 ``[scale, wd]`` on the device -> (v_new in v.dtype,
    w_new in w.dtype). No fp32 ``d`` buffer is written."""
    _check(g, v, w, scalars)
    v_new = torch.empty_like(v)
    w_new = torch.empty_like(w)
    _launch(g, v, w, v_new, w_new, scalars, beta=beta, eps=eps, apply=True)
    return v_new, w_new


# The plain versions beside the kernels (same math, ordinary tensor ops).
rmnp_rownorm_plain = rmnp_momentum_rownorm_ref


def rmnp_rownorm_apply_plain(g, v, w, scalars, *, beta: float, eps: float = 1e-8):
    return rmnp_rownorm_apply_ref(g, v, w, scalars[0], scalars[1], beta=beta, eps=eps)
