"""One quintic Newton-Schulz step on Hopper, built on the GEMM kernel
(``kernels/matmul.py``, ``csrc/matmul.cu``):

    G = X X^T                (m x m)    Gram: A = X, B = X^T by strides
    P = b*G + c*(G @ G)      (m x m)    polynomial, in the G@G epilogue
    Y = a*X + P @ X          (m x n)    apply, a*X in the epilogue

Replaces the TPU kernels ``repro/kernels/newton_schulz.py::_poly_kernel``
and ``::_poly_kernel3`` and the matmuls around them. The JAX package runs
four kernels per step (Gram, G@G, polynomial, apply); here the polynomial is
the epilogue of the G@G launch, so G@G never goes to device memory and a
step is three launches. The Gram reads X^T through strides, with no
transposed copy.

``ns_step`` takes a 2-D ``(m, n)`` X and counts its launches under
``matmul`` (Gram, apply) and ``ns_poly``; ``ns_step3`` takes a stacked
``(L, m, n)`` bucket and counts under ``matmul3`` and ``ns_poly3``. The
kernel's arithmetic on a slice depends only on ``(m, n)``, so ``ns_step3``
gives each slice the bits ``ns_step`` gives it. The caller puts the smaller
side first (``m <= n``), as ``core/muon.newton_schulz`` does.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import introspect
from repro_torch.kernels.matmul import gemm, gemm_plain
from repro_torch.kernels.ref import ns_step_ref


def _check(x, ndim):
    if not (x.is_cuda or introspect.tracing(x)):
        raise ValueError(f"the Newton-Schulz kernels take CUDA tensors; x is on {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"Newton-Schulz runs in float32; x is {x.dtype}")
    if x.ndim != ndim:
        raise ValueError(f"x must have {ndim} dims; got {tuple(x.shape)}")


def _step(x, a, b, c, mm, poly):
    g = gemm(x, x.transpose(1, 2), count=mm)
    p = gemm(g, g, g, alpha=c, beta=b, count=poly)
    return gemm(p, x, x, alpha=1.0, beta=a, count=mm)


def ns_step(x, a: float, b: float, c: float):
    """Kernel: one step on a 2-D (m, n) fp32 CUDA X (L = 1 launches)."""
    _check(x, 2)
    return _step(x[None], a, b, c, "matmul", "ns_poly")[0]


def ns_step3(x, a: float, b: float, c: float):
    """Kernel: one step on a stacked (L, m, n) fp32 CUDA bucket."""
    _check(x, 3)
    return _step(x, a, b, c, "matmul3", "ns_poly3")


# The plain versions, one per launch and one per step.
def gram_plain(x):
    return gemm_plain(x, x.transpose(-1, -2))


def poly_plain(g, b: float, c: float):
    return gemm_plain(g, g, g, alpha=c, beta=b)


def apply_plain(p, x, a: float):
    return gemm_plain(p, x, x, alpha=1.0, beta=a)


ns_step_plain = ns_step_ref
ns_step3_plain = ns_step_ref
