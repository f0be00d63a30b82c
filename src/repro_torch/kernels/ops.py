"""Public entry points of the RMNP kernels (mirror of ``repro.kernels.ops``).

Each dispatches on where its tensors lie: CUDA tensors go to the Triton
kernel (``kernels/rmnp_update.py``), which raises on anything it does not
take; CPU tensors go to the plain version. There is no fan-in fallback: the
JAX package sends fan-in above 32768 to its jnp reference, while the Hopper
kernel loops over ``d_in`` and takes every bucket, the ``50432 x 768``
embedding included. Launches are counted at the launch site
(``repro_torch.kernels.LAUNCHES``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import rmnp_update as _rm


def rmnp_momentum_rownorm(g, v, *, beta: float, eps: float = 1e-8):
    """Fused momentum EMA + row (fan-in) l2 normalization.
    g, v: (..., d_in, d_out); g fp32. Returns (v_new in v.dtype, d fp32)."""
    if g.is_cuda:
        return _rm.rmnp_rownorm(g, v, beta=beta, eps=eps)
    _require_cpu(g)
    return _rm.rmnp_rownorm_plain(g, v, beta=beta, eps=eps)


def rmnp_bucket_update(g, v, *, beta: float, eps: float = 1e-8):
    """The bucketed engine's precondition: one launch over a stacked
    ``(L, d_in, d_out)`` bucket. Returns (v_new in v.dtype, d fp32)."""
    return rmnp_momentum_rownorm(g, v, beta=beta, eps=eps)


def rmnp_bucket_update_apply(g, v, w, scale, wd, *, beta: float,
                             eps: float = 1e-8):
    """Single-pass fused apply over a stacked bucket: momentum EMA + row
    normalize + weight update in one launch; no fp32 ``d`` buffer.

    g fp32; v momentum (fp32 or bf16); w weights (math fp32, output in
    w.dtype); ``scale`` (0-d fp32 tensor, lr * rms_lr_scale) and ``wd`` are
    moved to the device as one ``[scale, wd]`` tensor, never read back.
    Returns (v_new, w_new)."""
    scalars = torch.stack([torch.as_tensor(scale, dtype=torch.float32),
                           torch.as_tensor(wd, dtype=torch.float32)])
    if g.is_cuda:
        return _rm.rmnp_rownorm_apply(
            g, v, w, scalars.to(g.device, non_blocking=True), beta=beta, eps=eps)
    _require_cpu(g)
    return _rm.rmnp_rownorm_apply_plain(g, v, w, scalars, beta=beta, eps=eps)


def _require_cpu(t):
    """The plain versions serve CPU tensors only; any other device raises."""
    if t.device.type != "cpu":
        raise ValueError(f"the RMNP kernels take CUDA tensors and their plain "
                         f"versions CPU tensors; got a tensor on {t.device}")
