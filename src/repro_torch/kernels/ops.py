"""Public entry points of the kernels (mirror of ``repro.kernels.ops``).

Each dispatches on where its tensors lie: CUDA tensors go to the kernel (the
RMNP update, ``kernels/rmnp_update.py``, and the GEMM that carries
Newton-Schulz, ``kernels/matmul.py`` and ``kernels/newton_schulz.py``, all
CUDA C++), which raises on anything it does not take; CPU tensors go to the
plain version. There is no fan-in fallback: the JAX package sends fan-in
above 32768 to its jnp reference, while the Hopper kernel splits ``d_in``
over a thread-block cluster and takes every bucket, the ``50432 x 768``
embedding included. Launches are counted at the launch site
(``repro_torch.kernels.LAUNCHES``).
"""
from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels import introspect
from repro_torch.kernels import matmul as _mm
from repro_torch.kernels import newton_schulz as _ns
from repro_torch.kernels import rmnp_update as _rm
from repro_torch.kernels.ref import matmul_ref, ns_step_ref


def rmnp_momentum_rownorm(g, v, *, beta: float, eps: float = 1e-8):
    """Fused momentum EMA + row (fan-in) l2 normalization.
    g, v: (..., d_in, d_out); g fp32. Returns (v_new in v.dtype, d fp32)."""
    if _on_card(g):
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
    if _on_card(g):
        return _rm.rmnp_rownorm_apply(
            g, v, w, scalars.to(g.device, non_blocking=True), beta=beta, eps=eps)
    _require_cpu(g)
    return _rm.rmnp_rownorm_apply_plain(g, v, w, scalars, beta=beta, eps=eps)


def rmnp_rownorm_split(g, v, comm, w=None, scale=None, wd=None, *, beta: float,
                       eps: float = 1e-8):
    """RMNP over a bucket whose ``d_in`` rows are split over the ranks of
    ``comm`` (the model group): PARTIAL (``v_new`` and each column's sum of
    squares over this rank's rows), the sums added over the group in rank
    order (one all-reduce), FINISH (``v_new`` and ``d`` or ``w_new``). Without ``w``: (v_new, d fp32); with
    ``w``, ``scale`` and ``wd``: (v_new, w_new in w.dtype), the single-pass
    form's op order. Kernels on CUDA tensors, their plain versions on CPU
    tensors."""
    card = _on_card(g)
    if not card:
        _require_cpu(g)
    partial = _rm.rmnp_rownorm_partial if card else _rm.rmnp_rownorm_partial_plain
    finish = _rm.rmnp_rownorm_finish if card else _rm.rmnp_rownorm_finish_plain
    total = comm.all_reduce(partial(g, v, beta=beta))
    if w is None:
        return finish(g, v, total, beta=beta, eps=eps)
    scalars = torch.stack([torch.as_tensor(scale, dtype=torch.float32),
                           torch.as_tensor(wd, dtype=torch.float32)])
    if card:
        scalars = scalars.to(g.device, non_blocking=True)
    return finish(g, v, total, w, scalars, beta=beta, eps=eps)


def ns_step(x, a: float, b: float, c: float):
    """One Newton-Schulz iteration on (..., m, n) fp32, m <= n. A 2-D X goes
    to ``ns_step``; leading dims are flattened into one stacked bucket for
    ``ns_step3``, so a whole ``(L, m, n)`` bucket costs one three-launch
    sequence (Gram, polynomial, apply) instead of one per matrix."""
    if _on_card(x):
        if x.ndim == 2:
            return _ns.ns_step(x, a, b, c)
        flat = x.reshape(-1, *x.shape[-2:])
        return _ns.ns_step3(flat, a, b, c).reshape(x.shape)
    _require_cpu(x)
    return ns_step_ref(x, a, b, c)


def matmul(a, b):
    """fp32 product of 2-D operands: the GEMM kernel on CUDA tensors."""
    if _on_card(a):
        return _mm.matmul(a, b)
    _require_cpu(a)
    return matmul_ref(a, b)


def count_kernel_launches(fn, *args, **kwargs) -> int:
    """Kernel launches one run of ``fn`` makes (counterpart of
    ``count_pallas_calls``): ``fn`` runs on meta copies of its tensor
    arguments under ``introspect.recording()``, so nothing is launched or
    allocated on a device. Used by ``train/step.optimizer_launches``."""
    return len(introspect.collect_kernel_launches(fn, *args, **kwargs))


class _AllocCounter(TorchDispatchMode):
    def __init__(self, shape, dtype, exclude_ops):
        super().__init__()
        self.shape, self.dtype = tuple(shape), dtype
        self.exclude = frozenset(exclude_ops)
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if introspect.op_name(func) not in self.exclude:
            self.n += sum(1 for t in introspect.new_storage_outputs(func, out)
                          if tuple(t.shape) == self.shape and t.dtype == self.dtype)
        return out


def count_buffer_allocs(fn, shape, dtype, *args, exclude_ops=(), **kwargs) -> int:
    """Op outputs of exactly ``(shape, dtype)`` with new storage that one run
    of ``fn`` makes (counterpart of ``count_buffer_eqns``): ``fn`` runs on
    meta copies of its tensor arguments under a dispatch mode and
    ``introspect.recording()``. Views and in-place results allocate nothing
    and are not counted. A kernel entry counts as one op per output it
    allocates, as a ``pallas_call`` is one jaxpr equation; what its plain
    version would allocate inside is not looked at. ``exclude_ops`` names
    aten ops (``"cat"``) whose outputs are not counted."""
    counter = _AllocCounter(shape, dtype, exclude_ops)
    args, kwargs = introspect.to_meta(args), introspect.to_meta(kwargs)
    with introspect.recording(), counter:
        fn(*args, **kwargs)
    return counter.n


def _on_card(t) -> bool:
    """CUDA tensors take the kernel; so do meta tensors inside
    ``introspect.recording()``, where the wrapper records its launch."""
    return t.is_cuda or introspect.tracing(t)


def _require_cpu(t):
    """The plain versions serve CPU tensors only; any other device raises."""
    if t.device.type != "cpu":
        raise ValueError(f"the kernels take CUDA tensors and their plain "
                         f"versions CPU tensors; got a tensor on {t.device}")
