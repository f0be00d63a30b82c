"""The RMNP update kernel for Hopper: its binding, its split and its plain
versions.

The kernel (``repro_torch/csrc/rmnp_update.cu``, CUDA C++) replaces the TPU
kernels ``repro/kernels/rmnp_update.py::_kernel3d`` (precondition: ``v_new``,
``d``) and ``::_kernel3d_apply`` (single-pass apply: ``v_new``, ``w_new``).
Per contiguous stacked bucket ``(L, d_in, d_out)``:

    v_new = beta * v + (1 - beta) * g
    d     = v_new / (||v_new||_col + eps)        (norm over d_in, per column)
    w_new = w + (-scale) * (d + wd * w)          (apply only)

It is bound by bytes, 16 per element at the main path's types (g, v, w read
once, v and w written once), and reads each byte once: a thread-block
cluster of K blocks splits a column block's rows, each block keeps its slab
of ``v_new`` in shared memory, and the blocks add their partial sums of
squares through distributed shared memory before they write. Its source
says how. It is built with ``nvcc`` at first use and called through
``ctypes`` on PyTorch's current stream. ``scale`` and ``wd`` arrive as a
device tensor, so a step reads no scalar back to the host.

This module chooses what the kernel cannot see: the split (``split``), a
function of ``(d_in, d_out)`` alone, so that a stacked launch gives each
slice the bits of a one-slice launch and the two forms give the same norm;
and whether the column block fits the cluster's shared memory (the one-read
path) or the kernel reads ``g`` and ``v`` a second time (the two-sweep
path, which no gpt2-small bucket takes).

Where the model axis splits a bucket's ``d_in`` over ranks
(``core/engine.py``), a column's norm spans the ranks and one pass cannot
finish it: ``rmnp_rownorm_partial`` (the source's PARTIAL mode) writes each
column's sum of squares of ``v_new`` over the rank's rows, the caller adds
the ranks' sums in rank order, and ``rmnp_rownorm_finish`` (FINISH) reads
``g`` and ``v`` again and writes ``v_new`` and ``d`` or ``w_new``: the
two-sweep path cut at its reduction, so one rank gives the one-pass bits.
Both keep the split of the rank's ``(d_in, d_out)``; neither keeps a slab.

Launches are counted under ``rmnp_precondition``, ``rmnp_apply``,
``rmnp_partial`` and ``rmnp_finish`` (``repro_torch.kernels.LAUNCHES``),
one per bucket and call.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import LAUNCHES, introspect
from repro_torch.kernels.ref import rmnp_momentum_rownorm_ref, rmnp_rownorm_apply_ref

_FN = None
_INT32_MAX = 2 ** 31 - 1
THREADS = 256
TALL_THREADS = 512  # one block an SM: twice the threads keep twice the loads in flight
SMEM_LIMIT = 232448  # the shared memory a block may use on an H100 (227 KB)
# A block's slab of v_new: at most ROWS rows by COLUMNS_WIDE columns, 96 KB,
# two blocks an SM (tools/rmnp_sweep.py chose 384 x 64 over 768 x 32).
ROWS = 384
COLUMNS_WIDE = 64
MAX_PORTABLE_CLUSTER = 8
MAX_CLUSTER = 16  # the kernel sets the non-portable cluster attribute above 8
COLUMNS = (8, 16, 32, 64)  # the kernel's column blocks


class Split(NamedTuple):
    """How a launch lays out one ``(d_in, d_out)`` slice: clusters of ``K``
    blocks along ``d_in``, ``R`` rows and ``C`` columns a block,
    ``threads`` a block; ``one_read`` keeps ``v_new`` in shared memory."""
    K: int
    R: int
    C: int
    threads: int
    one_read: bool

    def smem_bytes(self) -> int:
        """The kernel's dynamic shared memory (csrc/rmnp_update.cu::smem_bytes)."""
        return 4 * (4 * self.threads + 2 * self.C + (self.R * self.C if self.one_read else 0))


def split(d_in: int, d_out: int) -> Split:
    """The split of a ``(d_in, d_out)`` slice, never of ``L`` or the card.

    Up to 8 blocks of at most ``ROWS`` rows and 64 columns (96 KB of
    ``v_new`` a block, two blocks an SM; d_in 768: 2 blocks, 3072: 8);
    taller columns take 16 blocks (the non-portable cluster size) of 512
    threads with 16, then 8 columns, as long as the slab fits a block's
    shared memory (the ``50432 x 768`` embedding: 3152 rows by 16 columns,
    197 KB, one block an SM); beyond that the two-sweep path, 8 blocks of
    32 columns that keep no slab."""
    K = -(-d_in // ROWS)
    if K <= MAX_PORTABLE_CLUSTER:
        return Split(K, -(-d_in // K), COLUMNS_WIDE, THREADS, True)
    R = -(-d_in // MAX_CLUSTER)
    for C in (16, 8):
        s = Split(MAX_CLUSTER, R, C, TALL_THREADS, True)
        if s.smem_bytes() <= SMEM_LIMIT:
            return s
    return Split(MAX_PORTABLE_CLUSTER, -(-d_in // MAX_PORTABLE_CLUSTER), 32, THREADS, False)


def _kernel():
    global _FN
    if _FN is None:
        from repro_torch.kernels.build import load_library
        lib = load_library("rmnp_update")
        fn = lib.rmnp_update
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 12 + [ctypes.c_float] * 3
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fn_split = lib.rmnp_update_split
        fn_split.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 12 + [ctypes.c_float] * 3
                             + [ctypes.c_void_p])
        fn_split.restype = ctypes.c_int
        occ = lib.rmnp_max_active_clusters
        occ.argtypes = [ctypes.c_int] * 11 + [ctypes.POINTER(ctypes.c_int)]
        occ.restype = ctypes.c_int
        lib.rmnp_error_string.argtypes = [ctypes.c_int]
        lib.rmnp_error_string.restype = ctypes.c_char_p
        _FN = (fn, occ, lib.rmnp_error_string, fn_split)
    return _FN


_FLOATS = (torch.float32, torch.bfloat16)


def _check(g, v, w=None, scalars=None):
    if not (g.is_cuda or introspect.tracing(g)):
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
    d_in, d_out = g.shape[-2], g.shape[-1]
    L = g.numel() // (d_in * d_out) if g.numel() else 0
    if L * -(-d_out // split(d_in, d_out).C) > _INT32_MAX:
        raise ValueError(f"{tuple(g.shape)}: more than 2^31 - 1 column blocks in a launch")


def _launch(g, v, w, v_out, out, scalars, *, beta, eps, apply, layout=None):
    """One launch over the bucket, laid out by ``split`` or by ``layout``
    (tools/rmnp_sweep.py tries others)."""
    d_in, d_out = g.shape[-2], g.shape[-1]
    L = g.numel() // (d_in * d_out) if g.numel() else 0
    if L == 0:
        return
    s = layout or split(d_in, d_out)
    if g.is_meta:
        introspect.record(describe(g, v, w, v_out, out, apply=apply, layout=s))
        return
    tensors = [t for t in (g, v, w, v_out, out) if t is not None]
    vec = d_out % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors)
    v_bf16 = v.dtype == torch.bfloat16
    w_bf16 = w is not None and w.dtype == torch.bfloat16
    fn, _, err_str, _ = _kernel()
    stream = torch.cuda.current_stream(g.device).cuda_stream
    with torch.cuda.device(g.device):
        err = fn(g.data_ptr(), v.data_ptr(), None if w is None else w.data_ptr(),
                 v_out.data_ptr(), out.data_ptr(),
                 None if scalars is None else scalars.data_ptr(), L, d_in, d_out, s.K, s.R,
                 s.C, s.threads, int(s.one_read), int(vec), int(v_bf16), int(w_bf16),
                 int(apply), float(beta), 1.0 - float(beta), float(eps), stream)
    if err != 0:
        raise RuntimeError(f"RMNP kernel launch failed: {err_str(err).decode()} ({err})")
    LAUNCHES["rmnp_apply" if apply else "rmnp_precondition"] += 1


def describe(g, v, w, v_out, out, *, apply: bool, layout=None) -> introspect.KernelLaunch:
    """The launch ``_launch`` makes over this bucket: ``rmnp_kernel<C,
    APPLY, ONE_READ, TV, TW>`` on a grid of ``(K, min(items, 65535))``
    blocks in clusters of ``K`` along ``d_in`` (``csrc/rmnp_update.cu::
    configure``), each cluster row walking the ``L * ceil(d_out / C)``
    column blocks with a stride of ``gridDim.y``."""
    d_in, d_out = g.shape[-2], g.shape[-1]
    L = g.numel() // (d_in * d_out) if g.numel() else 0
    s = layout or split(d_in, d_out)
    blocks = -(-d_out // s.C)
    grid = (s.K, min(L * blocks, 65535), 1)

    def ctype(t):
        return "__nv_bfloat16" if t is not None and t.dtype == torch.bfloat16 else "float"
    template = (str(s.C), "true" if apply else "false", "true" if s.one_read else "false",
                ctype(v), ctype(w) if apply else "float")
    names = ("g", "v", "w", "v_out", "w_out" if apply else "d")
    tensors = [(n, t) for n, t in zip(names, (g, v, w, v_out, out), strict=True)
               if t is not None]
    return introspect.KernelLaunch(
        name="rmnp_apply" if apply else "rmnp_precondition", kernel="rmnp_kernel",
        template=template, grid=grid, block=(s.threads, 1, 1), cluster=(s.K, 1, 1),
        smem_bytes=s.smem_bytes(),
        operands=tuple(introspect.Operand.of(n, t) for n, t in tensors),
        tiles=tuple(introspect.Tiling(n, (L, d_in, d_out), (1, s.R, s.C), (L, grid[0], blocks))
                    for n, _ in tensors),
        layout=s)


def max_active_clusters(shape, v_dtype, w_dtype=None, *, apply: bool, layout=None) -> int:
    """How many clusters of the bucket's split the card holds at once
    (``cudaOccupancyMaxActiveClusters``; 0: none can be scheduled)."""
    _, d_in, d_out = shape
    s = layout or split(d_in, d_out)
    _, occ, err_str, _ = _kernel()
    n = ctypes.c_int(0)
    err = occ(1, d_in, d_out, s.K, s.R, s.C, s.threads, int(s.one_read),
              int(v_dtype == torch.bfloat16), int(w_dtype == torch.bfloat16), int(apply),
              ctypes.byref(n))
    if err != 0:
        raise RuntimeError(f"RMNP occupancy query failed: {err_str(err).decode()} ({err})")
    return n.value


def rmnp_rownorm(g, v, *, beta: float, eps: float = 1e-8):
    """Precondition kernel. g: (..., d_in, d_out) fp32; v: same shape, fp32
    or bf16 -> (v_new in v.dtype, d fp32)."""
    _check(g, v)
    v_new = torch.empty_like(v)
    d = torch.empty_like(g)
    _launch(g, v, None, v_new, d, None, beta=beta, eps=eps, apply=False)
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


PARTIAL, FINISH = 1, 2


def split_layout(d_in: int, d_out: int) -> Split:
    """The column-split modes' layout: ``split``'s clusters, rows and
    columns, without the slab."""
    return split(d_in, d_out)._replace(one_read=False)


def _launch_split(g, v, w, v_out, out, colsum, scalars, *, beta, eps, mode, apply):
    """One launch of PARTIAL (``mode=1``) or FINISH (``mode=2``) over the
    bucket."""
    d_in, d_out = v.shape[-2], v.shape[-1]
    L = v.numel() // (d_in * d_out) if v.numel() else 0
    if L == 0:
        return
    s = split_layout(d_in, d_out)
    name = "rmnp_partial" if mode == PARTIAL else "rmnp_finish"
    if v.is_meta:
        introspect.record(describe_split(g, v, w, v_out, out, colsum, mode=mode, apply=apply))
        return
    tensors = [t for t in (g, v, w, v_out, out, colsum) if t is not None]
    vec = d_out % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors)
    _, _, err_str, fn = _kernel()
    stream = torch.cuda.current_stream(v.device).cuda_stream
    ptr = (lambda t: None if t is None else t.data_ptr())
    with torch.cuda.device(v.device):
        err = fn(g.data_ptr(), v.data_ptr(), ptr(w), ptr(v_out), ptr(out), colsum.data_ptr(),
                 ptr(scalars), L, d_in, d_out, s.K, s.R, s.C, s.threads, int(vec),
                 int(v.dtype == torch.bfloat16), int(w is not None and w.dtype == torch.bfloat16),
                 mode, int(apply), float(beta), 1.0 - float(beta), float(eps), stream)
    if err != 0:
        raise RuntimeError(f"RMNP {name} launch failed: {err_str(err).decode()} ({err})")
    LAUNCHES[name] += 1


def describe_split(g, v, w, v_out, out, colsum, *, mode: int,
                   apply: bool) -> introspect.KernelLaunch:
    """The launch ``_launch_split`` makes: ``rmnp_split_kernel<C, MODE,
    APPLY, TV, TW>`` on ``split``'s grid, no slab."""
    d_in, d_out = v.shape[-2], v.shape[-1]
    L = v.numel() // (d_in * d_out) if v.numel() else 0
    s = split_layout(d_in, d_out)
    blocks = -(-d_out // s.C)
    grid = (s.K, min(L * blocks, 65535), 1)

    def ctype(t):
        return "__nv_bfloat16" if t is not None and t.dtype == torch.bfloat16 else "float"
    name = "rmnp_partial" if mode == PARTIAL else "rmnp_finish"
    template = (str(s.C), "PARTIAL" if mode == PARTIAL else "FINISH",
                "true" if apply else "false", ctype(v), ctype(w) if apply else "float")
    if mode == PARTIAL:
        names, ts = ("g", "v", "colsum"), (g, v, colsum)
    else:
        names = ("g", "v", "colsum", "v_out") + (("w", "w_out") if apply else ("d",))
        ts = (g, v, colsum, v_out) + ((w, out) if apply else (out,))
    return introspect.KernelLaunch(
        name=name, kernel="rmnp_split_kernel", template=template, grid=grid,
        block=(s.threads, 1, 1), cluster=(s.K, 1, 1), smem_bytes=s.smem_bytes(),
        operands=tuple(introspect.Operand.of(n, t) for n, t in zip(names, ts, strict=True)),
        tiles=tuple(introspect.Tiling(n, (L, d_in, d_out), (1, s.R, s.C), (L, grid[0], blocks))
                    for n in names if n != "colsum"),
        layout=s)


def rmnp_rownorm_partial(g, v, *, beta: float):
    """PARTIAL kernel over a rank's rows. g: (..., d_in, d_out) fp32; v fp32
    or bf16 -> colsum (..., 1, d_out) fp32: each column's sum of squares of
    ``v_new`` over these rows."""
    _check(g, v)
    colsum = torch.empty(g.shape[:-2] + (1, g.shape[-1]), dtype=torch.float32, device=g.device)
    _launch_split(g, v, None, None, None, colsum, None, beta=beta, eps=0.0, mode=PARTIAL,
                  apply=False)
    return colsum


def rmnp_rownorm_finish(g, v, colsum, w=None, scalars=None, *, beta: float,
                        eps: float = 1e-8):
    """FINISH kernel. g, v as PARTIAL took them; colsum (..., 1, d_out)
    fp32, the ranks' summed sums of squares. Without ``w`` -> (v_new, d
    fp32); with ``w`` and ``scalars`` ((2,) fp32 ``[scale, wd]``) -> (v_new,
    w_new in w.dtype)."""
    _check(g, v, w, scalars)
    want = g.shape[:-2] + (1, g.shape[-1])
    if (colsum.shape != want or colsum.dtype != torch.float32 or not colsum.is_contiguous()
            or colsum.device != g.device):
        raise ValueError(f"colsum must be a contiguous float32 {tuple(want)} on "
                         f"{g.device}, got {colsum.dtype} {tuple(colsum.shape)}")
    v_new = torch.empty_like(v)
    out = torch.empty_like(w) if w is not None else torch.empty_like(g)
    _launch_split(g, v, w, v_new, out, colsum, scalars, beta=beta, eps=eps,
                  mode=FINISH, apply=w is not None)
    return v_new, out


# The plain versions beside the kernels (same math, ordinary tensor ops).
rmnp_rownorm_plain = rmnp_momentum_rownorm_ref


def rmnp_rownorm_apply_plain(g, v, w, scalars, *, beta: float, eps: float = 1e-8):
    return rmnp_rownorm_apply_ref(g, v, w, scalars[0], scalars[1], beta=beta, eps=eps)


def rmnp_rownorm_partial_plain(g, v, *, beta: float):
    """PARTIAL's plain version: the sums of squares of the reference's
    ``v_new`` over these rows (``torch.sum`` over d_in, as the whole form)."""
    v_new = beta * v.float() + (1.0 - beta) * g.float()
    return torch.sum(torch.square(v_new), dim=-2, keepdim=True)


def rmnp_rownorm_finish_plain(g, v, colsum, w=None, scalars=None, *, beta: float,
                              eps: float = 1e-8):
    """FINISH's plain version, in the whole form's op order: ``v_new``,
    ``d = v_new / (sqrt(colsum) + eps)``, then ``w + (-scale) * (d + wd *
    w)``."""
    v_new = beta * v.float() + (1.0 - beta) * g.float()
    d = v_new / (torch.sqrt(colsum) + eps)
    if w is None:
        return v_new.to(v.dtype), d
    w32 = w.float()
    return v_new.to(v.dtype), (w32 + (-scalars[0]) * (d + scalars[1] * w32)).to(w.dtype)
