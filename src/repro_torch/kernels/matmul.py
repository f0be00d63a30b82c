"""Batched fp32 GEMM on Hopper: the CUDA kernel's binding and its plain
version.

The kernel (``repro_torch/csrc/matmul.cu``) computes ``D[l] = alpha * (A[l]
@ B[l]) + beta * C[l]`` over a stack of ``L`` slices, every operand read
through its strides. It replaces the TPU kernels
``repro/kernels/matmul.py::_kernel`` (2-D, launched here with ``L = 1``)
and ``::_kernel3`` (stacked), and with its epilogue the Newton-Schulz
polynomial (``kernels/newton_schulz.py``). Its products run on the tensor
cores as 3xTF32 (``wgmma``), summed in fp32 slab by slab; its source says
what bounds it and how it is laid out. It is built with ``nvcc`` at first
use and called through ``ctypes`` on PyTorch's current stream.

This module chooses what the kernel cannot see: the chunks of K that it
sums apart (``k_chunk``, a function of the slice's shape alone, so that
every slice of a stack rounds as it would alone) and whether a launch
spreads a tile's chunks over blocks (``split_blocks``, which changes no
bit of the result).

Launches are counted under the key the caller names: ``matmul`` and
``matmul3`` for the products, ``ns_poly`` and ``ns_poly3`` for the
polynomial (``repro_torch.kernels.LAUNCHES``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import LAUNCHES, introspect
from repro_torch.kernels.ref import matmul_ref

_FN = None
_INT32_MAX = 2 ** 31 - 1
_MAX_L = 65535  # gridDim.z
_TILE = 128  # the kernel's output tile (rows and columns)
_SLAB = 32  # the kernel's k-slab
_THREADS = 256  # two warpgroups
# the kernel's dynamic shared memory (csrc/matmul.cu::SMEM_BYTES): two
# stages of A and B in TF32 hi and lo, the finished chunks' sum (64 floats
# a thread), four mbarriers, and 1 KB to align the base
SMEM_BYTES = 2 * 4 * _TILE * _SLAB * 4 + 64 * _THREADS * 4 + 4 * 8 + 1024
# K is cut into chunks, each summed apart and the chunks added in order. No
# chunk is longer than K_CHUNK: on the H100 a serial fp32 chain over a Gram's
# K = 3072 landed 7.7x further from the exact sum than cuBLAS (PERF.md), and
# the embedding's Gram (K = 50432, 36 output tiles) runs 25 blocks per tile.
# Where the output tiles of one slice would leave most of the card's SMs
# idle, chunks down to MIN_CHUNK give it more blocks (a 768 x 768 x 768
# product: 36 tiles, 3 chunks of 256). The chunking is a function of
# (M, N, K) alone, never of L or of the card, so a stacked launch and a
# one-slice launch round alike.
K_CHUNK = 2048
MIN_CHUNK = 256
SMS = 132  # an H100's streaming multiprocessors


def _tiles(M: int, N: int) -> int:
    return -(-M // _TILE) * -(-N // _TILE)


def k_chunk(M: int, N: int, K: int) -> int:
    """The chunk of K the kernel sums apart, for an (M, K) @ (K, N) slice."""
    chunks = max(-(-K // K_CHUNK), min(SMS // _tiles(M, N), K // MIN_CHUNK), 1)
    per_chunk = -(-K // chunks)
    return max(_SLAB, -(-per_chunk // _SLAB) * _SLAB)  # whole slabs


def split_blocks(L: int, M: int, N: int, K: int, chunk: int) -> bool:
    """Whether a launch runs one block per (output tile, chunk), its chunk
    sums added through a workspace, rather than one block per tile. Only
    when the tiles of the whole stack leave SMs idle: the workspace costs a
    round trip through device memory. Both give the same bits."""
    return K > chunk and L * _tiles(M, N) < SMS


def _kernel():
    global _FN
    if _FN is None:
        from repro_torch.kernels.build import load_library
        lib = load_library("matmul")
        fn = lib.gemm_f32
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                       + [ctypes.c_longlong] * 9 + [ctypes.c_float] * 2
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.gemm_error_string.argtypes = [ctypes.c_int]
        lib.gemm_error_string.restype = ctypes.c_char_p
        _FN = (fn, lib.gemm_error_string)
    return _FN


def _check(a, b, c):
    operands = [("a", a), ("b", b)] + ([("c", c)] if c is not None else [])
    for name, t in operands:
        if not (t.is_cuda or introspect.tracing(t)):
            raise ValueError(f"the GEMM kernel takes CUDA tensors; {name} is on {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"the GEMM kernel takes float32; {name} is {t.dtype}")
        if t.ndim != 3:
            raise ValueError(f"{name} must be (L, rows, cols); got {tuple(t.shape)}")
        if t.device != a.device:
            raise ValueError(f"{name} is on {t.device}, a on {a.device}")
        if max(t.shape) > _INT32_MAX:
            raise ValueError(f"{name} has a dimension above 2^31 - 1: {tuple(t.shape)}")
    L, M, K = a.shape
    if b.shape[0] != L or b.shape[1] != K:
        raise ValueError(f"b must be (L, K, N) = ({L}, {K}, N); got {tuple(b.shape)}")
    if c is not None and tuple(c.shape) != (L, M, b.shape[2]):
        raise ValueError(f"c must be ({L}, {M}, {b.shape[2]}); got {tuple(c.shape)}")
    if L > _MAX_L:
        raise ValueError(f"at most {_MAX_L} slices per launch; got {L}")


def gemm(a, b, c=None, *, alpha: float = 1.0, beta: float = 0.0,
         count: str = "matmul3"):
    """The kernel: ``alpha * (a @ b) + beta * c`` over ``L`` slices.

    a (L, M, K), b (L, K, N), c (L, M, N) or None: float32 CUDA tensors of
    any strides (``b`` may be a transposed view). ``c`` is read only when
    given; without it ``beta`` must be 0. Returns a new contiguous (L, M, N)
    float32 tensor and adds one launch to ``LAUNCHES[count]``. Raises on
    anything the kernel does not take."""
    _check(a, b, c)
    if c is None and beta != 0.0:
        raise ValueError("beta is not 0 but no c was given")
    L, M, K = a.shape
    N = b.shape[2]
    out = torch.empty((L, M, N), dtype=torch.float32, device=a.device)
    chunk = k_chunk(M, N, K)
    split = split_blocks(L, M, N, K, chunk)
    work = arrivals = None
    if split:  # scratch of the chunk sums and the tiles' arrival counters
        work = torch.empty(L * -(-K // chunk) * M * N, dtype=torch.float32, device=a.device)
        arrivals = torch.zeros(L * _tiles(M, N), dtype=torch.int32, device=a.device)
    if a.is_meta:
        if L and M and N:  # the C side launches nothing for an empty product
            introspect.record(describe(a, b, c, out, count=count, chunk=chunk, split=split))
        return out
    fn, err_str = _kernel()
    cs = c.stride() if c is not None else (0, 0, 0)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    with torch.cuda.device(a.device):
        err = fn(a.data_ptr(), b.data_ptr(), c.data_ptr() if c is not None else None,
                 out.data_ptr(), None if work is None else work.data_ptr(),
                 None if arrivals is None else arrivals.data_ptr(), L, M, N, K, chunk,
                 int(split), *a.stride(), *b.stride(), *cs, float(alpha), float(beta), stream)
    if err != 0:
        raise RuntimeError(f"GEMM kernel launch failed: {err_str(err).decode()} ({err})")
    LAUNCHES[count] += 1
    return out


def describe(a, b, c, out, *, count: str, chunk: int, split: bool) -> introspect.KernelLaunch:
    """The launch ``gemm`` makes (``csrc/matmul.cu::gemm_f32``):
    ``gemm_kernel<A_K, B_K>`` (each operand read along k or along its rows,
    from its strides) on a grid of ``(ceil(N / 128) * chunks if split,
    ceil(M / 128), L)`` blocks of 256 threads, ``chunks = ceil(K / chunk)``."""
    L, M, K = a.shape
    N = b.shape[2]
    chunks = -(-K // chunk) if K > chunk else 1
    per_tile = chunks if split and chunks > 1 else 1
    tiles_n, tiles_m = -(-N // _TILE), -(-M // _TILE)
    grid = (tiles_n * per_tile, tiles_m, L)
    a_k = not (a.stride(1) == 1 and a.stride(2) != 1)
    b_k = not (b.stride(2) == 1 and b.stride(1) != 1)
    ops = [("a", a), ("b", b)] + ([("c", c)] if c is not None else []) + [("d", out)]
    tiles = [introspect.Tiling("a", (L, M, K), (1, _TILE, chunk), (L, tiles_m, chunks)),
             introspect.Tiling("b", (L, K, N), (1, chunk, _TILE), (L, chunks, tiles_n))]
    tiles += [introspect.Tiling(n, (L, M, N), (1, _TILE, _TILE), (L, tiles_m, tiles_n))
              for n, _ in ops[2:]]
    from repro_torch.launch.roofline import gemm_reads
    return introspect.KernelLaunch(
        name=count, kernel="gemm_kernel",
        template=("true" if a_k else "false", "true" if b_k else "false"),
        grid=grid, block=(_THREADS, 1, 1), cluster=(1, 1, 1), smem_bytes=SMEM_BYTES,
        operands=tuple(introspect.Operand.of(n, t) for n, t in ops), tiles=tuple(tiles),
        layout=(chunk, split), work=(("reads", gemm_reads(a, b, c)),))


def gemm_plain(a, b, c=None, *, alpha: float = 1.0, beta: float = 0.0):
    """The plain version: ``beta * c + alpha * (a @ b)``, each product and
    sum rounded as the kernel's epilogue rounds it (``alpha * p`` is ``p``
    for alpha 1)."""
    prod = matmul_ref(a, b)
    if alpha != 1.0:
        prod = alpha * prod
    return prod if c is None else beta * c + prod


def matmul(a, b):
    """The 2-D kernel (counterpart of ``_kernel``): a (m, k) @ b (k, n) ->
    fp32 (m, n), launched with L = 1 and counted under ``matmul``."""
    if a.ndim != 2 or b.ndim != 2:
        raise ValueError(f"matmul takes 2-D operands; got {tuple(a.shape)} @ {tuple(b.shape)}")
    return gemm(a[None], b[None], count="matmul")[0]


def matmul3(a, b):
    """The stacked kernel (counterpart of ``_kernel3``): a (L, m, k) @
    b (L, k, n) -> fp32 (L, m, n), counted under ``matmul3``."""
    return gemm(a, b, count="matmul3")


# The plain versions beside the kernels.
matmul_plain = matmul_ref
matmul3_plain = matmul_ref
