"""Flash attention (forward) on Hopper: the CUDA kernel's binding, its plain
version, and the differentiable wrapper.

Two CUDA kernels replace the TPU kernel
``repro/kernels/flash_attention.py::_fwd_kernel``, one per type, both on
the tensor cores with ``wgmma``: bf16 in ``repro_torch/csrc/flash_attention_fwd.cu``
(TMA-fed, P in three bf16 parts) and fp32 in
``repro_torch/csrc/flash_attention_fwd_tf32.cu`` (every product as three
TF32 products); each source says what bounds it and how it is laid out.
Each is built with ``nvcc`` at first use and called through ``ctypes`` on
PyTorch's current stream.

The backward recomputes, as the JAX package's ``_fa_bwd`` does: autograd
over the chunked online-softmax oracle (``kernels/ref.py``), with the
chunk sizes the caller passed as blocks.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import LAUNCHES, introspect
from repro_torch.kernels.ref import chunked_attention_ref

DEFAULT_BLOCK_Q = 512
DEFAULT_BLOCK_K = 512
# each type's kernel instantiations as (hd, hdv), the q/k and the v head
# dims: the bf16 kernel splits an hd-128 tile into two 64-column halves, an
# hd-192 one into three and an hd-256 one into four, and an hd-96 one into
# three 32-column sub-tiles; the fp32 kernel streams K and V^T through a
# ring of spans of at most 32 columns beside a resident Q. Both take
# phi3-mini's (96, 96), qwen3-4b's (128, 128), MLA's (96, 64) (minicpm3)
# and (192, 128) (deepseek-v2-lite) and paligemma's (256, 256).
HEAD_DIM_PAIRS = {dt: ((16, 16), (32, 32), (64, 64), (96, 96), (128, 128), (96, 64),
                       (192, 128), (256, 256)) for dt in (torch.bfloat16, torch.float32)}
# the C entry of each type: (q, k, v, out, B, S, H, K, hd, hdv, v's head,
# row and batch strides, causal, scale, stream)
ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 3
            + [ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
# each type's library, C entry and error string
_LIBS = {torch.bfloat16: ("flash_attention_fwd", "fa_fwd", "fa_error_string"),
         torch.float32: ("flash_attention_fwd_tf32", "fa_fwd_tf32", "fa_tf32_error_string")}
# v's strides must be multiples of this many elements (16 bytes)
_V_STRIDE = {torch.bfloat16: 8, torch.float32: 4}

_FN = {}


class FlashLayout(NamedTuple):
    """A block's share of one flash launch: ``bq`` query rows of one (batch,
    head), ``threads`` threads, ``smem_bytes`` of dynamic shared memory, and
    the ``stages`` of its K/V ring (bf16) or slots (fp32)."""
    bq: int
    threads: int
    smem_bytes: int
    stages: int


_SMEM = 227 * 1024  # both sources' SMEM_LIMIT
_BK = 64  # keys per K/V tile, both types


def flash_layout(dtype, hd: int, hdv: int) -> FlashLayout:
    """The layout the C side picks for a (dtype, hd, hdv) build, mirrored
    from ``Layout`` in ``csrc/flash_attention_fwd.cu`` (bf16: 128 query rows
    a block, a producer and two consumer warpgroups, 3 K/V stages or 2
    where 3 do not fit) and ``csrc/flash_attention_fwd_tf32.cu`` (fp32: one
    or two consumer warpgroups of 64 rows beside the producer, as many
    16 KB slots as fit beside Q). ``chip_smoke.py`` phase K holds the grids
    and blocks built from it against the card's profiler."""
    if dtype == torch.bfloat16:
        q, k, v = 128 * hd * 2, _BK * hd * 2, _BK * hdv * 2

        def alloc(n):
            return q + n * (k + v) + (1 + 3 * n) * 8 + 1024
        stages = 3 if alloc(3) <= _SMEM else 2
        return FlashLayout(128, 384, alloc(stages), stages)
    span, slot = 128, 2 * _BK * 128  # a swizzled row of 32 fp32; hi and lo of 64 rows
    spans = hd // min(hd, 32)
    cw = 2 if 2 * spans * 128 * span + 2 * slot + 256 + 1024 <= _SMEM else 1
    bq = 64 * cw
    ring = 2 * spans * bq * span
    nslot = (_SMEM - 1024 - 256 - ring) // slot
    return FlashLayout(bq, 128 * cw + 128, ring + nslot * slot + 2 * nslot * 8 + 1024, nslot)


def describe(q, k, v, out, causal: bool = True) -> introspect.KernelLaunch:
    """The launch ``flash_attention_fwd_kernel`` makes: one block per
    ``bq`` query rows of each (batch, head), a one-dimensional grid."""
    B, S, H, hd = q.shape
    K, hdv = k.shape[2], v.shape[3]
    lay = flash_layout(q.dtype, hd, hdv)
    nq = -(-S // lay.bq)
    bf16 = q.dtype == torch.bfloat16
    nk = -(-S // _BK)
    # a block of query head h reads kv head h // (H / K): all K are read
    tiles = (introspect.Tiling("q", (B, S, H, hd), (1, lay.bq, 1, hd), (B, nq, H, 1)),
             introspect.Tiling("k", (B, S, K, hd), (1, _BK, 1, hd), (B, nk, K, 1)),
             introspect.Tiling("v", (B, S, K, hdv), (1, _BK, 1, hdv), (B, nk, K, 1)),
             introspect.Tiling("out", (B, S, H, hdv), (1, lay.bq, 1, hdv), (B, nq, H, 1)))
    return introspect.KernelLaunch(
        name="flash_attention_fwd", kernel="fa_fwd_tc" if bf16 else "fa_fwd_tf32_kernel",
        template=(str(hd), str(hdv)), grid=(nq * H * B, 1, 1), block=(lay.threads, 1, 1),
        cluster=(1, 1, 1), smem_bytes=lay.smem_bytes,
        operands=tuple(introspect.Operand.of(n, t) for n, t in
                       (("q", q), ("k", k), ("v", v), ("out", out))),
        tiles=tiles, layout=lay, work=(("causal", bool(causal)),))


def _kernel(dtype):
    if dtype not in _FN:
        from repro_torch.kernels.build import load_library
        name, entry, error = _LIBS[dtype]
        lib = load_library(name)
        fn = getattr(lib, entry)
        fn.argtypes = ARGTYPES
        fn.restype = ctypes.c_int
        err_str = getattr(lib, error)
        err_str.argtypes = [ctypes.c_int]
        err_str.restype = ctypes.c_char_p
        _FN[dtype] = (fn, err_str)
    return _FN[dtype]


def _check(q, k, v):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not (t.is_cuda or introspect.tracing(t)):
            raise ValueError(f"the flash-attention kernel takes CUDA tensors; "
                             f"{name} is on {t.device}")
        if t.ndim != 4:
            raise ValueError(f"{name} must be (B, S, heads, hd); got {tuple(t.shape)}")
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError("q, k and v must share dtype and device")
    if q.dtype not in _LIBS:
        raise TypeError(f"unsupported dtype {q.dtype}")
    # q and k contiguous; both kernels read v through its head, row and
    # batch strides (bf16: in its tensor map; fp32: in its 16-byte loads),
    # so a column slice such as MLA's v is read in place
    for name, t in (("q", q), ("k", k)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    step = _V_STRIDE[q.dtype]
    if v.stride(3) != 1 or any(st % step for st in v.stride()[:3]):
        raise ValueError(f"v must have unit stride along hdv and its other strides in "
                         f"multiples of {step} elements; got strides {v.stride()}")
    B, S, H, hd = q.shape
    hdv = v.shape[3]
    if k.shape[:2] != (B, S) or k.shape[3] != hd or v.shape[:3] != k.shape[:3]:
        raise ValueError(f"k must be (B, S, K, hd) and v (B, S, K, hdv) matching q "
                         f"{tuple(q.shape)}; got k {tuple(k.shape)}, v {tuple(v.shape)}")
    if H % k.shape[2]:
        raise ValueError(f"query heads {H} not a multiple of kv heads {k.shape[2]}")
    if (hd, hdv) not in HEAD_DIM_PAIRS[q.dtype]:
        raise ValueError(f"head dims (hd, hdv) = ({hd}, {hdv}) not built for {q.dtype}; "
                         f"the kernel takes {HEAD_DIM_PAIRS[q.dtype]}")
    # both kernels read rows from each tensor's base address in 16-byte
    # pieces (TMA for bf16, vector loads for fp32), so the base must be
    # 16-byte aligned; a contiguous view into a larger tensor need not be
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start at a 16-byte aligned address for the "
                             f"kernel's 16-byte loads; got {t.data_ptr():#x}")


def flash_attention_fwd_kernel(q, k, v, *, causal: bool = True):
    """The CUDA kernel. q (B,S,H,hd); k (B,S,K,hd), v (B,S,K,hdv) ->
    (B,S,H,hdv) in q's type, scaled by 1/sqrt(hd); both types on the tensor
    cores: bf16 with P in three bf16 parts, fp32 as 3xTF32. Raises on
    anything the kernel does not take, an unbuilt (hd, hdv) included."""
    _check(q, k, v)
    B, S, H, hd = q.shape
    out = q.new_empty((B, S, H, v.shape[3]))
    if q.is_meta:
        introspect.record(describe(q, k, v, out, causal))
        return out
    fn, err_str = _kernel(q.dtype)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    args = (B, S, H, k.shape[2], hd, v.shape[3], v.stride(2), v.stride(1), v.stride(0),
            int(causal), 1.0 / (hd ** 0.5))
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), *args, stream)
    if err != 0:
        raise RuntimeError(f"flash-attention kernel launch failed: "
                           f"{err_str(err).decode()} ({err})")
    LAUNCHES["flash_attention_fwd"] += 1
    return out


def flash_attention_fwd_plain(q, k, v, *, causal: bool = True,
                              block_q: int = DEFAULT_BLOCK_Q,
                              block_k: int = DEFAULT_BLOCK_K):
    """The plain version: the chunked oracle at the caller's block sizes."""
    return chunked_attention_ref(q, k, v, causal=causal, chunk_q=block_q,
                                 chunk_k=block_k)


def flash_attention_fwd(q, k, v, *, causal: bool = True,
                        block_q: int = DEFAULT_BLOCK_Q,
                        block_k: int = DEFAULT_BLOCK_K):
    """Kernel for CUDA tensors, plain version for CPU tensors; any other
    device raises."""
    if q.is_cuda or introspect.tracing(q):
        return flash_attention_fwd_kernel(q, k, v, causal=causal)
    if q.device.type != "cpu":
        raise ValueError(f"the flash-attention kernel takes CUDA tensors and its "
                         f"plain version CPU tensors; got a tensor on {q.device}")
    return flash_attention_fwd_plain(q, k, v, causal=causal, block_q=block_q,
                                     block_k=block_k)


class FlashAttention(torch.autograd.Function):
    """Kernel forward; backward is autograd over the chunked oracle."""

    @staticmethod
    def forward(ctx, q, k, v, causal, block_q, block_k):
        ctx.save_for_backward(q, k, v)
        ctx.cfg = (causal, block_q, block_k)
        return flash_attention_fwd(q, k, v, causal=causal, block_q=block_q,
                                   block_k=block_k)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        causal, block_q, block_k = ctx.cfg
        with torch.enable_grad():
            qq, kk, vv = (x.detach().requires_grad_(True) for x in (q, k, v))
            out = chunked_attention_ref(qq, kk, vv, causal=causal,
                                        chunk_q=block_q, chunk_k=block_k)
            dq, dk, dv = torch.autograd.grad(out, (qq, kk, vv), g)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, causal: bool = True,
                    block_q: int = DEFAULT_BLOCK_Q,
                    block_k: int = DEFAULT_BLOCK_K):
    return FlashAttention.apply(q, k, v, causal, block_q, block_k)
