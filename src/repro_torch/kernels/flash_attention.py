"""Flash attention (forward) on Hopper: the CUDA kernel's binding, its plain
version, and the differentiable wrapper.

The kernel (``repro_torch/csrc/flash_attention_fwd.cu``) replaces the TPU
kernel ``repro/kernels/flash_attention.py::_fwd_kernel``; its source says
what bounds it and how it is laid out. bf16 runs on the tensor cores
(``wgmma`` fed by TMA), fp32 on the CUDA cores. It is built with ``nvcc``
at first use and called through ``ctypes`` on PyTorch's current stream.

The backward recomputes, as the JAX package's ``_fa_bwd`` does: autograd
over the chunked online-softmax oracle (``kernels/ref.py``), with the
chunk sizes the caller passed as blocks.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.ref import chunked_attention_ref

DEFAULT_BLOCK_Q = 512
DEFAULT_BLOCK_K = 512
HEAD_DIMS = (16, 32, 64)  # the kernel's instantiations
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_FN = None


def _kernel():
    global _FN
    if _FN is None:
        from repro_torch.kernels.build import load_library
        lib = load_library("flash_attention_fwd")
        fn = lib.fa_fwd
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.fa_error_string.argtypes = [ctypes.c_int]
        lib.fa_error_string.restype = ctypes.c_char_p
        _FN = (fn, lib.fa_error_string)
    return _FN


def _check(q, k, v):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"the flash-attention kernel takes CUDA tensors; "
                             f"{name} is on {t.device}")
        if t.ndim != 4:
            raise ValueError(f"{name} must be (B, S, heads, hd); got {tuple(t.shape)}")
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError("q, k and v must share dtype and device")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype not in _DTYPES:
        raise TypeError(f"unsupported dtype {q.dtype}")
    B, S, H, hd = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[1] != S or k.shape[3] != hd:
        raise ValueError(f"k/v must be (B, S, K, hd) matching q {tuple(q.shape)}; "
                         f"got k {tuple(k.shape)}, v {tuple(v.shape)}")
    if H % k.shape[2]:
        raise ValueError(f"query heads {H} not a multiple of kv heads {k.shape[2]}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not built; the kernel takes {HEAD_DIMS}")
    if q.dtype == torch.bfloat16:
        # TMA reads each tensor from its base address, which must be 16-byte
        # aligned; a contiguous view into a larger tensor need not be
        for name, t in (("q", q), ("k", k), ("v", v)):
            if t.data_ptr() % 16:
                raise ValueError(f"{name} must start at a 16-byte aligned address for "
                                 f"the bf16 kernel's TMA loads; got {t.data_ptr():#x}")


def flash_attention_fwd_kernel(q, k, v, *, causal: bool = True):
    """The CUDA kernel. q (B,S,H,hd); k, v (B,S,K,hd) -> (B,S,H,hd) in q's
    type: bf16 on the tensor cores, fp32 on the CUDA cores. Raises on
    anything the kernel does not take."""
    _check(q, k, v)
    B, S, H, hd = q.shape
    out = torch.empty_like(q)
    fn, err_str = _kernel()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S, H,
                 k.shape[2], hd, _DTYPES[q.dtype], int(causal), 1.0 / (hd ** 0.5),
                 stream)
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
    if q.is_cuda:
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
