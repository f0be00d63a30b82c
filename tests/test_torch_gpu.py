"""The port's Hopper kernels against their plain PyTorch versions, on the card.

Marked ``gpu``; every test asks the ``cuda`` fixture, which skips when no
CUDA card is present. This file imports no JAX, so it runs on a machine
that has only PyTorch, Triton and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

Tolerances. fp32 outputs: the kernels sum the column squares (RMNP) or
the softmax terms (attention) in another order than the plain versions,
and may fuse multiply-adds, so they agree to a few fp32 ulps (rtol 1e-5).
bf16 outputs round those fp32 values once: where a value straddles a
rounding boundary the two differ by one bf16 step, at most 2^-7 relative.
"""
import pytest
import torch

from repro_torch.kernels import LAUNCHES, reset_launches
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import rmnp_update as rm

pytestmark = pytest.mark.gpu

TOL = {torch.float32: dict(rtol=1e-5, atol=1e-6),
       torch.bfloat16: dict(rtol=2.0 ** -7, atol=1e-6)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert torch.isfinite(a.float()).all()
    torch.testing.assert_close(a.float(), b.float(), **TOL[a.dtype])


def _rmnp_inputs(shape, vdt, wdt, seed=0):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    g = torch.randn(shape, generator=gen, device="cuda") * 1e-3
    v = (torch.randn(shape, generator=gen, device="cuda") * 1e-3).to(vdt)
    w = (torch.randn(shape, generator=gen, device="cuda") * 0.02).to(wdt)
    scalars = torch.tensor([2e-3, 0.1], device="cuda")
    return g, v, w, scalars


# the four gpt2-small buckets, a ragged small bucket and a ragged 2-D leaf
SHAPES = [(48, 768, 768), (12, 768, 6144), (12, 3072, 768), (1, 50432, 768),
          (3, 33, 9), (300, 257)]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("vdt", [torch.float32, torch.bfloat16], ids=["v32", "v16"])
def test_rmnp_precondition_matches_plain(cuda, shape, vdt):
    g, v, _, _ = _rmnp_inputs(shape, vdt, torch.bfloat16)
    v_k, d_k = rm.rmnp_rownorm(g, v, beta=0.95)
    v_p, d_p = rm.rmnp_rownorm_plain(g, v, beta=0.95)
    torch.cuda.synchronize()
    _close(v_k, v_p)
    _close(d_k, d_p)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("vdt", [torch.float32, torch.bfloat16], ids=["v32", "v16"])
@pytest.mark.parametrize("wdt", [torch.float32, torch.bfloat16], ids=["w32", "w16"])
def test_rmnp_apply_matches_plain(cuda, shape, vdt, wdt):
    g, v, w, scalars = _rmnp_inputs(shape, vdt, wdt)
    v_k, w_k = rm.rmnp_rownorm_apply(g, v, w, scalars, beta=0.95)
    v_p, w_p = rm.rmnp_rownorm_apply_plain(g, v, w, scalars, beta=0.95)
    torch.cuda.synchronize()
    _close(v_k, v_p)
    _close(w_k, w_p)


def test_rmnp_ops_launch_the_kernel_once(cuda):
    g, v, w, _ = _rmnp_inputs((4, 64, 96), torch.float32, torch.bfloat16)
    reset_launches()
    ops.rmnp_bucket_update_apply(g, v, w, torch.tensor(1e-3), 0.1, beta=0.9)
    ops.rmnp_bucket_update(g, v, beta=0.9)
    ops.rmnp_momentum_rownorm(g, v, beta=0.9)
    assert LAUNCHES["rmnp_apply"] == 1
    assert LAUNCHES["rmnp_precondition"] == 2


def test_rmnp_kernel_rejects_what_it_does_not_take(cuda):
    g, v, w, scalars = _rmnp_inputs((64, 96), torch.float32, torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous"):
        rm.rmnp_rownorm(g.t(), v.t(), beta=0.9)
    with pytest.raises(TypeError, match="float32"):
        rm.rmnp_rownorm(g.half(), v, beta=0.9)
    with pytest.raises(ValueError, match="shape"):
        rm.rmnp_rownorm_apply(g, v, w[:32], scalars, beta=0.9)
    with pytest.raises(ValueError, match="scalars"):
        rm.rmnp_rownorm_apply(g, v, w, scalars.cpu(), beta=0.9)


ATTN = [("gpt2_small", 8, 1024, 12, 12, 64, torch.bfloat16),
        ("gqa_ragged", 2, 1000, 8, 2, 64, torch.bfloat16),
        ("gqa_ragged_fp32", 2, 1000, 8, 2, 64, torch.float32),
        ("hd32", 1, 130, 4, 4, 32, torch.float32),
        ("hd16_g4", 1, 77, 8, 2, 16, torch.bfloat16)]


def _qkv(B, S, H, K, hd, dt, requires_grad=False, seed=1):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    out = []
    for heads in (H, K, K):
        x = torch.randn(B, S, heads, hd, generator=gen, device="cuda").to(dt)
        out.append(x.requires_grad_(requires_grad))
    return out


@pytest.mark.parametrize("case", ATTN, ids=[c[0] for c in ATTN])
def test_flash_forward_matches_plain(cuda, case):
    _, B, S, H, K, hd, dt = case
    q, k, v = _qkv(B, S, H, K, hd, dt)
    out = fa.flash_attention_fwd_kernel(q, k, v, causal=True)
    ref = fa.flash_attention_fwd_plain(q, k, v, causal=True)
    torch.cuda.synchronize()
    _close(out, ref)


def test_flash_autograd_runs_the_kernel_forward(cuda):
    q, k, v = _qkv(2, 96, 4, 2, 32, torch.float32, requires_grad=True)
    reset_launches()
    out = fa.flash_attention(q, k, v, True, 32, 32)
    assert LAUNCHES["flash_attention_fwd"] == 1
    out.square().sum().backward()
    grads = [x.grad.clone() for x in (q, k, v)]
    for x in (q, k, v):
        x.grad = None
    ref = fa.flash_attention_fwd_plain(q, k, v, causal=True, block_q=32, block_k=32)
    ref.square().sum().backward()
    _close(out.detach(), ref.detach())
    for got, want in zip(grads, (q.grad, k.grad, v.grad), strict=True):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


def test_flash_kernel_rejects_what_it_does_not_take(cuda):
    q, k, v = _qkv(1, 64, 4, 2, 64, torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention_fwd_kernel(q.transpose(1, 2), k, v)
    with pytest.raises(ValueError, match="multiple"):
        fa.flash_attention_fwd_kernel(q[:, :, :3].contiguous(), k, v)
    q128, k128, v128 = _qkv(1, 64, 2, 2, 128, torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention_fwd_kernel(q128, k128, v128)
