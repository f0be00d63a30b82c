"""The port's kernel modules on the CPU against the JAX package's kernels.

On CPU tensors each wrapper of ``repro_torch.kernels`` runs its plain
PyTorch version, so these tests hold the plain versions (the arithmetic
the Hopper kernels are checked against on the card, in
``tests/test_torch_gpu.py``) against the Pallas kernels run in interpret
mode, as ``repro.kernels.ops._interpret`` picks on the CPU. Inputs come
from numpy with a seed and reach both sides as the same bits.

Tolerances. fp32 outputs: XLA and PyTorch evaluate the momentum EMA and the
column sum of squares with other instruction choices and summation orders,
which moves results by an ulp or two: rtol 1e-6 plus an atol of 1e-7 for
values near 0. bf16 outputs round those fp32 values once, so where a value
straddles a rounding boundary they differ by one bf16 step, at most 2^-7
relative. Attention sums softmax terms tile by tile in both, in other
orders: fp32 rtol 1e-5 / atol 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.flash_attention import flash_attention as jax_flash_attention
from repro_torch.interop import to_numpy, to_tensor
from repro_torch.kernels import LAUNCHES, ops, reset_launches
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import rmnp_update as rm
from repro_torch.kernels.ref import chunked_attention_ref

FP32 = dict(rtol=1e-6, atol=1e-7)
BF16 = dict(rtol=2.0 ** -7, atol=1e-7)


def _assert_close(jax_out, torch_out, tol=None):
    want = np.asarray(jax_out)
    assert str(torch_out.dtype).split(".")[1] == want.dtype.name
    if tol is None:
        tol = BF16 if want.dtype.name == "bfloat16" else FP32
    np.testing.assert_allclose(to_numpy(torch_out), want.astype(np.float32), **tol)


def _rmnp_inputs(shape, vdt, wdt, seed):
    rng = np.random.default_rng(seed)
    g = rng.standard_normal(shape).astype(np.float32)
    v = np.asarray(jnp.asarray(rng.standard_normal(shape), jnp.float32).astype(vdt))
    w = np.asarray(jnp.asarray(0.02 * rng.standard_normal(shape), jnp.float32).astype(wdt))
    return g, v, w


SHAPES = [(33, 9), (300, 257), (4, 32, 48)]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("vdt", ["float32", "bfloat16"], ids=["v32", "v16"])
def test_rmnp_precondition_matches_pallas(shape, vdt):
    g, v, _ = _rmnp_inputs(shape, vdt, "bfloat16", seed=len(shape) * 100 + shape[-1])
    jv, jd = jops.rmnp_bucket_update(jnp.asarray(g), jnp.asarray(v), beta=0.9)
    tv, td = ops.rmnp_bucket_update(to_tensor(g), to_tensor(v), beta=0.9)
    _assert_close(jv, tv)
    _assert_close(jd, td)
    tv1, td1 = ops.rmnp_momentum_rownorm(to_tensor(g), to_tensor(v), beta=0.9)
    assert torch.equal(tv1, tv) and torch.equal(td1, td)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("vdt", ["float32", "bfloat16"], ids=["v32", "v16"])
@pytest.mark.parametrize("wdt", ["float32", "bfloat16"], ids=["w32", "w16"])
def test_rmnp_apply_matches_pallas(shape, vdt, wdt):
    g, v, w = _rmnp_inputs(shape, vdt, wdt, seed=shape[0] + shape[-1])
    scale, wd = np.float32(3e-2), 0.1
    jv, jw = jops.rmnp_bucket_update_apply(jnp.asarray(g), jnp.asarray(v), jnp.asarray(w),
                                           jnp.float32(scale), wd, beta=0.9)
    tv, tw = ops.rmnp_bucket_update_apply(to_tensor(g), to_tensor(v), to_tensor(w),
                                          torch.tensor(scale), wd, beta=0.9)
    _assert_close(jv, tv)
    _assert_close(jw, tw)


def test_fan_in_above_jax_kernel_limit():
    """The JAX package sends fan-in above 32768 to its jnp reference; the
    port takes it like any other bucket, with the same result."""
    g, v, w = _rmnp_inputs((33000, 3), "float32", "bfloat16", seed=7)
    jv, jw = jops.rmnp_bucket_update_apply(jnp.asarray(g), jnp.asarray(v), jnp.asarray(w),
                                           jnp.float32(1e-2), 0.1, beta=0.95)
    tv, tw = ops.rmnp_bucket_update_apply(to_tensor(g), to_tensor(v), to_tensor(w),
                                          torch.tensor(1e-2, dtype=torch.float32), 0.1,
                                          beta=0.95)
    _assert_close(jv, tv)
    _assert_close(jw, tw)


def test_cpu_tensors_take_the_plain_version_uncounted():
    g, v, w = (to_tensor(x) for x in _rmnp_inputs((16, 8), "float32", "float32", 3))
    reset_launches()
    ops.rmnp_bucket_update(g, v, beta=0.9)
    ops.rmnp_bucket_update_apply(g, v, w, torch.tensor(1e-3), 0.1, beta=0.9)
    fa.flash_attention_fwd(g.reshape(1, 16, 1, 8), g.reshape(1, 16, 1, 8),
                           g.reshape(1, 16, 1, 8))
    assert all(n == 0 for n in LAUNCHES.values()), LAUNCHES


def test_kernel_wrappers_refuse_cpu_tensors():
    """The wrappers of the kernels themselves never run a plain version."""
    g = torch.zeros(8, 8)
    with pytest.raises(ValueError, match="CUDA"):
        rm.rmnp_rownorm(g, g, beta=0.9)
    with pytest.raises(ValueError, match="CUDA"):
        rm.rmnp_rownorm_apply(g, g, g, torch.zeros(2), beta=0.9)
    q = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_fwd_kernel(q, q, q)


def test_entry_points_refuse_other_devices():
    """Only CPU tensors take the plain versions: a tensor elsewhere raises."""
    g = torch.zeros(8, 8, device="meta")
    with pytest.raises(ValueError, match="meta"):
        ops.rmnp_bucket_update(g, g, beta=0.9)
    with pytest.raises(ValueError, match="meta"):
        ops.rmnp_bucket_update_apply(g, g, g, torch.tensor(1e-3), 0.1, beta=0.9)
    q = torch.zeros(1, 8, 2, 16, device="meta")
    with pytest.raises(ValueError, match="meta"):
        fa.flash_attention_fwd(q, q, q)


# (B, S, H, K, hd, hdv, block, dtype): G = H // K query heads per kv head;
# hd 96 as phi3-mini's (96, 96) and minicpm3's MLA (96, 64), v its own width
ATTN = [(1, 32, 2, 2, 16, 16, 16, "float32"),
        (1, 32, 4, 2, 16, 16, 16, "float32"),
        (1, 32, 4, 2, 8, 8, 32, "bfloat16"),
        (1, 32, 4, 2, 96, 96, 16, "float32"),
        (1, 32, 4, 2, 96, 96, 16, "bfloat16"),
        (1, 32, 4, 2, 96, 64, 16, "float32"),
        (1, 32, 2, 2, 96, 64, 16, "bfloat16")]
IDS = ["g1", "g2", "g2_bf16", "hd96_g2", "hd96_g2_bf16", "hd96_hdv64_g2", "hd96_hdv64_bf16"]
# fp32 at every head-dim pair wider than 64 that the fp32 kernel builds: qwen3-4b's
# hd 128 with G = 4, phi3-mini's 96, MLA's (96, 64) and (192,
# 128), paligemma's 256 on one kv head (G = 8); "ragged": S = 45, one block
# of 45 rows (no multiple of 8 or 16); hd 128 at S = 32 in blocks of 16
ATTN += [(1, 32, 8, 2, 128, 128, 16, "float32"), (1, 45, 4, 4, 96, 96, 512, "float32"),
         (1, 45, 4, 2, 96, 64, 512, "float32"), (1, 45, 4, 2, 192, 128, 512, "float32"),
         (1, 45, 8, 1, 256, 256, 512, "float32")]
IDS += ["hd128_g4_fp32", "hd96_ragged_fp32", "hd96_hdv64_g2_ragged_fp32",
        "hd192_hdv128_g2_ragged_fp32", "hd256_g8_ragged_fp32"]


@pytest.mark.parametrize("case", ATTN, ids=IDS)
def test_flash_attention_matches_pallas(case):
    """Forward: the torch chunked oracle and the port's autograd Function
    (plain version on the CPU) against ``flash_attention_fwd`` in interpret
    mode. Backward: the Function's gradients against ``jax.vjp`` of the
    JAX custom-VJP wrapper, for the same cotangent."""
    B, S, H, K, hd, hdv, blk, dt = case
    rng = np.random.default_rng(S * H + K)
    q, k, v, ct = (np.asarray(jnp.asarray(rng.standard_normal((B, S, h, d)),
                                          jnp.float32).astype(dt))
                   for h, d in ((H, hd), (K, hd), (K, hdv), (H, hdv)))
    out, vjp = jax.vjp(lambda a, b, c: jax_flash_attention(a, b, c, True, blk, blk, True),
                       jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    grads = vjp(jnp.asarray(ct))

    tq, tk, tv = (to_tensor(x).requires_grad_(True) for x in (q, k, v))
    t_out = fa.flash_attention(tq, tk, tv, True, blk, blk)
    t_grads = torch.autograd.grad(t_out, (tq, tk, tv), to_tensor(ct))
    tol = BF16 if dt == "bfloat16" else dict(rtol=1e-5, atol=1e-6)
    _assert_close(out, t_out.detach(), tol)
    _assert_close(out, chunked_attention_ref(tq.detach(), tk.detach(), tv.detach(),
                                             chunk_q=blk, chunk_k=blk), tol)
    for want, got in zip(grads, t_grads, strict=True):
        if dt == "bfloat16" and hd == 96:
            # each package rounds p, dp and ds to bf16 at its own places
            # and sums 32 keys (and G heads, for dk and dv) of such terms:
            # an element that comes out of cancellation lands a few bf16
            # steps of its own from the other's (measured 1.8 steps on dk,
            # 1.04 on dq, both under 6e-4 of the largest element), so
            # beside one step of itself it may differ by 2^-8 of the
            # largest; the forward holds the per-element limit above
            tol = dict(BF16, atol=2.0 ** -8 * float(np.abs(np.asarray(want, np.float32)).max()))
        elif hd == 256:
            # paligemma's G = 8: dk and dv each sum 8 heads' terms, every
            # term a dot product over 256 columns, in each package's own
            # fp32 order; they differ by up to 2e-6 at magnitude 3
            # (measured 1.97e-6 on 3 of 8192 elements), so beside 1e-5 of
            # itself an element may differ by 2e-6 of the largest, the fp32
            # bound of tests/test_torch_serve.py
            tol = dict(rtol=1e-5, atol=2e-6 * float(np.abs(np.asarray(want)).max()))
        _assert_close(want, got, tol)
