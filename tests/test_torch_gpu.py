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
(The bf16 attention kernel keeps p to fp32 accuracy on the tensor cores
by splitting it into three bf16 parts, and the fp32 attention kernel runs
every product as three TF32 products; see their sources.)
The fp32 GEMM sums 3xTF32 products (each operand split into two TF32
parts, three tensor-core products per fp32 product) in slabs of 32, adding
slabs and chunks of K in fp32, an order other than cuBLAS's: both are held
against a float64 product at the classic bound of a K-term fp32 sum,
K * 2^-24 * (|alpha| |A| |B| + |beta| |C|) per element, plus one rounding of
each epilogue operation and of each split-K chunk added.
"""
import pytest
import torch

from repro_torch.kernels import LAUNCHES, reset_launches
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import matmul as mm
from repro_torch.kernels import newton_schulz as nsk
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


# the four gpt2-small buckets, a ragged small bucket and a ragged 2-D leaf;
# llama-130m's 2048x768 bucket (split K = 6); a tall narrow leaf that takes
# C = 8, and one tall enough for the two-sweep path
SHAPES = [(48, 768, 768), (12, 768, 6144), (12, 3072, 768), (1, 50432, 768),
          (3, 33, 9), (300, 257), (12, 2048, 768), (1, 60000, 24), (1, 120000, 8)]


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


@pytest.mark.parametrize("shape", [(48, 768, 768), (7, 300, 257), (12, 2048, 768),
                                   (2, 60000, 24), (2, 120000, 8)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("apply", [False, True], ids=["precondition", "apply"])
def test_rmnp_stack_equals_slices_bitwise(cuda, shape, apply):
    """A stacked launch gives each slice the bits of that slice launched
    alone: the per-leaf engine (one launch per leaf) and the bucketed
    engines (one per stack) see the same numbers."""
    g, v, w, scalars = _rmnp_inputs(shape, torch.float32, torch.bfloat16)

    def run(g, v, w):
        if apply:
            return rm.rmnp_rownorm_apply(g, v, w, scalars, beta=0.95)
        return rm.rmnp_rownorm(g, v, beta=0.95)

    stacked = run(g, v, w)
    for i in range(shape[0]):
        one = run(g[i:i + 1], v[i:i + 1], w[i:i + 1])
        for a, b in zip(stacked, one, strict=True):
            assert torch.equal(a[i], b[0]), i


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_rmnp_apply_equals_precondition_then_eager_ops_bitwise(cuda, shape):
    """fp32 momentum and weights: the apply kernel's (v_new, w_new) equal the
    precondition kernel's v_new and ``w + (-scale) * (d + wd * w)`` taken
    by eager PyTorch from its d, the two-pass engine's ops
    (``core/engine.py``, ``core/types.apply_updates``), bit for bit."""
    g, v, w, scalars = _rmnp_inputs(shape, torch.float32, torch.float32)
    v_apply, w_apply = rm.rmnp_rownorm_apply(g, v, w, scalars, beta=0.95)
    v_pre, d = rm.rmnp_rownorm(g, v, beta=0.95)
    scale, wd = scalars[0], 0.1
    upd = -scale * (d + wd * w)
    assert torch.equal(v_apply, v_pre)
    assert torch.equal(w_apply, w + upd)


def test_rmnp_engines_bitwise_equal_on_the_card(cuda):
    """Reduced gpt2 in fp32 on the card, three steps from one CPU init:
    the per-leaf engine (precondition kernel per leaf, eager update), the
    bucketed engine (precondition kernel per bucket) and the single-pass
    engine (apply kernel per bucket) give the same parameters bit for bit,
    the card's counterpart of the CPU test in test_torch_optim.py."""
    from repro_torch.configs import get_config
    from repro_torch.core import apply_updates, cosine_with_warmup, make_optimizer
    from repro_torch.core.types import tree_map, tree_paths
    from repro_torch.models import init_params

    cfg = get_config("gpt2-small").reduced()
    init = init_params(cfg, seed=0, device="cpu")
    gen = torch.Generator().manual_seed(1)
    grads = [tree_map(lambda p: (0.01 * torch.randn(p.shape, generator=gen)).to("cuda"),
                      init) for _ in range(3)]
    engines = {"per-leaf": dict(fused=False, fused_apply=False),
               "bucketed": dict(fused=True, fused_apply=False),
               "single-pass": dict(fused=True, fused_apply=True)}
    results, launches = {}, {}
    for name, engine in engines.items():
        opt = make_optimizer("rmnp", dict(lr_matrix=cosine_with_warmup(2e-2, 3),
                                          lr_adamw=cosine_with_warmup(1e-2, 3),
                                          use_kernel=True, **engine))
        params = tree_map(lambda t: t.to("cuda"), init)
        state = opt.init(params)
        reset_launches()
        for step, g in enumerate(grads):
            if opt.update_apply is not None:
                params, state = opt.update_apply(g, state, params, step)
            else:
                updates, state = opt.update(g, state, params, step)
                params = apply_updates(params, updates)
        launches[name] = (LAUNCHES["rmnp_precondition"], LAUNCHES["rmnp_apply"])
        results[name] = dict(tree_paths(params))
    assert launches["per-leaf"][0] > launches["bucketed"][0] > 0
    assert launches["single-pass"][1] > 0
    for name in ("bucketed", "single-pass"):
        for path, t in results[name].items():
            assert torch.equal(t, results["per-leaf"][path]), (name, path)


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


# (name, B, S, H, K, hd, dtype, causal): both types run on the tensor
# cores; the main path's shape causal and not, GQA with a ragged S, hd 32
# and 16 with G = 4, and ragged S around the key tiles, in each type; bf16
# also at hd 128 (qwen3-4b's heads, G = 4)
ATTN = [("gpt2_small", 8, 1024, 12, 12, 64, torch.bfloat16, True),
        ("gpt2_small_noncausal", 8, 1024, 12, 12, 64, torch.bfloat16, False),
        ("gqa_ragged", 2, 1000, 8, 2, 64, torch.bfloat16, True),
        ("gqa_ragged_noncausal", 2, 1000, 8, 2, 64, torch.bfloat16, False),
        ("gqa_ragged_fp32", 2, 1000, 8, 2, 64, torch.float32, True),
        ("hd32", 1, 130, 4, 4, 32, torch.float32, True),
        ("hd32_g4", 2, 1024, 8, 2, 32, torch.bfloat16, True),
        ("hd16_g4", 1, 77, 8, 2, 16, torch.bfloat16, True),
        ("hd16_g4_s1000", 2, 1000, 8, 2, 16, torch.bfloat16, True)]
ATTN += [(f"s{S}", 2, S, 8, 2, 64, torch.bfloat16, True) for S in (1, 63, 65, 129)]
ATTN += [("hd128_g4", 2, 1024, 32, 8, 128, torch.bfloat16, True),
         ("hd128_g4_ragged_noncausal", 2, 1000, 8, 2, 128, torch.bfloat16, False),
         ("hd128_s65", 2, 65, 8, 2, 128, torch.bfloat16, True)]
# bf16 at hd 96, phi3-mini-3.8b's heads (H = K = 32 at its prefill shape)
ATTN += [("hd96_phi3_prefill", 8, 1024, 32, 32, 96, torch.bfloat16, True),
         ("hd96_g2_ragged_noncausal", 2, 1000, 8, 4, 96, torch.bfloat16, False),
         ("hd96_s65", 2, 65, 8, 8, 96, torch.bfloat16, True),
         ("hd96_s1", 2, 1, 8, 8, 96, torch.bfloat16, True)]
# bf16 at hd 256, paligemma-3b's heads (H = 8 on K = 1)
ATTN += [("hd256_g8", 2, 1024, 8, 1, 256, torch.bfloat16, True),
         ("hd256_g8_ragged_noncausal", 2, 1000, 8, 1, 256, torch.bfloat16, False),
         ("hd256_s65", 2, 65, 8, 1, 256, torch.bfloat16, True),
         ("hd256_s1", 2, 1, 8, 1, 256, torch.bfloat16, True)]
ATTN += [("gpt2_small_fp32", 8, 1024, 12, 12, 64, torch.float32, True),
         ("gpt2_small_fp32_noncausal", 8, 1024, 12, 12, 64, torch.float32, False),
         ("gqa_ragged_fp32_noncausal", 2, 1000, 8, 2, 64, torch.float32, False),
         ("hd32_g4_fp32", 2, 1024, 8, 2, 32, torch.float32, True),
         ("hd16_g4_fp32", 2, 1000, 8, 2, 16, torch.float32, True)]
ATTN += [(f"s{S}_fp32", 2, S, 8, 2, 64, torch.float32, True) for S in (1, 63, 65, 129)]
# fp32 at the wide builds' hd 128, 96 and 256: qwen3-4b's, phi3-mini's and
# paligemma-3b's prefill shapes, a ragged S non-causal, and S around the
# 64-key tile and the 64- and 128-row query tiles (MLA's pairs: MLA_ATTN)
ATTN += [("hd128_qwen3_prefill_fp32", 8, 1024, 32, 8, 128, torch.float32, True),
         ("hd128_qwen3_prefill_fp32_noncausal", 8, 1024, 32, 8, 128, torch.float32, False),
         ("hd128_g4_ragged_noncausal_fp32", 2, 1000, 8, 2, 128, torch.float32, False),
         ("hd96_phi3_prefill_fp32", 8, 1024, 32, 32, 96, torch.float32, True),
         ("hd96_g2_ragged_noncausal_fp32", 2, 1000, 8, 4, 96, torch.float32, False),
         ("hd256_paligemma_prefill_fp32", 8, 1024, 8, 1, 256, torch.float32, True),
         ("hd256_g8_ragged_noncausal_fp32", 2, 1000, 8, 1, 256, torch.float32, False)]
ATTN += [(f"hd{hd}_s{S}_fp32", 2, S, 8, K, hd, torch.float32, True)
         for hd, K in ((128, 2), (96, 8), (256, 1)) for S in (1, 63, 65, 129)]


def _qkv(B, S, H, K, hd, dt, requires_grad=False, seed=1):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    out = []
    for heads in (H, K, K):
        x = torch.randn(B, S, heads, hd, generator=gen, device="cuda").to(dt)
        out.append(x.requires_grad_(requires_grad))
    return out


@pytest.mark.parametrize("case", ATTN, ids=[c[0] for c in ATTN])
def test_flash_forward_matches_plain(cuda, case):
    _, B, S, H, K, hd, dt, causal = case
    q, k, v = _qkv(B, S, H, K, hd, dt)
    out = fa.flash_attention_fwd_kernel(q, k, v, causal=causal)
    ref = fa.flash_attention_fwd_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    if dt == torch.float32 and hd > 64:
        # the wide builds, held as phase B holds them: 1e-5 of each
        # element plus 1e-6 of the largest (the plain version's own fp32
        # error on near-zero elements of a 96- to 256-long dot product
        # reaches 1e-6 absolute); the float64 check below is the kernel's
        assert _ratio(out, ref) <= 1.0
    else:
        _close(out, ref)
    if dt == torch.float32:
        # also against a float64 softmax at the per-element fp32 limit, so
        # that a miss is the kernel's and not the plain version's
        assert _ratio(out, _exact_attention(q, k, v, causal)) <= 1.0


def test_flash_two_launches_give_identical_bits(cuda):
    """The kernels use no atomics: the same input gives the same bits."""
    for dt, hd in ((torch.bfloat16, 64), (torch.float32, 64), (torch.bfloat16, 96),
                   (torch.float32, 128), (torch.float32, 256)):
        q, k, v = _qkv(8, 1024, 12, 12, hd, dt)
        first = fa.flash_attention_fwd_kernel(q, k, v)
        second = fa.flash_attention_fwd_kernel(q, k, v)
        assert torch.equal(first, second), dt


def test_flash_fp32_seed_sweep(cuda):
    """Near-zero elements of non-causal rows over ~1000 keys are where the
    3xTF32 sums show: 40 seeds of one GQA head config, every element held
    at 1e-5 of itself plus 1e-6 of the largest against a float64 softmax
    (chip_smoke.py phase B). Not against the plain version: its own fp32
    error reaches 0.96 of that limit on these elements (PERF.md, PR 17);
    its reading is printed beside the kernel's."""
    over, report = [], []
    # 40 seeds at hd 64; 10 at each wide build (v MLA's strided slice
    # where hdv != hd), G = 4 where its models group heads
    sweeps = [(64, 64, 1, 40)] + [(hd, hdv, kv, 10) for hd, hdv, kv in (
        (128, 128, 1), (96, 96, 4), (96, 64, 4), (192, 128, 4), (256, 256, 1))]
    for hd, hdv, kv_heads, n in sweeps:
        for seed in range(n):
            if hdv == hd:
                q, k, v = _qkv(1, 1000, 4, kv_heads, hd, torch.float32, seed=100 + seed)
            else:
                q, k, v = _mla_qkv(1, 1000, 4, seed=100 + seed, hd=hd, hdv=hdv,
                                   dt=torch.float32)
            got = fa.flash_attention_fwd_kernel(q, k, v, causal=False)
            want = fa.flash_attention_fwd_plain(q, k, v, causal=False)
            exact = _exact_attention(q, k, v)
            report.append(((hd, hdv), seed, _ratio(got, exact), _ratio(want, exact),
                           _ratio(got, want)))
            if report[-1][2] > 1.0:
                over.append(report[-1][:2])
    print("(hd, hdv), seed, kernel/float64, plain/float64, kernel/plain:", report)
    assert not over


def _ratio(got, want):
    """Worst ratio of |got - want| to 1e-5 |want| + 1e-6 max|want|."""
    lim = 1e-6 * want.abs().max() + 1e-5 * want.abs()
    return float(((got.double() - want.double()).abs() / lim).max())


def _exact_attention(q, k, v, causal=False):
    """Softmax attention in float64, kv head h // G."""
    G = q.shape[2] // k.shape[2]
    qd, kd, vd = (x.double().transpose(1, 2) for x in (q, k, v))
    kd, vd = kd.repeat_interleave(G, 1), vd.repeat_interleave(G, 1)
    s = qd @ kd.transpose(-1, -2) / q.shape[-1] ** 0.5
    if causal:
        S = q.shape[1]
        s = s.masked_fill(torch.ones(S, S, dtype=torch.bool, device=q.device).triu(1),
                          float("-inf"))
    return (torch.softmax(s, -1) @ vd).transpose(1, 2)


def test_flash_fp32_rejects_a_misaligned_view(cuda):
    """The fp32 kernel reads rows in 16-byte loads; a contiguous view 4 bytes
    into a buffer is refused."""
    q, k, v = _qkv(1, 64, 4, 2, 64, torch.float32)
    flat = torch.empty(q.numel() + 1, dtype=torch.float32, device="cuda")
    shifted = flat[1:].view(q.shape)
    shifted.copy_(q)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    with pytest.raises(ValueError, match="aligned"):
        fa.flash_attention_fwd_kernel(shifted, k, v)


def test_reduced_fp32_gpt2_flash_step_matches_the_cpu(cuda):
    """Reduced gpt2 (fp32) with attn_impl="pallas": one RMNP train step on
    the card (the fp32 flash kernel, one launch a layer) and on the CPU (its
    plain version) from one CPU init give losses within 1e-4."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core import cosine_with_warmup, make_optimizer
    from repro_torch.core.types import tree_map
    from repro_torch.data.pipeline import make_stream
    from repro_torch.launch.train import batch_to_device
    from repro_torch.models import init_params
    from repro_torch.train.step import make_train_step

    cfg = dataclasses.replace(get_config("gpt2-small").reduced(), attn_impl="pallas")
    assert cfg.dtype == "float32"
    init = init_params(cfg, seed=0, device="cpu")
    batch = make_stream(cfg, 64, 4, seed=0).sample(0)
    losses = {}
    for device in ("cuda", "cpu"):
        opt = make_optimizer("rmnp", dict(lr_matrix=cosine_with_warmup(2e-3, 3),
                                          lr_adamw=cosine_with_warmup(1e-3, 3),
                                          fused=True, fused_apply=True))
        params = tree_map(lambda t, d=device: t.to(d), init)
        step_fn = make_train_step(cfg, opt, remat="none")
        reset_launches()
        _, _, metrics = step_fn(params, opt.init(params), batch_to_device(batch, device), 0)
        losses[device] = float(metrics["loss"])
        assert LAUNCHES["flash_attention_fwd"] == (cfg.num_layers if device == "cuda" else 0)
    assert abs(losses["cuda"] - losses["cpu"]) <= 1e-4, losses


def test_flash_bf16_rejects_a_misaligned_view(cuda):
    """TMA needs 16-byte aligned bases; a contiguous view 2 bytes into a
    buffer is refused, not sent to another path."""
    q, k, v = _qkv(1, 64, 4, 2, 64, torch.bfloat16)
    flat = torch.empty(q.numel() + 1, dtype=torch.bfloat16, device="cuda")
    shifted = flat[1:].view(q.shape)
    shifted.copy_(q)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    with pytest.raises(ValueError, match="aligned"):
        fa.flash_attention_fwd_kernel(shifted, k, v)
    with pytest.raises(ValueError, match="aligned"):
        fa.flash_attention_fwd(shifted, k, v)


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
    # hd 128 and hd 96 are built for both types, and hd 80 for neither
    q128, k128, v128 = _qkv(1, 64, 2, 2, 128, torch.float32)
    assert fa.flash_attention_fwd_kernel(q128, k128, v128).shape == (1, 64, 2, 128)
    q96, k96, v96 = _qkv(1, 64, 2, 2, 96, torch.bfloat16)
    assert fa.flash_attention_fwd_kernel(q96, k96, v96).shape == (1, 64, 2, 96)
    assert fa.flash_attention_fwd_kernel(q96.float(), k96.float(),
                                         v96.float()).shape == (1, 64, 2, 96)
    q80, k80, v80 = _qkv(1, 64, 2, 2, 80, torch.bfloat16)
    for dt in (torch.bfloat16, torch.float32):
        with pytest.raises(ValueError, match="head dim"):
            fa.flash_attention_fwd_kernel(q80.to(dt), k80.to(dt), v80.to(dt))


# (L, M, N, K, B transposed, C given, alpha, beta): the Newton-Schulz launch
# kinds (Gram: B = X^T; polynomial: C = G, alpha = c, beta = b; apply:
# alpha = 1, beta = a) at tile-sized and ragged shapes, and the plain product
GEMMS = [(1, 128, 128, 128, False, False, 1.0, 0.0),
         (3, 100, 300, 77, True, False, 1.0, 0.0),
         (2, 129, 129, 129, False, True, 2.0315, -4.7750),
         (4, 100, 300, 100, False, True, 1.0, 3.4445),
         (2, 7, 5, 3, True, True, -0.5, 2.0),
         (1, 64, 1000, 33, False, False, 0.25, 0.0),
         (1, 40, 40, 9000, True, False, 1.0, 0.0),
         (2, 130, 40, 5000, False, True, 2.0315, -4.7750)]


def _gemm_operands(L, M, N, K, trans_b, with_c, seed=2):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    a = torch.randn(L, M, K, generator=gen, device="cuda")
    b = (torch.randn(L, N, K, generator=gen, device="cuda").transpose(1, 2) if trans_b
         else torch.randn(L, K, N, generator=gen, device="cuda"))
    c = None
    if with_c:  # with a transposed B, C is a transposed view too
        c = (torch.randn(L, N, M, generator=gen, device="cuda").transpose(1, 2) if trans_b
             else torch.randn(L, M, N, generator=gen, device="cuda"))
    return a, b, c


def _gemm_bound(a, b, c, alpha, beta):
    """Per-element bound of an fp32 result against the float64 product; K
    above ``mm.K_CHUNK`` adds one rounding per chunk."""
    K = a.shape[-1]
    mag = abs(alpha) * (a.double().abs() @ b.double().abs())
    if c is not None:
        mag = mag + abs(beta) * c.double().abs()
    return (K + 2 + -(-K // mm.K_CHUNK)) * 2.0 ** -24 * mag + 1e-30


@pytest.mark.parametrize("case", GEMMS, ids=lambda c: "x".join(map(str, c[:4]))
                         + ("_bt" if c[4] else "") + ("_c" if c[5] else ""))
def test_gemm_matches_plain(cuda, case):
    L, M, N, K, trans_b, with_c, alpha, beta = case
    a, b, c = _gemm_operands(L, M, N, K, trans_b, with_c)
    got = mm.gemm(a, b, c, alpha=alpha, beta=beta)
    plain = mm.gemm_plain(a, b, c, alpha=alpha, beta=beta)
    want = alpha * (a.double() @ b.double())
    if c is not None:
        want = want + beta * c.double()
    torch.cuda.synchronize()
    assert got.shape == (L, M, N) and got.is_contiguous()
    bound = _gemm_bound(a, b, c, alpha, beta)
    for out in (got, plain):
        assert torch.isfinite(out).all()
        assert ((out.double() - want).abs() <= bound).all()


def _within_bound(got, a, b, c, alpha, beta):
    want = alpha * (a.double() @ b.double())
    if c is not None:
        want = want + beta * c.double()
    return bool(((got.double() - want).abs() <= _gemm_bound(a, b, c, alpha, beta)).all())


def test_gemm_two_launches_give_identical_bits(cuda):
    """No atomics decide the order of a sum: a split-K tile (the chunks
    added by whichever block arrives last) and a stack give the same bits
    twice."""
    for L, M, N, K in ((1, 768, 768, 768), (1, 130, 40, 9000), (4, 300, 200, 1000)):
        a, b, c = _gemm_operands(L, M, N, K, False, True)
        first = mm.gemm(a, b, c, alpha=2.0315, beta=-4.7750)
        second = mm.gemm(a, b, c, alpha=2.0315, beta=-4.7750)
        assert torch.equal(first, second), (L, M, N, K)


def test_gemm_small_polynomial_schedule(cuda):
    """The 2-D 768 x 768 polynomial (36 output tiles) runs a block per
    (tile, chunk), 3 chunks of 256: held against float64 at the bound."""
    assert mm.k_chunk(768, 768, 768) == 256
    assert mm.split_blocks(1, 768, 768, 768, 256)
    assert not mm.split_blocks(48, 768, 768, 768, 256)
    gen = torch.Generator(device="cuda").manual_seed(4)
    x = torch.randn(1, 768, 768, generator=gen, device="cuda")
    g = x @ x.transpose(1, 2) / 768
    got = mm.gemm(g, g, g, alpha=2.0315, beta=-4.7750, count="ns_poly")
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert _within_bound(got, g, g, g, 2.0315, -4.7750)


def _strided(kind, gen):
    """Operands of one launch kind, each a view whose rows are not packed:
    a column window of a wider buffer, so no stride is the packed one."""
    def window(L, rows, cols):
        return torch.randn(L, rows, cols + 24, generator=gen, device="cuda")[:, :, 5:5 + cols]
    if kind == "gram_b_transposed":  # B = X^T: k runs along X's unit stride
        x = window(2, 200, 300)
        return x, x.transpose(1, 2), None, 1.0, 0.0
    if kind == "poly_b_n_contiguous":  # A = B = C = G, B read along n
        g = window(2, 200, 200)
        return g, g, g, 2.0315, -4.7750
    if kind == "apply_c_transposed":  # C (and B) read through a transposed view
        p = window(2, 150, 150)
        x = window(2, 300, 150).transpose(1, 2)
        return p, x, x, 1.0, 3.4445
    # a base 4 bytes past a 16-byte boundary, contiguous otherwise
    flat = torch.randn(2 * 100 * 70 + 1, generator=gen, device="cuda")
    a = flat[1:].view(2, 100, 70)
    assert a.data_ptr() % 16
    return a, window(2, 70, 90), None, 0.25, 0.0


@pytest.mark.parametrize("kind", ["gram_b_transposed", "poly_b_n_contiguous",
                                  "apply_c_transposed", "misaligned_base"])
def test_gemm_strided_views(cuda, kind):
    gen = torch.Generator(device="cuda").manual_seed(5)
    a, b, c, alpha, beta = _strided(kind, gen)
    assert not (a.is_contiguous() and b.is_contiguous())
    got = mm.gemm(a, b, c, alpha=alpha, beta=beta)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert _within_bound(got, a, b, c, alpha, beta)


def test_gemm_2d_and_3d_wrappers(cuda):
    a, b, _ = _gemm_operands(3, 100, 60, 40, False, False)
    reset_launches()
    got3 = mm.matmul3(a, b)
    got2 = mm.matmul(a[1], b[1])
    assert LAUNCHES["matmul3"] == 1 and LAUNCHES["matmul"] == 1
    assert torch.equal(got2, got3[1])
    assert torch.equal(ops.matmul(a[1], b[1]), got2)


@pytest.mark.parametrize("shape", [(48, 768, 768), (3, 100, 300), (2, 64, 1000), (2, 64, 9000)],
                         ids=lambda s: "x".join(map(str, s)))
def test_ns_step3_slices_equal_ns_step(cuda, shape):
    gen = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn(shape, generator=gen, device="cuda")
    x = x / torch.linalg.vector_norm(x, dim=(-2, -1), keepdim=True)
    coeffs = (3.4445, -4.7750, 2.0315)
    reset_launches()
    stacked = nsk.ns_step3(x, *coeffs)
    assert (LAUNCHES["matmul3"], LAUNCHES["ns_poly3"]) == (2, 1)
    for i in range(shape[0]):
        assert torch.equal(stacked[i], nsk.ns_step(x[i], *coeffs)), i
    assert (LAUNCHES["matmul"], LAUNCHES["ns_poly"]) == (2 * shape[0], shape[0])
    plain = nsk.ns_step3_plain(x, *coeffs)
    rel = torch.linalg.vector_norm(stacked - plain) / torch.linalg.vector_norm(plain)
    assert rel < 1e-5, rel
    assert torch.equal(ops.ns_step(x.reshape(1, *shape), *coeffs)[0], stacked)


def test_gemm_rejects_what_it_does_not_take(cuda):
    a, b, c = _gemm_operands(2, 16, 8, 4, False, True)
    with pytest.raises(ValueError, match="CUDA"):
        mm.gemm(a.cpu(), b.cpu())
    with pytest.raises(TypeError, match="float32"):
        mm.gemm(a.half(), b)
    with pytest.raises(ValueError, match="b must be"):
        mm.gemm(a, b[:, :3])
    with pytest.raises(ValueError, match="c must be"):
        mm.gemm(a, b, c[:, :3], beta=1.0)
    with pytest.raises(ValueError, match="no c"):
        mm.gemm(a, b, beta=1.0)
    with pytest.raises(ValueError, match="2-D"):
        mm.matmul(a, b)
    with pytest.raises(TypeError, match="float32"):
        nsk.ns_step(a[0].double(), 1.0, 1.0, 1.0)


# ---------------------------------------------------------------------------
# checkpointing and the guard on the card (chip_smoke.py phase R, reduced)
# ---------------------------------------------------------------------------

def _bits(t):
    t = t.detach().cpu()
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy().tobytes()


def _same_bits(a, b):
    from repro_torch.core.types import tree_paths
    pa, pb = tree_paths(a), tree_paths(b)
    return [p for p, _ in pa] == [p for p, _ in pb] and all(
        _bits(x) == _bits(y) for (_, x), (_, y) in zip(pa, pb, strict=True))


def _train_card(**kw):
    from repro_torch.launch.train import train
    base = dict(batch=2, seq=64, seed=3, log_every=1, fused=True, fused_apply=True,
                momentum_dtype="bfloat16", steps=6)
    return train("llama-60m", **{**base, **kw})


def test_resume_on_the_card_equals_the_uninterrupted_run_bitwise(cuda, tmp_path):
    """R2 at reduced size: stop at step 3 with an async checkpoint every 3
    steps (pinned buffers, side-stream copy), restart to step 6: params and
    optimizer state equal the uninterrupted run's bit for bit, which needs
    the step itself to be repeatable on the card."""
    p1, s1, _ = _train_card()
    p2, s2, _ = _train_card()
    assert _same_bits((p1, s1), (p2, s2))
    _train_card(stop_at=3, ckpt_dir=str(tmp_path), ckpt_every=3)
    p3, s3, hist = _train_card(ckpt_dir=str(tmp_path), ckpt_every=3)
    assert [h["step"] for h in hist] == [3, 4, 5]
    assert _same_bits((p1, s1), (p3, s3))
    assert all(t.device.type == "cuda" for t in s3.buckets.values())


def test_guard_on_the_card_skips_the_poisoned_step_bitwise(cuda):
    """R3 at reduced size: ``nan:*:2`` under the guard skips step 2, its
    flags name the poisoned leaf, and the final bits equal a clean run that
    skipped step 2's update."""
    from repro_torch.configs import get_config
    from repro_torch.core import cosine_with_warmup, make_optimizer
    from repro_torch.data.pipeline import make_stream
    from repro_torch.launch.train import batch_to_device
    from repro_torch.models import init_params
    from repro_torch.train.step import make_train_step
    p_g, s_g, hist = _train_card(guard=True, inject_fault="nan:*:2")
    assert [h["skipped"] for h in hist] == [0.0, 0.0, 1.0, 0.0, 0.0, 0.0]
    assert [h["action"] for h in hist][2] == "skip"
    cfg = get_config("llama-60m").reduced()
    opt = make_optimizer("rmnp", dict(
        lr_matrix=cosine_with_warmup(2e-3, 6), lr_adamw=cosine_with_warmup(1e-3, 6),
        fused=True, fused_apply=True, momentum_dtype="bfloat16"))
    params = init_params(cfg, seed=3, device="cuda")
    state = opt.init(params)
    step_fn = make_train_step(cfg, opt, remat="none")
    stream = make_stream(cfg, 64, 2, seed=3)
    for t in range(6):
        batch = batch_to_device(next(stream), "cuda")
        if t != 2:
            params, state, _ = step_fn(params, state, batch, t)
    assert _same_bits((params, state), (p_g, s_g))


def test_reduced_qwen3_serving_on_the_card_matches_the_cpu(cuda):
    """Prefill (the fp32 flash kernel, one launch a layer) and 6 decode
    steps of reduced qwen3 with GQA, from one CPU init: the card's greedy
    tokens are the CPU's and every logit agrees to 1e-4 of the largest
    (fp32 matmuls without TF32)."""
    from repro_torch.configs import get_config
    from repro_torch.core.types import tree_map
    from repro_torch.launch.serve import generate
    from repro_torch.models import init_params

    cfg = get_config("qwen3-4b").reduced(n_heads=8, n_kv_heads=2, head_dim=16,
                                         attn_impl="pallas")
    init = init_params(cfg, seed=0, device="cpu")
    prompts = torch.randint(0, cfg.vocab, (2, 40), generator=torch.Generator().manual_seed(1))
    reset_launches()
    card = generate(cfg, tree_map(lambda t: t.to("cuda"), init), prompts.to("cuda"), 7,
                    keep_logits=True)
    assert LAUNCHES["flash_attention_fwd"] == cfg.num_layers
    cpu = generate(cfg, init, prompts, 7, keep_logits=True)
    assert torch.equal(card["tokens"].cpu(), cpu["tokens"])
    for got, want in zip(card["logits"], cpu["logits"], strict=True):
        assert float((got.cpu() - want).abs().max()) <= 1e-4 * float(want.abs().max())
    assert card["peak_bytes"] > 0 and len(card["decode_ms"]) == 6


# MLA's head dims, q/k 192 and v 128 (deepseek-v2-lite's) and q/k 96 and v
# 64 (minicpm3-4b's), v a strided column slice as MLA's is: (name, B, S, H,
# causal[, (hd, hdv)])
MLA_ATTN = [("mla_prefill", 8, 1024, 16, True), ("mla_prefill_noncausal", 8, 1024, 16, False),
            ("mla_ragged", 2, 1000, 16, True), ("mla_ragged_noncausal", 2, 1000, 16, False)]
MLA_ATTN += [(f"mla_s{S}", 2, S, 16, True) for S in (1, 63, 65, 129)]
MLA_ATTN += [("mla96_prefill", 8, 1024, 40, True, (96, 64)),
             ("mla96_noncausal", 2, 1024, 40, False, (96, 64)),
             ("mla96_ragged", 2, 1000, 40, True, (96, 64)),
             ("mla96_s129", 2, 129, 8, True, (96, 64))]
# the same in fp32 (the fp32 kernel reads v through its strides too)
MLA_ATTN += [(f"{name}_fp32", *rest, dims, torch.float32) for name, *rest, dims in (
    ("mla_prefill", 8, 1024, 16, True, (192, 128)),
    ("mla_prefill_noncausal", 8, 1024, 16, False, (192, 128)),
    ("mla_ragged_noncausal", 2, 1000, 16, False, (192, 128)),
    ("mla_s65", 2, 65, 16, True, (192, 128)), ("mla_s1", 2, 1, 16, True, (192, 128)),
    ("mla96_prefill", 8, 1024, 40, True, (96, 64)),
    ("mla96_ragged_noncausal", 2, 1000, 40, False, (96, 64)),
    ("mla96_s129", 2, 129, 8, True, (96, 64)), ("mla96_s63", 2, 63, 8, True, (96, 64)))]


def _mla_qkv(B, S, H, seed=1, hd=192, hdv=128, dt=torch.bfloat16):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k = (torch.randn(B, S, H, hd, generator=gen, device="cuda").to(dt) for _ in range(2))
    kv = torch.randn(B, S, H, 2 * hdv, generator=gen, device="cuda").to(dt)
    return q, k, kv[..., hdv:]


@pytest.mark.parametrize("case", MLA_ATTN, ids=[c[0] for c in MLA_ATTN])
def test_flash_mla_head_dims_match_plain(cuda, case):
    """The (192, 128) and (96, 64) builds against the plain version at one
    bf16 step of each element (fp32: phase B's per-element limit, and a
    float64 softmax at the same limit), and the strided v read in place: a
    contiguous copy gives the same bits; two launches give the same bits."""
    _, B, S, H, causal, *rest = case
    hd, hdv = rest[0] if rest else (192, 128)
    dt = rest[1] if len(rest) > 1 else torch.bfloat16
    q, k, v = _mla_qkv(B, S, H, hd=hd, hdv=hdv, dt=dt)
    assert not v.is_contiguous()
    out = fa.flash_attention_fwd_kernel(q, k, v, causal=causal)
    ref = fa.flash_attention_fwd_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert out.shape == (B, S, H, hdv)
    if dt == torch.float32:  # phase B's limit, as the wide builds' GQA cases
        assert _ratio(out, ref) <= 1.0
    else:
        _close(out, ref)
    assert torch.equal(out, fa.flash_attention_fwd_kernel(q, k, v.contiguous(), causal=causal))
    assert torch.equal(out, fa.flash_attention_fwd_kernel(q, k, v, causal=causal))
    if dt == torch.float32:
        assert _ratio(out, _exact_attention(q, k, v, causal)) <= 1.0


def test_flash_refuses_an_unbuilt_head_dim_pair(cuda):
    """minicpm3-4b's MLA (q/k 96, v 64) and deepseek's (192, 128) are built
    in both types and launch; hd 80 and q/k 192 with v at 192 are built in
    neither: the wrapper raises instead of running a neighbouring
    instantiation. v's strides must be 16-byte multiples (bf16: for its
    tensor map; fp32: for its 16-byte loads)."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    q96, v64, q80 = (torch.randn(1, 64, 2, d, generator=gen, device="cuda").bfloat16()
                     for d in (96, 64, 80))
    q, k, v = _mla_qkv(1, 64, 2)
    for dt in (torch.bfloat16, torch.float32):
        assert fa.flash_attention_fwd_kernel(q96.to(dt), q96.to(dt),
                                             v64.to(dt)).shape == (1, 64, 2, 64)
        assert fa.flash_attention_fwd_kernel(q.to(dt), k.to(dt),
                                             v.to(dt)).shape == (1, 64, 2, 128)
        with pytest.raises(ValueError, match="not built"):
            fa.flash_attention_fwd_kernel(q80.to(dt), q80.to(dt), q80.to(dt))
        with pytest.raises(ValueError, match="not built"):
            fa.flash_attention_fwd_kernel(q.to(dt), k.to(dt), q.to(dt))
    odd = torch.randn(1, 64, 2, 132, generator=gen, device="cuda").bfloat16()[..., 4:]
    with pytest.raises(ValueError, match="strides"):
        fa.flash_attention_fwd_kernel(q, k, odd)
    odd = torch.randn(1, 64, 2, 130, generator=gen, device="cuda")[..., 2:]
    with pytest.raises(ValueError, match="strides"):
        fa.flash_attention_fwd_kernel(q.float(), k.float(), odd)


def test_mla_prefill_runs_the_kernel_once_a_layer(cuda):
    """A reduced deepseek-v2-lite-16b with MLA's full head dims (q/k 128 +
    64, v 128) in bf16 with attn_impl="pallas": the prefill launches the
    (192, 128) kernel once a layer and its last logits agree with dense
    attention's to the bf16 bound of the serving tests (2^-5 of the
    largest, two layers)."""
    import dataclasses

    from repro_torch.configs import MLAConfig, get_config
    from repro_torch.models import init_params
    from repro_torch.train.step import make_prefill_step

    cfg = get_config("deepseek-v2-lite-16b").reduced(
        dtype="bfloat16", attn_impl="pallas",
        mla=MLAConfig(kv_lora_rank=64, qk_nope_head_dim=128, qk_rope_head_dim=64,
                      v_head_dim=128))
    m = cfg.moe
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        m, capacity_factor=m.num_experts / m.top_k))
    params = init_params(cfg, seed=0, device="cuda")
    toks = torch.randint(0, cfg.vocab, (2, 96), device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(1))
    reset_launches()
    flash, _ = make_prefill_step(cfg)(params, {"tokens": toks})
    assert LAUNCHES["flash_attention_fwd"] == cfg.num_layers
    dense, _ = make_prefill_step(dataclasses.replace(cfg, attn_impl="dense"))(
        params, {"tokens": toks})
    assert float((flash.float() - dense.float()).abs().max()) <= \
        2.0 ** -5 * float(dense.float().abs().max())


def test_hd96_prefills_run_the_kernel_once_a_layer(cuda):
    """Reduced minicpm3-4b with MLA's full head dims (q/k 64 + 32, v 64) and
    reduced phi3-mini at its head dim 96, in bf16 with attn_impl="pallas":
    each prefill launches the (96, 64) or (96, 96) kernel once a layer, and
    its last logits agree with dense attention's to the bf16 bound of the
    MLA check above (2^-5 of the largest)."""
    import dataclasses

    from repro_torch.configs import MLAConfig, get_config
    from repro_torch.models import init_params
    from repro_torch.train.step import make_prefill_step

    mla = MLAConfig(q_lora_rank=32, kv_lora_rank=64, qk_nope_head_dim=64, qk_rope_head_dim=32,
                    v_head_dim=64)
    for cfg in (get_config("minicpm3-4b").reduced(mla=mla),
                get_config("phi3-mini-3.8b").reduced(head_dim=96)):
        cfg = dataclasses.replace(cfg, dtype="bfloat16", attn_impl="pallas")
        params = init_params(cfg, seed=0, device="cuda")
        toks = torch.randint(0, cfg.vocab, (2, 96), device="cuda",
                             generator=torch.Generator(device="cuda").manual_seed(1))
        reset_launches()
        flash, _ = make_prefill_step(cfg)(params, {"tokens": toks})
        assert LAUNCHES["flash_attention_fwd"] == cfg.num_layers
        dense, _ = make_prefill_step(dataclasses.replace(cfg, attn_impl="dense"))(
            params, {"tokens": toks})
        assert float((flash.float() - dense.float()).abs().max()) <= \
            2.0 ** -5 * float(dense.float().abs().max())


def test_frontend_prefills_run_the_kernel_once_a_layer(cuda):
    """Reduced paligemma-3b at its full head dim (hd 256, H = 8 on K = 1)
    with its image embeddings, and reduced musicgen-large from audio
    frames, in bf16 with attn_impl="pallas": each prefill launches the
    kernel once a layer, and its last logits agree with dense attention's
    to the bf16 bound of the MLA check above (2^-5 of the largest)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import prompt_batch
    from repro_torch.models import init_params
    from repro_torch.train.step import make_prefill_step

    for cfg in (get_config("paligemma-3b").reduced(n_heads=8, n_kv_heads=1, head_dim=256),
                get_config("musicgen-large").reduced()):
        cfg = dataclasses.replace(cfg, dtype="bfloat16", attn_impl="pallas")
        params = init_params(cfg, seed=0, device="cuda")
        batch = prompt_batch(cfg, 2, 96, 1, "cuda")
        reset_launches()
        flash, _ = make_prefill_step(cfg)(params, batch)
        assert LAUNCHES["flash_attention_fwd"] == cfg.num_layers
        dense, _ = make_prefill_step(dataclasses.replace(cfg, attn_impl="dense"))(params, batch)
        assert float((flash.float() - dense.float()).abs().max()) <= \
            2.0 ** -5 * float(dense.float().abs().max())


# the runs of chip_smoke.py phase K: (rule, optimizer settings, method)
CENSUS = {"rmnp_single_pass": ("rmnp", {"fused_apply": True}, "update_apply"),
          "rmnp_two_pass": ("rmnp", {}, "update"),
          "muon_bucketed": ("muon", {"fused_apply": True}, "update_apply"),
          "forward_flash": None}


@pytest.mark.parametrize("kind", list(CENSUS))
def test_launch_census_on_the_card(cuda, kind):
    """chip_smoke.py phase K on reduced gpt2-small (fp32: the fp32 flash
    kernel at hd 16): the launches recorded on meta tensors, LAUNCHES and
    the profiler's kernel events agree per key, and each event's
    instantiation, grid and block are the recorded launch's."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core import make_optimizer
    from repro_torch.core.types import map_with_path
    from repro_torch.kernels import census, introspect
    from repro_torch.models import init_params
    from repro_torch.models.model import forward
    from repro_torch.train.step import optimizer_launches

    cfg = get_config("gpt2-small").reduced()
    params = init_params(cfg, seed=0, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    if CENSUS[kind] is None:
        cfg = dataclasses.replace(cfg, attn_impl="pallas")
        batch = {"tokens": torch.randint(0, cfg.vocab, (2, 200), generator=gen,
                                         device="cuda", dtype=torch.int32)}

        def fn(p, b):
            with torch.no_grad():
                return forward(cfg, p, b)
        args, n = (params, batch), cfg.num_layers
    else:
        rule, kw, method = CENSUS[kind]
        opt = make_optimizer(rule, dict(lr_matrix=1e-3, fused=True, **kw))
        grads = map_with_path(lambda _p, x: torch.randn(x.shape, generator=gen, device="cuda"),
                              params)
        fn, args = getattr(opt, method), (grads, opt.init(params), params, 0)
        n = optimizer_launches(opt, params)
    predicted = introspect.collect_kernel_launches(fn, *args)
    assert len(predicted) == n > 0
    fn(*args)  # the libraries are built and loaded before the census
    res = census.census(lambda: fn(*args), predicted)
    assert res["ok"], res["mismatches"]
    assert sum(c["profiler"] for c in res["kernels"].values()) == n
