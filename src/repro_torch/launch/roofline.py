"""The card's peaks, the model's useful work and the kernels' bounds
(counterpart of ``repro.launch.roofline`` and ``repro.launch.dryrun.
model_flops``).

A bound is the least time the card could take for a piece of work: the
larger of its bytes (each input read once, each output written once) over
the memory rate and its operations over the peak rate of the units that run
them. The peaks are NVIDIA's data sheet for the H100 SXM5 80GB HBM3 at its
700 W power limit, dense rates without sparsity; a card set below 700 W runs
slower under load, so a share of these peaks is stated beside the card's
power limit.

One card has no collective term: the JAX package's roofline divides its
collective bytes by the TPU's link rate, and the port's ZeRO-2 group on one
card moves nothing over a link.

``chip_smoke.py`` imports the bound formulas from here: ``rmnp_bytes``,
``attention_flops``, ``attention_bounds`` and ``gemm_bound``.
"""
from __future__ import annotations

import math

from repro_torch.configs.base import ModelConfig, ShapeConfig

# H100 SXM5 80GB HBM3 at 700 W (NVIDIA's data sheet, dense)
HBM_BW = 3.35e12              # bytes/s
PEAK_FLOPS_BF16 = 989e12      # bf16 on the tensor cores
PEAK_FLOPS_TF32 = 495e12      # TF32 on the tensor cores
PEAK_FLOPS_FP32 = 67e12       # fp32 FFMA outside the tensor cores
CARD = "NVIDIA H100 80GB HBM3, 700 W"


def active_params(cfg: ModelConfig) -> float:
    """Matmul-active parameter count (MoE: routed experts scaled by
    top_k / E); an untied embedding is a gather and counts nothing."""
    from repro_torch.core.types import tree_paths
    from repro_torch.models.model import build_param_specs

    moe_frac = cfg.moe.top_k / cfg.moe.num_experts if cfg.moe else 1.0
    total = 0.0
    for keys, sp in tree_paths(build_param_specs(cfg)):
        n = math.prod(sp.shape)
        if "embed" in keys and not cfg.tie_embeddings:
            continue
        if (("ffn/w_in" in keys or "ffn/w_out" in keys) and cfg.moe
                and len(sp.shape) >= 3 and sp.shape[-3] == cfg.moe.num_experts):
            n *= moe_frac
        total += n
    return total


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """6 * N_active * D (training) or 2 * N_active * D (per-token inference)."""
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * active_params(cfg) * tokens


def rmnp_bytes(shape, v_bytes, w_bytes, apply):
    n = math.prod(shape)
    out = w_bytes * 2 if apply else 4  # w read + written, or d written
    return n * (4 + 2 * v_bytes + out)


def attention_flops(B, S, H, hd, causal=True, hdv=None, pv_parts=1):
    """Q.K^T over hd and P.V over hdv (``pv_parts`` products, as the bf16
    kernel's three parts of P) for each (query, key) pair attended."""
    pairs = S * (S + 1) // 2 if causal else S * S  # causal: the lower triangle
    return 2 * B * H * pairs * (hd + pv_parts * (hdv or hd))


def attention_bounds(B, S, H, K, hd, dtype, causal, hdv=None):
    """(bound_ms, bound_by, ffma_ms or None): q/k/v read once and the output
    written once over the memory rate, against the FLOP at the peak of the
    units the kernel runs them on: bf16 on the tensor cores; fp32 as three
    TF32 products per fp32 product on the tensor cores (3xTF32). For fp32
    also the same with the FLOP at the CUDA cores' FFMA rate, for the
    record only. ``hdv``: v's and the output's head dim, if not hd."""
    import torch
    hdv = hdv or hd
    size = 2 if dtype == torch.bfloat16 else 4
    t_bytes = (B * S * H * (hd + hdv) + B * S * K * (hd + hdv)) * size / HBM_BW * 1e3
    flops = attention_flops(B, S, H, hd, causal, hdv)
    t_ops = (flops / PEAK_FLOPS_BF16 if size == 2 else 3 * flops / PEAK_FLOPS_TF32) * 1e3
    ffma = None if size == 2 else max(flops / PEAK_FLOPS_FP32 * 1e3, t_bytes)
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations", ffma


def gemm_bound(L, M, N, K, reads):
    """(bound_ms, bound_by, ffma_ms) of one GEMM launch: ``reads`` input
    elements read once and the (L, M, N) output written once over the
    memory rate, against the 2MNK FLOP as the kernel runs them, three TF32
    products per fp32 product at the TF32 tensor-core rate (3xTF32); and,
    for the record only, the same with 2MNK FLOP plus the epilogue at the
    fp32 CUDA-core (FFMA) rate."""
    t_ops = 3 * L * 2 * M * N * K / PEAK_FLOPS_TF32 * 1e3
    t_bytes = 4 * (reads + L * M * N) / HBM_BW * 1e3
    t_ffma = max(L * (2 * M * N * K + 3 * M * N) / PEAK_FLOPS_FP32 * 1e3, t_bytes)
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes", t_ffma
