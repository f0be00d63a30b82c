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

The collective term of a group of cards (``roofline_row``) divides the
ring wire bytes of a rank by ``LINK_BW``, NVLink's 450 GB/s each way per
card. That rate holds inside one node of 8 cards joined by NVLink; a group
of 16 or 32 ranks (``launch/mesh.make_production_world``) crosses nodes,
whose network no document in the repo rates, so for such a group the term
is a lower bound and the row says so (``collective_lower_bound``).

``chip_smoke.py`` imports the bound formulas from here: ``rmnp_bytes``,
``attention_flops``, ``attention_bounds``, ``gemm_reads`` and ``gemm_bound``.

``main()`` (counterpart of ``repro.launch.roofline.main``) reads the dry
run's records (``launch/dryrun.py``) and prints each single-world cell's
row, as JSON or (``--markdown``) as a table with a ``fits`` column:

    PYTHONPATH=src python -m repro_torch.launch.roofline --markdown
"""
from __future__ import annotations

import argparse
import json
import math
from pathlib import Path

from repro_torch.configs.base import ModelConfig, ShapeConfig

# H100 SXM5 80GB HBM3 at 700 W (NVIDIA's data sheet, dense)
HBM_BW = 3.35e12              # bytes/s
HBM_BYTES = 80e9              # device memory
PEAK_FLOPS_BF16 = 989e12      # bf16 on the tensor cores
PEAK_FLOPS_TF32 = 495e12      # TF32 on the tensor cores
PEAK_FLOPS_FP32 = 67e12       # fp32 FFMA outside the tensor cores
LINK_BW = 450e9               # NVLink 4, bytes/s each way per card, inside one 8-card node
NODE_CARDS = 8                # cards one NVLink node joins
CARD = "NVIDIA H100 80GB HBM3, 700 W"

# where launch/dryrun.py writes its records and main() reads them
ARTIFACTS = Path(__file__).resolve().parents[3] / "artifacts" / "dryrun"


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


def gemm_reads(*inputs) -> int:
    """The input elements one GEMM launch reads: each input once, where an
    input passed twice, or beside its own transpose (the Gram's X and X^T),
    is one read of one storage."""
    seen = {}
    for t in inputs:
        if t is not None:
            key = (id(t.untyped_storage()), t.storage_offset(),
                   frozenset(zip(t.shape, t.stride())))
            seen[key] = t.numel()
    return sum(seen.values())


def gemm_counts(L, M, N, K, reads):
    """(FLOPs, bytes) of one GEMM launch: the 2MNK product of each of the L
    matrices, and ``reads`` fp32 input elements (``gemm_reads``) read once
    and the (L, M, N) output written once."""
    return 2.0 * L * M * N * K, 4.0 * (reads + L * M * N)


def gemm_bound(L, M, N, K, reads):
    """(bound_ms, bound_by, ffma_ms) of one GEMM launch: its bytes
    (``gemm_counts``) over the memory rate, against its FLOPs as the
    kernel runs them, three TF32 products per fp32 product at the TF32
    tensor-core rate (3xTF32); and, for the record only, the same with the
    FLOPs plus the epilogue at the fp32 CUDA-core (FFMA) rate."""
    flops, nbytes = gemm_counts(L, M, N, K, reads)
    t_ops = 3 * flops / PEAK_FLOPS_TF32 * 1e3
    t_bytes = nbytes / HBM_BW * 1e3
    t_ffma = max(L * (2 * M * N * K + 3 * M * N) / PEAK_FLOPS_FP32 * 1e3, t_bytes)
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes", t_ffma


def unit_seconds(flops_by_unit) -> float:
    """The time of a step's FLOPs, each at the peak of the units that run
    it (``launch/cost.py``'s rule): bf16 products on the tensor cores,
    3xTF32 products as three TF32 products each, the rest at the FFMA
    rate."""
    return (flops_by_unit.get("bf16_tensor_core", 0.0) / PEAK_FLOPS_BF16
            + 3 * flops_by_unit.get("tf32x3_tensor_core", 0.0) / PEAK_FLOPS_TF32
            + flops_by_unit.get("fp32_ffma", 0.0) / PEAK_FLOPS_FP32)


def roofline_row(rec: dict) -> dict:
    """The three terms of one dry-run record (counterpart of
    ``repro.launch.roofline.roofline_row``), all per rank:

        compute    = the FLOPs at their units' peaks (``unit_seconds``)
        memory     = bytes accessed / HBM_BW
        collective = ring wire bytes / LINK_BW

    ``useful_flops_ratio`` is ``model_flops`` (the whole group's) over the
    rank's FLOPs times the world; ``roofline_fraction`` the time the model's
    FLOPs take at the bf16 peak on every rank over the largest term."""
    world = rec["world"]
    cost = rec["cost"]
    t_compute = cost["compute_s"]
    t_memory = cost["bytes_accessed"] / HBM_BW
    t_coll = rec["collective_wire_bytes"] / LINK_BW
    terms = {"compute": t_compute, "memory": t_memory, "collective": t_coll}
    dominant = max(terms, key=terms.get)
    flops_all = cost["flops"] * world
    ideal = rec["model_flops"] / (world * PEAK_FLOPS_BF16)
    step = max(terms.values())
    return {
        "cell": rec["cell"],
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_coll,
        "dominant": dominant,
        "model_flops": rec["model_flops"],
        "useful_flops_ratio": rec["model_flops"] / flops_all if flops_all else 0.0,
        "roofline_fraction": ideal / step if step else 0.0,
        "mem_gib_per_dev": rec["memory"]["bytes_per_device"] / 2**30,
        "fits": rec["memory"]["fits"],
        "collective_lower_bound": rec["collective_lower_bound"],
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dir", default=str(ARTIFACTS))
    ap.add_argument("--markdown", action="store_true")
    args = ap.parse_args(argv)

    rows = []
    for f in sorted(Path(args.dir).glob("*__single.json")):
        rec = json.loads(f.read_text())
        if rec.get("status") != "ok":
            rows.append({"cell": rec["cell"], "skipped": rec.get("reason", "")})
            continue
        rows.append(roofline_row(rec))

    if args.markdown:
        print("| cell | t_comp (s) | t_mem (s) | t_coll (s) | dominant | "
              "useful-FLOPs | roofline frac | GiB/dev | fits |")
        print("|---|---|---|---|---|---|---|---|---|")
        for r in rows:
            if "skipped" in r:
                print(f"| {r['cell']} | — | — | — | skipped | — | — | — | — |")
                continue
            print(f"| {r['cell']} | {r['t_compute_s']:.4f} | {r['t_memory_s']:.4f} | "
                  f"{r['t_collective_s']:.4f} | {r['dominant']} | "
                  f"{r['useful_flops_ratio']:.2f} | {r['roofline_fraction']:.3f} | "
                  f"{r['mem_gib_per_dev']:.2f} | {'yes' if r['fits'] else 'no'} |")
    else:
        print(json.dumps(rows, indent=1))


if __name__ == "__main__":
    main()
