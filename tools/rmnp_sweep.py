#!/usr/bin/env python3
"""Sweep the RMNP update kernel's split at gpt2-small's four buckets.

    python3 tools/rmnp_sweep.py        # needs one CUDA card and nvcc

For each bucket and each candidate split (K blocks a cluster, R rows, C
columns, threads a block; the one-read path unless marked), both forms of
the kernel (precondition with fp32 momentum; apply with fp32 momentum and
bf16 weights, the main path's types) are launched through
``kernels/rmnp_update.py::_launch`` with that split, held against their plain
versions per element (fp32 rtol 1e-5, bf16 one bf16 step, as
``chip_smoke.py`` phase A), and timed with CUDA events over 20 launches
after 3 of warm-up. Each row gives the split, how many of its clusters the
card holds at once (``cudaOccupancyMaxActiveClusters``), the time, the
bytes bound at 3.35 TB/s and the rate reached. The candidate marked
``split`` is the one ``kernels/rmnp_update.py::split`` takes. Prints one
JSON line per bucket and writes chiprun_out/rmnp_sweep.json.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12
# (K, R, C, threads, one_read) candidates per bucket (L, d_in, d_out)
CANDIDATES = {
    (48, 768, 768): [(1, 768, 32, 256, True), (2, 384, 32, 256, True),
                     (2, 384, 64, 256, True), (2, 384, 64, 512, True),
                     (4, 192, 64, 256, True), (1, 768, 32, 256, False)],
    (12, 768, 6144): [(1, 768, 32, 256, True), (2, 384, 32, 256, True),
                      (2, 384, 64, 256, True), (2, 384, 64, 512, True),
                      (4, 192, 64, 256, True)],
    (12, 3072, 768): [(4, 768, 32, 256, True), (8, 384, 32, 256, True),
                      (8, 384, 64, 256, True), (8, 384, 64, 512, True)],
    (1, 50432, 768): [(16, 3152, 16, 256, True), (16, 3152, 16, 512, True),
                      (8, 6304, 32, 256, False)],
}


def elementwise_ratio(got, want, rtol, atol_frac=1e-6):
    diff = (got.float() - want.float()).abs()
    mag = want.float().abs()
    return float((diff / (atol_frac * mag.max() + rtol * mag)).max())


def time_ms(fn, iters=20, warmup=3):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main():
    import torch
    if not torch.cuda.is_available():
        print("rmnp_sweep: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    from repro_torch.kernels import rmnp_update as rm
    rm._kernel()
    ptxas = build.PTXAS_REPORTS.get("rmnp_update", "")
    gen = torch.Generator(device="cuda").manual_seed(0)
    beta, eps = 0.95, 1e-8
    rtol = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}
    results = []
    for shape, candidates in CANDIDATES.items():
        g = torch.randn(shape, generator=gen, device="cuda") * 1e-3
        v = torch.randn(shape, generator=gen, device="cuda") * 1e-3
        w = (torch.randn(shape, generator=gen, device="cuda") * 0.02).to(torch.bfloat16)
        scalars = torch.tensor([2e-3, 0.1], device="cuda")
        def apply(s):
            v_new, w_new = torch.empty_like(v), torch.empty_like(w)
            rm._launch(g, v, w, v_new, w_new, scalars, beta=beta, eps=eps, apply=True,
                       layout=s)
            return v_new, w_new

        def precondition(s):
            v_new, d = torch.empty_like(v), torch.empty_like(g)
            rm._launch(g, v, None, v_new, d, None, beta=beta, eps=eps, apply=False, layout=s)
            return v_new, d

        forms = {
            "apply": (apply, rm.rmnp_rownorm_apply_plain(g, v, w, scalars, beta=beta, eps=eps),
                      math.prod(shape) * 16),
            "precondition": (precondition, rm.rmnp_rownorm_plain(g, v, beta=beta, eps=eps),
                             math.prod(shape) * 16),
        }
        chosen = rm.split(*shape[1:])
        rows = []
        for cand in candidates:
            s = rm.Split(*cand)
            rec = {"K": s.K, "R": s.R, "C": s.C, "threads": s.threads, "one_read": s.one_read,
                   "split": s == chosen, "smem_bytes": s.smem_bytes()}
            for form, (run, want, nbytes) in forms.items():
                clusters = rm.max_active_clusters(shape, v.dtype, w.dtype,
                                                  apply=form == "apply", layout=s)
                if clusters == 0:
                    rec[form] = {"clusters": 0}
                    continue
                got = run(s)
                torch.cuda.synchronize()
                ratio = max(elementwise_ratio(a, b, rtol[a.dtype])
                            for a, b in zip(got, want, strict=True))
                del got
                ms = time_ms(lambda run=run, s=s: run(s))
                bound = nbytes / HBM_BYTES_PER_S * 1e3
                rec[form] = {"clusters": clusters, "ms": ms, "bound_ms": bound,
                             "of_bound": bound / ms,
                             "gb_s": nbytes / ms / 1e6, "worst_ratio": ratio,
                             "ok": ratio <= 1.0}
            rows.append(rec)
        line = {"shape": list(shape), "candidates": rows}
        print(json.dumps(line), flush=True)
        results.append(line)
        del g, v, w, forms
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "rmnp_sweep.json").write_text(json.dumps(
        {"card": smi, "buckets": results, "ptxas": ptxas}, indent=1))
    bad = [(r["shape"], c) for r in results for c in r["candidates"]
           for f in ("apply", "precondition") if c[f].get("ok") is False]
    if bad:
        print(f"rmnp_sweep: candidates off the plain version: {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
