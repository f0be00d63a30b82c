#!/usr/bin/env python3
"""Where a served batch of a full-width model spends its time: the prefill
(attn_impl="pallas") and decode steps under torch.profiler.

    python3 tools/serve_profile.py [--arch qwen3-4b] [--decode-steps 8]   # one CUDA card

bf16, seed 0, B=8, T=1024, S_max=1152, as phase S (qwen3-4b) and phase M2
(deepseek-v2-lite-16b) of chip_smoke.py serve them, at the config's own
capacity factor for an MoE model. After a
warm-up, one prefill and then ``--decode-steps`` decode steps run under the
profiler, each window ended by a synchronize. Per window it reports the
sum of the device's kernel times, the number of kernel launches and the
kernels that take the most device time, and the wall time of the same
window run again without the profiler (whose host-side recording slows
the host): the device's idle share is 1 - kernel time / that wall time
(kernels on one stream do not overlap). Prints one JSON line per window
and writes chiprun_out/serve_profile_<arch>.json.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

B, T, N = 8, 1024, 128


def window(fn, top=12):
    """Profile ``fn`` once, then time it once more without the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        profiled = time.perf_counter() - t0
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        raise SystemExit("serve_profile: the profiler saw no device activity")
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    by_name = {}
    for e in kernels:
        n, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]
    return {"wall_ms": wall * 1e3, "wall_ms_profiled": profiled * 1e3,
            "kernel_ms": busy_us / 1e3, "launches": len(kernels),
            "idle_share": 1.0 - busy_us / 1e3 / (wall * 1e3),
            "top": [{"name": n[:120], "calls": c, "ms": us / 1e3} for n, (c, us) in ranked]}


def main():
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--decode-steps", type=int, default=8)
    args = ap.parse_args()
    if 2 * args.decode_steps > N:
        ap.error(f"--decode-steps at most {N // 2}: two windows share the cache's {N} slots")
    if not torch.cuda.is_available():
        print("serve_profile: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import place_cache, serve
    from repro_torch.models.model import init_cache, init_params
    from repro_torch.train.step import make_prefill_step, make_serve_step

    cfg = dataclasses.replace(get_config(args.arch), attn_impl="pallas")
    params = init_params(cfg, seed=0, device="cuda")
    prompts = torch.randint(0, cfg.vocab, (B, T), device="cuda",
                            generator=torch.Generator(device="cuda").manual_seed(1))
    serve(args.arch, full=True, batch=B, prompt_len=T, tokens=4, attn_impl="pallas",
          params=params, prompts=prompts)  # warm-up
    prefill, decode = make_prefill_step(cfg), make_serve_step(cfg)
    out = {}
    state = {}

    def run_prefill():
        state["last"], state["pc"] = prefill(params, {"tokens": prompts})

    out["prefill"] = window(run_prefill)
    cache = place_cache(init_cache(cfg, B, T + N, device="cuda"), state.pop("pc"), cfg)
    tok = torch.argmax(state["last"][:, :cfg.vocab], -1).to(torch.int32)[:, None]
    state.update(cache=cache, tok=tok)

    def run_decode():
        # the unprofiled rerun decodes the next steps' positions
        pos = state.setdefault("pos", T)
        for i in range(args.decode_steps):
            state["tok"], _, state["cache"] = decode(params, state["cache"], state["tok"],
                                                     pos + i)
        state["pos"] = pos + args.decode_steps

    out["decode"] = window(run_decode)
    out["decode"]["steps"] = args.decode_steps
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    for name, rec in out.items():
        print(json.dumps({"window": name, **rec}), flush=True)
    dest = ROOT / "chiprun_out"
    dest.mkdir(exist_ok=True)
    (dest / f"serve_profile_{args.arch}.json").write_text(
        json.dumps({"card": smi, "arch": args.arch, **out}, indent=1))
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
