#!/usr/bin/env python3
"""The bf16 flash kernel at head dim 128: build variants of
csrc/flash_attention_fwd.cu that differ in how a thread's registers are
spent, and time each at qwen3-4b's prefill shape beside its ptxas report.

    python3 tools/flash_hd128_variants.py     # needs one CUDA card and nvcc

Variants (text substitutions of the source, each a correct kernel):
  kernel          the source as it is: P.V in two products of 64 columns,
                  one per atom of V;
  maxnreg_224     __maxnreg__(224) in place of __launch_bounds__(THREADS,
                  1), under which ptxas caps the kernel at 168 registers a
                  thread; 288 threads x 224 registers fit the SM's 65536,
                  but 9 warps put 3 on one of its four sub-partitions of
                  16384, so the card may refuse the launch, which is then
                  reported as the variant's error.
Each is built with the package's own nvcc flags into
build/kernels/variants/, called through the same C entry as the kernel,
held against the plain version at 2^-7 of each element (plus 1e-6 of the
largest) and timed with CUDA events, in turns (kernel, variants, then
kernel again). Prints one JSON line per variant and writes
chiprun_out/flash_hd128_variants.json.
"""
from __future__ import annotations

import concurrent.futures
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

BOUNDS = "__global__ void __launch_bounds__(THREADS, 1)"
VARIANTS = {
    "kernel": [],
    "maxnreg_224": [(BOUNDS, "__global__ void __maxnreg__(224)")],
}
SHAPE = (8, 1024, 32, 8, 128)  # B, S, H, K, hd: qwen3-4b's prefill


def build(name, subs, out_dir):
    from repro_torch.kernels import build as kb
    src = (kb.CSRC / "flash_attention_fwd.cu").read_text()
    for old, new in subs:
        if old not in src:
            raise SystemExit(f"variant {name}: the kernel no longer has {old!r}")
        src = src.replace(old, new)
    d = out_dir / name
    d.mkdir(parents=True, exist_ok=True)
    (d / "flash_attention_fwd.cu").write_text(src)
    (d / "sm90.cuh").write_text((kb.CSRC / "sm90.cuh").read_text())
    cmd = [kb._nvcc(), *kb.NVCC_FLAGS, "-o", str(d / "lib.so"),
           str(d / "flash_attention_fwd.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        return None, proc.stderr[-3000:]
    from repro_torch.kernels import flash_attention as fa
    lib = ctypes.CDLL(str(d / "lib.so"))
    fn = lib.fa_fwd
    fn.argtypes = fa.BF16_ARGTYPES
    fn.restype = ctypes.c_int
    # registers and spills of the hd-128 instantiation
    report, keep = [], False
    for line in proc.stderr.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            keep = "fa_fwd_tcILi128ELi128EE" in m.group(1)
        elif keep and ("spill" in line or "Used" in line):
            report.append(line.split(":", 1)[-1].strip())
    return fn, " ".join(report)


def main():
    import torch
    if not torch.cuda.is_available():
        print("flash_hd128_variants: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import build as kb
    from repro_torch.kernels import flash_attention as fa
    out_dir = kb.BUILD_DIR / "variants"
    with concurrent.futures.ThreadPoolExecutor(len(VARIANTS)) as pool:
        built = dict(zip(VARIANTS, pool.map(lambda kv: build(*kv, out_dir), VARIANTS.items())))

    B, S, H, K, hd = SHAPE
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(B, S, h, hd, generator=gen, device="cuda").bfloat16()
               for h in (H, K, K))
    want = fa.flash_attention_fwd_plain(q, k, v, causal=True)

    def call(fn):
        out = torch.empty_like(q)
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S, H, K, hd, hd,
                 v.stride(2), v.stride(1), v.stride(0), 1, 1.0 / hd ** 0.5,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed ({err})")
        return out

    def time_ms(f, iters=20):
        for _ in range(3):
            f()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            f()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    rows = {}
    for name in [*VARIANTS, "kernel"]:
        fn, report = built[name]
        row = rows.setdefault(name, {"ptxas": report, "ms": []})
        if fn is None:
            row["error"] = "build failed: " + report
            continue
        try:
            got = call(fn)
            torch.cuda.synchronize()
        except RuntimeError as e:
            row["error"] = str(e)
            continue
        diff = (got.float() - want.float()).abs()
        mag = want.float().abs()
        row["worst_ratio"] = float((diff / (1e-6 * mag.max() + 2.0 ** -7 * mag)).max())
        row["ms"].append(time_ms(lambda fn=fn: call(fn)))
    for name, row in rows.items():
        print(json.dumps({"variant": name, **row}), flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "flash_hd128_variants.json").write_text(json.dumps(
        {"card": smi, "shape": SHAPE, "variants": rows}, indent=1))
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
