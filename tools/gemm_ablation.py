#!/usr/bin/env python3
"""Where the GEMM kernel's time goes: build variants of csrc/matmul.cu with
one part of its work taken out, and time each beside torch.bmm.

    python3 tools/gemm_ablation.py        # needs one CUDA card and nvcc

A variant is the kernel's source with a text substitution; its results are
wrong by design (the error column says how wrong) and only its time is
read. Each variant is built with the package's own nvcc flags into
build/kernels/ablation/ and called through the same C entry as the kernel,
laid out as kernels/matmul.py lays it out. While each variant runs for
about half a second more, nvidia-smi samples the SM clock and the power
draw (medians reported): a card at its power limit slows down, and a
variant's data changes its power. Last comes the time of one call of the
wrapper and of torch.baddbmm on a product too small to take any. Prints one
JSON line per shape and writes chiprun_out/gemm_ablation.json.
"""
from __future__ import annotations

import concurrent.futures
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

LOAD_A = "    load_tile<A_K>(va, A + k0 * p.sak, p.sam, p.sak, p.M - m0, ks, p.a_vec, t);"
LOAD_B = "    load_tile<B_K>(vb, B + k0 * p.sbk, p.sbn, p.sbk, p.N - n0, ks, p.b_vec, t);"
CONST = "    for (int i = 0; i < QUADS; ++i) va[i] = vb[i] = make_float4(j, 1, 2, ks);"
STORE_A = "    store_tile<A_K>(va, s, s + TILE_BYTES, t);"
STORE_B = "    store_tile<B_K>(vb, s + 2 * TILE_BYTES, s + 3 * TILE_BYTES, t);"
CROSS = ("      sm90::wgmma_tf32_m64n128k8(acc, a_lo + 2 * kk, b_hi + 2 * kk, kk > 0);",
         "      sm90::wgmma_tf32_m64n128k8(acc, a_hi + 2 * kk, b_lo + 2 * kk, 1);")
HIHI = "      sm90::wgmma_tf32_m64n128k8(acc, a_hi + 2 * kk, b_hi + 2 * kk, 1);"
SUMS = "      for (int i = 0; i < ACC; ++i) part[i] = __fadd_rn(part[i], acc[i]);"
VARIANTS = {
    "kernel": [],
    "no_loads": [(LOAD_A, CONST), (LOAD_B, "")],
    "no_stores": [(STORE_A, ""), (STORE_B, "")],
    "no_a_stores": [(STORE_A, "")],
    "no_b_stores": [(STORE_B, "")],
    "no_loads_no_stores": [(LOAD_A, CONST), (LOAD_B, ""), (STORE_A, ""), (STORE_B, "")],
    "hi_hi_only": [(CROSS[0], "      (void)0;"), (CROSS[1], "      (void)0;"),
                   (HIHI, HIHI.replace(", 1);", ", kk > 0);"))],
    "no_slab_sums": [(SUMS, "      for (int i = 0; i < ACC; ++i) part[i] = acc[i];")],
}
# (L, M, N, K): the 48-slice bucket's launches, the 768 x 6144 bucket's
# apply, and a 2-D polynomial-sized product
SHAPES = [(48, 768, 768, 768), (12, 768, 6144, 768), (1, 768, 768, 768)]


def build(name, subs, out_dir):
    from repro_torch.kernels import build as kb
    src = (kb.CSRC / "matmul.cu").read_text()
    for old, new in subs:
        if old not in src:
            raise SystemExit(f"variant {name}: the kernel no longer has {old.strip()!r}")
        src = src.replace(old, new)
    d = out_dir / name
    d.mkdir(parents=True, exist_ok=True)
    (d / "matmul.cu").write_text(src)
    (d / "sm90.cuh").write_text((kb.CSRC / "sm90.cuh").read_text())
    cmd = [kb._nvcc(), *kb.NVCC_FLAGS, "-o", str(d / "lib.so"), str(d / "matmul.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"variant {name} failed to build:\n{proc.stderr}")
    lib = ctypes.CDLL(str(d / "lib.so"))
    fn = lib.gemm_f32
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 9
                   + [ctypes.c_float] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def main():
    import torch
    if not torch.cuda.is_available():
        print("gemm_ablation: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.kernels import build as kb
    from repro_torch.kernels import matmul as mm
    out_dir = kb.BUILD_DIR / "ablation"
    with concurrent.futures.ThreadPoolExecutor(len(VARIANTS)) as pool:
        fns = dict(zip(VARIANTS, pool.map(lambda kv: build(*kv, out_dir), VARIANTS.items())))

    def gemm(fn, a, b):
        L, M, K = a.shape
        N = b.shape[2]
        out = torch.empty(L, M, N, device="cuda")
        chunk = mm.k_chunk(M, N, K)
        split = mm.split_blocks(L, M, N, K, chunk)
        work = torch.empty(L * -(-K // chunk) * M * N, device="cuda") if split else None
        count = torch.zeros(L * mm._tiles(M, N), dtype=torch.int32, device="cuda")
        err = fn(a.data_ptr(), b.data_ptr(), None, out.data_ptr(),
                 None if work is None else work.data_ptr(), count.data_ptr(), L, M, N, K, chunk,
                 int(split), *a.stride(), *b.stride(), 0, 0, 0, 1.0, 0.0,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed ({err})")
        return out

    def time_ms(f, iters=10):
        for _ in range(2):
            f()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            f()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    def sampled(run):
        """Median SM clock (MHz) and power draw (W) while run() runs."""
        smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                                "--format=csv,noheader,nounits", "-lms", "25"],
                               stdout=subprocess.PIPE, text=True)
        try:
            run()
        finally:
            smi.terminate()
        samples = [line.split(",") for line in smi.communicate()[0].splitlines()]
        samples = [(float(c), float(w)) for c, w in samples if c.strip() and w.strip()]
        if not samples:
            return {}
        mid = len(samples) // 2
        return {"sm_mhz": sorted(c for c, _ in samples)[mid],
                "power_w": sorted(w for _, w in samples)[mid], "samples": len(samples)}

    gen = torch.Generator(device="cuda").manual_seed(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    rows = []
    for L, M, N, K in SHAPES:
        a = torch.randn(L, M, K, generator=gen, device="cuda")
        b = torch.randn(L, K, N, generator=gen, device="cuda")
        want = a.double() @ b.double()
        bmm_ms = time_ms(lambda: torch.bmm(a, b))
        row = {"shape": [L, M, N, K], "bound_3xtf32_ms": 3 * 2 * L * M * N * K / 495e12 * 1e3,
               "bmm": {"ms": bmm_ms, **sampled(lambda: time_ms(lambda: torch.bmm(a, b),
                                                               int(500 / bmm_ms) + 1))}}
        for name, fn in fns.items():
            err = float((gemm(fn, a, b).double() - want).abs().max())
            ms = time_ms(lambda: gemm(fn, a, b))
            row[name] = {"ms": ms, "max_abs_err": err,
                         **sampled(lambda: time_ms(lambda: gemm(fn, a, b), int(500 / ms) + 1))}
        # the kernel on inputs that toggle few bits in the tensor cores
        ca, cb = torch.full_like(a, 0.5), torch.full_like(b, 0.25)
        ms = time_ms(lambda: gemm(fns["kernel"], ca, cb))
        row["kernel_constant_inputs"] = {
            "ms": ms, **sampled(lambda: time_ms(lambda: gemm(fns["kernel"], ca, cb),
                                                int(500 / ms) + 1))}
        rows.append(row)
        print(json.dumps(row), flush=True)
    # the floor of one call: the wrapper (kernels/matmul.py) and
    # torch.baddbmm on an 8 x 8 x 8 product, where the work is nothing
    t8 = torch.randn(1, 8, 8, generator=gen, device="cuda")
    floor = {"wrapper_ms": time_ms(lambda: mm.gemm(t8, t8, t8, alpha=2.0, beta=0.5), 200),
             "baddbmm_ms": time_ms(lambda: torch.baddbmm(t8, t8, t8, alpha=2.0, beta=0.5), 200)}
    print(json.dumps({"call_floor": floor}), flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "gemm_ablation.json").write_text(json.dumps({"card": smi, "rows": rows,
                                                       "call_floor": floor}, indent=1))
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
