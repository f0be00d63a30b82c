#!/usr/bin/env python3
"""Where the RMNP update kernel's time goes: build variants of
csrc/rmnp_update.cu with one part of its work changed or taken out, and
time each at the embedding bucket and the 48 x 768 x 768 bucket.

    python3 tools/rmnp_ablation.py        # needs one CUDA card and nvcc

A variant is the kernel's source with a text substitution; a variant that
takes work out gives wrong results by design and only its time is read
(``max_abs_err`` against the kernel says how wrong). Each variant is built
with the package's own nvcc flags into build/kernels/rmnp_ablation/ and
called through the same C entry as the kernel, with the split of
``kernels/rmnp_update.py::split`` at 256 and at 512 threads a block. Both forms run at the main path's types (fp32 gradient and
momentum; bf16 weights for apply), timed with CUDA events over 20 launches
after 3 of warm-up, the variants in turns (kernel first and last). Prints
one JSON line per bucket and writes chiprun_out/rmnp_ablation.json.
"""
from __future__ import annotations

import concurrent.futures
import ctypes
import json
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

AT = "        const int64_t at = base + (i0 + u) * step;\n"
LOADS_1 = AT + ("        load4(a.g + at, ncol, vec, gq[u]);\n"
                "        load4(v + at, ncol, vec, vq[u]);\n")
CONST_1 = AT + ("        for (int j = 0; j < 4; ++j) gq[u][j] = 1e-3f * (j + at % 7);\n"
                "        for (int j = 0; j < 4; ++j) vq[u][j] = 2e-3f;\n")
SLAB = ("          *reinterpret_cast<float4*>(slab + (i0 + u) * RT * C) =\n"
        "              make_float4(vn[0], vn[1], vn[2], vn[3]);\n")
V_OUT_3 = "        store4(v_out + at, vn, ncol, vec);\n"
V_OUT_1 = "        store4(v_out + base + (i0 + u) * step, vn, ncol, vec);\n"
OUT_3 = ("        if (APPLY)\n"
         "          store4(static_cast<TW*>(a.out) + at, o, ncol, vec);\n"
         "        else\n"
         "          store4(static_cast<float*>(a.out) + at, o, ncol, vec);\n")
UNROLL = "constexpr int UNROLL = 2;"
LD_F4 = "const float4 q = sm90::ld_stream_f4(p);"
LD_U2 = "const uint2 q = sm90::ld_stream_u2(p);"
ST_F4 = "__stcs(reinterpret_cast<float4*>(p), make_float4(x[0], x[1], x[2], x[3]));"
ST_U2 = "__stcs(reinterpret_cast<uint2*>(p), make_uint2("
PEER = "peer[k] = sm90::ld_dsmem_f32(sm90::dsmem_map(addr, k));"
W_LOAD = "        if (i0 + u < n) load4(w + base + (i0 + u) * step, ncol, vec, wq[u]);\n"
NO_W_LOAD = "        if (i0 + u < n) for (int j = 0; j < 4; ++j) wq[u][j] = 0.02f * j;\n"
V_LOAD_1 = "        load4(v + at, ncol, vec, vq[u]);\n"
W_IN_1 = """        if (APPLY) {
          float wt[4];
          load4(static_cast<const TW*>(a.w) + at, ncol, vec, wt);
          vq[u][0] = __fadd_rn(vq[u][0], __fmul_rn(0.f, wt[0] + wt[1] + wt[2] + wt[3]));
        }
"""
VARIANTS = {
    "kernel": [],
    "no_phase_3_stores": [(V_OUT_3, ""), (OUT_3, "")],
    "no_phase_1_loads": [(LOADS_1, CONST_1)],
    "no_weight_loads": [(W_LOAD, NO_W_LOAD)],
    "unroll_4": [(UNROLL, "constexpr int UNROLL = 4;")],
    # evict-first loads without the 128-byte L2 fetch, and no hints at all
    "no_l2_line": [(LD_F4, "const float4 q = __ldcs(reinterpret_cast<const float4*>(p));"),
                   (LD_U2, "const uint2 q = __ldcs(reinterpret_cast<const uint2*>(p));")],
    "no_cache_hints": [(LD_F4, "const float4 q = *reinterpret_cast<const float4*>(p);"),
                       (LD_U2, "const uint2 q = *reinterpret_cast<const uint2*>(p);"),
                       (ST_F4, "*reinterpret_cast<float4*>(p) = "
                               "make_float4(x[0], x[1], x[2], x[3]);"),
                       (ST_U2, "*reinterpret_cast<uint2*>(p) = (make_uint2(")],
    "no_dsmem_reads": [(PEER, "peer[k] = part[t];")],
    # w read in step 1 beside g and v (into a sum that changes no value) and
    # not in step 3: what reading w early would cost, were there room to keep
    # it until step 3
    "weight_in_phase_1": [(W_LOAD, NO_W_LOAD), (V_LOAD_1, V_LOAD_1 + W_IN_1)],
}
SHAPES = [(1, 50432, 768), (48, 768, 768)]
THREADS = (256, 512)  # a block's threads, with the rest of the wrapper's split


def build(name, subs, out_dir):
    from repro_torch.kernels import build as kb
    src = (kb.CSRC / "rmnp_update.cu").read_text()
    for old, new in subs:
        if src.count(old) != 1:
            raise SystemExit(f"variant {name}: the kernel has {src.count(old)} of {old!r}")
        src = src.replace(old, new)
    d = out_dir / name
    d.mkdir(parents=True, exist_ok=True)
    (d / "rmnp_update.cu").write_text(src)
    (d / "sm90.cuh").write_text((kb.CSRC / "sm90.cuh").read_text())
    cmd = [kb._nvcc(), *kb.NVCC_FLAGS, "-o", str(d / "lib.so"), str(d / "rmnp_update.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        print(f"variant {name} failed to build:\n{proc.stderr[-2000:]}", file=sys.stderr)
        return None
    fn = ctypes.CDLL(str(d / "lib.so")).rmnp_update
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 12 + [ctypes.c_float] * 3
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def main():
    import torch
    if not torch.cuda.is_available():
        print("rmnp_ablation: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import build as kb
    from repro_torch.kernels import rmnp_update as rm
    out_dir = kb.BUILD_DIR / "rmnp_ablation"
    with concurrent.futures.ThreadPoolExecutor(len(VARIANTS)) as pool:
        fns = dict(zip(VARIANTS, pool.map(lambda kv: build(*kv, out_dir), VARIANTS.items())))
    fns = {name: fn for name, fn in fns.items() if fn is not None}

    def launch(fn, g, v, w, scalars, layout):
        L, d_in, d_out = g.shape
        v_out = torch.empty_like(v)
        out = torch.empty_like(w) if w is not None else torch.empty_like(g)
        err = fn(g.data_ptr(), v.data_ptr(), None if w is None else w.data_ptr(),
                 v_out.data_ptr(), out.data_ptr(), scalars.data_ptr(), L, d_in, d_out,
                 layout.K, layout.R, layout.C, layout.threads, int(layout.one_read), 1, 0,
                 int(w is not None), int(w is not None), 0.95, 0.05, 1e-8,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed ({err})")
        return v_out, out

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

    gen = torch.Generator(device="cuda").manual_seed(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    rows = []
    order = list(fns) + ["kernel"]
    for shape in SHAPES:
        g = torch.randn(shape, generator=gen, device="cuda") * 1e-3
        v = torch.randn(shape, generator=gen, device="cuda") * 1e-3
        w = (torch.randn(shape, generator=gen, device="cuda") * 0.02).to(torch.bfloat16)
        scalars = torch.tensor([2e-3, 0.1], device="cuda")
        base = rm.split(*shape[1:])
        row = {"shape": list(shape), "bound_ms": math.prod(shape) * 16 / 3.35e12 * 1e3}
        for threads in THREADS:
            layout = base._replace(threads=threads)
            for form, ww in (("apply", w), ("precondition", None)):
                ref = launch(fns["kernel"], g, v, ww, scalars, layout)
                cell = {}
                for i, name in enumerate(order):
                    fn = fns[name]
                    got = launch(fn, g, v, ww, scalars, layout)
                    err = max(float((a.float() - b.float()).abs().max())
                              for a, b in zip(got, ref, strict=True))
                    del got
                    key = name if i < len(fns) else "kernel_again"
                    cell[key] = {"ms": time_ms(lambda fn=fn: launch(fn, g, v, ww, scalars,
                                                                    layout)),
                                 "max_abs_err": err}
                row[f"{form}_threads_{threads}"] = cell
        rows.append(row)
        print(json.dumps(row), flush=True)
        del g, v, w
        torch.cuda.empty_cache()
    print(smi, flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "rmnp_ablation.json").write_text(json.dumps({"card": smi, "buckets": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
