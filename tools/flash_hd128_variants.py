#!/usr/bin/env python3
"""The bf16 flash kernel's design choices at its wide-head builds: build
variants of csrc/flash_attention_fwd.cu that each change one choice, and
time each at qwen3-4b's prefill shape (hd 128), deepseek-v2-lite's
((192, 128), v a strided column slice), paligemma-3b's (hd 256, H = 8 on
K = 1), phi3-mini-3.8b's (hd 96, H = K = 32) or minicpm3-4b's ((96, 64),
H = K = 40, v strided) beside its ptxas report.

    python3 tools/flash_hd128_variants.py                # needs one CUDA card and nvcc
    python3 tools/flash_hd128_variants.py --build-only   # ptxas and SASS only, no launch
    python3 tools/flash_hd128_variants.py --parent build/parent/src/repro_torch/csrc
    python3 tools/flash_hd128_variants.py --trace        # cycles of each phase of a tile

Variants (patches of the source's constants, each a correct kernel):
  kernel           the source as it is: 64-key tiles, a 3-stage ring (2 at
                   hd 256, where 3 do not fit), a tile's P.V at hdv <= 128
                   as one product a part and k-step, S_t beside P_{t-1}.V;
                   at hdv 256 P.V in four 64-column pieces and each tile's
                   S, softmax and P.V in turn; hd 96 as three 32-column
                   sub-tiles under the 64-byte swizzle, P.V at hdv 96 as one
                   m64n96 product; the producer warpgroup at 24 registers
                   and the consumers at 240;
  nstage_2         a ring of 2 K/V stages (hd 128 and (192, 128));
  pv_n_64          P.V at hdv 128 as two 64-column products, the second
                   issued once the first is added into the running sum;
  producer_40      the producer at 40 registers, the consumers at 232;
  hd256_overlap    hd 256 with S_t beside P_{t-1}.V, P.V in 64-column pieces;
  hd256_pv_halves  hd 256 with P.V in two 128-column pieces, in turn;
  hd256_bk32       hd 256 with 32-key tiles (S as m64n32 products), three
                   stages, the overlap, P.V in 64-column pieces: its running
                   sum is grouped by 32 keys, so its bits differ;
  hd96_pv_n_32     hdv 96 with P.V in three 32-column pieces, each added
                   into the running sum before the next is issued;
  hd96_pad128      hd 96 padded to 128 columns under the 128-byte swizzle
                   (two boxes a tile, the second half past the tensor's
                   edge, zero-filled by TMA), Q.K^T over the 6 real k-steps,
                   P.V at hdv 96 as one m64n128 product.
The first three run at the hd-128 and (192, 128) shapes, the hd256 ones at
paligemma's, hd96_pv_n_32 at phi3-mini's and hd96_pad128 at phi3-mini's and
minicpm3's; each but hd256_bk32 must give the kernel's bits.
With ``--parent DIR`` the flash source and sm90.cuh in DIR (another
commit's csrc/, unpacked with git archive) are built as ``parent`` and
timed against ``kernel`` also at gpt2-small's hd-64 shapes (causal and
not), a ragged GQA shape and hd 32 and 16 (G = 4), so that every older
build is held to the parent's bits, in turns parent, kernel, kernel, parent
(a parent without the hd-96 builds refuses those shapes).

Each is built with the package's own nvcc flags into
build/kernels/variants/, called through the same C entry as the kernel,
held against the plain version at 2^-7 of each element (plus 1e-6 of the
largest), compared with the kernel's output bit for bit, and timed per call
with CUDA events while the card is held busy until the call is enqueued
(the median of 20: the card's time, not the host's). ``--trace`` also
builds a copy of the kernel that records clock64 at the phases of each
consumer warpgroup's main loop in the first four blocks (the heaviest query
tiles) and prints the median cycles of each phase over their middle tiles.
Prints one JSON line per variant and writes
chiprun_out/flash_hd128_variants.json.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

# hd 256, 32-key tiles: S as an m64n32 product (a helper of the variant's
# own), P's parts 24 registers, three stages in shared memory, and S_t beside
# P_{t-1}.V in 64-column pieces
BK32_SS = """template <int N>
__device__ __forceinline__ void wgmma_ss_n(float (&d)[N / 2], uint64_t da, uint64_t db,
                                           int scale_d) {
  if constexpr (N == 64) {
    wgmma_bf16_m64n64k16_ss(d, da, db, scale_d);
  } else {
    static_assert(N == 32, "S over 32 or 64 keys");
    asm volatile(
        "{\\n.reg .pred p;\\nsetp.ne.b32 p, %18, 0;\\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1, 0, 0;\\n}\\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(da), "l"(db), "r"(scale_d));
  }
}

"""
# hd 96 padded to 128 columns: 64-column sub-tiles under the 128-byte
# swizzle, the last box half past the map's 96 columns (TMA fills zeros),
# Q.K^T over the 6 real k-steps, P.V at hdv 96 as one m64n128 product
PAD128 = [
    ("  static constexpr int span = HD % 64 == 0 ? 64 : HD % 32 == 0 ? 32 : 16;\n"
     "  static constexpr int nsub = HD / span;     // sub-tiles of a tile\n",
     "  static constexpr int span = HD < 64 ? HD : 64;\n"
     "  static constexpr int nsub = (HD + span - 1) / span;\n"),
    ("q_bytes = BQ * HDQ * 2;", "q_bytes = BQ * QK::nsub * QK::span * 2;"),
    ("k_bytes = bk * HDQ * 2;", "k_bytes = bk * QK::nsub * QK::span * 2;"),
    ("v_bytes = bk * HDV * 2;", "v_bytes = bk * V::nsub * V::span * 2;"),
    ("  static constexpr int pv_n = wide ? 64 : HDV;",
     "  static constexpr int pv_n = wide ? 64 : V::nsub * V::span;"),
    ("static_assert(HDV % pv_n == 0", "static_assert(V::nsub * V::span % pv_n == 0"),
    ("    float acc[HDV / 2];\n#pragma unroll\n    for (int i = 0; i < HDV / 2; ++i)",
     "    float acc[V::nsub * V::span / 2];\n#pragma unroll\n"
     "    for (int i = 0; i < V::nsub * V::span / 2; ++i)"),
    ("      for (int c = 0; c < HDV / PN; ++c) {",
     "      for (int c = 0; c < V::nsub * V::span / PN; ++c) {"),
]
BK = "  static constexpr int bk = 64;"
OVERLAP = "  static constexpr bool overlap = !wide;"
PV_N = "  static constexpr int pv_n = wide ? 64 : HDV;"
VARIANTS = {
    "kernel": [],
    "nstage_2": [("  static constexpr int nstage = alloc_for(3) <= SMEM_LIMIT ? 3 : 2;",
                  "  static constexpr int nstage = 2;")],
    "pv_n_64": [(PV_N, "  static constexpr int pv_n = HDV % 64 ? HDV : 64;")],
    "producer_40": [("constexpr int PRODUCER_REGS = 24;", "constexpr int PRODUCER_REGS = 40;")],
    # the hd-256 candidates (the kernel: 64-key tiles, two stages, each
    # tile's S, softmax and P.V in turn, P.V in 64-column pieces)
    "hd256_overlap": [(OVERLAP, "  static constexpr bool overlap = true;")],
    "hd256_pv_halves": [(PV_N, "  static constexpr int pv_n = wide ? 128 : HDV;")],
    "hd256_bk32": [(BK, "  static constexpr int bk = wide ? 32 : 64;"),
                   (OVERLAP, "  static constexpr bool overlap = true;"),
                   ("template <int HDQ, int HDV>\n__global__", BK32_SS
                    + "template <int HDQ, int HDV>\n__global__"),
                   ("wgmma_bf16_m64n64k16_ss(s, q_desc", "wgmma_ss_n<BK>(s, q_desc")],
    # hd 96 (the kernel: one m64n96 product a part and k-step at hdv 96)
    "hd96_pv_n_32": [(PV_N, "  static constexpr int pv_n = wide ? 64 : HDV == 96 ? 32 : HDV;")],
    "hd96_pad128": PAD128,
}
# the shapes each variant runs besides the kernel (the parent runs all)
HD256 = ["paligemma_hd256"]
WIDE = ["qwen3_hd128", "deepseek_mla"]
HD96 = ["phi3_hd96", "minicpm3_mla"]
VARIANT_SHAPES = {"nstage_2": WIDE, "pv_n_64": WIDE, "producer_40": WIDE,
                  "hd256_overlap": HD256, "hd256_pv_halves": HD256, "hd256_bk32": HD256,
                  "hd96_pv_n_32": HD96[:1], "hd96_pad128": HD96}
# the trace: clock64 at the phases of the consumers' main loop (one record
# per block < 4, warpgroup and tile < 24), written by lane 0 of each
# warpgroup's first warp, read through fa_trace_get
TRACE_PHASES = ["wait K/V", "issue S and P.V", "wait S", "softmax", "wait and add P.V",
                "split P"]
TRACE = [("namespace {\n\nusing namespace sm90;",
          "__device__ unsigned long long fa_trace[4][2][24][8];\n"
          "extern \"C\" int fa_trace_get(void* dst) {\n"
          "  return cudaMemcpyFromSymbol(dst, fa_trace, sizeof(fa_trace));\n}\n"
          "#define TR(i) if (threadIdx.x % 128 == 0 && blockIdx.x < 4 && t < 24) "
          "fa_trace[blockIdx.x][wg][t][i] = clock64();\n"
          "namespace {\n\nusing namespace sm90;"),
         ("      for (int t = 1; t < nvisit; ++t) {\n",
          "      for (int t = 1; t < nvisit; ++t) {\n        TR(0);\n"),
         ("        wgmma_fence();\n        issue_qk(t);\n        issue_pv",
          "        TR(1);\n        wgmma_fence();\n        issue_qk(t);\n        issue_pv"),
         ("        wgmma_wait_group<1>();  // S_t",
          "        TR(2);\n        wgmma_wait_group<1>();"),
         ("        float ca, cb;", "        TR(3);\n        float ca, cb;"),
         ("        finish_pv(t - 1);", "        TR(4);\n        finish_pv(t - 1);\n        TR(5);"),
         ("        split_p();\n      }\n      // the last",
          "        split_p();\n        TR(6);\n      }\n      // the last")]
# (name, B, S, H, K, hd, hdv, causal); the kernel and each variant run the
# first five (VARIANT_SHAPES), the parent all of them
SHAPES = [("qwen3_hd128", 8, 1024, 32, 8, 128, 128, True),
          ("deepseek_mla", 8, 1024, 16, 16, 192, 128, True),
          ("paligemma_hd256", 8, 1024, 8, 1, 256, 256, True),
          ("phi3_hd96", 8, 1024, 32, 32, 96, 96, True),
          ("minicpm3_mla", 8, 1024, 40, 40, 96, 64, True),
          ("main", 8, 1024, 12, 12, 64, 64, True),
          ("main_noncausal", 8, 1024, 12, 12, 64, 64, False),
          ("gqa_ragged", 2, 1000, 8, 2, 64, 64, True),
          ("hd32_g4", 2, 1024, 8, 2, 32, 32, True),
          ("hd16_g4", 2, 1024, 8, 2, 16, 16, True)]


def build(name, source, header, out_dir):
    """(C entry or None, ptxas report or the compiler's error)"""
    from repro_torch.kernels import build as kb
    from repro_torch.kernels import flash_attention as fa
    d = out_dir / name
    d.mkdir(parents=True, exist_ok=True)
    (d / "flash_attention_fwd.cu").write_text(source)
    (d / "sm90.cuh").write_text(header)
    cmd = [kb._nvcc(), *kb.NVCC_FLAGS, "-o", str(d / "lib.so"), str(d / "flash_attention_fwd.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    (d / "ptxas.txt").write_text(proc.stderr)
    if proc.returncode:
        return None, proc.stderr[-3000:]
    fn = ctypes.CDLL(str(d / "lib.so")).fa_fwd
    fn.argtypes = fa.ARGTYPES
    fn.restype = ctypes.c_int
    return fn, proc.stderr


def patch(text, name, subs):
    """``text`` with each (old, new) of ``subs`` applied; old is a string or
    a compiled pattern and must occur exactly once."""
    for old, new in subs:
        pattern = old if isinstance(old, re.Pattern) else re.compile(re.escape(old))
        if len(pattern.findall(text)) != 1:
            raise SystemExit(f"variant {name}: the kernel no longer has {pattern.pattern!r} once")
        text = pattern.sub(lambda _: new, text)
    return text


def sources(parent, trace):
    from repro_torch.kernels import build as kb
    src = (kb.CSRC / "flash_attention_fwd.cu").read_text()
    header = (kb.CSRC / "sm90.cuh").read_text()
    out = {name: (patch(src, name, subs), header)
           for name, subs in {**VARIANTS, **({"trace": TRACE} if trace else {})}.items()}
    if parent:
        out["parent"] = ((parent / "flash_attention_fwd.cu").read_text(),
                         (parent / "sm90.cuh").read_text())
    return out


def design_report(report, library):
    """Per bf16 build: registers, spills and the setmaxnreg and HGMMA
    instructions in its SASS; and any wgmma that ptxas serialised."""
    from repro_torch.kernels import report as kreport
    return {"builds": kreport.flash_design(report, kreport.sass_functions(library), "fa_fwd_tc"),
            "wgmma_serialized": kreport.wgmma_serialized(report)}


def held_ms(fn, iters=20, warmup=3):
    """Median ms of ``iters`` calls, CUDA events around each, the card held
    busy (torch.cuda._sleep) until the call is enqueued: the card's time
    alone, also for a kernel shorter than its own enqueueing."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        torch.cuda.synchronize()
        torch.cuda._sleep(1_000_000)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def make_inputs(gen, B, S, H, K, hd, hdv):
    """q (B,S,H,hd), k (B,S,K,hd), v (B,S,K,hdv) in bf16; with hdv != hd, v
    is MLA's strided view: the last hdv columns of a (B,S,K,2 hdv) tensor."""
    import torch
    q, k = (torch.randn(B, S, h, hd, generator=gen, device="cuda").bfloat16() for h in (H, K))
    if hdv == hd:
        return q, k, torch.randn(B, S, K, hd, generator=gen, device="cuda").bfloat16()
    return q, k, torch.randn(B, S, K, 2 * hdv, generator=gen, device="cuda").bfloat16()[..., hdv:]


def worst_ratio(got, want):
    """The largest |got - want| over 2^-7 |want| + 1e-6 max|want|."""
    diff = (got.float() - want.float()).abs()
    mag = want.float().abs()
    return float((diff / (1e-6 * mag.max() + 2.0 ** -7 * mag)).max())


def trace(lib, fn, call, q, k, v, causal):
    """Median cycles of each phase of a consumer warpgroup's main loop, and
    of a whole tile, over the middle tiles of the first four blocks."""
    import numpy as np
    get = lib.fa_trace_get
    get.argtypes, get.restype = [ctypes.c_void_p], ctypes.c_int
    import torch
    call(fn, q, k, v, causal)
    torch.cuda.synchronize()
    buf = np.zeros((4, 2, 24, 8), np.uint64)
    if get(buf.ctypes.data):
        raise RuntimeError("reading the trace failed")
    a = buf.astype(np.int64)
    phases = {name: [] for name in TRACE_PHASES + ["tile"]}
    for blk in range(4):
        for wg in range(2):
            ts = [t for t in range(1, 24) if a[blk, wg, t, 6] > a[blk, wg, t, 0] > 0]
            for t in ts[1:-1]:  # the middle tiles, past the ring's filling
                for i, name in enumerate(TRACE_PHASES):
                    phases[name].append(int(a[blk, wg, t, i + 1] - a[blk, wg, t, i]))
                if t + 1 in ts:
                    phases["tile"].append(int(a[blk, wg, t + 1, 0] - a[blk, wg, t, 0]))
    return {name: statistics.median(v) for name, v in phases.items() if v}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--build-only", action="store_true",
                    help="build and report ptxas and SASS; launch nothing")
    ap.add_argument("--parent", type=Path, help="another commit's csrc/ to time beside")
    ap.add_argument("--trace", action="store_true",
                    help="also record the cycles of each phase of the main loop")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("flash_hd128_variants: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import build as kb
    from repro_torch.kernels import flash_attention as fa
    out_dir = kb.BUILD_DIR / "variants"
    srcs = sources(args.parent, args.trace)
    with concurrent.futures.ThreadPoolExecutor(len(srcs)) as pool:
        built = dict(zip(srcs, pool.map(lambda kv: build(kv[0], *kv[1], out_dir), srcs.items())))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    rows = {}
    for name, (fn, report) in built.items():
        rows[name] = {"error": "build failed: " + report} if fn is None else \
            design_report(report, out_dir / name / "lib.so")
        print(json.dumps({"variant": name, **rows[name]}), flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    record = {"card": smi, "shapes": SHAPES, "variants": rows}
    if not args.build_only:
        gen = torch.Generator(device="cuda").manual_seed(0)
        inputs = {}
        for name, B, S, H, K, hd, hdv, causal in SHAPES:
            q, k, v = make_inputs(gen, B, S, H, K, hd, hdv)
            want = fa.flash_attention_fwd_plain(q, k, v, causal=causal)
            inputs[name] = (q, k, v, causal, want)

        def call(fn, q, k, v, causal):
            B, S, H, hd = q.shape
            o = q.new_empty((B, S, H, v.shape[3]))
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, S, H, k.shape[2],
                     hd, v.shape[3], v.stride(2), v.stride(1), v.stride(0), int(causal),
                     1.0 / hd ** 0.5, torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"launch failed ({err})")
            return o

        names = [n for n in built if built[n][0] is not None and n != "trace"]
        # the kernel at the wide shapes, each variant at its own; the parent
        # everywhere
        plan = {n: VARIANT_SHAPES.get(n, WIDE + HD256 + HD96) for n in names}
        if "parent" in plan:
            plan["parent"] = plan["kernel"] = [s[0] for s in SHAPES]
        reference = {}
        for name in names:
            row = rows[name]
            row["cases"] = {}
            for shape in plan[name]:
                q, k, v, causal, want = inputs[shape]
                try:
                    got = call(built[name][0], q, k, v, causal)
                    torch.cuda.synchronize()
                except RuntimeError as e:
                    row["cases"][shape] = {"error": str(e)}
                    continue
                case = {"worst_ratio": worst_ratio(got, want), "ms": []}
                if name == "kernel":
                    reference[shape] = got
                elif shape in reference:
                    case["bits_equal_kernel"] = bool(torch.equal(got, reference[shape]))
                row["cases"][shape] = case
        # timing in turns: each variant between two readings of the kernel
        # (parent: parent, kernel, kernel, parent)
        order = [n for n in names if n != "kernel"]
        sequence = ["kernel"]
        for n in order:
            sequence += [n, "kernel"] if n != "parent" else ["parent", "kernel", "kernel", "parent"]
        for name in sequence:
            for shape in plan[name]:
                case = rows[name].get("cases", {}).get(shape, {})
                if "ms" not in case:
                    continue
                q, k, v, causal, _ = inputs[shape]
                fn = built[name][0]
                case["ms"].append(held_ms(lambda: call(fn, q, k, v, causal)))
        for name in names:
            print(json.dumps({"variant": name, "cases": rows[name]["cases"]}), flush=True)
        if args.trace and built["trace"][0] is not None:
            lib = ctypes.CDLL(str(out_dir / "trace" / "lib.so"))
            record["trace"] = {shape: trace(lib, built["trace"][0], call, *inputs[shape][:4])
                               for shape in WIDE}
            print(json.dumps({"trace": record["trace"]}), flush=True)
    (out / "flash_hd128_variants.json").write_text(json.dumps(record, indent=1))
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
