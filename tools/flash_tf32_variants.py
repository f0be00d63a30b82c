#!/usr/bin/env python3
"""The fp32 flash kernel's design choices (its ring of 32-column spans): build
variants of csrc/flash_attention_fwd_tf32.cu that each change one choice,
report each build's registers and spills, and time each at the prefill
shapes of the models that take those builds (B=8, S=1024, causal):
qwen3-4b's (128, 128) (H=32 K=8), phi3-mini-3.8b's (96, 96) (H=K=32),
minicpm3-4b's (96, 64) (H=K=40, v a strided column slice),
deepseek-v2-lite's (192, 128) (H=K=16, v strided) and paligemma-3b's
(256, 256) (H=8 K=1).

    python3 tools/flash_tf32_variants.py                # needs one CUDA card and nvcc
    python3 tools/flash_tf32_variants.py --build-only   # ptxas and SASS only, no launch
    python3 tools/flash_tf32_variants.py --parent build/parent/src/repro_torch/csrc

Variants (patches of the source, each a correct kernel that gives the
kernel's bits):
  kernel           the source as it is;
  producer_56      the producer warpgroup at 56 registers, the consumers at
                   224 (two consumer warpgroups): the producer spills;
  producer_72      the producer at 72, the consumers at 216 (4 bytes spill);
  v_block_test     the producer tests at run time whether its thread has a
                   V^T block (true at every build but hdv 16), where the
                   kernel folds the test away;
  q_desc_hoisted   Q's span descriptors left to the compiler, which hoists
                   them out of the key-tile loop;
  one_consumer     one consumer warpgroup of 64 rows at every build (hd
                   192: 8 slots beside a 96 KB Q);
  prefetch_1       the producer keeps one slot's loads in flight, not two.

With ``--parent DIR`` the source and sm90.cuh in DIR (another commit's
csrc/, unpacked with git archive) are built as ``parent`` and timed against
``kernel`` at gpt2-small's hd-64 shape too (causal and not) and at hd 32
and 16 (G = 4), in turns parent, kernel, kernel, parent; a parent without
a pair refuses its shape.

Each is built with the package's nvcc flags into build/kernels/tf32_variants/,
called through the kernel's C entry, held against the plain version at
1e-5 of each element (plus 1e-6 of the largest), compared with the kernel's
output bit for bit, and timed per call with CUDA events while the card is
held busy until the call is enqueued (the median of 20: the card's time).
Prints one JSON line per variant and shape with the card's name and power
limit, and writes chiprun_out/flash_tf32_variants.json.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tools"))

from flash_hd128_variants import held_ms, patch  # noqa: E402

VARIANTS = {
    "kernel": [],
    "producer_56": [("constexpr int PRODUCER_REGS = 96;", "constexpr int PRODUCER_REGS = 56;"),
                    ("constexpr int CONSUMER_REGS = 200;", "constexpr int CONSUMER_REGS = 224;")],
    "producer_72": [("constexpr int PRODUCER_REGS = 96;", "constexpr int PRODUCER_REGS = 72;"),
                    ("constexpr int CONSUMER_REGS = 200;", "constexpr int CONSUMER_REGS = 216;")],
    "v_block_test": [("const bool v_block = VC * (BK / 4) == PRODUCERS || grp < BK / 4;",
                      "const bool v_block = grp < BK / 4;")],
    "q_desc_hoisted": [("      sm90::fence_regs(qs_hi);\n      sm90::fence_regs(qs_lo);\n", "")],
    "one_consumer": [("static constexpr int cw = 2 * spans",
                      "static constexpr int cw = 16 * spans")],
    "prefetch_1": [("""    float4 xa[4], xb[4];
    fetch(0, xa);
    if (total > 1) fetch(1, xb);
    for (int n = 0; n < total; n += 2) {
      put(n, xa);
      if (n + 2 < total) fetch(n + 2, xa);
      if (n + 1 < total) {
        put(n + 1, xb);
        if (n + 3 < total) fetch(n + 3, xb);
      }
    }""", """    float4 xa[4];
    fetch(0, xa);
    for (int n = 0; n < total; ++n) {
      put(n, xa);
      if (n + 1 < total) fetch(n + 1, xa);
    }""")],
}

# (name, B, S, H, K, hd, hdv, causal)
SHAPES = [("qwen3_4b", 8, 1024, 32, 8, 128, 128, True),
          ("phi3_mini", 8, 1024, 32, 32, 96, 96, True),
          ("minicpm3_4b", 8, 1024, 40, 40, 96, 64, True),
          ("deepseek_v2_lite", 8, 1024, 16, 16, 192, 128, True),
          ("paligemma_3b", 8, 1024, 8, 1, 256, 256, True)]
PARENT_SHAPES = [("gpt2_small", 8, 1024, 12, 12, 64, 64, True),
                 ("gpt2_small_noncausal", 8, 1024, 12, 12, 64, 64, False),
                 ("hd32_g4", 2, 1024, 8, 2, 32, 32, True),
                 ("hd16_g4_ragged", 2, 1000, 8, 2, 16, 16, True)]
TF32_FLOPS = 495e12


def build(name, source, header, out_dir):
    """(library path or None, ptxas report or the compiler's error)"""
    from repro_torch.kernels import build as kb
    d = out_dir / name
    d.mkdir(parents=True, exist_ok=True)
    (d / "flash_attention_fwd_tf32.cu").write_text(source)
    (d / "sm90.cuh").write_text(header)
    cmd = [kb._nvcc(), *kb.NVCC_FLAGS, "-o", str(d / "lib.so"),
           str(d / "flash_attention_fwd_tf32.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    (d / "ptxas.txt").write_text(proc.stderr)
    return (None if proc.returncode else d / "lib.so"), proc.stderr


def entry(library, source):
    """The C entry of a build as a function of (q, k, v, causal); a source
    whose entry takes no hdv (an older commit's: hd only, v contiguous)
    gets a contiguous v."""
    import torch

    from repro_torch.kernels import flash_attention as fa
    fn = ctypes.CDLL(str(library)).fa_fwd_tf32
    fn.restype = ctypes.c_int
    with_hdv = "long long vhs" in source
    fn.argtypes = fa.ARGTYPES if with_hdv else (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p])

    def call(q, k, v, causal):
        B, S, H, hd = q.shape
        out = q.new_empty((B, S, H, v.shape[3]))
        stream = torch.cuda.current_stream().cuda_stream
        if with_hdv:
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S, H,
                     k.shape[2], hd, v.shape[3], v.stride(2), v.stride(1), v.stride(0),
                     int(causal), 1.0 / hd ** 0.5, stream)
        else:
            v = v.contiguous()
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S, H,
                     k.shape[2], hd if hd == v.shape[3] else -1, int(causal), 1.0 / hd ** 0.5,
                     stream)
        if err:
            raise RuntimeError(f"launch failed ({err})")
        return out
    return call


def builds_report(report, library):
    """Per build: registers, spill bytes, and HGMMA and USETMAXREG in its SASS."""
    from repro_torch.kernels import report as kreport
    return kreport.flash_design(report, kreport.sass_functions(library), "fa_fwd_tf32_kernel")


def make_inputs(gen, B, S, H, K, hd, hdv):
    """q, k, v in fp32; with hdv != hd, v is MLA's strided view: the last
    hdv columns of a (B,S,K,2 hdv) tensor."""
    import torch
    q, k = (torch.randn(B, S, h, hd, generator=gen, device="cuda") for h in (H, K))
    if hdv == hd:
        return q, k, torch.randn(B, S, K, hd, generator=gen, device="cuda")
    return q, k, torch.randn(B, S, K, 2 * hdv, generator=gen, device="cuda")[..., hdv:]


def bound_ms(B, S, H, hd, hdv, causal):
    """3xTF32 FLOP over the TF32 peak (the kernel is bound by operations)."""
    pairs = S * (S + 1) // 2 if causal else S * S
    return 3 * 2 * B * H * pairs * (hd + hdv) / TF32_FLOPS * 1e3


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--build-only", action="store_true",
                    help="build and report ptxas and SASS; launch nothing")
    ap.add_argument("--parent", type=Path, help="another commit's csrc/ to time beside")
    ap.add_argument("--variants", nargs="*", help="only these variants (and kernel)")
    args = ap.parse_args()
    from repro_torch.kernels import build as kb
    from repro_torch.kernels import report as kreport
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    src = (kb.CSRC / "flash_attention_fwd_tf32.cu").read_text()
    header = (kb.CSRC / "sm90.cuh").read_text()
    chosen = {n: s for n, s in VARIANTS.items()
              if not args.variants or n == "kernel" or n in args.variants}
    sources = {name: (patch(src, name, subs), header) for name, subs in chosen.items()}
    if args.parent:
        sources["parent"] = ((args.parent / "flash_attention_fwd_tf32.cu").read_text(),
                             (args.parent / "sm90.cuh").read_text())
    out_dir = kb.BUILD_DIR / "tf32_variants"
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        built = dict(zip(sources, pool.map(lambda kv: build(kv[0], *kv[1], out_dir),
                                           sources.items())))
    results = {"card": card, "builds": {}, "times": []}
    for name, (lib, report) in built.items():
        if lib is None:
            print(json.dumps({"variant": name, "error": report[-3000:]}), flush=True)
            continue
        results["builds"][name] = builds_report(report, lib)
        serialized = kreport.wgmma_serialized(report)
        if serialized:
            results["builds"][name]["wgmma_serialized"] = serialized
        print(json.dumps({"variant": name, "builds": results["builds"][name]}), flush=True)
    if args.build_only:
        (ROOT / "chiprun_out").mkdir(exist_ok=True)
        (ROOT / "chiprun_out" / "flash_tf32_variants.json").write_text(json.dumps(results))
        return 0

    import torch
    from repro_torch.kernels import flash_attention as fa
    fns = {name: entry(lib, sources[name][0]) for name, (lib, _) in built.items()
           if lib is not None}
    gen = torch.Generator(device="cuda").manual_seed(0)
    shapes = SHAPES + (PARENT_SHAPES if "parent" in fns else [])
    for shape, B, S, H, K, hd, hdv, causal in shapes:
        q, k, v = make_inputs(gen, B, S, H, K, hd, hdv)
        want = fa.flash_attention_fwd_plain(q, k, v, causal=causal)
        mine = fns["kernel"](q, k, v, causal)
        order = ["parent", "kernel", "kernel", "parent"] if "parent" in fns else ["kernel"]
        order += [n for n in fns if n not in ("kernel", "parent")]
        times = {}
        for name in order:
            try:
                got = fns[name](q, k, v, causal)
            except RuntimeError as err:
                times[name] = {"error": str(err)}
                continue
            torch.cuda.synchronize()
            lim = 1e-6 * want.abs().max() + 1e-5 * want.abs()
            ms = held_ms(lambda fn=fns[name]: fn(q, k, v, causal))
            rec = times.setdefault(name, {"ms": []})
            rec["ms"].append(ms)
            rec["worst_ratio"] = float(((got - want).abs() / lim).max())
            rec["same_bits"] = bool(torch.equal(got, mine))
            del got
        line = {"shape": shape, "B": B, "S": S, "H": H, "K": K, "hd": hd, "hdv": hdv,
                "causal": causal, "bound_ms": bound_ms(B, S, H, hd, hdv, causal),
                "variants": times}
        results["times"].append(line)
        print(json.dumps(line), flush=True)
        del q, k, v, want, mine
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "flash_tf32_variants.json").write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
