#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA card and check it.

    python3 chip_smoke.py            # needs one CUDA card; exit 0 = all phases passed

Phases:
  build  compile the four CUDA sources with nvcc, one process each, all
         started together, from the sources in this checkout;
  A      the RMNP kernel (csrc/rmnp_update.cu; apply and precondition, one
         line each) against its plain versions at the four gpt2-small
         bucket shapes and llama-130m's five (2048x768 at split K = 6),
         fp32 and bf16 momentum, bf16 weights (the main
         path's), and for the apply kernel also fp32 weights, whose update
         w_new - w is held against the plain version's at its own
         magnitude; per bucket its time, bound, rate, split (K, R, C) and
         path, failing if a bucket takes the two-sweep path; bit for bit,
         a stacked launch against its slices launched alone (both forms)
         and, in fp32, apply against precondition followed by the two-pass
         engine's eager ops; the ptxas report of each instantiation;
  B      the flash-attention forward kernels (bf16: csrc/flash_attention_fwd.cu;
         fp32, 3xTF32: csrc/flash_attention_fwd_tf32.cu; both on the tensor
         cores) against their plain version, in each type at B=8 S=1024
         H=K=12 hd=64, causal and not, a GQA shape (H=8, K=2) with a ragged
         S (causal and not), hd 32 and 16 with G=4, and S in {1, 63, 65,
         129}, each fp32 case also against a float64 softmax; two launches
         must give the same bits; 40 seeds of a non-causal S=1000 GQA head
         must all hold the limit in each type; the ptxas report of both
         kernels is printed, and cuobjdump must find HGMMA in each
         instantiation of each; an fp32 row's bound is that of its 3xTF32
         products on the tensor cores, the FFMA bound is recorded beside
         it; F.scaled_dot_product_attention is timed beside it as a
         yardstick only;
  C      the main path at full width: 3 steps of
         repro_torch.launch.train.train("gpt2-small", reduced=False,
         optimizer="rmnp", single-pass engine, use_kernel=True, batch=8,
         seq=1024) with 4 apply-kernel launches per step; one step of the
         two-pass bucketed engine (4 precondition launches); one step with
         attn_impl="pallas" through make_train_step, whose final hidden
         state and loss must match dense attention's from the same init,
         while a non-causal attention, the control, must not;
  C3f    the same in fp32 (gpt2-small at full width with dtype="float32"):
         one single-pass RMNP step with attn_impl="pallas" (the fp32 flash
         kernel, 24 launches) against dense attention from one init, loss
         and final hidden state within 1e-4, the non-causal control 10x
         outside; then 3 more steps of each, timed, and peak memory;
  E      the GEMM kernel (csrc/matmul.cu) in the three launches of a
         Newton-Schulz step (Gram, polynomial, apply) at gpt2-small's four
         buckets, each against a float64 product on the card, with a
         mutation control that must fail; five iterations kernel against
         plain; ns_step3 on a stack against ns_step on its slices; a ragged
         stack and a 2-D matrix taken on its transposed side; the ptxas
         report of each instantiation is printed, and cuobjdump must find
         HGMMA in all four; each launch's bound is that of its 3xTF32
         products on the tensor cores, the FFMA bound is recorded beside
         it; torch.bmm/baddbmm are timed beside it as yardsticks only;
  C4     Muon on the main path at full width: 3 single-pass steps with 40
         matmul3 and 20 ns_poly3 launches each, one per-leaf step (the 2-D
         kernels for the embedding), one bucketed step each of NorMuon,
         Muown and Nora, and the preconditioning time per step of RMNP
         against Muon (update_apply, CUDA events around each of 10 calls:
         median, min and max, back to back and with the card held busy
         while each call is enqueued, which reads the card's time alone);
  D      a small input: reduced gpt2 with attn_impl="pallas", 3 single-pass
         steps under RMNP and under Muon with the kernels on the card against
         the same steps with the plain versions on the CPU;
  R      checkpointing and the non-finite guard on llama-130m at full width
         (B=8, S=1024, bf16, single-pass RMNP, 6 steps of
         repro_torch.launch.train.train, 5 apply launches a step):
         R1 two uninterrupted runs give the same parameter and state bits;
         R2 stop_at=3 with a checkpoint every 3 steps, then a restart to
         step 6, equals the uninterrupted run bit for bit, and so does a
         restart after a subprocess SIGKILLed (kill_at) with an async save
         in flight, which leaves no .tmp_step_* behind; R3 inject_fault
         "nan:*:2" under the guard skips step 2 naming the poisoned leaf and
         ends on the bits of a clean run that skipped step 2's update, and a
         sticky fault that exhausts the skip budget rewinds to the
         last-known-good checkpoint; R4 each of the four storage faults on a
         checkpoint written here raises CheckpointCorruptionError by name
         and restore_latest falls back to the step before, bit for bit; R5
         reports (no gate) the save() stall async against blocking, the
         step time with a write in flight and with the guard, each the
         median of 5 interleaved, and the bytes of one checkpoint;
  Z      ZeRO-2 through a NCCL group of one rank at full width (gpt2-small,
         B=8, S=1024, bf16, seed 0): Z1 five runs of 3 steps of
         train(zero2=True) (exact and int8 wire, serialized and pipelined,
         accum 2), 4 apply launches a step and no plain version run; the
         exact wire equals the world-1 replicated dp step bit for bit and
         pipelined equals serialized on each wire; the step times of each
         form beside C1's single-device step (5 rounds in turns, medians),
         peak memory, the distance from C1; Z2 each rank's slice of
         gpt2-small's four and llama-130m's five buckets padded 4 and 8
         ways through the RMNP apply kernel, and Newton-Schulz on slices of
         the 768x768 bucket, equal that slice of the whole stack's result
         bit for bit, pads zero; Z3 the int8 codes and scales of one
         bucket's gradient and one world-1 reduce-scatter on the card equal
         the CPU's, and a Muon ZeRO-2 step equals its ZeRO-0 step.

Every phase prints one JSON line; then a line with the card's name and power
limit, a ``kernels`` line, and last ``{"ok": true, "device": ...}``. Any
failed check raises, and the script exits non-zero without the last line.
Details go to chiprun_out/chip_smoke.json.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
FP32_FLOPS = 67e12          # H100 SXM, fp32 outside the tensor cores
BF16_FLOPS = 989e12         # H100 SXM, dense bf16 tensor cores
TF32_FLOPS = 495e12         # H100 SXM, dense TF32 tensor cores
BUCKETS = [(48, 768, 768), (12, 768, 6144), (12, 3072, 768), (1, 50432, 768)]
# llama-130m's five (its 2048x768 bucket takes split K = 6, which no gpt2
# bucket does; the untied head and the embedding are buckets of one)
LLAMA_BUCKETS = [(48, 768, 768), (12, 768, 4096), (12, 2048, 768), (1, 768, 32000),
                 (1, 32000, 768)]
# Phase C3, flash against dense attention in bf16 at full width: the loss,
# and the final hidden state by relative Frobenius distance. The dense path
# rounds its probabilities to bf16 and the kernel keeps them in fp32, so the
# two differ by bf16 rounding carried through 12 layers; the tolerances sit
# a few times above the readings on an H100 (PERF.md), and a non-causal
# attention must land at least 10 times past the hidden-state tolerance.
C3_LOSS_TOL = 1e-3
C3_HIDDEN_TOL = 5e-2
# Phase C3f, the same in fp32: dense attention and the kernel (3xTF32, held
# at 1e-5 of each element in phase B) both compute in fp32, so the loss and
# the hidden state agree to fp32 rounding carried through 12 layers, orders
# of magnitude inside these tolerances; the control must still land at
# least 10 times past the hidden-state tolerance.
C3F_LOSS_TOL = 1e-4
C3F_HIDDEN_TOL = 1e-4
# Newton-Schulz at gpt2-small's buckets, smaller side first: (L, m, n)
NS_BUCKETS = [(48, 768, 768), (12, 768, 6144), (12, 768, 3072), (1, 768, 50432)]
NS_COEFFS = (3.4445, -4.7750, 2.0315)
# Phase E, one launch against a float64 product: the plain version (cuBLAS,
# TF32 off) sums K fp32 products in FMA chains; the kernel sums 3xTF32
# products in slabs of 32 and adds the slabs and the chunks of K in fp32
# (kernels/matmul.py, csrc/matmul.cu). Their errors grow with the chains and
# differ in order. The kernel's worst error may be at most 8x the plain
# version's: room for the chains and for the spread of a maximum over up to
# 3e7 elements, while a skipped k-tile or a transposed operand moves the
# result by O(1) of its size, thousands of times more (the mutation control
# shows it).
E_ERR_FACTOR = 8.0
# Phase E, five Newton-Schulz iterations, kernel against plain, relative
# Frobenius distance. Each launch rounds at a relative ~sqrt(K) * 2^-24 <=
# 1.3e-5 (K = 50432) and the two sides round differently; the quintic
# neither grows nor shrinks a relative error by much (p'(s) / (p(s)/s) stays
# within about 1 in size on [0, 1.2]), so 5 iterations x 3 launches drift
# apart by at most ~2e-4.
NS_REL_TOL = 5e-4
RESULTS = {}
C1_FINAL = {}  # phase C1's final params and momentum (host copies), for phase Z


def emit(name, record):
    RESULTS[name] = record
    print(json.dumps({"phase": name, **record}), flush=True)


def time_ms(fn, iters=10, warmup=2):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def per_call_ms(fn, iters=10, warmup=2, hold_cycles=0):
    """The time of each of ``iters`` calls, CUDA events around each. With
    ``hold_cycles`` the card spins that many cycles before each call
    (torch.cuda._sleep), so the host has enqueued the call before the card
    reaches it and the events read the card's time alone, not the host's."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(iters):
        if hold_cycles:
            torch.cuda.synchronize()
            torch.cuda._sleep(hold_cycles)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return [a.elapsed_time(b) for a, b in events]


def max_err(a, b):
    return float((a.float() - b.float()).abs().max())


def elementwise_err(got, want, rtol, atol_frac=1e-6):
    """(max |got - want|, worst ratio of |got - want| to its limit
    ``atol_frac * max|want| + rtol * |want|``, element by element). A ratio
    above 1 fails. The limit follows each element's own size, so a wrong
    value is caught wherever it exceeds that element's rounding, and not
    hidden under the largest element's."""
    diff = (got.float() - want.float()).abs()
    mag = want.float().abs()
    lim = atol_frac * mag.max() + rtol * mag
    return float(diff.max()), float((diff / lim).max())


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def phase_build():
    from repro_torch.kernels import build
    t0 = time.time()
    libs = ("flash_attention_fwd", "flash_attention_fwd_tf32", "matmul", "rmnp_update")
    # one nvcc per CUDA source, all started together; built even where a
    # library of the same source exists, for its ptxas report
    with concurrent.futures.ThreadPoolExecutor(len(libs)) as pool:
        built = list(pool.map(lambda name: build.build_library(name, force=True), libs))
    emit("build", {"seconds": round(time.time() - t0, 2),
                   "libraries": [lib.name for lib in built],
                   "ptxas": {"matmul": build.PTXAS_REPORTS.get("matmul", "")[-1500:]}})


def rmnp_bytes(shape, v_bytes, w_bytes, apply):
    n = math.prod(shape)
    out = w_bytes * 2 if apply else 4  # w read + written, or d written
    return n * (4 + 2 * v_bytes + out)


def rmnp_instantiation(mangled):
    """``C32_apply_one_read_v32_w16`` for the mangled name of
    ``rmnp_kernel<C, APPLY, ONE_READ, TV, TW>``."""
    import re
    # a repeated type is mangled as a substitution (S1_ for the second bf16)
    m = re.search(r"rmnp_kernelILi(\d+)ELb(\d)ELb(\d)E((?:f|13__nv_bfloat16|S\d*_)+)E", mangled)
    if m is None:
        return mangled
    tv, tw = ("32" if t == "f" else "16"
              for t in re.findall(r"f|13__nv_bfloat16|S\d*_", m.group(4)))
    form = "apply" if m.group(2) == "1" else "precondition"
    path = "one_read" if m.group(3) == "1" else "two_sweep"
    return f"C{m.group(1)}_{form}_{path}_v{tv}" + (f"_w{tw}" if form == "apply" else "")


def phase_rmnp():
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels import rmnp_update as rm
    gen = torch.Generator(device="cuda").manual_seed(0)
    beta, eps = 0.95, 1e-8
    # Each output element is held at atol_frac * max|want| + rtol * |want|.
    # fp32: the kernel sums squares in another order (its own fixed order,
    # csrc/rmnp_update.cu), a few fp32 ulps, so rtol 1e-5. bf16: both sides round
    # nearly equal fp32 values once; where a value straddles a rounding
    # boundary they differ by one bf16 step, at most 2^-7 of the element.
    # atol_frac 1e-6 covers values that cancel to near 0 (the EMA's terms
    # are ~2^-24 off in fp32). The weight update of a bf16 weight is mostly
    # below one bf16 step, so the fp32-weight runs also hold the update
    # itself, w_new - w, at 1e-3 of its largest value: w_new - w is exact to
    # an fp32 ulp of w (~1e-8), the update is ~1e-4, and a kernel that drops
    # it, flips its sign or normalizes over d_out misses it by its own size.
    rtol = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}
    update_rtol = 1e-3
    kernels = {
        "rmnp_apply": (
            lambda g, v, w, sc: rm.rmnp_rownorm_apply(g, v, w, sc, beta=beta, eps=eps),
            lambda g, v, w, sc: rm.rmnp_rownorm_apply_plain(g, v, w, sc, beta=beta, eps=eps),
            True),
        "rmnp_precondition": (
            lambda g, v, w, sc: rm.rmnp_rownorm(g, v, beta=beta, eps=eps),
            lambda g, v, w, sc: rm.rmnp_rownorm_plain(g, v, beta=beta, eps=eps),
            False),
    }
    # (momentum, weights): the main path's types, bf16 momentum, and fp32
    # weights for the update check (the precondition kernel reads no weights)
    combos = [(torch.float32, torch.bfloat16), (torch.bfloat16, torch.bfloat16),
              (torch.float32, torch.float32)]
    rows, bitwise = {name: [] for name in kernels}, []
    summary = {name: {"max_abs_err": 0.0, "worst_ratio": 0.0, "ms": 0.0,
                      "plain_ms": 0.0, "bound_ms": 0.0,
                      "llama": {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                                "max_abs_err": 0.0}} for name in kernels}
    for model, shape in ([("gpt2-small", b) for b in BUCKETS]
                         + [("llama-130m", b) for b in LLAMA_BUCKETS]):
        layout = rm.split(*shape[1:])
        path = "one-read" if layout.one_read else "two-sweep"
        check(layout.one_read, f"rmnp {shape}: split {layout} takes the two-sweep path")
        for vdt, wdt in combos:
            g = torch.randn(shape, generator=gen, device="cuda") * 1e-3
            v = (torch.randn(shape, generator=gen, device="cuda") * 1e-3).to(vdt)
            w = (torch.randn(shape, generator=gen, device="cuda") * 0.02).to(wdt)
            scalars = torch.tensor([2e-3 * max(1.0, (shape[2] / shape[1]) ** 0.5), 0.1],
                                   device="cuda")
            vb, wb = v.element_size(), w.element_size()
            for name, (kernel, plain, apply) in kernels.items():
                if not apply and wdt == torch.float32:
                    continue
                got = kernel(g, v, w, scalars)
                want = plain(g, v, w, scalars)
                torch.cuda.synchronize()
                rec = {"model": model, "shape": list(shape),
                       "momentum": str(vdt).split(".")[1], "weights": str(wdt).split(".")[1]}
                err, ratio = 0.0, 0.0
                for out, a, b in zip(("v", "w" if apply else "d"), got, want, strict=True):
                    check(torch.isfinite(a.float()).all().item(),
                          f"{name} {out} {shape} not finite")
                    e, r = elementwise_err(a, b, rtol[a.dtype])
                    rec[f"{out}_max_abs_err"], rec[f"{out}_worst_ratio"] = e, r
                    check(r <= 1.0, f"{name} {out} {shape} {vdt} {wdt}: max_abs_err {e}, "
                                    f"worst ratio to the limit {r} > 1")
                    err, ratio = max(err, e), max(ratio, r)
                if apply and wdt == torch.float32:
                    u_got, u_want = got[1] - w, want[1] - w
                    e = max_err(u_got, u_want)
                    lim = update_rtol * float(u_want.abs().max())
                    rec.update(update_max_abs_err=e, update_max=float(u_want.abs().max()),
                               update_tolerance=lim)
                    check(e <= lim, f"{name} update {shape}: max_abs_err {e} > {lim}")
                    del u_got, u_want
                del got, want
                nbytes = rmnp_bytes(shape, vb, wb, apply)
                clusters = rm.max_active_clusters(shape, vdt, wdt, apply=apply)
                check(clusters > 0, f"{name} {shape}: no cluster of {layout} fits the card")
                rec.update(max_abs_err=err, worst_ratio=ratio,
                           kernel_ms=time_ms(lambda: kernel(g, v, w, scalars)),
                           plain_ms=time_ms(lambda: plain(g, v, w, scalars)),
                           bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
                           split=layout._asdict(), path=path, clusters_at_once=clusters)
                rec["gb_s"] = nbytes / rec["kernel_ms"] / 1e6
                rows[name].append(rec)
                print(f"{name} {model} {'x'.join(map(str, shape))} v {rec['momentum']} w "
                      f"{rec['weights']}: {rec['kernel_ms']:.4f} ms, bound "
                      f"{rec['bound_ms']:.4f} ms, {rec['gb_s']:.0f} GB/s, plain "
                      f"{rec['plain_ms']:.4f} ms; K={layout.K} R={layout.R} C={layout.C} "
                      f"threads={layout.threads}, {path}, {clusters} clusters at once",
                      flush=True)
                if (vdt, wdt) == combos[0] and model == "llama-130m":
                    s = summary[name]["llama"]
                    s["max_abs_err"] = max(s["max_abs_err"], err)
                    for k in ("ms", "plain_ms", "bound_ms"):
                        s[k] += rec["kernel_ms" if k == "ms" else k]
                elif (vdt, wdt) == combos[0]:  # the main path's types
                    s = summary[name]
                    s["max_abs_err"] = max(s["max_abs_err"], err)
                    s["worst_ratio"] = max(s["worst_ratio"], ratio)
                    s["ms"] += rec["kernel_ms"]
                    s["plain_ms"] += rec["plain_ms"]
                    s["bound_ms"] += rec["bound_ms"]
            del g, v, w
            torch.cuda.empty_cache()
        bitwise.append(dict(rmnp_bitwise(shape, gen, beta, eps), model=model))
    for name, recs in rows.items():
        emit(f"A_{name}", {"buckets": recs})
    ptxas = ptxas_lines(build.PTXAS_REPORTS.get("rmnp_update", ""), "rmnp_kernel", "",
                        key=rmnp_instantiation)
    check(len(ptxas) == 30, f"rmnp: {len(ptxas)} instantiations in the ptxas report, want 30")
    for key, line in sorted(ptxas.items()):
        print(f"ptxas rmnp_kernel {key}: {line}", flush=True)
    emit("A_rmnp_bitwise", {"buckets": bitwise, "ptxas": ptxas})
    return summary


def rmnp_bitwise(shape, gen, beta, eps):
    """Bit for bit at one bucket: a stacked launch against each slice
    launched alone (both forms; fp32 momentum, bf16 weights), and in fp32
    apply against precondition followed by the two-pass engine's eager ops
    (``-scale * (d + wd * w)``, then ``w + update``)."""
    import torch
    from repro_torch.kernels import rmnp_update as rm
    g = torch.randn(shape, generator=gen, device="cuda") * 1e-3
    v = torch.randn(shape, generator=gen, device="cuda") * 1e-3
    w = torch.randn(shape, generator=gen, device="cuda") * 0.02
    scalars = torch.tensor([2e-3, 0.1], device="cuda")
    w16 = w.to(torch.bfloat16)
    stacked = {"precondition": rm.rmnp_rownorm(g, v, beta=beta, eps=eps),
               "apply": rm.rmnp_rownorm_apply(g, v, w16, scalars, beta=beta, eps=eps)}
    slices = {"precondition": 0, "apply": 0}
    for i in range(shape[0]):
        one = {"precondition": rm.rmnp_rownorm(g[i:i + 1], v[i:i + 1], beta=beta, eps=eps),
               "apply": rm.rmnp_rownorm_apply(g[i:i + 1], v[i:i + 1], w16[i:i + 1], scalars,
                                              beta=beta, eps=eps)}
        for form, outs in one.items():
            slices[form] += all(torch.equal(a[i], b[0])
                                for a, b in zip(stacked[form], outs, strict=True))
    del stacked, w16
    v_apply, w_apply = rm.rmnp_rownorm_apply(g, v, w, scalars, beta=beta, eps=eps)
    v_pre, d = rm.rmnp_rownorm(g, v, beta=beta, eps=eps)
    two_pass = w + -scalars[0] * (d + 0.1 * w)
    rec = {"shape": list(shape), "slices_equal": slices, "slices": shape[0],
           "apply_v_equals_precondition_v": bool(torch.equal(v_apply, v_pre)),
           "apply_w_equals_two_pass_w": bool(torch.equal(w_apply, two_pass)),
           "apply_w_two_pass_max_abs_diff": max_err(w_apply, two_pass)}
    check(slices == {"precondition": shape[0], "apply": shape[0]},
          f"rmnp {shape}: a stacked launch differs from its slices {slices}")
    check(rec["apply_v_equals_precondition_v"] and rec["apply_w_equals_two_pass_w"],
          f"rmnp {shape}: apply differs from precondition + eager ops {rec}")
    return rec


def attention_flops(B, S, H, hd, causal=True):
    pairs = S * (S + 1) // 2 if causal else S * S  # causal: the lower triangle
    return 4 * B * H * hd * pairs


def template_args(mangled):
    """The integer and bool template arguments in a mangled kernel name
    (``ILi64E``: 64; ``ILb1ELb0E``: 1, 0)."""
    import re
    return re.findall(r"L[ib](\d+)E", mangled)


def ptxas_lines(report, marker, prefix, key=None):
    """Registers, stack and spills of each function whose name holds
    ``marker``, from an ``nvcc -Xptxas -v`` report, keyed by ``prefix`` and
    the template arguments in its mangled name (``hd`` and ``ILi64E``:
    hd64), or by ``key(mangled name)``."""
    import re
    out, name = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1) if marker in m.group(1) else None
            continue
        if name is None:
            continue
        k = key(name) if key else prefix + "_".join(template_args(name))
        if "spill" in line or "Used" in line:
            out[k] = (out.get(k, "") + " " + line.split(":", 1)[-1].strip()).strip()
    return out


def hgmma_counts(library):
    """HGMMA instructions in the SASS of each kernel of a built library,
    read with cuobjdump (the CUDA toolkit's, else the copy in Triton's
    package)."""
    import re
    from repro_torch.kernels import build
    tool = Path(build._nvcc()).with_name("cuobjdump")
    if not tool.exists():
        import triton
        tool = Path(triton.__file__).parent / "backends" / "nvidia" / "bin" / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(library)], capture_output=True, text=True,
                          check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            kind = re.search(r"fa_fwd_tc|fa_fwd_tf32_kernel|gemm_kernel", m.group(1))
            args = template_args(m.group(1))
            name = (kind.group(0) + "".join(f"_{a}" for a in args)) if kind else m.group(1)
            counts[name] = 0
        elif name and "HGMMA" in line:
            counts[name] += 1
    return counts


def attention_bounds(B, S, H, K, hd, dtype, causal):
    """(bound_ms, bound_by, ffma_ms or None): q/k/v read once and the output
    written once over the memory rate, against the FLOP at the peak of the
    units the kernel runs them on: bf16 on the tensor cores; fp32 as three
    TF32 products per fp32 product on the tensor cores (3xTF32). For fp32
    also the same with the FLOP at the CUDA cores' FFMA rate, for the
    record only."""
    import torch
    size = 2 if dtype == torch.bfloat16 else 4
    t_bytes = (2 * B * S * H * hd + 2 * B * S * K * hd) * size / HBM_BYTES_PER_S * 1e3
    flops = attention_flops(B, S, H, hd, causal)
    t_ops = (flops / BF16_FLOPS if size == 2 else 3 * flops / TF32_FLOPS) * 1e3
    ffma = None if size == 2 else max(flops / FP32_FLOPS * 1e3, t_bytes)
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations", ffma


def exact_attention(q, k, v, causal):
    """Softmax attention in float64 (dense, kv head h // G), (B,S,H,hd)."""
    import torch
    G = q.shape[2] // k.shape[2]
    qd, kd, vd = (x.double().transpose(1, 2) for x in (q, k, v))
    kd, vd = kd.repeat_interleave(G, 1), vd.repeat_interleave(G, 1)
    s = qd @ kd.transpose(-1, -2) / q.shape[-1] ** 0.5
    if causal:
        S = q.shape[1]
        s = s.masked_fill(torch.ones(S, S, dtype=torch.bool, device=q.device).triu(1),
                          float("-inf"))
    return (torch.softmax(s, -1) @ vd).transpose(1, 2)


def attention_inputs(gen, B, S, H, K, hd, dtype):
    import torch
    return [torch.randn(B, S, h, hd, generator=gen, device="cuda").to(dtype) for h in (H, K, K)]


def phase_attention():
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(1)
    bf16, fp32 = torch.bfloat16, torch.float32
    # (name, B, S, H, K, hd, dtype, causal, timed): in each type the main
    # path's shape causal and not, GQA with a ragged S causal and not, hd 32
    # and 16 with G = 4, and ragged S around the 64-key tile and the 128-row
    # query tile; timed: bf16 at the main shape causal and not and at the
    # GQA shape, fp32 at the main shape and at the GQA shape (row 3f)
    cases = [("main", 8, 1024, 12, 12, 64, bf16, True, True),
             ("main_noncausal", 8, 1024, 12, 12, 64, bf16, False, True),
             ("gqa_ragged", 2, 1000, 8, 2, 64, bf16, True, True),
             ("gqa_ragged_fp32", 2, 1000, 8, 2, 64, fp32, True, True),
             ("gqa_ragged_noncausal", 2, 1000, 8, 2, 64, bf16, False, False),
             ("hd32_g4", 2, 1024, 8, 2, 32, bf16, True, False),
             ("hd16_g4", 2, 1024, 8, 2, 16, bf16, True, False)]
    cases += [(f"s{S}", 2, S, 8, 2, 64, bf16, True, False) for S in (1, 63, 65, 129)]
    cases += [("main_fp32", 8, 1024, 12, 12, 64, fp32, True, True),
              ("main_fp32_noncausal", 8, 1024, 12, 12, 64, fp32, False, False),
              ("gqa_ragged_fp32_noncausal", 2, 1000, 8, 2, 64, fp32, False, False),
              ("hd32_g4_fp32", 2, 1024, 8, 2, 32, fp32, True, False),
              ("hd16_g4_fp32", 2, 1024, 8, 2, 16, fp32, True, False)]
    cases += [(f"s{S}_fp32", 2, S, 8, 2, 64, fp32, True, False) for S in (1, 63, 65, 129)]
    # Each output element is held at 1e-6 * max|want| + rtol * |want|
    # (elementwise_err). fp32: the plain version sums fp32 products, the
    # kernel 3xTF32 products (to about 2^-22 each) in its own order, and
    # both agree to a few fp32 ulps of each element: rtol 1e-5. bf16: both
    # compute in fp32 (the kernel keeps p to fp32 accuracy in three bf16
    # parts) and round once; where a value straddles a rounding boundary they
    # differ by one bf16 step, at most 2^-7 of the element.
    rtol = {bf16: 2.0 ** -7, fp32: 1e-5}
    rows, inputs = [], {}
    for name, B, S, H, K, hd, dt, causal, timed in cases:
        q, k, v = attention_inputs(gen, B, S, H, K, hd, dt)
        inputs[name] = (q, k, v, causal)
        out = fa.flash_attention_fwd_kernel(q, k, v, causal=causal)
        ref = fa.flash_attention_fwd_plain(q, k, v, causal=causal,
                                           block_q=min(512, S), block_k=min(512, S))
        torch.cuda.synchronize()
        e, ratio = elementwise_err(out, ref, rtol[dt])
        check(out.shape == q.shape and torch.isfinite(out.float()).all().item(),
              f"attention {name}: bad output")
        check(ratio <= 1.0, f"attention {name}: max_abs_err {e}, worst ratio {ratio} > 1")
        rec = {"case": name, "B": B, "S": S, "H": H, "K": K, "hd": hd,
               "dtype": str(dt).split(".")[1], "causal": causal, "max_abs_err": e,
               "worst_ratio": ratio}
        if dt == fp32:
            # also against a float64 softmax, so that a miss is assigned to
            # the kernel or to the plain version
            exact = exact_attention(q, k, v, causal)
            rec["worst_ratio_float64"] = elementwise_err(out, exact, rtol[dt])[1]
            rec["plain_worst_ratio_float64"] = elementwise_err(ref, exact, rtol[dt])[1]
            check(rec["worst_ratio_float64"] <= 1.0,
                  f"attention {name}: against float64, worst ratio "
                  f"{rec['worst_ratio_float64']} > 1")
            del exact
        del out, ref
        if timed:
            qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
            rec.update(
                kernel_ms=time_ms(lambda: fa.flash_attention_fwd_kernel(q, k, v, causal=causal)),
                plain_ms=time_ms(lambda: fa.flash_attention_fwd_plain(
                    q, k, v, causal=causal, block_q=min(512, S), block_k=min(512, S)), iters=3),
                library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=causal, enable_gqa=K != H)))
            del qt, kt, vt
            bound, by, ffma = attention_bounds(B, S, H, K, hd, dt, causal)
            rec.update(bound_ms=bound, bound_by=by)
            if ffma is not None:
                rec["bound_ffma_ms"] = ffma
            rec["tflops"] = attention_flops(B, S, H, hd, causal) / rec["kernel_ms"] / 1e9
            print(f"attention {name}: {rec['kernel_ms']:.4f} ms, bound {bound:.4f} ms ({by})"
                  + (f", FFMA bound {ffma:.4f} ms" if ffma is not None else "")
                  + f", SDPA {rec['library_ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms",
                  flush=True)
        rows.append(rec)

    # two launches on the same input give the same bits (no atomics)
    for name in ("main", "main_fp32"):
        q, k, v, causal = inputs[name]
        a = fa.flash_attention_fwd_kernel(q, k, v)
        b = fa.flash_attention_fwd_kernel(q, k, v)
        check(torch.equal(a, b), f"attention: two launches on the {name} input differ")
        del a, b

    # Near-zero elements of non-causal rows over ~1000 keys are where P's
    # precision (bf16) and the 3xTF32 sums (fp32) show: one head config,
    # many seeds, every element of every seed held at the limit. bf16 is
    # held against the plain version, whose fp32 error is far below a bf16
    # step. fp32 is held against a float64 softmax: there the plain
    # version's own fp32 error reaches 0.93-0.96 of the limit on near-zero
    # elements (PERF.md, PR 17), so a reading against it measures the plain
    # version; the kernel's reading against the plain version is reported
    # beside it.
    def seeds_over_limit(dt, n=40):
        over, worst, ratios = 0, 0.0, []
        g = torch.Generator(device="cuda").manual_seed(3)
        for _ in range(n):
            q, k, v = attention_inputs(g, 1, 1000, 4, 1, 64, dt)
            got = fa.flash_attention_fwd_kernel(q, k, v, causal=False)
            want = fa.flash_attention_fwd_plain(q, k, v, causal=False)
            if dt == fp32:
                exact = exact_attention(q, k, v, causal=False)
                ratios.append({"kernel_float64": elementwise_err(got, exact, rtol[dt])[1],
                               "plain_float64": elementwise_err(want, exact, rtol[dt])[1],
                               "kernel_plain": elementwise_err(got, want, rtol[dt])[1]})
                r = ratios[-1]["kernel_float64"]
            else:
                r = elementwise_err(got, want, rtol[dt])[1]
            over, worst = over + (r > 1.0), max(worst, r)
        out = {"seeds": n, "reference": "float64" if dt == fp32 else "plain",
               "over_limit": over, "worst_ratio": worst}
        if ratios:
            out.update({f"worst_{k}": max(r[k] for r in ratios) for k in ratios[0]})
            out["per_seed"] = ratios
        return out

    stress = {"bf16": seeds_over_limit(bf16), "fp32": seeds_over_limit(fp32)}
    check(all(r["over_limit"] == 0 for r in stress.values()),
          f"attention: the non-causal seed sweep missed the limit {stress}")
    ptxas, hgmma = {}, {}
    for lib, kernel in (("flash_attention_fwd", "fa_fwd_tc"),
                        ("flash_attention_fwd_tf32", "fa_fwd_tf32_kernel")):
        lines = ptxas_lines(build.PTXAS_REPORTS.get(lib, ""), kernel, "hd")
        counts = hgmma_counts(build.library_path(lib))
        ours = {n: c for n, c in counts.items() if n.startswith(kernel)}
        check(len(ours) == len(fa.HEAD_DIMS) and all(c > 0 for c in ours.values()),
              f"attention: HGMMA missing from {kernel}'s SASS: {counts}")
        for key, line in lines.items():
            print(f"ptxas {kernel} {key}: {line}", flush=True)
        ptxas[kernel], hgmma[kernel] = lines, ours
    emit("B_attention", {"cases": rows, "noncausal_seeds": stress, "ptxas": ptxas,
                         "hgmma": hgmma})
    del inputs
    torch.cuda.empty_cache()
    return {r["case"]: r for r in rows}


def gemm_bound(L, M, N, K, reads):
    """(bound_ms, bound_by, ffma_ms) of one GEMM launch: ``reads`` input
    elements read once and the (L, M, N) output written once over the
    memory rate, against the 2MNK FLOP as the kernel runs them, three TF32
    products per fp32 product at the TF32 tensor-core rate (3xTF32); and,
    for the record only, the same with 2MNK FLOP plus the epilogue at the
    fp32 CUDA-core (FFMA) rate."""
    t_ops = 3 * L * 2 * M * N * K / TF32_FLOPS * 1e3
    t_bytes = 4 * (reads + L * M * N) / HBM_BYTES_PER_S * 1e3
    t_ffma = max(L * (2 * M * N * K + 3 * M * N) / FP32_FLOPS * 1e3, t_bytes)
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes", t_ffma


def phase_ns():
    """The GEMM kernel in its three Newton-Schulz launches, each against a
    float64 product on the card, with a mutation control; five iterations
    kernel against plain; ns_step3 against ns_step slice by slice; times."""
    import torch
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import newton_schulz as nsk
    from repro_torch.kernels import ops
    a, b, c = NS_COEFFS
    gen = torch.Generator(device="cuda").manual_seed(2)

    def normalized(shape):
        x = torch.randn(shape, generator=gen, device="cuda")
        return x / (torch.linalg.vector_norm(x, dim=(-2, -1), keepdim=True) + 1e-7)

    def launches(x):
        """(name, kernel, plain, library, float64 reference, reads) of the
        three launch kinds, each fed exact fp32 inputs (the float64 results
        of the launch before, rounded once)."""
        L, m, n = x.shape
        x64 = x.double()
        g64 = x64 @ x64.transpose(1, 2)
        g = g64.float()
        g64 = g.double()
        p64 = b * g64 + c * (g64 @ g64)
        p = p64.float()
        p64 = p.double()
        xt = x.transpose(1, 2)
        return [
            ("gram", lambda: mm.gemm(x, xt), lambda: nsk.gram_plain(x),
             lambda: torch.bmm(x, xt), x64 @ x64.transpose(1, 2), (L, m, m, n), L * m * n),
            ("poly", lambda: mm.gemm(g, g, g, alpha=c, beta=b),
             lambda: nsk.poly_plain(g, b, c),
             lambda: torch.baddbmm(g, g, g, beta=b, alpha=c), p64, (L, m, m, m), L * m * m),
            ("apply", lambda: mm.gemm(p, x, x, alpha=1.0, beta=a),
             lambda: nsk.apply_plain(p, x, a),
             lambda: torch.baddbmm(x, p, x, beta=a), a * x64 + p64 @ x64, (L, m, n, m),
             L * (m * m + m * n)),
        ]

    def held(name, shape, kernel, plain, want, record):
        got, ref = kernel(), plain()
        torch.cuda.synchronize()
        check(got.shape == want.shape and torch.isfinite(got).all().item(),
              f"{name} {shape}: bad output")
        e_k = float((got.double() - want).abs().max())
        e_p = float((ref.double() - want).abs().max())
        record.update(kernel_err64=e_k, plain_err64=e_p, max_abs_err=max_err(got, ref),
                      err_ratio=e_k / max(e_p, 1e-30))
        check(e_k <= E_ERR_FACTOR * e_p,
              f"{name} {shape}: kernel error {e_k} > {E_ERR_FACTOR} x plain error {e_p}")
        return got

    rows, per_kind = [], {}
    for shape in NS_BUCKETS + [(3, 100, 300)]:
        L, m, n = shape
        x = normalized(shape)
        for name, kernel, plain, library, want, (Lb, M, N, K), reads in launches(x):
            rec = {"kind": name, "shape": list(shape)}
            held(name, shape, kernel, plain, want, rec)
            if shape == (3, 100, 300):
                rows.append(rec)
                continue
            bound, by, ffma = gemm_bound(Lb, M, N, K, reads)
            rec.update(ms=time_ms(kernel), plain_ms=time_ms(plain, iters=3),
                       library_ms=time_ms(library), bound_ms=bound, bound_by=by,
                       bound_ffma_ms=ffma)
            rows.append(rec)
            per_kind.setdefault(name, []).append(rec)
            del want
        # mutation control: the Gram with its last k-tile of 8 skipped must fail
        if shape == NS_BUCKETS[0]:
            want = x.double() @ x.double().transpose(1, 2)
            try:
                held("gram-skipped-k-tile", shape,
                     lambda: mm.gemm(x[..., :-8], x[..., :-8].transpose(1, 2)),
                     lambda: nsk.gram_plain(x), want, {})
            except AssertionError as exc:
                control = str(exc)
            else:
                raise AssertionError("the mutation control (a skipped k-tile) passed the check")
            del want
        # five iterations, kernel against plain, and the stack against its slices
        yk = yp = x
        for _ in range(5):
            yk, yp = ops.ns_step(yk, a, b, c), nsk.ns_step3_plain(yp, a, b, c)
        rel = float(torch.linalg.vector_norm(yk - yp) / torch.linalg.vector_norm(yp))
        one = nsk.ns_step3(x, a, b, c)
        same = all(torch.equal(one[i], nsk.ns_step(x[i], a, b, c)) for i in {0, L - 1})
        rows.append({"kind": "newton_schulz_5", "shape": list(shape), "rel_frobenius": rel,
                     "tolerance": NS_REL_TOL, "stack_equals_slices": same})
        check(rel <= NS_REL_TOL, f"newton_schulz {shape}: relative distance {rel} > {NS_REL_TOL}")
        check(same, f"ns_step3 {shape}: a slice differs from ns_step on that slice")
        del x, yk, yp, one
        torch.cuda.empty_cache()

    # the 2-D path on the transposed side: rows > cols goes through X^T
    from repro_torch.core.muon import newton_schulz
    v = torch.randn(300, 100, generator=gen, device="cuda")
    got = newton_schulz(v)
    x = v.T / (torch.linalg.vector_norm(v) + 1e-7)
    for _ in range(5):
        x = nsk.ns_step_plain(x, a, b, c)
    rel = float(torch.linalg.vector_norm(got - x.T) / torch.linalg.vector_norm(x))
    rows.append({"kind": "newton_schulz_5_2d_transposed", "shape": [300, 100],
                 "rel_frobenius": rel, "tolerance": NS_REL_TOL})
    check(got.shape == v.shape and rel <= NS_REL_TOL,
          f"2-D transposed newton_schulz: relative distance {rel}")

    # the kernel's build: registers, spills and shared memory of each
    # instantiation, and wgmma (HGMMA) in the SASS of every one
    from repro_torch.kernels import build
    ptxas = ptxas_lines(build.PTXAS_REPORTS.get("matmul", ""), "gemm_kernel", "ab")
    hgmma = hgmma_counts(build.library_path("matmul"))
    gemms = {n: c for n, c in hgmma.items() if n.startswith("gemm_kernel")}
    check(len(gemms) == 4 and all(c > 0 for c in gemms.values()),
          f"GEMM: HGMMA missing from a kernel instantiation's SASS: {hgmma}")
    for key, line in ptxas.items():
        print(f"ptxas gemm_kernel {key}: {line}", flush=True)

    # The per-leaf engine runs the embedding leaf (50432, 768) through the 2-D
    # wrappers: the same launches as the L = 1 bucket (checked bit for bit
    # above, ns_step against ns_step3), so their rows take that bucket's times.
    emit("E_newton_schulz", {"launches": rows, "mutation_control": control,
                             "err_factor": E_ERR_FACTOR, "ptxas": ptxas, "hgmma": hgmma})

    def total(recs):
        out = {k: sum(r[k] for r in recs)
               for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
        out["max_abs_err"] = max(r["max_abs_err"] for r in recs)
        out["bound_by"] = ("operations" if all(r["bound_by"] == "operations" for r in recs)
                           else "bytes")
        return out

    def embedding(recs):
        return [r for r in recs if r["shape"] == list(NS_BUCKETS[-1])]

    return {"matmul3": total(per_kind["gram"] + per_kind["apply"]),
            "ns_poly3": total(per_kind["poly"]),
            "matmul": total(embedding(per_kind["gram"] + per_kind["apply"])),
            "ns_poly": total(embedding(per_kind["poly"]))}


def phase_train():
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import cosine_with_warmup, make_optimizer
    from repro_torch.data.pipeline import make_stream
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.train import batch_to_device, train
    from repro_torch.models import init_params, layers
    from repro_torch.models.model import forward
    from repro_torch.train.step import make_train_step

    main_launches = {}
    # C1: the main path, single-pass engine
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    params, state, hist = train("gpt2-small", reduced=False, optimizer="rmnp",
                                fused=True, fused_apply=True, use_kernel=True,
                                batch=8, seq=1024, steps=3, log_every=1)
    torch.cuda.synchronize()
    secs = time.time() - t0
    counts = dict(LAUNCHES)
    losses = [h["loss"] for h in hist]
    check(len(losses) == 3 and all(math.isfinite(x) for x in losses),
          f"train losses {losses}")
    check([h["launches"]["rmnp_apply"] for h in hist] == [4, 4, 4],
          f"apply launches per step {[h['launches'] for h in hist]}")
    check(counts["rmnp_apply"] == 12, f"apply launches {counts}")
    main_launches["rmnp_apply"] = counts["rmnp_apply"]
    C1_FINAL.update(final=host_copy((params, state.buckets)),
                    step_s=step_seconds(hist),
                    peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30)
    n_matrix = sum(b.numel() for b in state.buckets.values())
    buckets = {k: list(b.shape) for k, b in state.buckets.items()}
    check(sorted(buckets) == ["3072x768", "50432x768", "768x6144", "768x768"],
          f"buckets {buckets}")
    del params, state
    torch.cuda.empty_cache()
    # each step ends in a host read of its metrics, so the differences of the
    # cumulative wall clock are step times (step 0 includes first-use set-up)
    walls = [0.0] + [h["wall_s"] for h in hist]
    emit("C1_train_single_pass", {"losses": losses, "seconds": round(secs, 2),
                                  "step_s": [b - a for a, b in zip(walls, walls[1:])],
                                  "launches": counts, "buckets": buckets,
                                  "matrix_params": n_matrix,
                                  "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30})

    # C2: the two-pass bucketed engine runs the precondition kernel
    reset_launches()
    _, _, hist2 = train("gpt2-small", reduced=False, optimizer="rmnp", fused=True,
                        fused_apply=False, use_kernel=True, batch=8, seq=1024,
                        steps=1, log_every=1)
    counts = dict(LAUNCHES)
    check(counts["rmnp_precondition"] == 4 and math.isfinite(hist2[0]["loss"]),
          f"bucketed step: launches {counts}, loss {hist2[0]['loss']}")
    main_launches["rmnp_precondition"] = counts["rmnp_precondition"]
    torch.cuda.empty_cache()
    emit("C2_train_bucketed", {"loss": hist2[0]["loss"], "launches": counts})

    # C3: attn_impl="pallas" against dense attention from the same init. At
    # init the loss (about ln 50432) hardly depends on attention, so the
    # final hidden state (after the last norm, O(1) values) is compared too,
    # by its relative Frobenius distance, and a control shows that the
    # comparison sees a wrong attention: the dense path made non-causal.
    base = get_config("gpt2-small")
    hidden, loss = {}, {}
    batch = batch_to_device(make_stream(base, 1024, 8, seed=0).sample(0), "cuda")
    dense_attention = layers.attention
    for run in ("auto", "pallas", "control"):
        cfg = dataclasses.replace(base, attn_impl="auto" if run == "control" else run)
        params = init_params(cfg, seed=0, device="cuda")
        if run == "control":
            layers.attention = lambda q, k, v, causal=True, **kw: dense_attention(
                q, k, v, False, **kw)
        try:
            with torch.no_grad():
                hidden[run] = forward(cfg, params, batch, return_hidden=True)[0].float()
        finally:
            layers.attention = dense_attention
        if run != "control":
            opt = make_optimizer("rmnp", dict(
                lr_matrix=cosine_with_warmup(2e-3, 3), lr_adamw=cosine_with_warmup(1e-3, 3),
                fused=True, fused_apply=True, use_kernel=True))
            state = opt.init(params)
            step_fn = make_train_step(cfg, opt, remat="full")
            reset_launches()
            params, state, metrics = step_fn(params, state, batch, 0)
            torch.cuda.synchronize()
            loss[run] = float(metrics["loss"])
            if run == "pallas":
                counts = dict(LAUNCHES)
            del state
        del params
        torch.cuda.empty_cache()

    def rel(a, b):
        return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))

    rel_flash = rel(hidden["pallas"], hidden["auto"])
    rel_control = rel(hidden["control"], hidden["auto"])
    diff = abs(loss["auto"] - loss["pallas"])
    emit("C3_train_flash", {"loss_dense": loss["auto"], "loss_flash": loss["pallas"],
                            "loss_abs_diff": diff, "loss_tolerance": C3_LOSS_TOL,
                            "hidden_rel_flash": rel_flash, "hidden_rel_control": rel_control,
                            "hidden_tolerance": C3_HIDDEN_TOL, "launches": counts})
    # 12 layers' forward, and each again when remat="full" recomputes it
    check(counts["flash_attention_fwd"] == 2 * base.num_layers, f"flash launches {counts}")
    check(math.isfinite(loss["pallas"]) and diff <= C3_LOSS_TOL,
          f"pallas loss {loss['pallas']} vs dense {loss['auto']}")
    check(rel_flash <= C3_HIDDEN_TOL, f"hidden state: flash {rel_flash} > {C3_HIDDEN_TOL}")
    check(rel_control >= 10 * C3_HIDDEN_TOL,
          f"hidden state: the non-causal control is only {rel_control} from dense, "
          f"less than 10x the tolerance {C3_HIDDEN_TOL}")
    main_launches["flash_attention_fwd"] = counts["flash_attention_fwd"]
    return main_launches


def phase_train_fp32():
    """C3f: gpt2-small at full width in fp32 with attn_impl="pallas", the
    fp32 flash kernel on the main path, against dense attention from one
    init: the final hidden state (and a non-causal control), one single-pass
    RMNP step under remat="full" (24 launches: 12 layers' forward and each
    again in the recompute) and its loss, then 3 more steps of each, timed
    on the host clock (each ends in a host read of the loss)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import cosine_with_warmup, make_optimizer
    from repro_torch.data.pipeline import make_stream
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.train import batch_to_device
    from repro_torch.models import init_params, layers
    from repro_torch.models.model import forward
    from repro_torch.train.step import make_train_step

    base = dataclasses.replace(get_config("gpt2-small"), dtype="float32")
    batch = batch_to_device(make_stream(base, 1024, 8, seed=0).sample(0), "cuda")
    dense_attention = layers.attention
    hidden, loss, step_s, peak, counts = {}, {}, {}, {}, {}
    for run in ("auto", "pallas", "control"):
        cfg = dataclasses.replace(base, attn_impl="auto" if run == "control" else run)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        params = init_params(cfg, seed=0, device="cuda")
        if run == "control":
            layers.attention = lambda q, k, v, causal=True, **kw: dense_attention(
                q, k, v, False, **kw)
        try:
            with torch.no_grad():
                hidden[run] = forward(cfg, params, batch, return_hidden=True)[0].float()
        finally:
            layers.attention = dense_attention
        if run == "control":
            del params
            continue
        opt = make_optimizer("rmnp", dict(
            lr_matrix=cosine_with_warmup(2e-3, 4), lr_adamw=cosine_with_warmup(1e-3, 4),
            fused=True, fused_apply=True, use_kernel=True))
        state = opt.init(params)
        step_fn = make_train_step(cfg, opt, remat="full")
        secs = []
        for i in range(4):
            torch.cuda.synchronize()
            if i == 0:
                reset_launches()
            t = time.perf_counter()
            params, state, metrics = step_fn(params, state, batch, i)
            value = float(metrics["loss"])
            secs.append(time.perf_counter() - t)
            if i == 0:
                counts[run], loss[run] = dict(LAUNCHES), value
            check(math.isfinite(value), f"C3f {run} step {i}: loss {value}")
        step_s[run] = secs
        peak[run] = torch.cuda.max_memory_allocated() / 2**30
        del params, state
    torch.cuda.empty_cache()

    def rel(a, b):
        return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))

    rel_flash = rel(hidden["pallas"], hidden["auto"])
    rel_control = rel(hidden["control"], hidden["auto"])
    diff = abs(loss["auto"] - loss["pallas"])
    timing = {run: {"first_step_s": secs[0], "median_s": statistics.median(secs[1:]),
                    "min_s": min(secs[1:]), "max_s": max(secs[1:]), "step_s": secs}
              for run, secs in step_s.items()}
    emit("C3f_train_flash_fp32", {
        "loss_dense": loss["auto"], "loss_flash": loss["pallas"], "loss_abs_diff": diff,
        "loss_tolerance": C3F_LOSS_TOL, "hidden_rel_flash": rel_flash,
        "hidden_rel_control": rel_control, "hidden_tolerance": C3F_HIDDEN_TOL,
        "launches": counts["pallas"], "steps": timing, "peak_mem_gb": peak})
    for run, t in timing.items():
        print(f"C3f {run}: first step {t['first_step_s']:.3f} s, then median "
              f"{t['median_s']:.3f} s ({t['min_s']:.3f}-{t['max_s']:.3f}), peak "
              f"{peak[run]:.2f} GiB", flush=True)
    check(counts["pallas"]["flash_attention_fwd"] == 2 * base.num_layers,
          f"C3f flash launches {counts['pallas']}")
    check(counts["auto"]["flash_attention_fwd"] == 0, f"C3f dense launches {counts['auto']}")
    check(diff <= C3F_LOSS_TOL, f"C3f pallas loss {loss['pallas']} vs dense {loss['auto']}")
    check(rel_flash <= C3F_HIDDEN_TOL,
          f"C3f hidden state: flash {rel_flash} > {C3F_HIDDEN_TOL}")
    check(rel_control >= 10 * C3F_HIDDEN_TOL,
          f"C3f hidden state: the non-causal control is only {rel_control} from dense, "
          f"less than 10x the tolerance {C3F_HIDDEN_TOL}")
    return counts["pallas"]["flash_attention_fwd"]


def phase_muon():
    """C4: Muon on the main path at full width, its per-leaf step, one
    bucketed step of each other rule, and the preconditioning time per step
    of RMNP against Muon."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import cosine_with_warmup, is_matrix_param, make_optimizer
    from repro_torch.core.types import map_with_path, tree_paths
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.train import train
    from repro_torch.models import init_params

    def ns_counts(counts):
        return {k: counts[k] for k in ("matmul", "matmul3", "ns_poly", "ns_poly3")}

    # 4 buckets x 5 iterations x (Gram + apply, polynomial)
    per_step = {"matmul": 0, "matmul3": 40, "ns_poly": 0, "ns_poly3": 20}
    main_launches = {}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.time()
    params, state, hist = train("gpt2-small", reduced=False, optimizer="muon", fused=True,
                                fused_apply=True, use_kernel=True, batch=8, seq=1024,
                                steps=3, log_every=1)
    torch.cuda.synchronize()
    secs = time.time() - t0
    counts = ns_counts(LAUNCHES)
    losses = [h["loss"] for h in hist]
    check(len(losses) == 3 and all(math.isfinite(x) for x in losses), f"muon losses {losses}")
    check(all(ns_counts(h["launches"]) == per_step for h in hist),
          f"muon launches per step {[ns_counts(h['launches']) for h in hist]}, "
          f"want {per_step}")
    main_launches.update(matmul3=counts["matmul3"], ns_poly3=counts["ns_poly3"])
    walls = [0.0] + [h["wall_s"] for h in hist]
    emit("C4_train_muon", {"losses": losses, "seconds": round(secs, 2),
                           "step_s": [b - a for a, b in zip(walls, walls[1:])],
                           "launches": counts, "launches_per_step": per_step,
                           "buckets": {k: list(b.shape) for k, b in state.buckets.items()},
                           "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30})
    del params, state
    torch.cuda.empty_cache()

    # the per-leaf engine: the 2-D embedding leaf through ns_step, each
    # stacked leaf through ns_step3
    reset_launches()
    params, _, hist = train("gpt2-small", reduced=False, optimizer="muon", fused=False,
                            fused_apply=False, use_kernel=True, batch=8, seq=1024, steps=1,
                            log_every=1)
    counts = ns_counts(LAUNCHES)
    mats = [t for p, t in tree_paths(params) if is_matrix_param(p, t)]
    n2, n3 = sum(t.ndim == 2 for t in mats), sum(t.ndim > 2 for t in mats)
    want = {"matmul": 10 * n2, "matmul3": 10 * n3, "ns_poly": 5 * n2, "ns_poly3": 5 * n3}
    check(n2 == 1 and counts == want and math.isfinite(hist[0]["loss"]),
          f"per-leaf muon: launches {counts}, want {want}; loss {hist[0]['loss']}")
    main_launches.update(matmul=counts["matmul"], ns_poly=counts["ns_poly"])
    rules = {"per_leaf_muon": {"loss": hist[0]["loss"], "launches": counts}}
    del params
    torch.cuda.empty_cache()

    # one bucketed step of each other rule; Nora launches no Newton-Schulz kernel
    for name in ("normuon", "muown", "nora"):
        reset_launches()
        _, state, hist = train("gpt2-small", reduced=False, optimizer=name, fused=True,
                               fused_apply=False, use_kernel=True, batch=8, seq=1024,
                               steps=1, log_every=1)
        counts = ns_counts(LAUNCHES)
        want = per_step if name != "nora" else dict.fromkeys(per_step, 0)
        check(counts == want and math.isfinite(hist[0]["loss"]),
              f"{name}: launches {counts}, want {want}; loss {hist[0]['loss']}")
        rules[name] = {"loss": hist[0]["loss"], "launches": counts,
                       "slots": sorted(state.slots)}
        del state
        torch.cuda.empty_cache()
    emit("C4_rules", rules)

    # the preconditioning time per step: update_apply of each optimizer on
    # the same params and gradients (AdamW leaves, gathers and scatters
    # included), 10 timed calls after 2 of warm-up, back to back (what a
    # step pays, the host's enqueueing included) and with the card held
    # busy while each call is enqueued (the card's time alone)
    cfg = get_config("gpt2-small")
    params = init_params(cfg, seed=0, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(5)
    grads = map_with_path(lambda _p, t: (torch.randn(t.shape, generator=gen, device="cuda")
                                         * 1e-3).to(t.dtype), params)
    precond, spread = {}, {}
    for name in ("rmnp", "muon"):
        opt = make_optimizer(name, dict(lr_matrix=cosine_with_warmup(2e-3, 10),
                                        lr_adamw=cosine_with_warmup(1e-3, 10),
                                        fused=True, fused_apply=True))
        state = opt.init(params)
        run = (lambda o=opt, st=state: o.update_apply(grads, st, params, 5))
        calls, device = per_call_ms(run), per_call_ms(run, hold_cycles=200_000_000)
        precond[name] = statistics.median(calls)
        spread[name] = {kind: {"median": statistics.median(x), "min": min(x), "max": max(x),
                               "calls": x} for kind, x in (("calls", calls), ("device", device))}
        del state
    for kind in ("calls", "device"):
        r, m = spread["rmnp"][kind], spread["muon"][kind]
        print(f"preconditioning per step ({kind}; update_apply, gpt2-small, median (min-max) "
              f"of 10): rmnp {r['median']:.3f} ms ({r['min']:.3f}-{r['max']:.3f}), muon "
              f"{m['median']:.3f} ms ({m['min']:.3f}-{m['max']:.3f}), muon/rmnp "
              f"{m['median'] / r['median']:.2f}", flush=True)
    emit("C4_precondition_ms", {**precond, "muon_over_rmnp": precond["muon"] / precond["rmnp"],
                                "device_muon_over_rmnp": spread["muon"]["device"]["median"]
                                / spread["rmnp"]["device"]["median"], "spread": spread})
    del params, grads
    torch.cuda.empty_cache()
    return main_launches


@contextlib.contextmanager
def plain_calls():
    """Count calls of the kernels' plain versions (the CPU path) while the
    block runs; on the card none may run."""
    from repro_torch.kernels import ops, rmnp_update
    calls = {"n": 0}
    saved = [(mod, name, getattr(mod, name)) for mod, name in (
        (rmnp_update, "rmnp_rownorm_plain"), (rmnp_update, "rmnp_rownorm_apply_plain"),
        (ops, "matmul_ref"), (ops, "ns_step_ref"))]
    for mod, name, fn in saved:
        def counted(*a, _fn=fn, **k):
            calls["n"] += 1
            return _fn(*a, **k)
        setattr(mod, name, counted)
    try:
        yield calls
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def max_abs_diff(a, b):
    """Largest |a - b| over two host copies of the same tree (as fp32)."""
    return max(float((x.float() - y.float()).abs().max()) for (_, x), (_, y) in zip(a, b, strict=True))


def phase_zero():
    """Z: ZeRO-2 at full width through a NCCL group of one rank."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.core import bucketing, cosine_with_warmup, make_optimizer
    from repro_torch.core.muon import newton_schulz
    from repro_torch.data.pipeline import make_stream
    from repro_torch.distributed import compression
    from repro_torch.distributed.comm import Comm, init_comm
    from repro_torch.kernels import LAUNCHES, ops, reset_launches
    from repro_torch.launch.train import batch_to_device, train
    from repro_torch.models import init_params
    from repro_torch.train import pipeline
    from repro_torch.train.dp_step import init_dp_state, make_dp_train_step

    comm = init_comm("cuda")
    check(dist.get_backend() == "nccl" and comm.world == 1, f"group {comm}, {dist.get_backend()}")
    cfg = get_config("gpt2-small")
    z_launches = {}

    # Z1: five runs of 3 steps of train(zero2=True), each from seed 0
    runs = {}
    for name, kw in (("exact_serial", dict(compress=False, overlap=False)),
                     ("exact_overlap", dict(compress=False, overlap=True)),
                     ("int8_serial", dict(compress=True, overlap=False)),
                     ("int8_overlap", dict(compress=True, overlap=True)),
                     ("exact_accum2", dict(compress=False, accum=2))):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        with plain_calls() as plain:
            params, state, hist = train("gpt2-small", reduced=False, optimizer="rmnp",
                                        fused=True, fused_apply=True, use_kernel=True,
                                        zero2=True, batch=8, seq=1024, steps=3,
                                        log_every=1, **kw)
        torch.cuda.synchronize()
        counts = dict(LAUNCHES)
        losses = [h["loss"] for h in hist]
        check(len(losses) == 3 and all(math.isfinite(x) for x in losses),
              f"Z1 {name}: losses {losses}")
        check([h["launches"]["rmnp_apply"] for h in hist] == [4, 4, 4],
              f"Z1 {name}: apply launches per step {[h['launches'] for h in hist]}")
        check(plain["n"] == 0, f"Z1 {name}: {plain['n']} plain-version calls")
        runs[name] = {"final": host_copy((params, state.buckets)), "losses": losses,
                      "step_s": step_seconds(hist), "launches": counts,
                      "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
                      "plain_calls": plain["n"]}
        z_launches.setdefault("rmnp_apply", counts["rmnp_apply"])
        del params, state
    # the world-1 ZeRO-0 dp step from the same init, schedules and batches
    torch.cuda.empty_cache()
    opt = make_optimizer("rmnp", dict(
        lr_matrix=cosine_with_warmup(2e-3, 3), lr_adamw=cosine_with_warmup(1e-3, 3),
        fused=True, fused_apply=True, shard_axis=comm, shard_size=1))
    params = init_params(cfg, seed=0, device=comm.device)
    st, comp = init_dp_state(opt, params, comm)
    fn = make_dp_train_step(cfg, opt, comm, compress=False, remat="full")
    stream = make_stream(cfg, 1024, 8, seed=0)
    for t in range(3):
        params, st, comp, _ = fn(params, st, comp, batch_to_device(next(stream), comm.device), t)
    zero0 = host_copy((params, st.buckets))
    del params, st, comp
    # step times at a finer grain than train()'s 10 ms log: the single-device
    # step of C1 and each ZeRO-2 form on one batch, 5 rounds taken in turns,
    # each step ended by a synchronize; medians
    from repro_torch.train.step import make_train_step
    params = init_params(cfg, seed=0, device=comm.device)
    batch = batch_to_device(make_stream(cfg, 1024, 8, seed=0).sample(0), comm.device)
    forms = {}
    for name, kw in (("exact_serial", dict(compress=False, overlap=False)),
                     ("exact_overlap", dict(compress=False, overlap=True)),
                     ("int8_serial", dict(compress=True, overlap=False)),
                     ("int8_overlap", dict(compress=True, overlap=True)),
                     ("exact_accum2", dict(compress=False, accum=2))):
        opt_z = make_optimizer("rmnp", dict(lr_matrix=2e-3, lr_adamw=1e-3, fused_apply=True,
                                            shard_axis=comm, shard_size=1))
        st_z, comp_z = init_dp_state(opt_z, params, comm, shard_state=True)
        forms[name] = [make_dp_train_step(cfg, opt_z, comm, zero2=True, remat="full", **kw),
                       [params, st_z, comp_z]]
    opt_c1 = make_optimizer("rmnp", dict(lr_matrix=2e-3, lr_adamw=1e-3, fused_apply=True))
    c1_step = make_train_step(cfg, opt_c1, remat="full")
    forms["single_device_C1"] = [lambda p, o, c, b, t: c1_step(p, o, b, t) + (None,),
                                 [params, opt_c1.init(params), None]]
    samples = {name: [] for name in forms}
    for rnd in range(6):  # round 0 warms up
        for name, (fn_z, st_list) in forms.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn_z(*st_list, batch, rnd + 1)
            torch.cuda.synchronize()
            if rnd:
                samples[name].append(round((time.perf_counter() - t0) * 1e3, 3))
            st_list[:] = out[:3] if name != "single_device_C1" else [out[0], out[1], None]
    step_ms = {name: statistics.median(v) for name, v in samples.items()}
    del forms, params, batch, opt_c1, c1_step
    torch.cuda.empty_cache()
    bad = {"exact_serial vs zero0": differing(runs["exact_serial"]["final"], zero0),
           "exact_overlap vs exact_serial": differing(runs["exact_overlap"]["final"],
                                                      runs["exact_serial"]["final"]),
           "int8_overlap vs int8_serial": differing(runs["int8_overlap"]["final"],
                                                    runs["int8_serial"]["final"])}
    c1 = C1_FINAL["final"]
    emit("Z1_zero2", {
        "runs": {k: {kk: vv for kk, vv in v.items() if kk != "final"} for k, v in runs.items()},
        "bitwise_failures": bad, "step_ms_median": step_ms, "step_ms_samples": samples,
        "c1_step_s": C1_FINAL["step_s"], "c1_peak_mem_gb": C1_FINAL["peak_mem_gb"],
        "exact_vs_c1_max_abs": max_abs_diff(runs["exact_serial"]["final"], c1),
        "exact_vs_c1_bitwise": not differing(runs["exact_serial"]["final"], c1),
        "accum2_vs_exact_max_abs": max_abs_diff(runs["exact_accum2"]["final"],
                                                runs["exact_serial"]["final"]),
        "int8_vs_exact_max_abs": max_abs_diff(runs["int8_serial"]["final"],
                                              runs["exact_serial"]["final"])})
    for what, paths in bad.items():
        check(not paths, f"Z1 {what}: differs at {paths[:4]}")
    del runs

    # Z2: each rank's slice of a padded bucket through the kernel equals that
    # slice of the whole stack's result, at shard sizes 4 and 8
    gen = torch.Generator(device="cuda").manual_seed(0)
    shards = []
    for model, buckets in (("gpt2-small", BUCKETS), ("llama-130m", LLAMA_BUCKETS)):
        for n in (4, 8):
            for (L, d_in, d_out) in buckets:
                padded = -(-L // n) * n
                rows = padded // n
                g = torch.randn((padded, d_in, d_out), generator=gen, device="cuda")
                v = torch.randn((padded, d_in, d_out), generator=gen, device="cuda")
                w = torch.randn((padded, d_in, d_out), generator=gen, device="cuda").bfloat16()
                for t in (g, v, w):
                    t[L:] = 0
                scale = torch.tensor(2e-3)
                v_all, w_all = ops.rmnp_bucket_update_apply(g, v, w, scale, 0.1, beta=0.95)
                same = True
                for r in range(n):
                    part = slice(r * rows, (r + 1) * rows)
                    v_r, w_r = ops.rmnp_bucket_update_apply(
                        g[part].clone(), v[part].clone(), w[part].clone(), scale, 0.1, beta=0.95)
                    same = same and torch.equal(v_r, v_all[part]) and torch.equal(
                        w_r.view(torch.int16), w_all[part].view(torch.int16))
                pads_zero = not (v_all[L:].any() or w_all[L:].any())
                shards.append({"model": model, "n": n, "bucket": [padded, d_in, d_out],
                               "slices_bitwise": bool(same), "pads_zero": bool(pads_zero)})
                del g, v, w, v_all, w_all
    x = torch.randn((48, 768, 768), generator=gen, device="cuda")
    ns_all = newton_schulz(x)
    ns_same = {n: all(torch.equal(newton_schulz(x[r * 48 // n:(r + 1) * 48 // n].clone()),
                                  ns_all[r * 48 // n:(r + 1) * 48 // n]) for r in range(n))
               for n in (4, 8)}
    del x, ns_all
    torch.cuda.empty_cache()
    emit("Z2_shard_slices", {"rmnp_apply": shards, "newton_schulz_768x768": ns_same})
    check(all(s["slices_bitwise"] and s["pads_zero"] for s in shards),
          f"Z2: {[s for s in shards if not (s['slices_bitwise'] and s['pads_zero'])]}")
    check(all(ns_same.values()), f"Z2 Newton-Schulz slices: {ns_same}")

    # Z3: the int8 quantizer and one world-1 reduce-scatter on the card
    # against the CPU, on the 768x768 bucket's gradient; Muon ZeRO-2 against
    # its ZeRO-0 step
    params = init_params(cfg, seed=0, device=comm.device)
    batch = batch_to_device(make_stream(cfg, 1024, 8, seed=0).sample(0), comm.device)
    rmnp_opt = make_optimizer("rmnp", dict(lr_matrix=2e-3, fused_apply=True))
    grads, _ = pipeline.grads_of(cfg, params, batch, "full")
    plan = rmnp_opt.bucket_plan(params)
    with torch.no_grad():
        chunks = bucketing.gather_chunks(plan, grads, 1, dtype=torch.float32)["768x768"]
    del grads
    q, s = compression.quantize_blockwise(chunks.reshape(-1))
    q_cpu, s_cpu = compression.quantize_blockwise(chunks.reshape(-1).cpu())
    quant_same = torch.equal(q.cpu(), q_cpu) and torch.equal(
        s.cpu().view(torch.int32), s_cpu.view(torch.int32))
    cpu_comm = Comm(dist.new_group(backend="gloo"), 0, 1, torch.device("cpu"))
    mean, resid = compression.compressed_reduce_scatter_leaf(chunks, comm)
    mean_cpu, resid_cpu = compression.compressed_reduce_scatter_leaf(chunks.cpu(), cpu_comm)
    rs_same = torch.equal(mean.cpu(), mean_cpu) and torch.equal(resid.cpu(), resid_cpu)
    del chunks, mean, resid, mean_cpu, resid_cpu, q, s
    muon = make_optimizer("muon", dict(lr_matrix=2e-3, lr_adamw=1e-3, fused_apply=True,
                                       shard_axis=comm, shard_size=1))
    finals = {}
    for mode in ("zero2", "zero0"):
        st, comp = init_dp_state(muon, params, comm, shard_state=mode == "zero2")
        fn = make_dp_train_step(cfg, muon, comm, compress=False, remat="full",
                                zero2=mode == "zero2")
        reset_launches()
        p, st, comp, m = fn(params, st, comp, batch, 1)
        torch.cuda.synchronize()
        if mode == "zero2":
            muon_launches = {k: LAUNCHES[k] for k in ("matmul3", "ns_poly3", "matmul", "ns_poly")}
        finals[mode] = host_copy((p, st.buckets))
        del p, st, comp
    muon_bad = differing(finals["zero2"], finals["zero0"])
    emit("Z3_int8_and_muon", {"quantize_card_equals_cpu": quant_same,
                              "reduce_scatter_card_equals_cpu": rs_same,
                              "muon_zero2_vs_zero0_differing": muon_bad,
                              "muon_zero2_launches_per_step": muon_launches})
    check(quant_same, "Z3: int8 codes or scales differ between the card and the CPU")
    check(rs_same, "Z3: the world-1 reduce-scatter differs between the card and the CPU")
    check(not muon_bad, f"Z3: Muon ZeRO-2 differs from ZeRO-0 at {muon_bad[:4]}")
    check(muon_launches["matmul3"] == 40 and muon_launches["ns_poly3"] == 20,
          f"Z3 Muon launches {muon_launches}")
    z_launches.update({k: muon_launches[k] for k in ("matmul3", "ns_poly3")})
    del params, batch, finals
    torch.cuda.empty_cache()
    dist.destroy_process_group()
    return z_launches


def phase_small():
    """Reduced gpt2 (fp32) with attn_impl="pallas", under RMNP and under Muon:
    the RMNP apply kernel, the GEMM kernel that carries Newton-Schulz and the
    flash-attention kernel on the card against their plain versions on the
    CPU. fp32 matmuls on the card run without TF32, and the losses and
    parameters agree to 1e-4 relative after 3 steps (Newton-Schulz keeps a
    relative difference near its size, see NS_REL_TOL)."""
    from repro_torch.configs import get_config
    from repro_torch.core import cosine_with_warmup, make_optimizer
    from repro_torch.core.types import tree_map, tree_paths
    from repro_torch.data.pipeline import make_stream
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.train import batch_to_device
    from repro_torch.models import init_params
    from repro_torch.train.step import make_train_step

    cfg = dataclasses.replace(get_config("gpt2-small").reduced(), attn_impl="pallas")
    init = init_params(cfg, seed=0, device="cpu")  # one init, copied to the card
    for name in ("rmnp", "muon"):
        runs = {}
        for device in ("cuda", "cpu"):
            opt = make_optimizer(name, dict(
                lr_matrix=cosine_with_warmup(2e-3, 3), lr_adamw=cosine_with_warmup(1e-3, 3),
                fused=True, fused_apply=True, use_kernel=True))
            params = tree_map(lambda t, d=device: t.to(d), init)
            state = opt.init(params)
            step_fn = make_train_step(cfg, opt, remat="none")
            stream = make_stream(cfg, 64, 4, seed=0)
            reset_launches()
            losses = []
            for step in range(3):
                params, state, metrics = step_fn(params, state,
                                                 batch_to_device(next(stream), device), step)
                losses.append(float(metrics["loss"]))
            on_card = device == "cuda"
            n_buckets = len(opt.bucket_plan(params).buckets)
            want = {"flash_attention_fwd": 3 * cfg.num_layers * on_card,
                    "rmnp_apply": 3 * n_buckets * on_card * (name == "rmnp"),
                    "matmul3": 3 * 10 * n_buckets * on_card * (name == "muon"),
                    "ns_poly3": 3 * 5 * n_buckets * on_card * (name == "muon")}
            check(all(LAUNCHES[k] == n for k, n in want.items()),
                  f"{name} {device} launches {dict(LAUNCHES)}, want {want}")
            runs[device] = (losses, {p: t.float().cpu() for p, t in tree_paths(params)})
        loss_err = max(abs(a - b) for a, b in zip(runs["cuda"][0], runs["cpu"][0], strict=True))
        p_err = max(max_err(runs["cuda"][1][p], runs["cpu"][1][p]) for p in runs["cpu"][1])
        check(loss_err <= 1e-4 * abs(runs["cpu"][0][0]),
              f"{name} small losses cuda {runs['cuda'][0]} cpu {runs['cpu'][0]}")
        check(p_err <= 1e-4, f"{name} small params max_abs_err {p_err}")
        emit("D_small_vs_cpu" if name == "rmnp" else f"D_{name}_small_vs_cpu",
             {"losses_cuda": runs["cuda"][0], "losses_cpu": runs["cpu"][0],
              "loss_abs_err": loss_err, "param_max_abs_err": p_err})


R_ARCH, R_BATCH, R_SEQ, R_STEPS = "llama-130m", 8, 1024, 6


def card_name():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def host_copy(tree):
    """[(path, CPU tensor)] of a tree of tensors, for bit comparisons."""
    from repro_torch.core.types import tree_paths
    return [(p, t.detach().to("cpu", copy=True)) for p, t in tree_paths(tree)]


def differing(a, b):
    """Paths whose bits differ between two host copies (or the path lists)."""
    import torch
    if [p for p, _ in a] != [p for p, _ in b]:
        return ["<tree structure>"]
    out = []
    for (p, x), (_, y) in zip(a, b, strict=True):
        if x.dtype != y.dtype or x.shape != y.shape or not torch.equal(
                x.view(torch.int16) if x.dtype == torch.bfloat16 else x,
                y.view(torch.int16) if y.dtype == torch.bfloat16 else y):
            out.append(p)
    return out


def step_seconds(hist):
    walls = [0.0] + [h["wall_s"] for h in hist if "wall_s" in h]
    return [round(b - a, 3) for a, b in zip(walls, walls[1:])]


def phase_resilience():
    """R: checkpointing and the guard on llama-130m at full width."""
    import os
    import shutil
    import warnings
    import torch
    from repro_torch.checkpoint import faults as ckpt_faults
    from repro_torch.checkpoint.manager import CheckpointCorruptionError, CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.core import cosine_with_warmup, make_optimizer
    from repro_torch.data.pipeline import make_stream
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.train import batch_to_device, train
    from repro_torch.models import init_params
    from repro_torch.train.step import make_train_step

    work = ROOT / "build" / "phase_r"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    kw = dict(reduced=False, optimizer="rmnp", fused=True, fused_apply=True, use_kernel=True,
              batch=R_BATCH, seq=R_SEQ, steps=R_STEPS, log_every=1, seed=0)
    n_buckets = len(LLAMA_BUCKETS)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    # R1: two uninterrupted runs from one init (the seed, on the card)
    reset_launches()
    p, s, h1 = train(R_ARCH, **kw)
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    ref = host_copy((p, s))
    n_params = sum(t.numel() for _, t in host_copy(p))
    buckets = {k: list(b.shape) for k, b in s.buckets.items()}
    del p, s
    p, s, h2 = train(R_ARCH, **kw)
    diff = differing(ref, host_copy((p, s)))
    losses = [h["loss"] for h in h1]
    emit("R1_determinism", {
        "model": R_ARCH, "batch": R_BATCH, "seq": R_SEQ, "steps": R_STEPS,
        "params": n_params, "buckets": buckets, "losses": losses,
        "losses_second_run": [h["loss"] for h in h2], "step_s": step_seconds(h1),
        "step_s_second_run": step_seconds(h2), "launches": launches,
        "bitwise_equal": not diff, "differing_leaves": diff[:20],
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30})
    check(sorted(buckets) == sorted(f"{a}x{b}" for _, a, b in LLAMA_BUCKETS),
          f"llama buckets {buckets}")
    check(all(math.isfinite(x) for x in losses), f"llama losses {losses}")
    check([h["launches"]["rmnp_apply"] for h in h1] == [n_buckets] * R_STEPS,
          f"apply launches per step {[h['launches'] for h in h1]}")
    check(not diff, f"two runs from one init differ in {len(diff)} leaves: {diff[:5]}")
    del p, s
    torch.cuda.empty_cache()

    # R2: stop at step 3 and restart; SIGKILL with an async save in flight
    stop_dir = work / "stop"
    p, s, _ = train(R_ARCH, stop_at=3, ckpt_dir=str(stop_dir), ckpt_every=3, **kw)
    at3 = host_copy((p, s))
    del p, s
    p, s, hr = train(R_ARCH, ckpt_dir=str(stop_dir), ckpt_every=3, **kw)
    diff_stop = differing(ref, host_copy((p, s)))
    del p, s
    kill_dir = work / "kill"
    code = ("import sys; sys.path.insert(0, 'src'); "
            "from repro_torch.launch.train import train; "
            f"train({R_ARCH!r}, reduced=False, optimizer='rmnp', fused=True, fused_apply=True, "
            f"batch={R_BATCH}, seq={R_SEQ}, steps={R_STEPS}, log_every=1, seed=0, "
            "ckpt_every=2, kill_at=4, ckpt_dir=sys.argv[1])")
    t0 = time.time()
    proc = subprocess.run([sys.executable, "-c", code, str(kill_dir)], cwd=ROOT,
                          capture_output=True, text=True, timeout=600)
    kill_s = time.time() - t0
    committed = sorted(int(d.name.split("_")[1]) for d in kill_dir.glob("step_*")
                       if (d / "COMMITTED").exists())
    torn = sorted(d.name for d in kill_dir.glob(".tmp_step_*"))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        p, s, hk = train(R_ARCH, ckpt_dir=str(kill_dir), ckpt_every=2, **kw)
    diff_kill = differing(ref, host_copy((p, s)))
    left = sorted(d.name for d in kill_dir.glob(".tmp_step_*"))
    emit("R2_crash_resume", {
        "stop_at": 3, "resumed_steps": [h["step"] for h in hr], "stop_bitwise_equal":
        not diff_stop, "stop_differing": diff_stop[:20], "kill_returncode": proc.returncode,
        "kill_s": round(kill_s, 2), "committed_at_kill": committed, "torn_at_kill": torn,
        "resumed_after_kill_from": hk[0]["step"] if hk else None,
        "tmp_left_after_restart": left, "kill_bitwise_equal": not diff_kill,
        "kill_differing": diff_kill[:20],
        "restart_warnings": [str(w.message)[:200] for w in caught]})
    check(not diff_stop, f"stop/resume differs from the uninterrupted run in {diff_stop[:5]}")
    check(proc.returncode == -9, f"kill_at: return code {proc.returncode}, "
                                 f"stderr {proc.stderr[-2000:]}")
    check("SIGKILL at step 4" in proc.stdout, "kill_at: the process did not reach step 4")
    check(4 not in committed and committed and committed[-1] == 2,
          f"kill_at: committed steps {committed}; the step-4 save should be in flight")
    check(hk and hk[0]["step"] == committed[-1], f"kill restart resumed at {hk[:1]}")
    check(not left, f"kill restart left {left}")
    check(not diff_kill, f"kill/resume differs from the uninterrupted run in {diff_kill[:5]}")
    shutil.rmtree(kill_dir)

    # R3: the guard skips a NaN step bit for bit; a sticky fault rewinds
    pg, sg, hg = train(R_ARCH, guard=True, inject_fault="nan:*:2", **kw)
    guarded = host_copy((pg, sg))
    del pg, sg
    cfg = get_config(R_ARCH)
    opt = make_optimizer("rmnp", dict(
        lr_matrix=cosine_with_warmup(2e-3, R_STEPS), lr_adamw=cosine_with_warmup(1e-3, R_STEPS),
        fused=True, fused_apply=True))
    params = init_params(cfg, seed=0, device="cuda")
    state = opt.init(params)
    step_fn = make_train_step(cfg, opt, remat="full")
    stream = make_stream(cfg, R_SEQ, R_BATCH, seed=0)
    for t in range(R_STEPS):
        batch = batch_to_device(next(stream), "cuda")
        if t != 2:
            params, state, _ = step_fn(params, state, batch, t)
    diff_guard = differing(host_copy((params, state)), guarded)
    del params, state
    rewind_dir = work / "rewind"
    _, _, hw = train(R_ARCH, guard=True, inject_fault="nan:*:4+", ckpt_dir=str(rewind_dir),
                     ckpt_every=2, anomaly_skip_budget=1, anomaly_health_window=1, **kw)
    rewinds = [h for h in hw if h.get("action") == "rewind"]
    skipped = [h["skipped"] for h in hg]
    emit("R3_guard", {
        "skipped": skipped, "actions": [h.get("action") for h in hg],
        "nonfinite_at_step_2": hg[2].get("nonfinite"), "losses": [h["loss"] for h in hg],
        "bitwise_equal_to_clean_run_without_step_2": not diff_guard,
        "differing": diff_guard[:20],
        "rewind_run": [(h["step"], h.get("action"), h.get("rewind_to")) for h in hw]})
    check(skipped == [0.0, 0.0, 1.0, 0.0, 0.0, 0.0], f"guard skipped {skipped}")
    check(hg[2].get("nonfinite") == ["embed/tokens"],
          f"step 2's flags name {hg[2].get('nonfinite')}, want the first leaf embed/tokens")
    check(not diff_guard, f"guarded run differs from the clean run in {diff_guard[:5]}")
    check(len(rewinds) == 1 and rewinds[0]["rewind_to"] == 2 and rewinds[0]["step"] == 5,
          f"rewind run {[(h['step'], h.get('action')) for h in hw]}")
    check([h["step"] for h in hw if h.get("action") == "ok"][-4:] == [2, 3, 4, 5],
          "the rewind did not replay steps 2-5")
    shutil.rmtree(rewind_dir)

    # R4: storage faults on a checkpoint written here (stop_dir: steps 3, 6)
    like = (init_params(cfg, seed=0, device="cuda"), None)
    like = (like[0], opt.init(like[0]))
    faults_seen = {}
    for kind in ("bit_rot", "truncated", "missing_shard", "torn_manifest"):
        d = work / f"r4_{kind}"
        for step in (3, 6):
            src = stop_dir / f"step_{step:09d}"
            dst = d / src.name
            dst.mkdir(parents=True)
            for f in src.iterdir():
                written = (f.name == "manifest.json" or (
                    f.suffix == ".npz" and kind in ("bit_rot", "truncated") and step == 6))
                (shutil.copy2 if written else os.link)(f, dst / f.name)
        ckpt_faults.CORRUPTIONS[kind](d / "step_000000006")
        mgr = CheckpointManager(str(d))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            try:
                mgr.restore(6, like)
            except CheckpointCorruptionError as e:
                error = str(e)
            else:
                error = None
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            got = mgr.restore_latest(like)
        back = got[1] if got else None
        diff4 = differing(at3, host_copy(got[0])) if got else ["<nothing restored>"]
        faults_seen[kind] = {"error": error, "fell_back_to": back, "bitwise_equal": not diff4,
                             "warning": [str(w.message)[:240] for w in caught]}
        del got
        shutil.rmtree(d)
    emit("R4_corruption", faults_seen)
    for kind, rec in faults_seen.items():
        check(rec["error"] is not None and ("leaf '" in rec["error"] or "shard" in rec["error"]
                                            or "manifest.json" in rec["error"]),
              f"{kind}: not detected by name: {rec['error']}")
        check(rec["fell_back_to"] == 3 and rec["bitwise_equal"],
              f"{kind}: restore_latest gave step {rec['fell_back_to']}, "
              f"equal {rec['bitwise_equal']}")

    # R5: cost, reported and not gated; medians of 5 interleaved samples
    params, state = like
    del like
    batch = batch_to_device(make_stream(cfg, R_SEQ, R_BATCH, seed=0).sample(0), "cuda")
    plain = make_train_step(cfg, opt, remat="full")
    guarded_fn = make_train_step(cfg, opt, remat="full", guard=True)

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t, out

    amgr = CheckpointManager(str(work / "r5_async"), keep=1)
    bmgr = CheckpointManager(str(work / "r5_block"), keep=1, async_save=False)
    stall = {"async": [], "blocking": [], "async_write": []}
    step_t = {"plain": [], "write_in_flight": [], "guarded": []}
    for i in range(7):  # two rounds fill both host buffers and are dropped
        torch.cuda.synchronize()
        t = time.perf_counter()
        amgr.save(i, (params, state))
        a = time.perf_counter() - t
        dt_flight, _ = timed(lambda: plain(params, state, batch, 3))
        t = time.perf_counter()
        amgr.wait()
        w = time.perf_counter() - t + a + dt_flight
        dt_plain, _ = timed(lambda: plain(params, state, batch, 3))
        dt_guard, _ = timed(lambda: guarded_fn(params, state, batch, 3))
        t = time.perf_counter()
        bmgr.save(i, (params, state), block=True)
        b = time.perf_counter() - t
        if i >= 2:
            stall["async"].append(a)
            stall["blocking"].append(b)
            stall["async_write"].append(w)
            step_t["write_in_flight"].append(dt_flight)
            step_t["plain"].append(dt_plain)
            step_t["guarded"].append(dt_guard)
    (step_dir,) = (work / "r5_block").glob("step_*")
    nbytes = sum(f.stat().st_size for f in step_dir.iterdir())
    med = {k: statistics.median(v) * 1e3 for k, v in {**stall, **step_t}.items()}
    card = card_name()
    emit("R5_cost", {
        "card": card, "save_stall_ms_async": med["async"], "save_stall_ms_blocking":
        med["blocking"], "async_save_to_commit_ms": med["async_write"],
        "step_ms_plain": med["plain"], "step_ms_write_in_flight": med["write_in_flight"],
        "step_ms_guarded": med["guarded"], "checkpoint_bytes": nbytes,
        "samples_ms": {k: [round(x * 1e3, 3) for x in v] for k, v in {**stall, **step_t}.items()}})
    print(f"R5 ({card}): save() stall async {med['async']:.2f} ms, blocking "
          f"{med['blocking']:.1f} ms; step {med['plain']:.1f} ms, with a write in flight "
          f"{med['write_in_flight']:.1f} ms, guarded {med['guarded']:.1f} ms; "
          f"{nbytes / 2**30:.3f} GiB a checkpoint", flush=True)
    del params, state, batch
    shutil.rmtree(work)
    torch.cuda.empty_cache()
    return {"rmnp_apply": launches["rmnp_apply"]}


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)

    t0 = time.time()
    phase_build()
    rmnp = phase_rmnp()
    attn_cases = phase_attention()
    attn, attn_fp32 = attn_cases["main"], attn_cases["main_fp32"]
    ns = phase_ns()
    launches = phase_train()
    fp32_launches = phase_train_fp32()
    launches.update(phase_muon())
    phase_small()
    llama_launches = phase_resilience()
    zero_launches = phase_zero()

    smi = card_name()
    print(smi, flush=True)
    src = "src/repro_torch/csrc/rmnp_update.cu"
    kernels = [
        {"name": "rmnp_apply", "route": "cuda", "source": src,
         "replaces": "src/repro/kernels/rmnp_update.py:129",
         "launches": launches["rmnp_apply"], **rmnp["rmnp_apply"], "bound_by": "bytes",
         "library_ms": None, "launches_llama_130m_R1": llama_launches["rmnp_apply"],
         "launches_Z1": zero_launches["rmnp_apply"]},
        {"name": "rmnp_precondition", "route": "cuda", "source": src,
         "replaces": "src/repro/kernels/rmnp_update.py:63",
         "launches": launches["rmnp_precondition"], **rmnp["rmnp_precondition"],
         "bound_by": "bytes", "library_ms": None},
        {"name": "flash_attention_fwd", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention_fwd.cu",
         "replaces": "src/repro/kernels/flash_attention.py:37",
         "launches": launches["flash_attention_fwd"], "max_abs_err": attn["max_abs_err"],
         "worst_ratio": attn["worst_ratio"], "ms": attn["kernel_ms"], "plain_ms": attn["plain_ms"],
         "bound_ms": attn["bound_ms"], "bound_by": attn["bound_by"],
         "library_ms": attn["library_ms"],
         # the fp32 kernel (csrc/flash_attention_fwd_tf32.cu): launches on
         # C3f, and per timed shape its time, plain and SDPA times and its
         # 3xTF32 bound
         "fp32_source": "src/repro_torch/csrc/flash_attention_fwd_tf32.cu",
         "launches_C3f": fp32_launches,
         "fp32": {name: {k: attn_cases[name][k] for k in (
             "kernel_ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "max_abs_err",
             "worst_ratio")} for name in ("main_fp32", "gqa_ragged_fp32")}},
        # the same TPU kernel in fp32, its own source: launches on C3f, times
        # at the full-width shape C3f runs
        {"name": "flash_attention_fwd_fp32", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention_fwd_tf32.cu",
         "replaces": "src/repro/kernels/flash_attention.py:37", "launches": fp32_launches,
         "max_abs_err": attn_fp32["max_abs_err"], "worst_ratio": attn_fp32["worst_ratio"],
         "ms": attn_fp32["kernel_ms"], "plain_ms": attn_fp32["plain_ms"],
         "bound_ms": attn_fp32["bound_ms"], "bound_by": attn_fp32["bound_by"],
         "library_ms": attn_fp32["library_ms"]},
    ]
    replaces = {"matmul": "src/repro/kernels/matmul.py:19",
                "matmul3": "src/repro/kernels/matmul.py:69",
                "ns_poly": "src/repro/kernels/newton_schulz.py:26",
                "ns_poly3": "src/repro/kernels/newton_schulz.py:49"}
    for name, where in replaces.items():
        kernels.append({"name": name, "route": "cuda", "source": "src/repro_torch/csrc/matmul.cu",
                        "replaces": where, "launches": launches[name], **ns[name]})
        if name in zero_launches:
            kernels[-1]["launches_Z3"] = zero_launches[name]
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {"card": smi, "seconds": time.time() - t0, "kernels": kernels,
         "phases": RESULTS}, indent=1))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
