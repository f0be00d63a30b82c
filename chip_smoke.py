#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA card and check it.

    python3 chip_smoke.py            # needs one CUDA card; exit 0 = all phases passed

Phases:
  build  compile the CUDA source with nvcc while Triton compiles the RMNP
         kernel, both from the sources in this checkout;
  A      the RMNP kernels (apply and precondition, one line each) against
         their plain versions at the four gpt2-small bucket shapes, fp32
         and bf16 momentum, bf16 weights (the main path's), and for the
         apply kernel also fp32 weights, whose update w_new - w is held
         against the plain version's at its own magnitude;
  B      the flash-attention forward kernel against its plain version at
         B=8 S=1024 H=K=12 hd=64 (bf16), and a GQA shape (H=8, K=2) with a
         ragged S in bf16 and fp32; F.scaled_dot_product_attention is timed
         beside it as a yardstick only;
  C      the main path at full width: 3 steps of
         repro_torch.launch.train.train("gpt2-small", reduced=False,
         optimizer="rmnp", single-pass engine, use_kernel=True, batch=8,
         seq=1024) with 4 apply-kernel launches per step; one step of the
         two-pass bucketed engine (4 precondition launches); one step with
         attn_impl="pallas" through make_train_step, whose final hidden
         state and loss must match dense attention's from the same init,
         while a non-causal attention, the control, must not;
  D      a small input: reduced gpt2 with attn_impl="pallas", 3 single-pass
         steps with the kernels on the card against the same steps with the
         plain versions on the CPU.

Every phase prints one JSON line; then a line with the card's name and power
limit, a ``kernels`` line, and last ``{"ok": true, "device": ...}``. Any
failed check raises, and the script exits non-zero without the last line.
Details go to chiprun_out/chip_smoke.json.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
FP32_FLOPS = 67e12          # H100 SXM, fp32 outside the tensor cores
BF16_FLOPS = 989e12         # H100 SXM, dense bf16 tensor cores
BUCKETS = [(48, 768, 768), (12, 768, 6144), (12, 3072, 768), (1, 50432, 768)]
# Phase C3, flash against dense attention in bf16 at full width: the loss,
# and the final hidden state by relative Frobenius distance. The dense path
# rounds its probabilities to bf16 and the kernel keeps them in fp32, so the
# two differ by bf16 rounding carried through 12 layers; the tolerances sit
# a few times above the readings on an H100 (PERF.md), and a non-causal
# attention must land at least 10 times past the hidden-state tolerance.
C3_LOSS_TOL = 1e-3
C3_HIDDEN_TOL = 5e-2
RESULTS = {}


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
    import torch
    from repro_torch.kernels import build, rmnp_update
    t0 = time.time()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        nvcc = pool.submit(build.build_library, "flash_attention_fwd")
        g = torch.randn(2, 8, 8, device="cuda")
        # compiles both Triton specializations (APPLY False and True)
        rmnp_update.rmnp_rownorm(g, g.clone(), beta=0.9)
        rmnp_update.rmnp_rownorm_apply(g, g.clone(), g.clone(), torch.zeros(2, device="cuda"),
                                       beta=0.9)
        torch.cuda.synchronize()
        lib = nvcc.result()
    emit("build", {"seconds": round(time.time() - t0, 2), "library": lib.name,
                   "ptxas": build.PTXAS_REPORTS.get("flash_attention_fwd", "")[-1500:]})


def rmnp_bytes(shape, v_bytes, w_bytes, apply):
    n = math.prod(shape)
    out = w_bytes * 2 if apply else 4  # w read + written, or d written
    return n * (4 + 2 * v_bytes + out)


def phase_rmnp():
    import torch
    from repro_torch.kernels import rmnp_update as rm
    gen = torch.Generator(device="cuda").manual_seed(0)
    beta, eps = 0.95, 1e-8
    # Each output element is held at atol_frac * max|want| + rtol * |want|.
    # fp32: the kernel sums squares in another order and may fuse
    # multiply-adds, a few fp32 ulps, so rtol 1e-5. bf16: both sides round
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
    rows = {name: [] for name in kernels}
    summary = {name: {"max_abs_err": 0.0, "worst_ratio": 0.0, "ms": 0.0,
                      "plain_ms": 0.0, "bound_ms": 0.0} for name in kernels}
    for shape in BUCKETS:
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
                rec = {"shape": list(shape), "momentum": str(vdt).split(".")[1],
                       "weights": str(wdt).split(".")[1]}
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
                rec.update(max_abs_err=err, worst_ratio=ratio,
                           kernel_ms=time_ms(lambda: kernel(g, v, w, scalars)),
                           plain_ms=time_ms(lambda: plain(g, v, w, scalars)),
                           bound_ms=rmnp_bytes(shape, vb, wb, apply) / HBM_BYTES_PER_S * 1e3,
                           bound_by="bytes")
                rows[name].append(rec)
                if (vdt, wdt) == combos[0]:  # the main path's types
                    s = summary[name]
                    s["max_abs_err"] = max(s["max_abs_err"], err)
                    s["worst_ratio"] = max(s["worst_ratio"], ratio)
                    s["ms"] += rec["kernel_ms"]
                    s["plain_ms"] += rec["plain_ms"]
                    s["bound_ms"] += rec["bound_ms"]
            del g, v, w
            torch.cuda.empty_cache()
    for name, recs in rows.items():
        emit(f"A_{name}", {"buckets": recs})
    return summary


def attention_flops(B, S, H, hd):
    return 4 * B * H * hd * (S * (S + 1) // 2)  # causal: the lower triangle


def phase_attention():
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(1)
    cases = [("main", 8, 1024, 12, 12, 64, torch.bfloat16),
             ("gqa_ragged", 2, 1000, 8, 2, 64, torch.bfloat16),
             ("gqa_ragged_fp32", 2, 1000, 8, 2, 64, torch.float32)]
    rows, main = [], None
    for name, B, S, H, K, hd, dt in cases:
        q = torch.randn(B, S, H, hd, generator=gen, device="cuda").to(dt)
        k = torch.randn(B, S, K, hd, generator=gen, device="cuda").to(dt)
        v = torch.randn(B, S, K, hd, generator=gen, device="cuda").to(dt)
        out = fa.flash_attention_fwd_kernel(q, k, v, causal=True)
        ref = fa.flash_attention_fwd_plain(q, k, v, causal=True,
                                           block_q=min(512, S), block_k=min(512, S))
        torch.cuda.synchronize()
        # both sides compute in fp32 with different tilings (sums agree to
        # ~1e-6 relative): an fp32 output is held at rtol 1e-5 per element; a
        # bf16 output rounds those values once and may differ by one bf16
        # step, at most 2^-7 of the element (see elementwise_err)
        e, ratio = elementwise_err(out, ref, 2.0 ** -7 if dt == torch.bfloat16 else 1e-5)
        check(out.shape == q.shape and torch.isfinite(out.float()).all().item(),
              f"attention {name}: bad output")
        check(ratio <= 1.0, f"attention {name}: max_abs_err {e}, worst ratio {ratio} > 1")
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        rec = {"case": name, "B": B, "S": S, "H": H, "K": K, "hd": hd,
               "dtype": str(dt).split(".")[1], "max_abs_err": e, "worst_ratio": ratio,
               "kernel_ms": time_ms(lambda: fa.flash_attention_fwd_kernel(q, k, v)),
               "plain_ms": time_ms(lambda: fa.flash_attention_fwd_plain(
                   q, k, v, block_q=min(512, S), block_k=min(512, S)), iters=3),
               "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                   qt, kt, vt, is_causal=True, enable_gqa=K != H))}
        nbytes = (q.numel() + k.numel() + v.numel() + out.numel()) * q.element_size()
        peak = BF16_FLOPS if dt == torch.bfloat16 else FP32_FLOPS
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = attention_flops(B, S, H, hd) / peak * 1e3
        rec["bound_ms"] = max(t_bytes, t_ops)
        rec["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        rows.append(rec)
        if name == "main":
            main = rec
    emit("B_attention", {"cases": rows})
    return main


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


def phase_small():
    """Reduced gpt2 (fp32) with attn_impl="pallas": the RMNP apply kernel
    and the flash-attention kernel on the card against their plain versions
    on the CPU. fp32 matmuls on the card run without TF32, and the losses
    and parameters agree to 1e-4 relative after 3 steps."""
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
    runs = {}
    for device in ("cuda", "cpu"):
        opt = make_optimizer("rmnp", dict(
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
        check(LAUNCHES["rmnp_apply"] == 12 * on_card
              and LAUNCHES["flash_attention_fwd"] == 3 * cfg.num_layers * on_card,
              f"{device} launches {dict(LAUNCHES)}")
        runs[device] = (losses, {p: t.float().cpu() for p, t in tree_paths(params)})
    loss_err = max(abs(a - b) for a, b in zip(runs["cuda"][0], runs["cpu"][0], strict=True))
    p_err = max(max_err(runs["cuda"][1][p], runs["cpu"][1][p]) for p in runs["cpu"][1])
    check(loss_err <= 1e-4 * abs(runs["cpu"][0][0]),
          f"small losses cuda {runs['cuda'][0]} cpu {runs['cpu'][0]}")
    check(p_err <= 1e-4, f"small params max_abs_err {p_err}")
    emit("D_small_vs_cpu", {"losses_cuda": runs["cuda"][0], "losses_cpu": runs["cpu"][0],
                            "loss_abs_err": loss_err, "param_max_abs_err": p_err})


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
    attn = phase_attention()
    launches = phase_train()
    phase_small()

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    src = "src/repro_torch/kernels/rmnp_update.py"
    kernels = [
        {"name": "rmnp_apply", "route": "triton", "source": src,
         "replaces": "src/repro/kernels/rmnp_update.py:129",
         "launches": launches["rmnp_apply"], **rmnp["rmnp_apply"], "bound_by": "bytes",
         "library_ms": None},
        {"name": "rmnp_precondition", "route": "triton", "source": src,
         "replaces": "src/repro/kernels/rmnp_update.py:63",
         "launches": launches["rmnp_precondition"], **rmnp["rmnp_precondition"],
         "bound_by": "bytes", "library_ms": None},
        {"name": "flash_attention_fwd", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention_fwd.cu",
         "replaces": "src/repro/kernels/flash_attention.py:37",
         "launches": launches["flash_attention_fwd"], "max_abs_err": attn["max_abs_err"],
         "worst_ratio": attn["worst_ratio"], "ms": attn["kernel_ms"], "plain_ms": attn["plain_ms"],
         "bound_ms": attn["bound_ms"], "bound_by": attn["bound_by"],
         "library_ms": attn["library_ms"]},
    ]
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
