"""The launch census: what a run was predicted to launch, what the wrappers
counted, and what the card's profiler saw, held against each other.

Three sources, one run:

* the prediction: the same call on meta tensors under
  ``introspect.recording()`` (``introspect.collect_kernel_launches``), a
  :class:`~repro_torch.kernels.introspect.KernelLaunch` per launch, in
  launch order;
* ``LAUNCHES``, which each wrapper bumps where it launches its kernel;
* the kernels ``torch.profiler`` records on the card, read from its Chrome
  trace: the demangled name (kernel and template arguments), grid, block
  and shared memory of each.

The port's kernels run on one stream in program order, so the profiler's
events of the port's kernels, sorted by start time, line up one to one with
the prediction. :func:`census` checks that they do, event by event
(instantiation, grid, block, shared memory), and counts per ``LAUNCHES``
key. The trace reports a kernel's static and dynamic shared memory
together; the record holds the dynamic part, and the port's kernels declare
at most ``STATIC_SMEM`` bytes statically (the GEMM's 1 KB, by ptxas). Used by
``chip_smoke.py`` phase K and the card tests; it needs a card.
"""
from __future__ import annotations

import json
import os
import re
import tempfile
from typing import Callable, Dict, List, Sequence

from repro_torch.kernels import LAUNCHES, reset_launches
from repro_torch.kernels.introspect import KernelLaunch

# the port's CUDA kernel functions, as their demangled names spell them
KERNELS = ("rmnp_kernel", "gemm_kernel", "fa_fwd_tc", "fa_fwd_tf32_kernel")
_NAME = re.compile(r"\b(" + "|".join(KERNELS) + r")<([^()]*)>")
STATIC_SMEM = 1024


def signature(name: str) -> str:
    """``rmnp_kernel<64, true, true, float, __nv_bfloat16>`` from a demangled
    kernel name (``void (anonymous namespace)::rmnp_kernel<64, true, ...>(
    (anonymous namespace)::Args)``), "" when it is none of the port's."""
    m = _NAME.search(name)
    if m is None:
        return ""
    args = ", ".join(a.strip() for a in m.group(2).split(","))
    return f"{m.group(1)}<{args}>"


def profiled_kernels(fn: Callable[[], object]) -> List[Dict]:
    """Run ``fn`` once under ``torch.profiler`` and return the port's kernels
    it launched on the card, in start order: ``{"signature", "grid",
    "block", "smem"}`` each (``smem``: static and dynamic shared memory)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path, encoding="utf-8") as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        os.remove(path)
    out = []
    for e in events:
        if e.get("cat") != "kernel":
            continue
        sig = signature(e.get("name", ""))
        if not sig:
            continue
        args = e.get("args", {})
        out.append({"signature": sig, "grid": tuple(args.get("grid", ())),
                    "block": tuple(args.get("block", ())),
                    "smem": args.get("shared memory"), "ts": e.get("ts", 0.0)})
    out.sort(key=lambda k: k["ts"])
    return out


def census(run: Callable[[], object], predicted: Sequence[KernelLaunch]) -> Dict:
    """Run ``run`` once on the card with ``LAUNCHES`` set to 0 and under the
    profiler, and hold it against ``predicted`` (the same call recorded on
    meta tensors). Returns ``{"kernels": {key: {"meta", "launches",
    "profiler"}}, "events": n, "mismatches": [...], "ok": bool}``; a
    mismatch names the launch whose instantiation, grid, block or shared
    memory differs."""
    reset_launches()
    events = profiled_kernels(run)
    counted = dict(LAUNCHES)
    mismatches: List[str] = []
    if len(events) != len(predicted):
        mismatches.append(f"{len(predicted)} launches predicted, {len(events)} on the "
                          f"profiler")
    per_key: Dict[str, Dict[str, int]] = {}
    for rec in predicted:
        per_key.setdefault(rec.name, {"meta": 0, "launches": counted.get(rec.name, 0),
                                      "profiler": 0})["meta"] += 1
    for i, (rec, ev) in enumerate(zip(predicted, events)):
        got = (ev["signature"], ev["grid"], ev["block"])
        want = (rec.signature, tuple(rec.grid), tuple(rec.block))
        shared = ev["smem"]
        if got != want:
            mismatches.append(f"launch {i}: predicted {want}, the profiler saw {got}")
        elif shared is None or not rec.smem_bytes <= shared <= rec.smem_bytes + STATIC_SMEM:
            mismatches.append(f"launch {i} {rec.signature}: {rec.smem_bytes} bytes of dynamic "
                              f"shared memory recorded, {shared} in the trace")
        else:
            per_key[rec.name]["profiler"] += 1
    for key, n in counted.items():
        if n and key not in per_key:
            per_key[key] = {"meta": 0, "launches": n, "profiler": 0}
    for key, c in sorted(per_key.items()):
        if not c["meta"] == c["launches"] == c["profiler"]:
            mismatches.append(f"{key}: meta {c['meta']}, LAUNCHES {c['launches']}, "
                              f"profiler {c['profiler']}")
    smem = sorted({(ev["signature"], ev["smem"], rec.smem_bytes)
                   for rec, ev in zip(predicted, events)})
    return {"kernels": per_key, "events": len(events), "mismatches": mismatches,
            "smem": [{"signature": s, "trace": t, "recorded": r} for s, t, r in smem],
            "ok": not mismatches}
