"""Memory pass: no full-bucket fp32 buffer in the recorded ZeRO-2 step
(counterpart of ``repro.analysis.memory``).

The single-pass ZeRO-2 engine's memory claim is that per rank, per bucket,
only ``1/N``-sized gradient, momentum and slot buffers and the one
*intended* full-size buffer (the updated-weight all-gather's result) ever
exist. This pass counts, over every op of the recorded step, the outputs
with new storage (views and in-place results allocate nothing) at

* the full ``(padded, d_in, d_out)`` bucket in fp32 (a gradient gather, a
  two-pass ``d`` buffer, or a replicated momentum buffer leaking in);
* every slot stripe at its FULL ``(padded, 1, d_out)`` shape: sharded
  rules (NorMuon's ``nu``, Nora's ``r``) must only ever hold the
  ``padded/N`` shard.

Collective results are excluded: the updated-weight all-gather is the
intended full buffer. Buckets where a planned leaf is itself bucket-sized
are skipped (the leaf's own gradient has the full shape).
"""
from __future__ import annotations

from typing import List, Tuple

import torch

from repro_torch.analysis.findings import Finding, Severity
from repro_torch.analysis.framework import AnalysisPass, Artifacts, Combo, register_pass


def fresh_buffers(artifacts: Artifacts, shape: Tuple[int, ...], dtype) -> List[str]:
    """Names of the ops whose outputs with new storage have exactly
    ``(shape, dtype)``, collective results excluded."""
    shape = tuple(shape)
    collected = {t for op in artifacts.collectives for t in op.outputs}
    hits: List[str] = []
    for op in artifacts.ops:
        for t in op.fresh:
            info = artifacts.tensors[t]
            if t not in collected and info.shape == shape and info.dtype == dtype:
                hits.append(op.name)
    return hits


@register_pass
class MemoryPass(AnalysisPass):
    name = "memory"
    description = ("no full-bucket fp32 gradient/momentum/slot buffer in the "
                   "recorded ZeRO-2 step")
    scope = "combo"

    def applies(self, combo: Combo) -> bool:
        # the bucketed two-pass engine materializes the full fp32 ``d``
        # bucket by design; the invariant is defined for ZeRO-2 only
        return combo.zero2

    def run(self, artifacts: Artifacts) -> List[Finding]:
        out: List[Finding] = []
        combo = artifacts.combo
        checked = 0
        for b in artifacts.buckets:
            if any(tuple(s) == b.full_shape for s in b.leaf_shapes):
                out.append(Finding(
                    pass_name=self.name, severity=Severity.INFO, code="bucket-skipped",
                    message=(f"bucket {b.key}: a planned leaf is itself bucket-sized "
                             f"{b.full_shape}; full-shape counting would flag the "
                             f"leaf's own gradient"),
                    combo=combo.id, location=b.key))
                continue
            checked += 1
            for op in fresh_buffers(artifacts, b.full_shape, torch.float32):
                out.append(Finding(
                    pass_name=self.name, severity=Severity.ERROR, code="full-bucket-fp32",
                    message=(f"bucket {b.key}: op {op!r} allocates a full {b.full_shape} "
                             f"fp32 buffer; the ZeRO-2 path must only hold "
                             f"1/{artifacts.n_dev} shards (plus the updated-weight "
                             f"all-gather)"),
                    combo=combo.id, location=b.key))
            for slot, (shape, dtype) in sorted(b.slot_shapes.items()):
                for op in fresh_buffers(artifacts, shape, dtype):
                    out.append(Finding(
                        pass_name=self.name, severity=Severity.ERROR,
                        code="full-slot-stripe",
                        message=(f"bucket {b.key}: op {op!r} allocates slot {slot!r} at "
                                 f"its full shape {tuple(shape)} ({dtype}); slot stripes "
                                 f"must stay sharded along L"),
                        combo=combo.id, location=f"{b.key}/{slot}"))
        out.append(Finding(
            pass_name=self.name, severity=Severity.INFO, code="summary",
            message=(f"checked {checked} buckets for full-shape fp32 buffers and slot "
                     f"stripes over {len(artifacts.ops)} ops"), combo=combo.id))
        return out
