"""Sharding pass: ZeRO-sharded state is never silently replicated
(counterpart of ``repro.analysis.sharding``).

In the ZeRO-2 step the ONLY legitimate full-bucket all-gather is the
updated-weight gather at the end of each bucket's chain: exactly one per
bucket. Momentum and slot stripes live and die as ``L/N`` shards; an
all-gather whose result is a full momentum bucket (beyond the one weight
gather) or a full slot stripe means some change started replicating
sharded state, which multiplies optimizer memory by N and the bytes on the
wire. This pass classifies every recorded all-gather by its result's shape
against the bucket plan.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from repro_torch.analysis.findings import Finding, Severity
from repro_torch.analysis.framework import AnalysisPass, Artifacts, Combo, register_pass


def classify_all_gathers(artifacts: Artifacts) -> Dict[str, List[Tuple[int, str]]]:
    """``bucket key -> [(op index, dtype)]`` for every all-gather whose result
    is exactly the bucket's full shape, ``"slot:<bucket>/<slot>"`` for
    full-slot-stripe gathers and ``"?"`` for the rest."""
    full = {b.full_shape: b.key for b in artifacts.buckets}
    slots = {tuple(shape): f"slot:{b.key}/{name}"
             for b in artifacts.buckets for name, (shape, _dt) in b.slot_shapes.items()}
    out: Dict[str, List[Tuple[int, str]]] = {}
    for op in artifacts.collectives:
        if op.name != "all_gather":
            continue
        info = artifacts.tensors[op.outputs[0]]
        key = full.get(info.shape) or slots.get(info.shape) or "?"
        out.setdefault(key, []).append((op.index, str(info.dtype)))
    return out


@register_pass
class ShardingPass(AnalysisPass):
    name = "sharding"
    description = ("no all-gather replicates ZeRO-sharded momentum or slot "
                   "stripes (one weight gather per bucket)")
    scope = "combo"

    def applies(self, combo: Combo) -> bool:
        return combo.zero2

    def run(self, artifacts: Artifacts) -> List[Finding]:
        out: List[Finding] = []
        combo = artifacts.combo
        gathers = classify_all_gathers(artifacts)
        for key, ops in sorted(gathers.items()):
            if key.startswith("slot:"):
                for index, _dt in ops:
                    out.append(Finding(
                        pass_name=self.name, severity=Severity.ERROR,
                        code="slot-stripe-gathered",
                        message=(f"all-gather #{index} rebuilds the full {key[5:]} slot "
                                 f"stripe; slot state must stay ZeRO-sharded"),
                        combo=combo.id, location=f"#{index}"))
            elif key != "?" and len(ops) != 1:
                names = ", ".join(f"#{i} ({dt})" for i, dt in ops)
                out.append(Finding(
                    pass_name=self.name, severity=Severity.ERROR, code="state-replicated",
                    message=(f"bucket {key}: {len(ops)} full-bucket all-gathers ({names}); "
                             f"only the one updated-weight gather is allowed: an extra "
                             f"gather means momentum or another sharded buffer is being "
                             f"replicated"),
                    combo=combo.id, location=key))
        for b in artifacts.buckets:
            if b.key not in gathers:
                out.append(Finding(
                    pass_name=self.name, severity=Severity.ERROR, code="weights-not-gathered",
                    message=(f"bucket {b.key}: no all-gather of the updated weights to "
                             f"{b.full_shape}; every rank must end the step with the "
                             f"whole bucket"),
                    combo=combo.id, location=b.key))
        n_bucket = sum(len(v) for k, v in gathers.items()
                       if k != "?" and not k.startswith("slot:"))
        out.append(Finding(
            pass_name=self.name, severity=Severity.INFO, code="summary",
            message=(f"{n_bucket} bucket-shaped all-gathers across "
                     f"{len(artifacts.buckets)} buckets, {len(gathers.get('?', []))} "
                     f"others"), combo=combo.id))
        return out
