"""Overlap pass: no update -> collective serialization edge
(counterpart of ``repro.analysis.overlap``).

The pipelined ZeRO-2 step keeps every bucket's chain (gradient
reduce-scatter -> fused apply -> updated-weight all-gather) independent of
every other bucket's, so that one bucket's collective can run while
another bucket computes. A data path from one bucket's update *output*
back into any gradient collective serializes communication behind compute.
This pass follows the recorded tensor ids from each updated-weight
all-gather (a gather of a ``(L/N, d_in, d_out)`` shard of a bucket) through
every later op and fails on any gradient collective (``all_to_all``: the
reduce-scatter of the exact wire and the int8 exchange) it reaches.
"""
from __future__ import annotations

from typing import Dict, List, Set, Tuple

from repro_torch.analysis.findings import Finding, Severity
from repro_torch.analysis.framework import AnalysisPass, Artifacts, Combo, register_pass


def collective_overlap_report(artifacts: Artifacts) -> Dict:
    """``{"collectives": [op index], "update_gathers": [(op index, bucket)],
    "serialization_edges": [(gather index, collective index, bucket)]}``."""
    by_shape = {(b.d_in, b.d_out): b.key for b in artifacts.buckets}
    gathers: List[Tuple[int, str]] = []
    collectives: List[int] = []
    for op in artifacts.collectives:
        if op.name == "all_to_all":
            collectives.append(op.index)
            continue
        shape = artifacts.tensors[op.inputs[0]].shape
        key = by_shape.get(tuple(shape[-2:])) if len(shape) == 3 else None
        if key is not None:
            gathers.append((op.index, key))
    edges = []
    ops = artifacts.ops
    for start, key in gathers:
        reached: Set[int] = set(ops[start].outputs)
        for op in ops[start + 1:]:
            if reached.intersection(op.inputs):
                if op.kind == "collective" and op.name == "all_to_all":
                    edges.append((start, op.index, key))
                reached.update(op.outputs)
    return {"collectives": collectives, "update_gathers": gathers,
            "serialization_edges": edges, "n_serialization_edges": len(edges)}


@register_pass
class OverlapPass(AnalysisPass):
    name = "overlap"
    description = ("no updated-weight -> gradient-collective data path in the "
                   "recorded ZeRO-2 step")
    scope = "combo"

    def applies(self, combo: Combo) -> bool:
        return combo.zero2

    def run(self, artifacts: Artifacts) -> List[Finding]:
        out: List[Finding] = []
        combo = artifacts.combo
        if not artifacts.buckets:
            out.append(Finding(
                pass_name=self.name, severity=Severity.INFO, code="no-buckets",
                message="no matrix buckets in the plan; nothing to check", combo=combo.id))
            return out
        rep = collective_overlap_report(artifacts)
        if not rep["update_gathers"]:
            out.append(Finding(
                pass_name=self.name, severity=Severity.ERROR, code="no-update-gathers",
                message=("ZeRO-2 step recorded with no bucket-shaped updated-weight "
                         "all-gather: either weights are not gathered or the classifier "
                         "no longer matches the plan"), combo=combo.id))
        for u, c, key in rep["serialization_edges"]:
            out.append(Finding(
                pass_name=self.name, severity=Severity.ERROR, code="serialization-edge",
                message=(f"updated-weight gather #{u} (bucket {key}) feeds gradient "
                         f"collective #{c}: the bucket chains are serialized"),
                combo=combo.id, location=f"#{u} -> #{c}"))
        out.append(Finding(
            pass_name=self.name, severity=Severity.INFO, code="summary",
            message=(f"{len(rep['collectives'])} gradient collectives, "
                     f"{len(rep['update_gathers'])} update gathers, "
                     f"{rep['n_serialization_edges']} serialization edges"),
            combo=combo.id))
        return out
