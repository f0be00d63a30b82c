"""Donation pass: no big parameter or state leaf is copied defensively
(counterpart of ``repro.analysis.donation``).

The JAX package donates params and optimizer state to the jitted step and
checks XLA's input/output alias table. Eager PyTorch has no donation to
drop: the step returns new tensors, and the old ones live on until the
caller drops them. What can still go wrong is a copy: a leaf cloned before
it is updated holds a second buffer of its size for the whole step. For
every leaf of at least ``BIG_LEAF_BYTES`` (a bucket, a momentum shard, an
embedding), the step may make at most one new tensor of the leaf's shape
and dtype from it, its new value: a value-preserving op (``clone``,
``_to_copy``, ``copy``, ``copy_``) that reads the leaf's storage and writes
a new buffer of the leaf's shape and dtype counts as a copy.

The pass also reports, as INFO, how many bytes of old values the step
leaves alive beside their new values (leaves replaced out of place);
``chip_smoke.py`` phase K measures what that costs on the card.
"""
from __future__ import annotations

from typing import Dict, List

from repro_torch.analysis.findings import Finding, Severity
from repro_torch.analysis.framework import AnalysisPass, Artifacts, Leaf, register_pass

BIG_LEAF_BYTES = 1 << 20
COPY_OPS = frozenset({"clone", "_to_copy", "copy", "copy_", "lift_fresh_copy"})


def leaf_copies(artifacts: Artifacts, leaf: Leaf) -> List[int]:
    """Indices of the ops that copy ``leaf`` into a new buffer of its shape
    and dtype."""
    t = artifacts.tensors
    hits = []
    for op in artifacts.ops:
        if op.kind != "op" or op.name not in COPY_OPS or not op.inputs:
            continue
        if op.name == "copy_":
            if len(op.inputs) < 2:
                continue
            dest, src = t[op.inputs[0]], t[op.inputs[1]]
            if (src.storage == leaf.storage and dest.storage != leaf.storage
                    and dest.shape == leaf.shape and dest.dtype == leaf.dtype):
                hits.append(op.index)
        elif t[op.inputs[0]].storage == leaf.storage and any(
                t[o].shape == leaf.shape and t[o].dtype == leaf.dtype for o in op.fresh):
            hits.append(op.index)
    return hits


@register_pass
class DonationPass(AnalysisPass):
    name = "donation"
    description = ("no parameter or state leaf of 1 MiB or more is copied "
                   "defensively; old values left alive are reported")
    scope = "combo"

    def run(self, artifacts: Artifacts) -> List[Finding]:
        out: List[Finding] = []
        combo = artifacts.combo
        after: Dict[str, Leaf] = {leaf.path: leaf for leaf in artifacts.after}
        big = [leaf for leaf in artifacts.before if leaf.nbytes >= BIG_LEAF_BYTES]
        alive = 0
        for leaf in big:
            copies = leaf_copies(artifacts, leaf)
            new = after.get(leaf.path)
            replaced = new is not None and new.storage != leaf.storage
            alive += leaf.nbytes if replaced else 0
            if len(copies) + int(replaced) > 1:
                out.append(Finding(
                    pass_name=self.name, severity=Severity.ERROR, code="defensive-copy",
                    message=(f"leaf {leaf.path} ({leaf.shape} {leaf.dtype}, "
                             f"{leaf.nbytes / 2**20:.2f} MiB) is copied by op(s) "
                             f"{', '.join(f'#{i}' for i in copies)} beside its new value: "
                             f"a second buffer of its size for the whole step"),
                    combo=combo.id, location=leaf.path))
        out.append(Finding(
            pass_name=self.name, severity=Severity.INFO, code="old-values-alive",
            message=(f"{len(big)} leaves of 1 MiB or more; the step replaces their "
                     f"values out of place, so {alive / 2**20:.2f} MiB of old values "
                     f"stay alive until the caller drops them"), combo=combo.id))
        return out
