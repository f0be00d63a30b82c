"""Numerical fault injection for the resilience checks (mirror of
``repro.train.faults``).

A fault poisons one element of a chosen gradient leaf straight out of the
backward pass, upstream of the clip and the optimizer, where a bad loss
kernel or an overflowed bf16 activation would land it. Faults parse from one
string (``launch/train.py --inject-fault``):

    kind:leaf:step[:microbatch]

    nan:stack/layer_0/mixer/wq:5   NaN into that leaf's gradient at step 5
    inf:embed/tokens:3:1           Inf at step 3, microbatch 1 only
    nan:*:6+                       NaN into the first leaf, every step >= 6
                                   (sticky: the input that walks the
                                   rewind ladder to abort)
    bitflip:768x768:4              flip the top exponent bit of the first
                                   fp32 block scale rank 0 sends for bucket
                                   768x768 at step 4 (the int8 wire of ZeRO-2)

A trailing ``+`` on the step makes the fault sticky. The driver disarms an
injected fault on rewind, so a sticky fault models a transient that a rewind
clears, while the abort rung covers anomalies that keep firing.

A bit-flip targets a *scale*, not an int8 sample: a flipped sample is bounded
by its block's scale and stays finite, invisible to a finite-ness guard,
while exponent bit 30 of a normal scale makes dequantization overflow to
inf, the class the guard must catch. A block whose scale is 0.0 flips to
2.0 and still dequantizes to 0: aim at a bucket with live gradients.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.types import PyTree, map_with_path, tree_paths

_KINDS = ("nan", "inf", "bitflip")


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One injected fault. ``leaf`` is a gradient-leaf path for nan/inf
    (``*`` = the tree's first leaf) or a bucket key for bitflip;
    ``microbatch`` of -1 fires on every microbatch; ``sticky`` fires at
    every step >= ``step`` instead of exactly at it."""
    kind: str
    leaf: str
    step: int
    microbatch: int = -1
    sticky: bool = False

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"fault kind must be one of {_KINDS}, "
                             f"got {self.kind!r}")
        if self.kind == "bitflip" and self.microbatch != -1:
            raise ValueError("bitflip is a wire fault — it has no "
                             "microbatch (the wire sees the accumulated "
                             "gradient)")

    def describe(self) -> str:
        when = f"step >= {self.step}" if self.sticky else f"step {self.step}"
        mb = f", microbatch {self.microbatch}" if self.microbatch >= 0 else ""
        return f"{self.kind} into {self.leaf!r} at {when}{mb}"


def parse_fault(spec: str) -> FaultSpec:
    """Parse ``kind:leaf:step[:microbatch]`` (see the module docstring)."""
    parts = spec.split(":")
    if len(parts) not in (3, 4):
        raise ValueError(
            f"--inject-fault expects kind:leaf:step[:microbatch], "
            f"got {spec!r}")
    kind, leaf, step_s = parts[0], parts[1], parts[2]
    sticky = step_s.endswith("+")
    try:
        step = int(step_s[:-1] if sticky else step_s)
        mb = int(parts[3]) if len(parts) == 4 else -1
    except ValueError:
        raise ValueError(f"--inject-fault {spec!r}: step/microbatch must "
                         f"be integers") from None
    return FaultSpec(kind=kind, leaf=leaf, step=step, microbatch=mb,
                     sticky=sticky)


def _hit(spec: FaultSpec, step: int) -> bool:
    return step >= spec.step if spec.sticky else step == spec.step


def apply_grad_fault(spec: Optional[FaultSpec], grads: PyTree, step,
                     microbatch: int = 0) -> PyTree:
    """Poison element ``[0, ..., 0]`` of the named gradient leaf when
    ``step`` (and the microbatch, if pinned) matches; otherwise return
    ``grads`` itself. The step is a host integer in the port, so the check
    costs the device nothing. A wire fault (bitflip) leaves the gradients
    alone."""
    if spec is None or spec.kind not in ("nan", "inf"):
        return grads
    flat = tree_paths(grads)
    target = spec.leaf if spec.leaf != "*" else flat[0][0]
    if target not in {p for p, _ in flat}:
        raise ValueError(
            f"--inject-fault leaf {spec.leaf!r} is not a gradient leaf; "
            f"available: {', '.join(p for p, _ in flat)}")
    hit = _hit(spec, int(step))
    if spec.microbatch >= 0:
        hit = hit and int(microbatch) == spec.microbatch
    if not hit:
        return grads
    bad = float("nan") if spec.kind == "nan" else float("inf")

    def poison(path, g):
        if path != target:
            return g
        g = g.clone()
        g[(0,) * g.ndim] = bad
        return g

    return map_with_path(poison, grads)


def wire_fault_for(spec: Optional[FaultSpec], bucket_key: str, step, comm):
    """The ``wire_fault`` hook of ``compressed_reduce_scatter_leaf``: None
    unless ``spec`` is a bitflip aimed at ``bucket_key``, else a ``(q,
    scale) -> (q, scale)`` callable that flips bit 30 (the top exponent bit)
    of the first outgoing fp32 block scale when this is rank 0 of ``comm``
    and the step matches. It runs after the sender has taken its residual,
    so the corruption is on the wire: the sender's error feedback stays
    honest and only the receiver of that chunk sees it."""
    if spec is None or spec.kind != "bitflip" or spec.leaf != bucket_key:
        return None
    hit = _hit(spec, int(step)) and comm.rank == 0

    def corrupt(q, scale):
        if not hit:
            return q, scale
        flat = scale.reshape(-1).clone()
        bits = flat[:1].view(torch.int32) ^ (1 << 30)
        flat[:1] = bits.view(torch.float32)
        return q, flat.reshape(scale.shape)

    return corrupt
