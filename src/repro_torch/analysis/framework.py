"""The pass framework: combos, the recorded step of a combo, and the registry
(counterpart of ``repro.analysis.framework``).

A *combo* is one point of the optimizer x engine x wire x accum matrix.
:mod:`repro_torch.analysis.trace` turns a combo into :class:`Artifacts`:
the record of one real ``train/dp_step.make_dp_train_step`` step run on
meta tensors, as rank 0 of a group of four whose collectives are recorded,
not made. Each registered :class:`AnalysisPass` then inspects the artifacts
and returns :class:`Finding` objects. Where the JAX package reads a jaxpr
and compiled HLO, the port reads the ops the step dispatched, with the
tensors and storages each op read and wrote.

Two scopes: ``combo`` passes run once per recorded combination; ``repo``
passes (the AST conventions, the kernel lint) run once per invocation with
no artifacts.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

from repro_torch.analysis.findings import Finding, Severity

ENGINES = ("bucketed", "single-pass")
WIRES = ("fp32", "int8-ef")


@dataclasses.dataclass(frozen=True)
class Combo:
    """One optimizer x engine x wire x accum point.

    ``engine="bucketed"`` is the two-pass bucketed engine (replicated
    state: the full fp32 direction bucket is its *definition*, so the
    memory pass does not apply); ``engine="single-pass"`` is the fused
    ZeRO-2 path (``update_apply_sharded``), where every memory, sharding
    and overlap invariant must hold."""
    optimizer: str
    engine: str            # "bucketed" | "single-pass"
    wire: str              # "fp32" | "int8-ef"
    accum: int = 1
    guard: bool = False    # the non-finite guard's masked update

    def __post_init__(self):
        if self.engine not in ENGINES:
            raise ValueError(f"engine must be one of {ENGINES}, "
                             f"got {self.engine!r}")
        if self.wire not in WIRES:
            raise ValueError(f"wire must be one of {WIRES}, "
                             f"got {self.wire!r}")
        if self.accum < 1:
            raise ValueError(f"accum must be >= 1, got {self.accum}")

    @property
    def zero2(self) -> bool:
        return self.engine == "single-pass"

    @property
    def compress(self) -> bool:
        return self.wire == "int8-ef"

    @property
    def id(self) -> str:
        base = f"{self.optimizer}/{self.engine}/{self.wire}/accum{self.accum}"
        return base + "/guard" if self.guard else base


class BucketMeta(NamedTuple):
    """One bucket of the plan: its key, the stacked full shape whose fp32
    materialization or all-gather the passes police, its slot stripes at
    their full ``(padded, 1, d_out)`` shapes and the planned leaves'
    shapes."""
    key: str
    d_in: int
    d_out: int
    size: int
    padded: int
    slot_shapes: Dict[str, Tuple[Tuple[int, ...], object]]
    leaf_shapes: Tuple[Tuple[int, ...], ...]

    @property
    def full_shape(self) -> Tuple[int, int, int]:
        return (self.padded, self.d_in, self.d_out)


class TensorInfo(NamedTuple):
    shape: Tuple[int, ...]
    dtype: object
    storage: int           # identity of its storage (views share it)


class OpRecord(NamedTuple):
    """One dispatched op (``kind="op"``, ``name`` the aten op) or one
    collective of the recording group (``kind="collective"``, ``name``
    ``all_to_all`` or ``all_gather``, ``inputs`` its operand and
    ``outputs`` its result). ``fresh`` lists the outputs with new storage."""
    index: int
    kind: str
    name: str
    inputs: Tuple[int, ...]
    outputs: Tuple[int, ...]
    fresh: Tuple[int, ...]


class Leaf(NamedTuple):
    path: str              # "params/..." or "opt_state/..."
    shape: Tuple[int, ...]
    dtype: object
    storage: int
    nbytes: int


@dataclasses.dataclass
class Artifacts:
    """Everything the combo-scope passes may consume: the step's ``ops`` in
    dispatch order, ``tensors`` by id, the kernel ``launches`` it recorded,
    the plan's ``buckets``, and the parameter and state leaves ``before``
    and ``after`` the step."""
    combo: Combo
    ops: Tuple[OpRecord, ...] = ()
    tensors: Dict[int, TensorInfo] = dataclasses.field(default_factory=dict)
    launches: Tuple = ()
    buckets: Tuple[BucketMeta, ...] = ()
    before: Tuple[Leaf, ...] = ()
    after: Tuple[Leaf, ...] = ()
    n_dev: int = 4

    @property
    def collectives(self) -> List[OpRecord]:
        return [op for op in self.ops if op.kind == "collective"]


class AnalysisPass:
    """Base checker. Subclasses set ``name``/``description``/``scope``
    and implement ``run``; ``applies`` gates combos the invariant is not
    defined for (returning False records an INFO skip, not silence)."""

    name = "base"
    description = ""
    scope = "combo"            # "combo" | "repo"

    def applies(self, combo: Combo) -> bool:
        return True

    def run(self, artifacts: Optional[Artifacts]) -> List[Finding]:
        raise NotImplementedError

    def skip_finding(self, combo: Combo, why: str) -> Finding:
        return Finding(pass_name=self.name, severity=Severity.INFO,
                       code="not-applicable", message=why, combo=combo.id)


_REGISTRY: Dict[str, Callable[[], AnalysisPass]] = {}


def register_pass(cls):
    _REGISTRY[cls.name] = cls
    return cls


def registered_passes() -> Dict[str, Callable[[], AnalysisPass]]:
    """name -> pass class, with every pass module imported."""
    from repro_torch.analysis import (  # noqa: F401
        conventions, donation, kernel_lint, memory, overlap, sharding,
    )
    return dict(_REGISTRY)


def pass_catalog() -> List[Dict[str, str]]:
    return [{"name": name, "scope": cls.scope,
             "description": cls.description}
            for name, cls in sorted(registered_passes().items())]


def run_passes(artifacts_list: Sequence[Artifacts],
               only: Optional[Sequence[str]] = None) -> List[Finding]:
    """Run every registered pass over every combo's artifacts (repo-scope
    passes once)."""
    passes = registered_passes()
    names = list(only) if only else sorted(passes)
    unknown = [n for n in names if n not in passes]
    if unknown:
        raise ValueError(f"unknown pass(es) {unknown}; registered: "
                         f"{sorted(passes)}")
    findings: List[Finding] = []
    for name in names:
        p = passes[name]()
        if p.scope == "repo":
            findings.extend(p.run(None))
            continue
        for art in artifacts_list:
            if not p.applies(art.combo):
                findings.append(p.skip_finding(
                    art.combo, f"{name}: invariant not defined for "
                    f"{art.combo.engine} engine"))
                continue
            findings.extend(p.run(art))
    return findings
