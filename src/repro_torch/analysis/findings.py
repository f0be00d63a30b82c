"""Severity-ranked findings and the stable ``ANALYSIS_report.json`` schema
(a copy of ``repro.analysis.findings``).

A finding is one violated (or degraded) invariant, attributed to a pass
and, when applicable, to the optimizer x engine x wire x accum combo whose
recorded step exhibited it.  The report schema is stable across PRs so
CI artifacts diff cleanly:

    {"version": 1, "ok": bool, "counts": {"error": n, ...},
     "combos": [...], "passes": [...], "findings": [{...}, ...]}

Allowlisting: a JSON file of ``{"pass": ..., "code": ..., "match": ...}``
entries (all fields optional, substring semantics for ``match`` against
the message) downgrades matching findings to severity ``allowlisted`` —
they stay in the report but never fail the gate.
"""
from __future__ import annotations

import dataclasses
import enum
import json
from typing import Dict, List, Optional, Sequence


class Severity(enum.Enum):
    """ERROR fails the gate; WARNING is surfaced but non-fatal; INFO is
    bookkeeping (counts, classifications); ALLOWLISTED is a downgraded
    finding kept for the record."""
    ERROR = "error"
    WARNING = "warning"
    INFO = "info"
    ALLOWLISTED = "allowlisted"

    @property
    def rank(self) -> int:
        return {"error": 0, "warning": 1, "info": 2, "allowlisted": 3}[self.value]


@dataclasses.dataclass(frozen=True)
class Finding:
    pass_name: str        # which checker produced it
    severity: Severity
    code: str             # stable machine code, e.g. "full-bucket-fp32"
    message: str          # human explanation, names the offending object
    combo: str = ""       # combo id ("rmnp/single-pass/fp32/accum1") or ""
    location: str = ""    # op / file / bucket the finding points at

    def as_dict(self) -> Dict[str, str]:
        return {"pass": self.pass_name, "severity": self.severity.value,
                "code": self.code, "message": self.message,
                "combo": self.combo, "location": self.location}


def load_allowlist(path: Optional[str]) -> List[Dict[str, str]]:
    if not path:
        return []
    with open(path) as f:
        entries = json.load(f)
    if not isinstance(entries, list):
        raise ValueError(f"allowlist {path!r} must be a JSON list of "
                         f"{{pass, code, match}} objects")
    return entries


def _matches(finding: Finding, entry: Dict[str, str]) -> bool:
    if entry.get("pass") and entry["pass"] != finding.pass_name:
        return False
    if entry.get("code") and entry["code"] != finding.code:
        return False
    if entry.get("match") and entry["match"] not in finding.message:
        return False
    return bool(entry)  # an empty entry allowlists nothing


def apply_allowlist(findings: Sequence[Finding],
                    allowlist: Sequence[Dict[str, str]]) -> List[Finding]:
    """Downgrade findings matching any allowlist entry to ALLOWLISTED."""
    out = []
    for f in findings:
        if f.severity is not Severity.INFO and any(
                _matches(f, e) for e in allowlist):
            f = dataclasses.replace(f, severity=Severity.ALLOWLISTED)
        out.append(f)
    return out


def report_dict(findings: Sequence[Finding], combos: Sequence[str],
                passes: Sequence[str]) -> Dict:
    """Assemble the stable report payload, findings sorted most severe
    first (then by pass/combo/location for a deterministic artifact)."""
    ranked = sorted(findings, key=lambda f: (f.severity.rank, f.pass_name,
                                             f.combo, f.location, f.code))
    counts = {s.value: 0 for s in Severity}
    for f in ranked:
        counts[f.severity.value] += 1
    return {
        "version": 1,
        "ok": counts["error"] == 0,
        "counts": counts,
        "combos": list(combos),
        "passes": list(passes),
        "findings": [f.as_dict() for f in ranked],
    }
