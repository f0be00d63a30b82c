"""CLI: record every combo, run every pass, write ANALYSIS_report.json.

    PYTHONPATH=src python -m repro_torch.analysis.check --all

The counterpart of ``python -m repro.analysis.check``, with its flags, and
``--break`` to record the combos with one of ``trace.BREAK_MODES`` on
purpose. Exit status is 1 iff an ERROR finding survives the allowlist, 2 on
a bad argument. Everything runs on meta tensors on the CPU: no card, no
process group.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import List

from repro_torch.analysis.findings import Severity, apply_allowlist, load_allowlist, report_dict
from repro_torch.analysis.framework import pass_catalog, registered_passes, run_passes


def _parser() -> argparse.ArgumentParser:
    from repro_torch.analysis.trace import BREAK_MODES

    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.check",
        description="Invariant checks over the recorded optimizer x engine x wire "
                    "matrix (meta tensors; nothing runs on a device).")
    p.add_argument("--all", action="store_true",
                   help="check the full combo matrix (default when no filter is given)")
    p.add_argument("--optimizer", action="append", default=None,
                   help="restrict to an optimizer (repeatable)")
    p.add_argument("--engine", action="append", default=None,
                   choices=["bucketed", "single-pass"],
                   help="restrict to an engine (repeatable)")
    p.add_argument("--wire", action="append", default=None, choices=["fp32", "int8-ef"],
                   help="restrict to a wire format (repeatable)")
    p.add_argument("--accum", action="append", type=int, default=None,
                   help="restrict to an accumulation factor (repeatable)")
    p.add_argument("--pass", dest="passes", action="append", default=None,
                   help="run only this pass (repeatable)")
    p.add_argument("--break", dest="break_mode", default=None, choices=BREAK_MODES,
                   help="record every combo with this regression built in (the "
                        "passes must catch it)")
    p.add_argument("--report", default="ANALYSIS_report.json",
                   help="report path (default: %(default)s)")
    p.add_argument("--allowlist", default=None,
                   help="JSON allowlist of findings to downgrade")
    p.add_argument("--list", action="store_true",
                   help="list passes and the selected combos, then exit")
    return p


def main(argv: List[str] | None = None) -> int:
    args = _parser().parse_args(argv)

    from repro_torch.analysis import trace

    combos = trace.build_combos(optimizers=args.optimizer, engines=args.engine,
                                wires=args.wire, accums=args.accum)
    catalog = pass_catalog()
    catalog_names = [entry["name"] for entry in catalog]
    if args.passes:
        unknown = set(args.passes) - set(catalog_names)
        if unknown:
            print(f"unknown pass(es): {', '.join(sorted(unknown))}; "
                  f"available: {', '.join(catalog_names)}", file=sys.stderr)
            return 2

    if args.list:
        print("passes:")
        for entry in catalog:
            print(f"  {entry['name']:<12} ({entry['scope']}) {entry['description']}")
        print(f"combos ({len(combos)}):")
        for c in combos:
            print(f"  {c.id}")
        return 0

    artifacts = []
    t_all = time.monotonic()
    passes = registered_passes()
    if all(passes[n].scope == "repo" for n in (args.passes or catalog_names)):
        combos = []  # repo-scope passes read no recorded step
    for i, combo in enumerate(combos):
        t0 = time.monotonic()
        artifacts.append(trace.record_combo(combo, break_mode=args.break_mode))
        print(f"[{i + 1}/{len(combos)}] recorded {combo.id} "
              f"({len(artifacts[-1].ops)} ops) in {time.monotonic() - t0:.2f}s",
              file=sys.stderr, flush=True)

    findings = run_passes(artifacts, only=args.passes)
    if args.allowlist:
        findings = apply_allowlist(findings, load_allowlist(args.allowlist))

    pass_names = args.passes or catalog_names
    report = report_dict(findings, [c.id for c in combos], pass_names)
    with open(args.report, "w", encoding="utf-8") as f:
        json.dump(report, f, indent=2)
        f.write("\n")

    counts = report["counts"]
    for sev in (Severity.ERROR, Severity.WARNING):
        for fd in findings:
            if fd.severity is sev:
                where = fd.combo or fd.location or "-"
                print(f"{sev.value.upper():<8} {fd.pass_name:<12} [{fd.code}] {where}: "
                      f"{fd.message}")
    print(f"\n{len(combos)} combos x {len(pass_names)} passes in "
          f"{time.monotonic() - t_all:.1f}s: {counts.get('error', 0)} errors, "
          f"{counts.get('warning', 0)} warnings, {counts.get('allowlisted', 0)} "
          f"allowlisted, {counts.get('info', 0)} info -> {args.report}")
    return 1 if counts.get("error", 0) else 0


if __name__ == "__main__":
    sys.exit(main())
