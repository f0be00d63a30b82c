#!/usr/bin/env python3
"""What the cost counter's replay saves: record one dry-run cell
(``launch/dryrun.run_cell``, 16 ranks) twice, once as the counter runs
(an op met again with the same argument metadata replayed without its
meta kernel) and once with every op run through its meta kernel, and
print both recording times and whether the two records are equal.

Runs on meta tensors on the CPU; nothing touches a device.

    PYTHONPATH=src python3 tools/dryrun_replay.py --arch xlstm-350m --shape prefill_32k
    PYTHONPATH=src python3 tools/dryrun_replay.py --arch qwen3-4b --shape train_4k --mode every
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

from repro_torch.launch import cost, dryrun


def record(arch: str, shape: str, replay: bool) -> dict:
    scan = cost._scan
    if not replay:  # no op has a key, so none is kept or replayed
        cost._scan = lambda f, a, k: (scan(f, a, k)[0], None)
    try:
        with tempfile.TemporaryDirectory() as out:
            t0 = time.perf_counter()
            rec = dryrun.run_cell(arch, shape, False, Path(out))
            rec["wall_s"] = time.perf_counter() - t0
    finally:
        cost._scan = scan
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--mode", choices=("both", "replay", "every"), default="both",
                    help="record with the replay, without it (every op through its "
                         "meta kernel), or both and compare")
    ap.add_argument("--json", help="write the times and the records' cost here")
    args = ap.parse_args(argv)

    modes = ("replay", "every") if args.mode == "both" else (args.mode,)
    recs = {m: record(args.arch, args.shape, m == "replay") for m in modes}
    out = {"arch": args.arch, "shape": args.shape}
    for m, rec in recs.items():
        out[m] = {"record_s": rec.get("record_s"), "wall_s": rec["wall_s"],
                  "status": rec["status"], "cost": rec.get("cost"),
                  "memory": rec.get("memory")}
        print(f"[replay] {args.arch} {args.shape} {m}: record {rec.get('record_s', 0):.1f} s "
              f"(wall {rec['wall_s']:.1f} s)", flush=True)
    if len(recs) == 2:
        strip = [json.loads(json.dumps({k: v for k, v in r.items()
                                        if k not in ("record_s", "wall_s")}))
                 for r in recs.values()]
        out["equal"] = strip[0] == strip[1]
        out["speedup"] = recs["every"]["wall_s"] / recs["replay"]["wall_s"]
        print(f"[replay] records equal: {out['equal']}; "
              f"every op / replay: {out['speedup']:.2f}x", flush=True)
    if args.json:
        Path(args.json).write_text(json.dumps(out, indent=1))
    return 0 if out.get("equal", True) else 1


if __name__ == "__main__":
    sys.exit(main())
