#!/usr/bin/env python3
"""Step time and run-to-run repeatability of the port's main path on the card.

    python3 tools/step_repeat.py [--src DIR] [--arch gpt2-small] [--steps 4] [--runs 2]

Trains ``--arch`` at full width (B = 8, S = 1024, single-pass RMNP) ``--runs``
times from one seed with the ``repro_torch`` package under ``--src`` (this
checkout's ``src`` by default), and prints one JSON line: each run's step
times (the differences of the driver's wall clock, each step ending in a
host read of its loss), whether the runs end on the same parameter and
optimizer-state bits, the leaves that differ, and the card's name and power
limit. Pointing ``--src`` at the ``src`` of another checkout (unpacked with
``git archive`` under ``build/``) measures that version of the port in the
same machine, so two versions are compared in one call; each builds its
kernels into its own tree's ``build/kernels``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1] / "src"))
    ap.add_argument("--arch", default="gpt2-small")
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--runs", type=int, default=2)
    ap.add_argument("--label", default="")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch
    if not torch.cuda.is_available():
        print("step_repeat: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.core.types import tree_paths
    from repro_torch.launch.train import train

    def bits(t):
        t = t.detach().cpu()
        return t.view(torch.int16) if t.dtype == torch.bfloat16 else t

    runs, first = [], None
    for _ in range(args.runs):
        params, state, hist = train(args.arch, reduced=False, optimizer="rmnp", fused=True,
                                    fused_apply=True, use_kernel=True, batch=8, seq=1024,
                                    steps=args.steps, log_every=1, seed=0)
        walls = [0.0] + [h["wall_s"] for h in hist]
        host = [(p, bits(t)) for p, t in tree_paths((params, state))]
        diff = [] if first is None else [
            p for (p, a), (_, b) in zip(first, host, strict=True) if not torch.equal(a, b)]
        first = first or host
        runs.append({"losses": [h["loss"] for h in hist],
                     "step_s": [round(b - a, 4) for a, b in zip(walls, walls[1:])],
                     "differing_from_first_run": diff})
        del params, state, host
        torch.cuda.empty_cache()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"label": args.label, "src": args.src, "arch": args.arch, "card": card,
                      "bitwise_repeatable": all(not r["differing_from_first_run"]
                                                for r in runs),
                      "runs": runs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
