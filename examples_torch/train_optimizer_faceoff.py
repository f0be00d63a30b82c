"""End-to-end driver on the PyTorch port: train the same model with every
optimizer in the constructor registry (AdamW, Muon, NorMuon, Muown, Nora,
RMNP) and compare loss curves at equal steps AND equal wall-clock (the
paper's core experiment, extended to the whole update-rule family; the
counterpart of ``examples/train_optimizer_faceoff.py``).

    PYTHONPATH=src python examples_torch/train_optimizer_faceoff.py \\
        [--arch gpt2-small] [--steps 300] [--full] [--only muon rmnp] [--device cpu]

Uses the port's training stack: config -> deterministic synthetic stream ->
registry-built mixed optimizer on the bucketed engine -> train step, through
``repro_torch.launch.train.train``. It runs on ``cuda`` unless ``--device
cpu`` is given, and stops with an error where there is no card.
"""
import argparse

import torch

from repro_torch.core import optimizer_names
from repro_torch.launch.train import train

# Per-family tuned matrix LR (lr_sweep protocol: each optimizer gets its
# own); the NS family shares Muon's, the row-norm family shares RMNP's.
# FACEOFF_LRS and loss_at_wall are copies of benchmarks/faceoff.py:44-58,
# kept here because the port imports nothing from benchmarks/.
FACEOFF_LRS = {
    "adamw": (1e-3, 1e-3),
    "muon": (2e-2, 3e-3),
    "normuon": (2e-2, 3e-3),
    "muown": (2e-2, 3e-3),
    "rmnp": (2e-2, 3e-3),
    "nora": (2e-2, 3e-3),
}


def loss_at_wall(history, budget_s: float) -> float:
    """Loss of the last logged row inside the wall-clock budget."""
    rows = [h for h in history if h["wall_s"] <= budget_s]
    return (rows[-1] if rows else history[0])["loss"]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gpt2-small")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--only", nargs="*", default=None,
                    choices=list(optimizer_names()),
                    help="subset of registered optimizers to race")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass --device cpu to run on the CPU")

    results = {}
    for opt in (args.only or optimizer_names()):
        lrm, lra = FACEOFF_LRS.get(opt, (2e-2, 3e-3))
        print(f"\n=== {opt} ===")
        _, _, hist = train(args.arch, optimizer=opt, steps=args.steps,
                           batch=args.batch, seq=args.seq,
                           lr_matrix=lrm, lr_adamw=lra,
                           reduced=not args.full, fused=True,
                           log_every=max(1, args.steps // 10), device=args.device)
        results[opt] = {"final": hist[-1]["loss"], "history": hist,
                        "wall_s": hist[-1]["wall_s"]}

    budget = min(r["wall_s"] for r in results.values())
    print(f"\n=== summary (equal-wall budget {budget:.1f}s) ===")
    for opt, r in results.items():
        r["at_budget"] = loss_at_wall(r["history"], budget)
        print(f"{opt:8s} final-loss {r['final']:.4f}  "
              f"loss@{budget:.0f}s {r['at_budget']:.4f}  wall {r['wall_s']:.1f}s")
    best = min(results, key=lambda k: results[k]["final"])
    print(f"\nbest final loss: {best} "
          f"(paper: RMNP matches or beats Muon, both beat AdamW)")
    return results


if __name__ == "__main__":
    main()
