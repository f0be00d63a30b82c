"""Fault-tolerance demo on the PyTorch port: kill training mid-run, restart,
and verify the resumed run matches an uninterrupted one (the counterpart of
``examples/fault_tolerant_restart.py``).

    PYTHONPATH=src python examples_torch/fault_tolerant_restart.py               # act 1 on the card
    PYTHONPATH=src python examples_torch/fault_tolerant_restart.py --device cpu
    PYTHONPATH=src python examples_torch/fault_tolerant_restart.py --act 1       # one act only

Act 1 — same-device restart, on ``--device`` (``cuda`` unless ``--device
cpu`` is given; no card is an error): a simulated crash (clean exit, no
final checkpoint) followed by a resume on the same device. Exercises the
checkpoint manager's atomic-commit protocol and the deterministic data
stream's (seed, host, step) addressing — together these make
restart-after-failure bitwise exact.

Act 2 — elastic restart, always on the CPU: an 8-rank ZeRO-2 run under
``torchrun`` (``python -m torch.distributed.run``, gloo) is SIGKILLed
mid-loop (real fault injection: no cleanup, the in-flight async save may be
torn) and resumed on FOUR ranks. The checkpoint's layout manifest flags the
group-size mismatch and the bucketed optimizer state reshards automatically
(``repro_torch.distributed.elastic``), so the resumed run continues as if it
had always been 4-way. The final params are compared against an
uninterrupted 4-rank run: allclose, not bitwise — the gradient sums over 8
and over 4 ranks associate differently. Act 2 is CPU by design, not as a
fallback: NCCL puts no two ranks on one card, and a machine with one card
has one rank to give, as the JAX example runs its meshes on CPU devices.
"""
import argparse
import os
import shutil
import signal
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from repro_torch.core.types import tree_paths
from repro_torch.launch.train import train

STEPS, CKPT_EVERY = 60, 20
ARCH = "llama-60m"
SRC = Path(__file__).resolve().parents[1] / "src"


def act1_same_device(device="cuda"):
    tmp = tempfile.mkdtemp(prefix="rmnp_ckpt_")
    try:
        print(f"=== act 1: uninterrupted run (on {device}) ===")
        p_ref, _, h_ref = train(ARCH, steps=STEPS, batch=4, seq=32,
                                log_every=10, seed=3, device=device)

        print("\n=== act 1: interrupted run (simulated failure at step 40) ===")
        train(ARCH, steps=STEPS, stop_at=40, batch=4, seq=32, log_every=10,
              seed=3, ckpt_dir=tmp, ckpt_every=CKPT_EVERY, device=device)

        print("\n=== act 1: restart from the last committed checkpoint ===")
        p_res, _, h_res = train(ARCH, steps=STEPS, batch=4, seq=32,
                                log_every=10, seed=3,
                                ckpt_dir=tmp, ckpt_every=CKPT_EVERY, device=device)

        res = dict(tree_paths(p_res))
        assert sorted(res) == sorted(p for p, _ in tree_paths(p_ref))
        worst = max(float((a.float() - res[p].float()).abs().max())
                    for p, a in tree_paths(p_ref))
        print(f"\nmax |param diff| interrupted-vs-uninterrupted: {worst:.3e}")
        print("restart is exact" if worst == 0.0 else
              "restart drift detected (investigate!)")
        assert worst == 0.0
        return {"worst": worst, "history": h_ref, "history_resumed": h_res}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _train_proc(n_ranks, extra):
    env = dict(os.environ,
               PYTHONPATH=os.pathsep.join(
                   [str(SRC), os.environ.get("PYTHONPATH", "")]
               ).rstrip(os.pathsep))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc_per_node={n_ranks}", "-m", "repro_torch.launch.train",
           "--arch", ARCH, "--device", "cpu",
           "--steps", "30", "--batch", "8", "--seq", "32", "--seed", "3",
           "--zero2", "--no-compress", "--log-every", "10"] + extra
    return subprocess.run(cmd, env=env, capture_output=True, text=True,
                          timeout=900)


def act2_elastic():
    tmp = tempfile.mkdtemp(prefix="rmnp_elastic_demo_")
    try:
        ckpt, ref_ckpt = f"{tmp}/ckpt", f"{tmp}/ref"
        dump_res, dump_ref = f"{tmp}/resumed.npz", f"{tmp}/ref.npz"

        print("\n=== act 2 (CPU, gloo): 8-rank ZeRO-2 run under torchrun, "
              "SIGKILLed at step 25 ===")
        r = _train_proc(8, ["--ckpt-dir", ckpt, "--ckpt-every", "10",
                            "--kill-at", "25"])
        # torchrun reports a rank that died of a signal and exits non-zero
        killed = f"Signal {int(signal.SIGKILL)} (SIGKILL)"
        assert r.returncode != 0 and killed in r.stderr, (r.returncode, r.stderr[-4000:])
        print(r.stdout.rstrip())
        print(f"(the ranks died with SIGKILL as injected; torchrun rc={r.returncode})")

        print("\n=== act 2: resume on FOUR ranks (elastic reshard) ===")
        r = _train_proc(4, ["--ckpt-dir", ckpt, "--ckpt-every", "10",
                            "--dump-params", dump_res])
        assert r.returncode == 0, (r.stdout, r.stderr[-4000:])
        print(r.stdout.rstrip())
        assert "elastic reshard 8-way -> 4-way" in r.stdout, r.stdout

        print("\n=== act 2: uninterrupted 4-rank reference ===")
        r = _train_proc(4, ["--ckpt-dir", ref_ckpt, "--ckpt-every", "10",
                            "--dump-params", dump_ref])
        assert r.returncode == 0, (r.stdout, r.stderr[-4000:])

        with np.load(dump_res) as a, np.load(dump_ref) as b:
            assert set(a.files) == set(b.files)
            worst = max(float(np.max(np.abs(a[k] - b[k])))
                        for k in a.files)
        print(f"\nmax |param diff| 8->4 resumed vs uninterrupted 4-rank: "
              f"{worst:.3e}")
        print("elastic restart tracks the uninterrupted run"
              if worst < 2e-3 else "elastic drift detected (investigate!)")
        assert worst < 2e-3
        return {"worst": worst}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="act 1's device: cuda (the default) or cpu; act 2 is CPU")
    ap.add_argument("--act", type=int, choices=(1, 2), default=None,
                    help="run one act only (default: both)")
    args = ap.parse_args(argv)
    out = {}
    if args.act in (None, 1):
        if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device; pass --device cpu to run act 1 on the CPU")
        out["act1"] = act1_same_device(args.device)
    if args.act in (None, 2):
        out["act2"] = act2_elastic()
    return out


if __name__ == "__main__":
    main()
