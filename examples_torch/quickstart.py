"""Quickstart on the PyTorch port: the paper's algorithm in a page of
``repro_torch``'s public API (the counterpart of ``examples/quickstart.py``).

    PYTHONPATH=src python examples_torch/quickstart.py                # on the card
    PYTHONPATH=src python examples_torch/quickstart.py --device cpu   # on the CPU

Builds a reduced GPT-2 (fp32), trains 50 steps with RMNP (Algorithm 2:
momentum EMA + row-wise l2 normalization instead of Muon's Newton-Schulz),
prints the loss curve and the preconditioner diagonal-dominance ratios that
motivate the substitution. It runs on ``cuda`` unless ``--device cpu`` is
given, and stops with an error where there is no card.
"""
import argparse

import torch

from repro_torch.configs import get_config
from repro_torch.core import cosine_with_warmup, global_dominance, mixed_optimizer
from repro_torch.data.pipeline import make_stream
from repro_torch.launch.train import batch_to_device
from repro_torch.models import init_params
from repro_torch.train.step import make_train_step

STEPS = 50


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    device = ap.parse_args(argv).device
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass --device cpu to run on the CPU")

    cfg = get_config("gpt2-small").reduced()
    opt = mixed_optimizer("rmnp",
                          lr_matrix=cosine_with_warmup(2e-2, STEPS),
                          lr_adamw=cosine_with_warmup(3e-3, STEPS))

    params = init_params(cfg, seed=0, device=device)
    opt_state = opt.init(params)
    step_fn = make_train_step(cfg, opt, remat="none")

    stream = make_stream(cfg, seq_len=64, global_batch=8)
    logged = []
    for step in range(STEPS):
        params, opt_state, metrics = step_fn(params, opt_state,
                                             batch_to_device(next(stream), device), step)
        if step % 10 == 0 or step == STEPS - 1:
            loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
            logged.append((step, loss, gnorm))
            print(f"step {step:3d}  loss {loss:.4f}  grad-norm {gnorm:.3f}")

    dom = {k: float(v) for k, v in global_dominance(opt_state.momentum).items()}
    print(f"\npreconditioner dominance: r_avg={dom['r_avg']:.2f} "
          f"r_min={dom['r_min']:.2f} r_max={dom['r_max']:.2f}  "
          f"(paper Sec 3.2: > 1 justifies row normalization)")
    return {"logged": logged, "dominance": dom}


if __name__ == "__main__":
    main()
