"""Batched serving on the PyTorch port: prefill a prompt batch, then
autoregressive greedy decode from the KV/SSM cache (the counterpart of
``examples/serve_batched.py``).

    PYTHONPATH=src python examples_torch/serve_batched.py [--arch qwen3-4b] [--tokens 32]
    PYTHONPATH=src python examples_torch/serve_batched.py --device cpu

Every architecture of the config registry is served reduced (fp32): GQA,
MLA's latent cache, the SSM states. Weights come from seed 0, the prompts
(tokens) from seed 1, both drawn on the device. It runs on ``cuda`` unless
``--device cpu`` is given, and stops with an error where there is no card.
"""
import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.launch.serve import place_cache
from repro_torch.models import init_params
from repro_torch.models.model import init_cache
from repro_torch.train.step import make_prefill_step, make_serve_step


def prompt_tokens(cfg, batch, prompt_len, device):
    """A synthetic prompt batch (B, T), uniform over the vocabulary, from seed 1."""
    gen = torch.Generator(device=device).manual_seed(1)
    return torch.randint(0, cfg.vocab, (batch, prompt_len), generator=gen, device=device)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = args.device
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass --device cpu to run on the CPU")

    cfg = get_config(args.arch).reduced()
    params = init_params(cfg, seed=0, device=device)
    B, T, S_max = args.batch, args.prompt_len, args.prompt_len + args.tokens

    prefill = make_prefill_step(cfg)
    decode = make_serve_step(cfg)

    prompts = prompt_tokens(cfg, B, T, device)
    logits, pc = prefill(params, {"tokens": prompts})

    # place the prompt cache into a full-length decode cache
    cache = place_cache(init_cache(cfg, B, S_max, device=device), pc, cfg)
    del pc
    tok = torch.argmax(logits[:, :cfg.vocab], dim=-1).to(torch.int32)[:, None]

    out = [tok]
    _sync(device)
    t0 = time.time()
    for i in range(args.tokens - 1):
        tok, _, cache = decode(params, cache, tok, T + i)
        out.append(tok)
    seqs = torch.cat(out, dim=1)
    _sync(device)
    dt = time.time() - t0
    where = (torch.cuda.get_device_name(device) if torch.device(device).type == "cuda"
             else "cpu")
    print(f"decoded {B}x{args.tokens} tokens in {dt:.2f}s "
          f"({B * args.tokens / dt:.1f} tok/s on {where})")
    seqs = seqs.cpu()
    for b in range(B):
        print(f"  seq[{b}]: {seqs[b][:16].tolist()} ...")
    return {"tokens": seqs, "seconds": dt, "device": where}


if __name__ == "__main__":
    main()
