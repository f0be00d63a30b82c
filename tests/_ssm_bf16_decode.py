"""Decode against a teacher-forced forward, in each package, in bf16 and
fp32: how far an SSM model's greedy decode steps drift from the forward
over the same tokens when every product rounds to bf16.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/_ssm_bf16_decode.py [--full]

For each package (the JAX reference and the port, both on the CPU) and
type: prefill T prompt tokens, decode F greedy tokens from the prefill's
cache, and compare the decode steps' logits with those of one forward over
the prompt and the first F generated tokens, by their relative Frobenius
distance over the real vocabulary (per step and over all F). Random weights
from seed 0 in each package's own generator, prompts from seed 1. The
default is reduced xlstm-350m (B=2, T=32, F=8), where the two agree to the
bit in bf16; ``--full`` runs it at full width (B=2, T=128, F=16; about 20 s
each), where the GEMMs of one token and of the whole sequence round
differently. It is a measurement, not a test: pytest does not collect it.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def _rel(got, want, vocab):
    got, want = np.asarray(got, np.float64)[..., :vocab], np.asarray(want, np.float64)[..., :vocab]
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def drift(pkg: str, arch: str, dtype: str, full: bool, B: int, T: int, F: int):
    """(over all F steps, per step) relative distance of ``pkg``'s decode
    logits from its own forced forward."""
    if pkg == "jax":
        import jax
        import jax.numpy as jnp
        from repro.configs import get_config
        from repro.models import init_params
        from repro.models.model import forward, init_cache
        from repro.train.step import make_prefill_step, make_serve_step
        cfg = get_config(arch)
        cfg = dataclasses.replace(cfg if full else cfg.reduced(), dtype=dtype)
        params = init_params(cfg, jax.random.PRNGKey(0))
        prompts = jax.random.randint(jax.random.PRNGKey(1), (B, T), 0, cfg.vocab)
        last, pc = jax.jit(make_prefill_step(cfg))(params, {"tokens": prompts})
        cache = jax.tree_util.tree_map(
            lambda d, s: d.at[tuple(slice(0, n) for n in s.shape)].set(s.astype(d.dtype)),
            init_cache(cfg, B, T + F + 1), pc)
        decode = jax.jit(make_serve_step(cfg))
        tok = jnp.argmax(last[:, :cfg.vocab], -1).astype(jnp.int32)[:, None]
        toks, got = [tok], []
        for i in range(F):
            tok, lg, cache = decode(params, cache, tok, jnp.int32(T + i))
            toks.append(tok)
            got.append(np.asarray(lg[:, 0].astype(jnp.float32)))
        forced = jnp.concatenate([prompts] + toks[:F], axis=1)
        want = jax.jit(lambda p, b: forward(cfg, p, b, "train")[0])(params, {"tokens": forced})
        want = np.asarray(want[:, T:T + F].astype(jnp.float32))
    else:
        import torch
        from repro_torch.configs import get_config
        from repro_torch.launch.serve import generate
        from repro_torch.models import init_params
        from repro_torch.models.model import forward, lm_head
        cfg = get_config(arch)
        cfg = dataclasses.replace(cfg if full else cfg.reduced(), dtype=dtype)
        params = init_params(cfg, seed=0, device="cpu")
        prompts = torch.randint(0, cfg.vocab, (B, T), generator=torch.Generator().manual_seed(1))
        res = generate(cfg, params, prompts, F + 1, keep_logits=True)
        got = [lg.float().numpy() for lg in res["logits"][1:F + 1]]
        forced = torch.cat([prompts, res["tokens"][:, :F].long()], dim=1)
        with torch.no_grad():
            hidden = forward(cfg, params, {"tokens": forced}, "train", return_hidden=True)[0]
            want = (hidden[:, T:T + F] @ lm_head(cfg, params)).float().numpy()
    got = np.stack(got, axis=1)
    return (_rel(got, want, cfg.vocab),
            [_rel(got[:, i], want[:, i], cfg.vocab) for i in range(F)])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="xlstm-350m")
    ap.add_argument("--full", action="store_true")
    args = ap.parse_args()
    B, T, F = (2, 128, 16) if args.full else (2, 32, 8)
    for pkg in ("jax", "torch"):
        for dtype in ("bfloat16", "float32"):
            total, per_step = drift(pkg, args.arch, dtype, args.full, B, T, F)
            print(json.dumps({"package": pkg, "arch": args.arch, "full": args.full,
                              "dtype": dtype, "B": B, "T": T, "F": F, "rel": total,
                              "per_step": per_step}), flush=True)


if __name__ == "__main__":
    main()
