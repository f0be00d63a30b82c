"""Batched greedy serving with the port (counterpart of
``examples/serve_batched.py``): prefill a prompt batch, place the prompt's
KV cache into a zeroed full-length decode cache, then decode one token a
step from the cache.

    # on the CPU, reduced (fp32)
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-4b --device cpu \\
        --batch 2 --prompt-len 8 --tokens 8
    # on the card, full width (bf16)
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-4b --full \\
        --batch 8 --prompt-len 1024 --tokens 128
    # MLA and MoE: deepseek-v2-lite-16b (the flash prefill at q/k 192, v 128)
    PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-v2-lite-16b \\
        --full --attn-impl pallas --batch 8 --prompt-len 1024 --tokens 128
    # the modality frontends: paligemma-3b (256 image embeddings in front of
    # the prompt; the flash prefill at hd 256), musicgen-large (audio frames)
    PYTHONPATH=src python -m repro_torch.launch.serve --arch paligemma-3b --full \\
        --attn-impl pallas --batch 8 --prompt-len 1024 --tokens 128
    PYTHONPATH=src python -m repro_torch.launch.serve --arch musicgen-large --full \\
        --attn-impl pallas --batch 8 --prompt-len 1024 --tokens 128
    # the SSM architectures: xlstm-350m whole, jamba cut to its first group
    PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-350m --full \\
        --batch 8 --prompt-len 1024 --tokens 128
    PYTHONPATH=src python -m repro_torch.launch.serve --arch jamba-v0.1-52b --full \\
        --layers 0:8 --attn-impl pallas --batch 8 --prompt-len 1024 --tokens 128

Weights are random, drawn from ``--seed`` on the device; the prompts are
synthetic tokens (with a frontend model's image embeddings, or audio frames
in their place) drawn from ``--seed + 1``. It runs on ``cuda`` unless
``--device cpu`` is given, and never switches device by itself.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Any, Dict, Optional

import torch

from repro_torch.configs import cut_layers, get_config
from repro_torch.core.types import map_with_path
from repro_torch.models.model import init_cache, init_params
from repro_torch.train.step import make_prefill_step, make_serve_step


def place(dst: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """Write ``src`` into the leading corner of ``dst`` (the prompt's
    positions ``[0, T)`` of a longer cache) and return ``dst``: GQA's 4-D
    k and v, MLA's 3-D latent ``ckv`` and ``k_rope``, with the unit axis in
    front for the stack and without it for a prefix layer."""
    dst[tuple(slice(0, n) for n in src.shape)] = src.to(dst.dtype)
    return dst


def place_cache(full, prompt_cache, cfg, world=None, prompt_len: Optional[int] = None,
                cache_len: Optional[int] = None):
    """The prompt's cache in positions ``[0, T)`` of ``full``. On a
    ``world`` (a ``distributed.comm.WorldComm``) with a model group above
    one, each rank holds its span of both where the rules split ``kv_seq``:
    the prompt cache's spans (of ``prompt_len`` positions) are gathered
    over the group and each rank writes the prompt positions that fall in
    its span of ``full`` (of ``cache_len``). The positions' dimension of
    each leaf is the one its spec names ``kv_seq`` (``cfg``'s
    ``build_cache_specs``): GQA's k and v hold it third from last, MLA's
    latent ``ckv`` and ``k_rope`` second from last."""
    if world is None or world.model.world == 1:
        return map_with_path(lambda _path, dst, src: place(dst, src), full, prompt_cache)
    from repro_torch.distributed.tensor_parallel import ModelAxis
    from repro_torch.models.model import build_cache_specs
    axis = ModelAxis(world.model, world.mesh)
    M, r = axis.size, axis.rank
    first = r * (cache_len // M) if axis.splits("kv_seq", cache_len) else 0
    # the leaves' names, the same at every batch above one (a stacked leaf
    # leads with its units, so the batch is not dim 0 of every leaf; a
    # batch of one names its positions long_seq, which a model group does
    # not split yet: init_cache raises for it)
    specs = build_cache_specs(cfg, 2, cache_len)

    def place_span(_path, spec, dst, src):
        seq = list(spec.axes).index("kv_seq")
        if axis.splits("kv_seq", prompt_len):
            src = world.model.all_gather_dim(src, seq)
        n = max(0, min(prompt_len - first, dst.shape[seq]))
        if n:
            dst.narrow(seq, 0, n).copy_(src.narrow(seq, first, n).to(dst.dtype))
        return dst

    return map_with_path(place_span, specs, full, prompt_cache)


class _Clock:
    """Marks on the device's timeline (CUDA events, read after the run, so
    no mark waits for the card) or on the host's clock for the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks = []

    def mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def intervals_ms(self):
        if self.cuda:
            torch.cuda.synchronize()
            return [a.elapsed_time(b) for a, b in zip(self.marks, self.marks[1:])]
        return [(b - a) * 1e3 for a, b in zip(self.marks, self.marks[1:])]


def prompt_batch(cfg, batch: int, prompt_len: int, seed: int, device) -> Dict[str, Any]:
    """A synthetic prompt batch drawn on ``device`` from ``seed``: tokens (B,
    T); a vision model's ``vision_embeds`` (B, n_frontend_tokens, d_model)
    beside them; an audio model's ``frames`` (B, T, d_model) in their place.
    A frontend array is standard normal x 0.02 in fp32, as the data stream
    draws it."""
    gen = torch.Generator(device=device).manual_seed(seed)
    if cfg.frontend == "audio_frames":
        return {"frames": torch.randn((batch, prompt_len, cfg.d_model), generator=gen,
                                      device=device) * 0.02}
    out = {"tokens": torch.randint(0, cfg.vocab, (batch, prompt_len), generator=gen,
                                   device=device)}
    if cfg.frontend == "vision":
        out["vision_embeds"] = torch.randn((batch, cfg.n_frontend_tokens, cfg.d_model),
                                           generator=gen, device=device) * 0.02
    return out


def generate(cfg, params, prompts, tokens: int, *,
             keep_logits: bool = False, world=None) -> Dict[str, Any]:
    """Greedy generation of ``tokens`` tokens after ``prompts``: token ids
    (B, T), or a prefill batch (``prompt_batch``: tokens and a frontend
    array, or an audio model's frames alone). One prefill (whose last logits
    give the first token) and ``tokens - 1`` decode steps, which embed the
    generated tokens, with S_max = T + tokens. Returns the tokens (B,
    tokens), int32, and the timings: prefill and placement ms, each decode
    step's ms, decode tokens per second and, on a card, the peak device
    memory and the bytes already held when its count began. With
    ``keep_logits`` also the prefill's last logits and each decode step's
    logits (B, padded_vocab). ``world`` (a ``distributed.comm.WorldComm``):
    ``params`` are the rank's shards and the steps run on its model axis
    (``train/step.py``), the rank's prompt rows given."""
    batch = prompts if isinstance(prompts, dict) else {"tokens": prompts}
    lead = batch["tokens"] if "tokens" in batch else batch["frames"]
    device = lead.device
    B, T = lead.shape[:2]
    prefill = make_prefill_step(cfg, world)
    decode = make_serve_step(cfg, world, cache_len=T + tokens)
    clock = _Clock(device)
    held = None
    if clock.cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    clock.mark()
    last, prompt_cache = prefill(params, batch)
    tok = torch.argmax(last[:, :cfg.vocab], dim=-1).to(torch.int32)[:, None]
    clock.mark()
    cache = place_cache(init_cache(cfg, B, T + tokens, device=device,
                                   world=None if world is None else world.mesh),
                        prompt_cache, cfg, world, T, T + tokens)
    del prompt_cache
    clock.mark()
    out, logits = [tok], [last] if keep_logits else None
    for i in range(tokens - 1):
        tok, step_logits, cache = decode(params, cache, tok, T + i)
        out.append(tok)
        if keep_logits:
            logits.append(step_logits[:, 0])
        clock.mark()
    seqs = torch.cat(out, dim=1)
    ms = clock.intervals_ms()
    wall = time.perf_counter() - t0
    steps = ms[2:]
    decode_s = sum(steps) / 1e3
    res = {
        "config": cfg.name, "device": str(device), "batch": B, "prompt_len": T,
        "new_tokens": tokens, "tokens": seqs, "prefill_ms": ms[0], "place_ms": ms[1],
        "decode_ms": steps,
        "decode_tokens_per_s": B * len(steps) / decode_s if steps else None,
        "tokens_per_s": B * tokens / wall, "wall_s": wall,
        "peak_bytes": torch.cuda.max_memory_allocated() if clock.cuda else None,
        "held_bytes": held,
    }
    if keep_logits:
        res["logits"] = logits
    return res


def serve(arch: str, *, full: bool = False, batch: int = 4, prompt_len: int = 16,
          tokens: int = 32, seed: int = 0, device: str = "cuda",
          attn_impl: Optional[str] = None, params=None, prompts=None,
          keep_logits: bool = False, layers: str = "") -> Dict[str, Any]:
    """Serve ``arch`` (its full config with ``full``, else ``.reduced()``;
    ``layers`` "START:STOP" keeps only those layers, ``configs.cut_layers``):
    random weights from ``seed`` and synthetic prompts (``prompt_batch``,
    with a frontend model's array) from ``seed + 1``, both drawn on
    ``device``, unless ``params`` or ``prompts`` are given. ``attn_impl``
    overrides the config's attention for the prefill. Returns
    ``generate``'s result."""
    cfg = get_config(arch)
    if not full:
        cfg = cfg.reduced()
    if layers:
        cfg = cut_layers(cfg, layers)
    if attn_impl is not None:
        cfg = dataclasses.replace(cfg, attn_impl=attn_impl)
    dev = torch.device(device)
    if params is None:
        params = init_params(cfg, seed=seed, device=dev)
    if prompts is None:
        prompts = prompt_batch(cfg, batch, prompt_len, seed + 1, dev)
    elif isinstance(prompts, dict):
        prompts = {k: v.to(dev) for k, v in prompts.items()}
    else:
        prompts = prompts.to(dev)
    return generate(cfg, params, prompts, tokens, keep_logits=keep_logits)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--full", action="store_true", help="full-size config")
    ap.add_argument("--layers", default="",
                    help="START:STOP, keep only these layers of the pattern "
                         "(a depth cut; every width is kept)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu; never chosen for you")
    ap.add_argument("--attn-impl", default=None,
                    choices=["auto", "dense", "chunked", "pallas"],
                    help="the prefill's attention (default: the config's)")
    args = ap.parse_args(argv)
    res = serve(args.arch, full=args.full, batch=args.batch, prompt_len=args.prompt_len,
                tokens=args.tokens, seed=args.seed, device=args.device,
                attn_impl=args.attn_impl, layers=args.layers)
    seqs = res.pop("tokens").cpu()
    steps = sorted(res["decode_ms"])
    med = steps[len(steps) // 2] if steps else float("nan")
    print(f"prefill {res['prefill_ms']:.2f} ms; decode {med:.3f} ms a step (median of "
          f"{len(steps)}); {res['decode_tokens_per_s'] or 0:.1f} decode tok/s; "
          f"{args.batch}x{args.tokens} tokens in {res['wall_s']:.2f}s on {res['device']}")
    for b in range(seqs.shape[0]):
        print(f"  seq[{b}]: {seqs[b][:16].tolist()} ...")
    print(json.dumps(res))


if __name__ == "__main__":
    main()
