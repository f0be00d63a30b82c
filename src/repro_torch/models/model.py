"""Model assembly of the port (mirror of ``repro.models.model``): GQA, MLA
and the SSM mixers (mamba, mLSTM, sLSTM), dense and MoE FFNs, and the
modality frontend stubs (audio frames, vision embeddings) at the input.

A config's per-layer ``pattern`` is decomposed as prefix + unit * n_units
(deepseek-v2-lite: one dense-FFN prefix layer and 26 MoE units; jamba: a
unit of 8 layers, 4 times; xlstm: an mLSTM-sLSTM unit, 12 times); the unit's
parameters are stacked ``(n_units, ...)`` exactly as in the JAX package, so
tree paths, leaf shapes and optimizer buckets match, and so is the decode
cache (GQA: ``stack/layer_j/{k,v}`` of shape ``(n_units, B, S, K, hd)``;
MLA: ``stack/layer_j/{ckv,k_rope}`` of shape ``(n_units, B, S, r)``; the
SSM mixers: their fixed-size states, ``ssm.*_cache_specs``). The
forward walks the stack with a Python loop over ``torch.unbind`` slices and
sums the MoE layers' auxiliary losses in layer order.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.types import map_with_path, tree_paths
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import ssm as SSM

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


# ---------------------------------------------------------------------------
# Stack planning
# ---------------------------------------------------------------------------

def plan_stack(pattern) -> Tuple[int, int, int]:
    """Return (prefix_len, unit_len, n_units) with pattern == prefix + unit*n."""
    n = len(pattern)
    best = (n, 1, 0)  # fully-unrolled fallback: all layers in the prefix
    best_p = n + 1
    for q in range(0, min(3, n)):
        rest = pattern[q:]
        for p in range(1, len(rest) + 1):
            if len(rest) % p == 0 and rest == tuple(rest[:p]) * (len(rest) // p):
                if p < best_p:
                    best, best_p = (q, p, len(rest) // p), p
                break
    return best


MIXERS = {
    "gqa": (L.gqa_specs, L.gqa_apply, L.gqa_cache_specs),
    "mla": (L.mla_specs, L.mla_apply, L.mla_cache_specs),
    "mamba": (SSM.mamba_specs, SSM.mamba_apply, SSM.mamba_cache_specs),
    "mlstm": (SSM.mlstm_specs, SSM.mlstm_apply, SSM.mlstm_cache_specs),
    "slstm": (SSM.slstm_specs, SSM.slstm_apply, SSM.slstm_cache_specs),
}


def _mixer(mixer: str):
    if mixer not in MIXERS:  # a KeyError, as the JAX package's lookup raises
        raise KeyError(f"unknown mixer {mixer!r}; known: {', '.join(MIXERS)}")
    return MIXERS[mixer]


def _layer_specs(cfg: ModelConfig, mixer: str, ffn: str) -> Dict[str, Any]:
    if ffn not in ("dense", "moe", "none"):
        raise ValueError(f"unknown FFN kind {ffn!r}")
    specs = {"mixer": _mixer(mixer)[0](cfg)}
    if ffn == "dense":
        specs["ffn"] = L.ffn_specs(cfg)
    elif ffn == "moe":
        specs["ffn"] = M.moe_specs(cfg)
    return specs


def _cache_specs(cfg: ModelConfig, mixer: str, batch: int, seq: int):
    return _mixer(mixer)[2](cfg, batch, seq)


def _stack_specs(specs, n_units: int):
    if isinstance(specs, dict):
        return {k: _stack_specs(v, n_units) for k, v in specs.items()}
    return L.ParamSpec((n_units,) + specs.shape, ("layers",) + tuple(specs.axes),
                       specs.init, specs.scale, specs.dtype)


def build_param_specs(cfg: ModelConfig) -> Dict[str, Any]:
    d, V = cfg.d_model, cfg.padded_vocab
    q, p, n = plan_stack(cfg.pattern)
    specs: Dict[str, Any] = {
        "embed": {"tokens": L.ParamSpec((V, d), ("vocab", "embed"), "normal", 0.02)},
        "final_norm": L.ParamSpec((d,), ("embed",), "ones"),
    }
    for i in range(q):
        mixer, ffn = cfg.pattern[i]
        specs[f"prefix_{i}"] = _layer_specs(cfg, mixer, ffn)
    if n:
        unit = {}
        for j in range(p):
            mixer, ffn = cfg.pattern[q + j]
            unit[f"layer_{j}"] = _layer_specs(cfg, mixer, ffn)
        specs["stack"] = _stack_specs(unit, n)
    if not cfg.tie_embeddings:
        specs["lm_head"] = L.ParamSpec((d, V), ("d_in", "vocab"), "fan_in")
    return specs


def build_cache_specs(cfg: ModelConfig, batch: int, seq: int) -> Dict[str, Any]:
    q, p, n = plan_stack(cfg.pattern)
    specs: Dict[str, Any] = {}
    for i in range(q):
        mixer, _ = cfg.pattern[i]
        specs[f"prefix_{i}"] = _cache_specs(cfg, mixer, batch, seq)
    if n:
        unit = {f"layer_{j}": _cache_specs(cfg, cfg.pattern[q + j][0], batch, seq)
                for j in range(p)}
        specs["stack"] = _stack_specs(unit, n)
    return specs


def init_cache(cfg: ModelConfig, batch: int, seq: int, device="cuda",
               world=None) -> Dict[str, Any]:
    """A zeroed decode cache of ``seq`` positions, in the model's type. With
    ``world`` (a ``launch/mesh.World``) a model rank's shard of it (its
    span of the positions where the rules split ``kv_seq``); ``batch`` is
    the rank's rows."""
    from repro_torch.distributed.sharding import local_shape

    def shape(sp):
        return sp.shape if world is None else local_shape(sp.shape, sp.axes, world)
    return map_with_path(
        lambda _path, sp: torch.zeros(shape(sp), dtype=torch_dtype(sp.dtype or cfg.dtype),
                                      device=device),
        build_cache_specs(cfg, batch, seq))


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda", world=None,
                model_rank: int = 0) -> Dict[str, Any]:
    """Random parameters from ``seed``, drawn leaf by leaf in tree order from
    one ``torch.Generator`` on ``device``. With ``world`` (a
    ``launch/mesh.World``) the whole model is drawn so, then cut to model
    rank ``model_rank``'s shards (``interop.shard_params``): M ranks hold
    the model one rank does."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    dtype = torch_dtype(cfg.dtype)
    specs = build_param_specs(cfg)
    flat = {path: L.materialize(spec, gen, dtype, device)
            for path, spec in _spec_paths(specs)}
    params = map_with_path(lambda path, _spec: flat[path], specs)
    if world is None:
        return params
    from repro_torch.interop import shard_params
    return shard_params(params, cfg, world, model_rank, device)


def _spec_paths(specs, prefix=()):
    for k in sorted(specs):
        v = specs[k]
        if isinstance(v, dict):
            yield from _spec_paths(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), v


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _apply_layer(cfg, mixer, ffn, p, x, positions, mode, cache=None, pos=None):
    """One layer: (x, new_cache, aux), aux the MoE FFN's auxiliary loss
    (None for other FFNs)."""
    out, new_cache = _mixer(mixer)[1](cfg, p["mixer"], x, positions, mode, cache, pos)
    x = x + out
    aux = None
    if ffn == "dense":
        x = x + L.ffn_apply(cfg, p["ffn"], x)
    elif ffn == "moe":
        y, aux = M.moe_apply(cfg, p["ffn"], x)
        x = x + y
    return x, new_cache, aux


def lm_head(cfg: ModelConfig, params) -> torch.Tensor:
    """The (d, padded_vocab) output projection: the embedding's transpose
    when tied."""
    return params["embed"]["tokens"].T if cfg.tie_embeddings else params["lm_head"]


def _vocab_split(cfg: ModelConfig):
    """The model axis where the rules split the vocabulary over it, else
    None."""
    axis = tp.current()
    return axis if axis is not None and axis.splits("vocab", cfg.padded_vocab) else None


def embed_tokens(cfg: ModelConfig, params, tokens: torch.Tensor) -> torch.Tensor:
    """The token embeddings: a lookup, vocabulary-parallel where the model
    axis splits the table's rows."""
    axis = _vocab_split(cfg)
    if axis is None:
        return params["embed"]["tokens"][tokens.long()]
    return tp.vocab_parallel_embed(params["embed"]["tokens"], tokens, axis)


def head_logits(cfg: ModelConfig, params, x: torch.Tensor) -> torch.Tensor:
    """``x @ lm_head``, the whole (..., padded_vocab) logits on every rank:
    where the model axis splits the vocabulary, each rank's columns
    gathered."""
    axis = _vocab_split(cfg)
    if axis is None:
        return x @ lm_head(cfg, params)
    local = tp.copy_to_model(x, axis) @ lm_head(cfg, params)
    return tp.gather_from_model(local, axis, -1, "slice")


def forward(cfg: ModelConfig, params, batch: Dict[str, torch.Tensor],
            mode: str = "train", cache=None, pos=None, remat: str = "full",
            return_hidden: bool = False):
    """mode: train | prefill | decode. Returns (logits, new_cache, aux); with
    ``return_hidden`` the first element is the final-norm hidden state.

    prefill returns the prompt's cache, stacked as ``build_cache_specs``
    lays it out for S = the prompt's length. decode takes one token a row
    (``batch["tokens"]`` of shape (B, 1)) at position ``pos`` (an int) and a
    cache of ``init_cache``'s layout, writes each layer's k and v (MLA: its
    latent and RoPE key) into it at ``pos`` in place (an SSM layer: its new
    state) and returns it: the cache passed in is consumed, as
    the JAX package's decode step consumes its donated cache. train and
    prefill ignore ``cache``. ``remat="full"`` keeps only each unit's input
    and recomputes the unit in the backward (``torch.utils.checkpoint``),
    which changes no number.

    The frontend stubs, outside decode (which always embeds ``tokens``): an
    ``audio_frames`` model given ``batch["frames"]`` (B, S, d_model) takes
    them, cast to the config's type, as its input embeddings and needs no
    ``tokens``; a ``vision`` model given ``batch["vision_embeds"]`` (B, nf,
    d_model) puts them in place of the first nf token embeddings. Attention
    stays causal over the image prefix, as in the JAX package."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"unknown forward mode {mode!r}")
    if mode == "decode" and cache is None:
        raise ValueError("decode needs a cache (init_cache, filled by prefill)")
    q, p, n = plan_stack(cfg.pattern)
    if cfg.frontend == "audio_frames" and mode != "decode" and "frames" in batch:
        x = batch["frames"].to(torch_dtype(cfg.dtype))
    else:
        x = embed_tokens(cfg, params, batch["tokens"])
        if cfg.frontend == "vision" and mode != "decode" and "vision_embeds" in batch:
            nf = batch["vision_embeds"].shape[1]
            x = torch.cat([batch["vision_embeds"].to(x.dtype), x[:, nf:]], dim=1)
    B, S = x.shape[:2]
    if mode == "decode":
        positions = torch.full((B, S), int(pos), dtype=torch.int32, device=x.device)
    else:
        positions = batch.get("positions")
        if positions is None:
            positions = torch.arange(S, dtype=torch.int32, device=x.device).expand(B, S)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    new_cache: Dict[str, Any] = {}

    for i in range(q):
        mixer, ffn = cfg.pattern[i]
        c = cache.get(f"prefix_{i}") if mode == "decode" else None
        x, nc, a = _apply_layer(cfg, mixer, ffn, params[f"prefix_{i}"], x, positions,
                                mode, c, pos)
        if a is not None:
            aux = aux + a
        if nc is not None:
            new_cache[f"prefix_{i}"] = nc

    if n:
        unit_kinds = [cfg.pattern[q + j] for j in range(p)]
        stacked = tree_paths(params["stack"])
        slices = {path: torch.unbind(t, 0) for path, t in stacked}
        stack_cache = cache["stack"] if mode == "decode" else None

        def apply_unit(x_in, aux_in, u):
            unit = map_with_path(lambda path, _t: slices[path][u], params["stack"])
            # unit u's cache slices are views: a write lands in the stack
            unit_cache = (map_with_path(lambda _path, t: t[u], stack_cache)
                          if stack_cache is not None else None)
            ncs = {}
            for j, (mixer, ffn) in enumerate(unit_kinds):
                cj = unit_cache[f"layer_{j}"] if unit_cache is not None else None
                x_in, nc, a = _apply_layer(cfg, mixer, ffn, unit[f"layer_{j}"], x_in,
                                           positions, mode, cj, pos)
                if a is not None:
                    aux_in = aux_in + a
                if nc is not None:
                    ncs[f"layer_{j}"] = nc
            return x_in, aux_in, ncs

        for u in range(n):
            if mode == "train" and remat == "full" and torch.is_grad_enabled():
                # the unit's aux loss leaves the checkpoint with its output
                x, aux = checkpoint(lambda x_in, a_in, u: apply_unit(x_in, a_in, u)[:2],
                                    x, aux, u, use_reentrant=False)
                continue
            x, aux, ncs = apply_unit(x, aux, u)
            if mode == "prefill":
                # each unit's prompt cache goes into its slot of one stacked
                # tensor per leaf, allocated at the first unit
                if u == 0:
                    stack_cache = map_with_path(
                        lambda _path, t: t.new_empty((n,) + tuple(t.shape)), ncs)
                map_with_path(lambda _path, dst, src: dst[u].copy_(src),
                              stack_cache, ncs)
        if stack_cache is not None:
            new_cache["stack"] = stack_cache

    x = L.rms_norm(x, params["final_norm"], cfg.rms_eps)
    out_cache = new_cache if new_cache else None
    if return_hidden:
        return x, out_cache, aux
    return head_logits(cfg, params, x), out_cache, aux


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------

_LOSS_CHUNK = 1024


def _ce_terms(logits, labels, mask):
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    return torch.sum((logz - gold) * mask)


def loss_fn(cfg: ModelConfig, params, batch, remat: str = "full"):
    """Cross-entropy with the LM head applied in sequence chunks when S is a
    multiple of the chunk above one chunk (each chunk recomputed in the
    backward), so the full (B, S, V) fp32 logits never exist there."""
    hidden, _, aux = forward(cfg, params, batch, "train", remat=remat,
                             return_hidden=True)
    head = lm_head(cfg, params)
    labels = batch["labels"].long()
    mask = (labels >= 0).float()
    labels_c = torch.clamp(labels, min=0)
    B, S, _ = hidden.shape
    axis = _vocab_split(cfg)
    if axis is None:
        def terms(h, lab, m):
            return _ce_terms(h @ head, lab, m)
    elif axis.size == 1:   # the gathered logits of one rank: _ce_terms unchanged
        def terms(h, lab, m):
            return _ce_terms(head_logits(cfg, params, h), lab, m)
    else:
        def terms(h, lab, m):
            return tp.vocab_parallel_ce(tp.copy_to_model(h, axis) @ head, lab, m, axis)

    if S % _LOSS_CHUNK == 0 and S > _LOSS_CHUNK:
        nll_sum = torch.zeros((), dtype=torch.float32, device=hidden.device)
        for c in range(S // _LOSS_CHUNK):
            sl = slice(c * _LOSS_CHUNK, (c + 1) * _LOSS_CHUNK)
            nll_sum = nll_sum + checkpoint(terms, hidden[:, sl], labels_c[:, sl],
                                           mask[:, sl], use_reentrant=False)
    else:
        nll_sum = terms(hidden, labels_c, mask)

    denom = torch.clamp(torch.sum(mask), min=1.0)
    nll = nll_sum / denom
    loss = nll + aux
    return loss, {"loss": loss, "nll": nll, "aux": aux, "ntokens": denom}
