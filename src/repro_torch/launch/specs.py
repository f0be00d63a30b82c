"""Stand-ins for every input of a step that take no device memory
(counterpart of ``repro.launch.specs``): meta tensors of the parameter
tree, the optimizer state, the batch and the decode cache, in the order of
the step's signature.

The JAX package returns ``ShapeDtypeStruct``s and, beside them, a
``NamedSharding`` per leaf over a device mesh. The card is one device, so
there are no shardings here. ``world > 1`` stands for one rank of a ZeRO-2
group instead: the state is the fused optimizer's with every stacked bucket
and slot stripe cut to the rank's ``padded L / world`` rows, as
``distributed/sharding.py`` cuts it, the error-feedback residual of the
int8 wire beside it, and the batch is the global one that
``train/dp_step.py`` splits by rank.
"""
from __future__ import annotations

import types
from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.mixed import MixedState, is_matrix_param
from repro_torch.core.types import map_with_path, tree_map
from repro_torch.models.model import build_cache_specs, build_param_specs, torch_dtype


def _meta(shape, dtype) -> torch.Tensor:
    dt = torch.int32 if dtype == "int32" else torch_dtype(dtype)
    return torch.empty(tuple(shape), dtype=dt, device="meta")


def _from_specs(specs, default_dtype):
    return map_with_path(lambda _p, sp: _meta(sp.shape, sp.dtype or default_dtype), specs)


def param_specs(cfg: ModelConfig):
    return _from_specs(build_param_specs(cfg), cfg.dtype)


def opt_state_specs(cfg: ModelConfig, matrix_embed: bool = True, world: int = 1):
    """``MixedState(momentum, nu)``: fp32 momentum like every parameter, nu
    ``(1,) * ndim`` on the matrix leaves. With ``world > 1`` the state of
    the ZeRO-2 optimizer instead (rmnp, fused apply, buckets padded to a
    multiple of ``world``), as rank 0 of the group holds it."""
    params = param_specs(cfg)
    if world > 1:
        from repro_torch.core import make_optimizer
        from repro_torch.distributed.sharding import shard_state
        rank0 = types.SimpleNamespace(rank=0, world=world)
        opt = make_optimizer("rmnp", dict(lr_matrix=1e-3, matrix_embed=matrix_embed,
                                          shard_axis=rank0, shard_size=world))
        return shard_state(opt.init(params), rank0)
    momentum = tree_map(lambda p: _meta(p.shape, "float32"), params)
    nu = map_with_path(
        lambda path, p: _meta((1,) * p.ndim if is_matrix_param(path, p, matrix_embed)
                              else p.shape, "float32"), params)
    return MixedState(momentum=momentum, nu=nu)


def batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, torch.Tensor]:
    """Training / prefill batch inputs."""
    B, S = shape.global_batch, shape.seq_len
    out: Dict[str, torch.Tensor] = {}
    if cfg.frontend == "audio_frames":
        out["frames"] = _meta((B, S, cfg.d_model), cfg.dtype)
    else:
        out["tokens"] = _meta((B, S), "int32")
        if cfg.frontend == "vision":
            out["vision_embeds"] = _meta((B, cfg.n_frontend_tokens, cfg.d_model), cfg.dtype)
    if shape.kind == "train":
        out["labels"] = _meta((B, S), "int32")
    return out


def cache_specs(cfg: ModelConfig, shape: ShapeConfig):
    return _from_specs(build_cache_specs(cfg, shape.global_batch, shape.seq_len), cfg.dtype)


def input_specs(cfg: ModelConfig, shape: ShapeConfig, world: int = 1) -> Tuple[Any, ...]:
    """Every input of the (arch x shape) cell's step, in its signature's
    order: train ``(params, opt_state, batch, step)`` (with ``world > 1``
    the ZeRO-2 dp step's ``(params, opt_state, comp_state, batch, step)``),
    prefill ``(params, batch)``, decode ``(params, cache, tokens, pos)``."""
    params = param_specs(cfg)
    step = _meta((), "int32")
    if shape.kind == "train":
        batch = batch_specs(cfg, shape)
        if world > 1:
            from repro_torch.distributed.compression import init_compression_state
            return (params, opt_state_specs(cfg, world=world),
                    init_compression_state(params), batch, step)
        return params, opt_state_specs(cfg), batch, step
    if shape.kind == "prefill":
        return params, batch_specs(cfg, shape)
    return params, cache_specs(cfg, shape), _meta((shape.global_batch, 1), "int32"), step
