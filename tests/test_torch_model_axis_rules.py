"""The logical-axis rules of the port's model axis against the JAX package's,
its shards, and the dry run on the production world.

* Rule parity: for every registered config, every parameter spec and every
  cache spec (the batches of the dry run's shapes, a batch of one among
  them), the port's ``distributed/sharding.spec_for`` on the production
  world's axes equals JAX's ``spec_for`` on ``AbstractMesh((16, 16),
  ("data", "model"))`` and on ``(2, 16, 16)``, entry for entry; and with
  ``--rules`` overrides.
* Shards: ``shard_leaf``/``gather_leaf`` and ``interop.shard_params``/
  ``gather_params`` are inverses, the fused ``[gate; up]`` columns cut as
  ``[gate_r; up_r]``.
* What the slice does not cover raises at a model group above one, naming
  ROADMAP item 14.
* The dry run: at ``16 x 16`` a record's argument bytes are the rules'
  local shard sizes; on reduced gpt2-small the model group's matmul FLOPs
  add up to the single-rank FLOPs (train, prefill, decode).
"""
import types

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import get_config as jax_get_config
from repro.distributed.sharding import DEFAULT_RULES as JAX_RULES
from repro.distributed.sharding import spec_for as jax_spec_for
from repro.models.model import build_cache_specs as jax_cache_specs
from repro.models.model import build_param_specs as jax_param_specs
from repro_torch.configs import SHAPES, ShapeConfig, get_config, list_configs
from repro_torch.core.types import map_with_path, tree_paths
from repro_torch.distributed import sharding
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.distributed.comm import WorldComm
from repro_torch.interop import gather_params, shard_params
from repro_torch.launch import dryrun, mesh
from repro_torch.models.model import (build_cache_specs, build_param_specs, init_cache,
                                      init_params)
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
CACHE_BATCHES = [(128, 32_768), (32, 32_768), (1, 524_288), (8, 64)]
OVERRIDES = [{"heads": None}, {"mlp": None, "vocab": None}, {"kv_seq": None},
             {"embed": "model"}, {"d_in": None, "kv_heads": "model"}]
ITEM = "item 14"


def _world(name, rules=None):
    return mesh.make_production_world(multi_pod=name == "2x16x16", rules=rules)


def _spec_leaves(specs):
    out = []

    def visit(path, sp):
        out.append((path, tuple(sp.shape), tuple(sp.axes)))
        return sp
    map_with_path(visit, specs)
    return out


def _jax_spec_leaves(specs):
    leaves = jax.tree_util.tree_leaves_with_path(
        specs, is_leaf=lambda x: hasattr(x, "axes") and hasattr(x, "shape"))
    return {"/".join(str(k.key) for k in path): sp for path, sp in leaves}


def _check_parity(port_specs, jax_specs, name, rules=None):
    w = _world(name, rules)
    jmesh = AbstractMesh(*MESHES[name])
    jleaves = _jax_spec_leaves(jax_specs)
    port = _spec_leaves(port_specs)
    assert sorted(p for p, _, _ in port) == sorted(jleaves)
    for path, shape, axes in port:
        want = tuple(jax_spec_for(shape, axes, jmesh, None if rules is None
                                  else dict(JAX_RULES, **rules)))
        got = sharding.spec_for(shape, axes, w.axes, w.full_rules)
        assert got == want, (path, shape, axes, got, want)


def test_the_rules_table_is_the_jax_packages():
    assert sharding.DEFAULT_RULES == JAX_RULES


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", list_configs())
def test_param_and_cache_specs_resolve_as_jax(arch, mesh_name):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    _check_parity(build_param_specs(cfg), jax_param_specs(jcfg), mesh_name)
    for batch, seq in CACHE_BATCHES:
        _check_parity(build_cache_specs(cfg, batch, seq), jax_cache_specs(jcfg, batch, seq),
                      mesh_name)


@pytest.mark.parametrize("rules", OVERRIDES, ids=lambda r: ",".join(f"{k}={v}" for k, v
                                                                    in r.items()))
@pytest.mark.parametrize("arch", ["qwen3-4b", "paligemma-3b", "deepseek-v2-lite-16b"])
def test_rule_overrides_resolve_as_jax(arch, rules):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    for name in MESHES:
        _check_parity(build_param_specs(cfg), jax_param_specs(jcfg), name, rules)
        _check_parity(build_cache_specs(cfg, 128, 32_768), jax_cache_specs(jcfg, 128, 32_768),
                      name, rules)


def test_jax_drops_a_vocab_the_axis_does_not_divide():
    w = _world("16x16")
    assert sharding.spec_for((73448, 2560), ("vocab", "embed"), w.axes) == (None, None)
    assert sharding.local_shape((151936, 2560), ("vocab", "embed"), w) == (9496, 2560)
    # d_in over data is the JAX package's; the port's shard takes model alone
    assert sharding.spec_for((2560, 4096), ("d_in", "heads"), w.axes) == ("data", "model")
    assert sharding.local_shape((2560, 4096), ("d_in", "heads"), w) == (2560, 256)


def test_shard_and_gather_leaves_round_trip():
    w = mesh.make_local_world(1, 4)
    x = torch.arange(3 * 16, dtype=torch.float32).reshape(3, 16)
    for fused in (False, True):
        shards = [sharding.shard_leaf(x, ("d_in", "mlp"), w, r, fused) for r in range(4)]
        assert all(s.shape == (3, 4) for s in shards)
        assert torch.equal(sharding.gather_leaf(shards, ("d_in", "mlp"), w, x.shape, fused), x)
    # [gate_r; up_r]: rank 1 of 4 holds gate columns 2, 3 and up columns 10, 11
    assert sharding.shard_leaf(x, ("d_in", "mlp"), w, 1, True)[0].tolist() == [2, 3, 10, 11]
    assert sharding.shard_leaf(x, ("d_in", "mlp"), w, 1, False)[0].tolist() == [4, 5, 6, 7]
    assert sharding.shard_leaf(x, ("d_in", "embed"), w, 1) is x


@pytest.mark.parametrize("dims", [(1, 2), (2, 4), (1, 3)])
@pytest.mark.parametrize("arch", ["qwen3-4b", "paligemma-3b", "llama-130m", "gpt2-small",
                                  "deepseek-v2-lite-16b", "minicpm3-4b", "olmoe-1b-7b"])
def test_shard_params_and_gather_params_are_inverses(arch, dims):
    cfg = get_config(arch).reduced()
    w = mesh.make_local_world(*dims)
    whole = init_params(cfg, 0, "cpu")
    shards = [shard_params(whole, cfg, w, r) for r in range(dims[1])]
    table = tp.leaf_table(cfg, w)
    for path, t in tree_paths(shards[0]):
        want = sharding.local_shape(table[path].whole, table[path].names, w)
        assert tuple(t.shape) == want, path
    back = dict(tree_paths(gather_params(shards, cfg, w)))
    for path, t in tree_paths(whole):
        assert torch.equal(back[path], t), path
    # init_params with a world draws the whole model, then cuts it
    one = dict(tree_paths(init_params(cfg, 0, "cpu", world=w, model_rank=dims[1] - 1)))
    for path, t in tree_paths(shards[-1]):
        assert torch.equal(one[path], t), path


def test_expert_stacks_and_shared_halves_shard_by_rank():
    """Reduced deepseek-v2-lite (E = 4, one shared expert of 64) on a model
    group of 2: rank r holds experts ``[r E / M, (r + 1) E / M)`` of both
    routed stacks, and ``[gate_r; up_r]`` of the shared experts' fused
    ``w_in_shared``; gathering the shards gives the whole tree back."""
    cfg = get_config("deepseek-v2-lite-16b").reduced()
    w = mesh.make_local_world(1, 2)
    whole = init_params(cfg, 0, "cpu")
    shards = [shard_params(whole, cfg, w, r) for r in range(2)]
    table = tp.leaf_table(cfg, w)
    ffn = whole["stack"]["layer_1"]["ffn"]
    E, f = cfg.moe.num_experts, cfg.moe.d_ff_expert
    assert not table["stack/layer_1/ffn/w_in"].fused_halves
    assert table["stack/layer_1/ffn/w_in_shared"].fused_halves
    assert table["stack/layer_0/ffn/w_in"].fused_halves    # the dense FFN's
    for r, shard in enumerate(shards):
        mine = shard["stack"]["layer_1"]["ffn"]
        experts = slice(r * E // 2, (r + 1) * E // 2)
        assert torch.equal(mine["w_in"], ffn["w_in"][:, experts]), r
        assert torch.equal(mine["w_out"], ffn["w_out"][:, experts]), r
        gate, up = torch.chunk(ffn["w_in_shared"], 2, dim=-1)
        half = f // 2
        assert torch.equal(mine["w_in_shared"], torch.cat(
            [gate[..., r * half:(r + 1) * half], up[..., r * half:(r + 1) * half]], -1)), r
        assert torch.equal(mine["w_out_shared"],
                           ffn["w_out_shared"][:, r * half:(r + 1) * half]), r
        for name in ("router", "norm"):
            assert torch.equal(mine[name], ffn[name]), (r, name)
        mla = shard["stack"]["layer_1"]["mixer"]
        for name in ("wkv_a", "kv_a_norm"):
            assert torch.equal(mla[name], whole["stack"]["layer_1"]["mixer"][name]), name
    back = dict(tree_paths(gather_params(shards, cfg, w)))
    for path, t in tree_paths(whole):
        assert torch.equal(back[path], t), path


class _GatherOf:
    """Model rank ``rank`` of a group whose every rank's prompt cache
    (``per_rank``, its leaves in tree order) is known: ``all_gather_dim``
    concatenates that leaf of every rank in rank order."""

    def __init__(self, rank, world, per_rank):
        self.rank, self.world, self.per_rank = rank, world, per_rank

    def all_gather_dim(self, x, dim):
        i = next(i for i, t in enumerate(self.per_rank[self.rank]) if t is x)
        return torch.cat([leaves[i] for leaves in self.per_rank], dim=dim)


DS3 = dict(num_layers=3, pattern=(("mla", "dense"),) + (("mla", "moe"),) * 2)


@pytest.mark.parametrize("arch,overrides", [("deepseek-v2-lite-16b", DS3), ("qwen3-4b", {})],
                         ids=["mla_latent", "gqa"])
def test_place_cache_puts_each_ranks_span_of_a_split_cache(arch, overrides):
    """A prompt cache of T = 8 positions split over ``kv_seq`` at M = 2 goes
    into each rank's span of a decode cache of 12: rank 0 positions 0-5,
    rank 1 positions 6-7 of the prompt and zeros after. MLA's latent ``ckv``
    and ``k_rope`` hold positions in their second-to-last dim, GQA's k and v
    in their third-to-last; a prefix layer's leaves have no unit axis."""
    from repro_torch.launch.serve import place_cache
    from repro_torch.models.model import init_cache
    cfg = get_config(arch).reduced(**overrides)
    B, T, S = 2, 8, 12
    w = mesh.make_local_world(1, 2)
    gen = torch.Generator().manual_seed(3)
    whole = map_with_path(lambda _p, t: torch.randn(t.shape, generator=gen),
                          init_cache(cfg, B, T, device="cpu"))
    specs = build_cache_specs(cfg, B, T)
    seq = {p: list(sp.axes).index("kv_seq") for p, sp in _spec_leaves_with_axes(specs)}
    spans = [map_with_path(lambda p, t, r=r: t.narrow(seq[p], r * T // 2, T // 2).clone(), whole)
             for r in range(2)]
    flat = [[t for _, t in tree_paths(sp)] for sp in spans]
    for r in range(2):
        comm = WorldComm(w, r, types.SimpleNamespace(rank=0, world=1),
                         _GatherOf(r, 2, flat))
        full = init_cache(cfg, B, S, device="cpu", world=w)
        got = dict(tree_paths(place_cache(full, spans[r], cfg, comm, T, S)))
        for path, t in tree_paths(whole):
            d = seq[path]
            assert got[path].shape[d] == S // 2, path
            want = torch.zeros_like(got[path])
            n = max(0, min(T - r * S // 2, S // 2))
            want.narrow(d, 0, n).copy_(t.narrow(d, r * S // 2, n))
            assert torch.equal(got[path], want), (path, r)


def _spec_leaves_with_axes(specs):
    out = []
    map_with_path(lambda path, sp: out.append((path, sp)) or sp, specs)
    return out


def _world_comm(dims):
    w = mesh.make_local_world(*dims)
    data = types.SimpleNamespace(rank=0, world=dims[0])
    model = types.SimpleNamespace(rank=0, world=dims[1])
    return WorldComm(w, 0, data, model)


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "minicpm3-4b", "olmoe-1b-7b",
                                  "jamba-v0.1-52b", "xlstm-350m"])
def test_configs_outside_the_slice_raise_naming_item_14(arch):
    """The SSM archs (``d_inner``) raise at a model group above one; the MLA
    and MoE archs run there, and a batch-1 cache of theirs (``long_seq``
    over data and model) raises."""
    cfg = get_config(arch).reduced()
    if arch in ("jamba-v0.1-52b", "xlstm-350m"):
        with pytest.raises(NotImplementedError, match=ITEM):
            tp.axis_for(cfg, _world_comm((1, 2)))
    else:
        assert tp.axis_for(cfg, _world_comm((1, 2))).size == 2
        with pytest.raises(NotImplementedError, match=ITEM):
            init_cache(cfg, 1, 8, device="cpu", world=mesh.make_local_world(2, 2))
    assert tp.axis_for(cfg, _world_comm((1, 1))) is not None  # nothing split at one


def test_optimizers_and_rules_outside_the_slice_raise_naming_item_14():
    from repro_torch.core import make_optimizer
    cfg = get_config("qwen3-4b").reduced()
    axis = tp.axis_for(cfg, _world_comm((1, 2)))
    params = init_params(cfg, 0, "cpu", world=mesh.make_local_world(1, 2))
    for name in ("muon", "normuon", "muown", "nora"):
        opt = make_optimizer(name, dict(lr_matrix=1e-3))
        state = opt.init(params)
        with tp.use(axis), pytest.raises(NotImplementedError, match=ITEM):
            opt.update(params, state, params, 0)
    for name in ("rmnp", "adamw"):
        with tp.use(axis):
            make_optimizer(name, dict(lr_matrix=1e-3, fused=True)).init(params)
    for bad in ({"embed": "model"}, {"heads": "data"}, {"batch": None}):
        with pytest.raises(NotImplementedError, match=ITEM):
            tp.check_rules(bad)
    tp.check_rules({"heads": None, "mlp": "model", "bucket": "data"})


def test_a_state_initialised_off_the_steps_axis_raises():
    from repro_torch.core import make_optimizer
    cfg = get_config("gpt2-small").reduced()
    axis = tp.axis_for(cfg, _world_comm((1, 1)))
    params = init_params(cfg, 0, "cpu", world=mesh.make_local_world(1, 1))
    for config in (dict(fused=True), dict(fused_apply=True)):
        opt = make_optimizer("rmnp", dict(lr_matrix=1e-3, **config))
        state = opt.init(params)   # outside the axis: no row-split buckets
        step = opt.update if opt.update_apply is None else opt.update_apply
        with tp.use(axis), pytest.raises(ValueError, match="initialise the state"):
            step(params, state, params, 0)
        with tp.use(axis):
            assert any(k.endswith("_rows") for k in opt.init(params).buckets)


def test_decode_on_a_group_needs_the_cache_length():
    cfg = get_config("qwen3-4b").reduced()
    axis = tp.axis_for(cfg, _world_comm((1, 2)))
    with pytest.raises(ValueError, match="cache_len"):
        axis.cache_len(8)
    assert axis.with_cache_len(16).cache_len(8) == 16
    assert axis.with_cache_len(15).cache_len(15) == 15   # 15 positions do not split


def test_the_production_worlds_of_the_dry_run():
    for arch in ("qwen3-4b", "yi-9b", "phi3-mini-3.8b", "paligemma-3b", "musicgen-large",
                 "gpt2-small", "llama-130m", "minicpm3-4b", "olmoe-1b-7b",
                 "deepseek-v2-lite-16b"):
        w, why = dryrun.production_world(get_config(arch), False)
        assert (w.size, w.model_parallel, why) == (256, 16, None), arch
        w, why = dryrun.production_world(get_config(arch), True)
        assert (w.size, w.model_parallel, why) == (512, 16, None), arch
    for arch in ("jamba-v0.1-52b", "xlstm-350m"):
        w, why = dryrun.production_world(get_config(arch), True)
        assert (w.size, w.model_parallel) == (32, 1) and ITEM in why, arch


def test_a_16x16_record_holds_the_rules_local_shards():
    cfg = get_config("qwen3-4b")
    shape = SHAPES["decode_32k"]
    w = mesh.make_production_world()
    rec = dryrun.record(cfg, shape, w.data_parallel, jax_world=w)
    assert (rec["world"], rec["model_parallel"], rec["data_parallel"]) == (256, 16, 16)

    def local_bytes(specs, dtype_bytes=2):
        total = 0
        for _, shape_, axes in _spec_leaves(specs):
            total += int(np.prod(sharding.local_shape(shape_, axes, w))) * dtype_bytes
        return total
    assert rec["memory"]["params_bytes"] == local_bytes(build_param_specs(cfg))
    assert rec["memory"]["cache_bytes"] == local_bytes(
        build_cache_specs(cfg, shape.global_batch // 16, shape.seq_len))
    assert rec["collective_wire_bytes_by_group"]["model"] > 0


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("M", [2, 4])
def test_model_group_matmul_flops_add_up_to_one_rank(kind, M):
    cfg = get_config("gpt2-small").reduced()
    shape = ShapeConfig(f"tiny_{kind}", 32, 4, kind)
    one = dryrun.record(cfg, shape, 1)
    part = dryrun.record(cfg, shape, 1, jax_world=mesh.make_local_world(1, M))
    assert part["model_parallel"] == M
    assert M * part["cost"]["matmul_flops"] == one["cost"]["matmul_flops"]
