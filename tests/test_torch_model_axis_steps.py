"""Training steps on the port's model axis, and the model-axis code on a
world of one.

* Three mixed-RMNP single-pass steps of the ZeRO-2 step on a ``(data 2,
  model 2)`` gloo world (``train/dp_step.py`` with ``world``) against the
  port's own single-rank step on the whole batch, within fp32 tolerance
  (rtol 1e-5 plus 2e-6 of each leaf's largest magnitude): the row-split
  buckets take RMNP's norm across the model group (the kernel's PARTIAL and
  FINISH modes, their plain versions here), the learning-rate scale reads
  the whole shapes. Two runs of the ``(2, 2)`` step are equal bit for bit.
* Expert parallelism under ZeRO-2: reduced olmoe-1b-7b, three steps on
  ``(2, 2)`` against the same steps on ``(2, 1)`` (the data group alone),
  within the same fp32 limit.
* On a world of one (a gloo group of one, as phase C1 of ``chip_smoke.py``
  runs it on a NCCL group of one), every collective of the model-axis code
  runs and each is an identity: three steps (fp32 and bf16 momentum,
  single-pass and two-pass), prefill and decode equal the single-rank code
  bit for bit (GQA, and reduced deepseek-v2-lite: MLA, a dense first layer,
  MoE with a shared expert).
"""
import numpy as np
import pytest
import torch

import _torch_model_axis_worker as W
from repro_torch.configs import get_config
from repro_torch.core import make_optimizer
from repro_torch.core.types import tree_paths
from repro_torch.interop import gather_params, tree_from_numpy
from repro_torch.launch.mesh import make_local_world
from repro_torch.models.model import init_params
from repro_torch.train.step import make_train_step
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

RTOL, ATOL_FRAC = 1e-5, 2e-6
STEPS, B, S = 3, 4, 16
ARCH, OVERRIDES = "qwen3-4b", dict(n_heads=4, n_kv_heads=1, head_dim=16)


def _flatten(tree):
    return {p: np.asarray(t) for p, t in tree_paths(tree)}


def _unflatten(flat):
    tree = {}
    for key, value in flat.items():
        node = tree
        *head, leaf = key.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[leaf] = value
    return tree


MOE_ARCH = "olmoe-1b-7b"


def _write_inputs(d, cfg, seed):
    """The parameters (seed 0) and STEPS batches of tokens (``seed``) the
    spawned steps read."""
    params = init_params(cfg, 0, "cpu")
    np.savez(d / "params.npz", **_flatten(params))
    gen = torch.Generator().manual_seed(seed)
    toks = torch.randint(0, cfg.vocab, (STEPS, B, S + 1), generator=gen, dtype=torch.int32)
    np.save(d / "tokens.npy", toks.numpy())
    return params, toks


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """The ZeRO-2 steps of both fixtures below on three spawned worlds: one
    ``(2, 2)`` world runs the GQA steps' first run and olmoe's steps in
    turn, a second ``(2, 2)`` world the GQA steps again (two processes'
    runs are held bit for bit), and ``(2, 1)`` olmoe's data group alone.
    Returns each run's per-rank results by tag."""
    gqa, moe = tmp_path_factory.mktemp("steps"), tmp_path_factory.mktemp("moe_steps")
    inputs = {"gqa": _write_inputs(gqa, get_config(ARCH).reduced(**OVERRIDES), 11),
              "moe": _write_inputs(moe, get_config(MOE_ARCH).reduced(), 13)}

    def job(d, arch, overrides, tag):
        return ("steps", str(d), arch, overrides, str(d / "params.npz"),
                str(d / "tokens.npy"), STEPS, tag)

    worlds = [((2, 2), [job(gqa, ARCH, OVERRIDES, "a"), job(moe, MOE_ARCH, {}, "2x2")]),
              ((2, 2), [job(gqa, ARCH, OVERRIDES, "b")]),
              ((2, 1), [job(moe, MOE_ARCH, {}, "2x1")])]
    runs = {}
    for dims, jobs in worlds:
        W.spawn("in_turn", dims, tmp_path_factory.mktemp("world"), jobs)
        for _, d, *_, tag in jobs:
            runs[tag] = [dict(np.load(f"{d}/steps_{tag}_{r}.npz"))
                         for r in range(dims[0] * dims[1])]
    return inputs, runs


@pytest.fixture(scope="module")
def steps_run(spawned):
    inputs, runs = spawned
    params, toks = inputs["gqa"]
    cfg = get_config(ARCH).reduced(**OVERRIDES)
    opt = make_optimizer("rmnp", dict(W.LR, fused_apply=True))
    step = make_train_step(cfg, opt, remat="full")
    state = opt.init(params)
    ref = []
    for i in range(STEPS):
        params, state, m = step(params, state, {"tokens": toks[i, :, :-1].long(),
                                                "labels": toks[i, :, 1:].long()}, i)
        ref.append(m)
    return cfg, {tag: runs[tag] for tag in ("a", "b")}, params, ref


def test_three_model_axis_steps_match_the_single_rank_step(steps_run):
    cfg, runs, params, ref = steps_run
    ranks = runs["a"]
    for i in range(STEPS):
        for r in ranks:
            np.testing.assert_allclose(r[f"loss_{i}"], ref[i]["loss"].numpy(), rtol=RTOL)
            np.testing.assert_allclose(r[f"grad_norm_{i}"], ref[i]["grad_norm"].numpy(),
                                       rtol=RTOL)
    for dr in range(2):
        mine = ranks[2 * dr:2 * dr + 2]
        shards = [tree_from_numpy(_unflatten({k[6:]: v for k, v in r.items()
                                              if k.startswith("param:")})) for r in mine]
        whole = _flatten(gather_params(shards, cfg, make_local_world(2, 2)))
        for path, want in _flatten(params).items():
            np.testing.assert_allclose(whole[path], want, rtol=RTOL,
                                       atol=ATOL_FRAC * float(np.abs(want).max()),
                                       err_msg=f"data rank {dr} {path}")


def test_two_model_axis_runs_are_bitwise_equal(steps_run):
    _, runs, _, _ = steps_run
    for a, b in zip(runs["a"], runs["b"], strict=True):
        assert sorted(a) == sorted(b)
        for k in a:
            assert np.array_equal(a[k], b[k]), k


@pytest.fixture(scope="module")
def moe_steps_run(spawned):
    """Reduced olmoe-1b-7b (E = 4 top-2 at the config's capacity factor,
    qk_norm): three ZeRO-2 steps on ``(data 2, model 2)`` and on ``(data 2,
    model 1)`` from the same parameters and batches."""
    _, runs = spawned
    return get_config(MOE_ARCH).reduced(), {(2, 2): runs["2x2"], (2, 1): runs["2x1"]}


def test_moe_zero2_steps_on_a_model_group_match_the_data_group_alone(moe_steps_run):
    """Expert parallelism under ZeRO-2: the expert stacks split over the
    model group (each rank runs its experts, the group sums in rank order),
    the router and the norms replicated; losses, grad norms and every
    parameter gathered over the model group equal the data group's own
    run within the fp32 limit."""
    cfg, runs = moe_steps_run
    axis, alone = runs[(2, 2)], runs[(2, 1)]
    for i in range(STEPS):
        for r in axis:
            for key in (f"loss_{i}", f"grad_norm_{i}"):
                np.testing.assert_allclose(r[key], alone[0][key], rtol=RTOL, err_msg=key)
    for dr in range(2):
        shards = [tree_from_numpy(_unflatten({k[6:]: v for k, v in r.items()
                                              if k.startswith("param:")}))
                  for r in axis[2 * dr:2 * dr + 2]]
        whole = _flatten(gather_params(shards, cfg, make_local_world(2, 2)))
        want = {k[6:]: v for k, v in alone[dr].items() if k.startswith("param:")}
        assert sorted(whole) == sorted(want)
        for path, w in want.items():
            np.testing.assert_allclose(whole[path], w, rtol=RTOL,
                                       atol=ATOL_FRAC * float(np.abs(w).max()),
                                       err_msg=f"data rank {dr} {path}")


WORLD_ONE = {"qwen3_gqa": ("qwen3-4b", OVERRIDES), "gpt2_tied": ("gpt2-small", {}),
             "paligemma": ("paligemma-3b", {}),
             "deepseek_mla_moe": ("deepseek-v2-lite-16b", dict(
                 num_layers=3, pattern=(("mla", "dense"),) + (("mla", "moe"),) * 2))}


@pytest.fixture(scope="module")
def world_one_runs(tmp_path_factory):
    """Each WORLD_ONE case's results, the cases in turn on one spawned
    world of one."""
    jobs, dirs = [], {}
    for name, (arch, overrides) in WORLD_ONE.items():
        d = dirs[name] = tmp_path_factory.mktemp(name)
        cfg = get_config(arch).reduced(**overrides)
        gen = torch.Generator().manual_seed(5)
        np.save(d / "tokens.npy",
                torch.randint(0, cfg.vocab, (3, 2, S + 1), generator=gen, dtype=torch.int32)
                .numpy())
        jobs.append(("world_one", str(d), arch, overrides, str(d / "tokens.npy")))
    W.spawn("in_turn", (1, 1), tmp_path_factory.mktemp("world"), jobs)
    return {name: dict(np.load(d / "world_one_0.npz")) for name, d in dirs.items()}


@pytest.mark.parametrize("name", list(WORLD_ONE))
def test_model_axis_on_a_world_of_one_is_the_single_rank_path(world_one_runs, name):
    res = world_one_runs[name]
    single = {k[len("single:"):]: v for k, v in res.items() if k.startswith("single:")}
    axis = {k[len("axis:"):]: v for k, v in res.items() if k.startswith("axis:")}
    assert sorted(single) == sorted(axis) and any("bfloat16_two_pass" in k for k in single)
    for k in single:
        assert single[k].dtype == axis[k].dtype and np.array_equal(single[k], axis[k]), k
