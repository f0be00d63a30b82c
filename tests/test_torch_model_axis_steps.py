"""Training steps on the port's model axis, and the model-axis code on a
world of one.

* Three mixed-RMNP single-pass steps of the ZeRO-2 step on a ``(data 2,
  model 2)`` gloo world (``train/dp_step.py`` with ``world``) against the
  port's own single-rank step on the whole batch, within fp32 tolerance
  (rtol 1e-5 plus 2e-6 of each leaf's largest magnitude): the row-split
  buckets take RMNP's norm across the model group (the kernel's PARTIAL and
  FINISH modes, their plain versions here), the learning-rate scale reads
  the whole shapes. Two runs of the ``(2, 2)`` step are equal bit for bit.
* On a world of one (a gloo group of one, as phase C1 of ``chip_smoke.py``
  runs it on a NCCL group of one), every collective of the model-axis code
  runs and each is an identity: three steps (fp32 and bf16 momentum,
  single-pass and two-pass), prefill and decode equal the single-rank code
  bit for bit.
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


@pytest.fixture(scope="module")
def steps_run(tmp_path_factory):
    d = tmp_path_factory.mktemp("steps")
    cfg = get_config(ARCH).reduced(**OVERRIDES)
    params = init_params(cfg, 0, "cpu")
    np.savez(d / "params.npz", **_flatten(params))
    gen = torch.Generator().manual_seed(11)
    toks = torch.randint(0, cfg.vocab, (STEPS, B, S + 1), generator=gen, dtype=torch.int32)
    np.save(d / "tokens.npy", toks.numpy())
    for tag in ("a", "b"):
        W.spawn("steps", (2, 2), d, ARCH, OVERRIDES, str(d / "params.npz"),
                str(d / "tokens.npy"), STEPS, tag)
    runs = {tag: [dict(np.load(d / f"steps_{tag}_{r}.npz")) for r in range(4)]
            for tag in ("a", "b")}
    opt = make_optimizer("rmnp", dict(W.LR, fused_apply=True))
    step = make_train_step(cfg, opt, remat="full")
    state = opt.init(params)
    ref = []
    for i in range(STEPS):
        params, state, m = step(params, state, {"tokens": toks[i, :, :-1].long(),
                                                "labels": toks[i, :, 1:].long()}, i)
        ref.append(m)
    return cfg, runs, params, ref


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


@pytest.mark.parametrize("arch,overrides", [("qwen3-4b", OVERRIDES), ("gpt2-small", {}),
                                            ("paligemma-3b", {})],
                         ids=["qwen3_gqa", "gpt2_tied", "paligemma"])
def test_model_axis_on_a_world_of_one_is_the_single_rank_path(tmp_path, arch, overrides):
    cfg = get_config(arch).reduced(**overrides)
    gen = torch.Generator().manual_seed(5)
    np.save(tmp_path / "tokens.npy",
            torch.randint(0, cfg.vocab, (3, 2, S + 1), generator=gen, dtype=torch.int32)
            .numpy())
    W.spawn("world_one", (1, 1), tmp_path, arch, overrides, str(tmp_path / "tokens.npy"))
    res = dict(np.load(tmp_path / "world_one_0.npz"))
    single = {k[len("single:"):]: v for k, v in res.items() if k.startswith("single:")}
    axis = {k[len("axis:"):]: v for k, v in res.items() if k.startswith("axis:")}
    assert sorted(single) == sorted(axis) and any("bfloat16_two_pass" in k for k in single)
    for k in single:
        assert single[k].dtype == axis[k].dtype and np.array_equal(single[k], axis[k]), k
