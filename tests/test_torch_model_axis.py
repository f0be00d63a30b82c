"""The model axis of the port on ``data x model`` gloo worlds against the
JAX package's unsharded model.

Each case runs the port's model-axis code (``distributed/
tensor_parallel.py``) on every rank of a gloo world of spawned workers
(``tests/_torch_model_axis_worker.py``), from the JAX package's parameters
cut into the rank's shards by the rules (``interop.shard_params``), and
holds against JAX's ``loss_fn`` and ``jax.grad`` on the rank's data rows,
computed in float64 from the same parameters (the exact reference):
the loss, every gradient gathered over the model group
(``interop.gather_params``), the prefill's last logits and each rank's
span of its cache, and four decode steps fed the next tokens against
JAX's forward over the whole sequence (teacher-forced).

The cases cover a group that divides the q heads with fewer kv heads than
ranks (the gathered kv columns), kv heads equal to q heads, q heads the
group does not divide (every head on every rank, as JAX replicates them),
a tied embedding, a vocabulary the group divides and one it does not
(a model group of 3), ``d_ff`` whose fused ``[gate; up]`` columns split
while ``d_ff`` itself does not, MLA's heads split and not, and MoE's
experts split over the group, replicated where it does not divide them,
and with pairs dropped at capacity (that case's decode steps route other
than the forward, so it holds the loss, gradients and prefill only).

Tolerance, fp32 (the serve and MLA tests'): rtol 1e-5 plus 2e-6 of each
leaf's largest magnitude. The split sums (row-split products summed over
the group, the log-sum-exp merge of the decode's spans, the vocabulary's
log-sum-exp) change the order of fp32 sums only.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import _torch_model_axis_worker as W
from repro.configs import get_config as jax_get_config
from repro.models import init_params as jax_init_params
from repro.models.model import forward as jax_forward
from repro.models.model import loss_fn as jax_loss_fn
from repro.train.step import make_prefill_step as jax_make_prefill_step
from repro_torch.configs import get_config
from repro_torch.core.types import tree_paths
from repro_torch.interop import gather_params, tree_from_numpy
from repro_torch.launch.mesh import make_local_world
from repro_torch.models import moe
from repro_torch.models.model import build_cache_specs, forward
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

RTOL, ATOL_FRAC = 1e-5, 2e-6
B, S, T = 4, 12, 8          # the batch, the tokens (S + 1 drawn), the prompt
GQA_KV1 = dict(n_heads=4, n_kv_heads=1, head_dim=16)       # K < M
ODD_HEADS = dict(n_heads=3, n_kv_heads=1, head_dim=16)     # H % M != 0 at M = 2
# the MoE cases run at capacity factor E / K, where nothing is dropped: a
# decode step over B tokens and the forward over B S tokens then route alike
NODROP = dict(moe=dict(capacity_factor=2.0))
DS3 = dict(NODROP, num_layers=3, pattern=(("mla", "dense"),) + (("mla", "moe"),) * 2)
CASES = {
    # name: (arch, overrides, (data, model))
    "gqa_kv_below_group_1x2": ("qwen3-4b", GQA_KV1, (1, 2)),
    "gqa_kv_below_group_2x2": ("qwen3-4b", GQA_KV1, (2, 2)),
    "mha_1x2": ("phi3-mini-3.8b", {}, (1, 2)),
    "heads_replicated_1x2": ("qwen3-4b", ODD_HEADS, (1, 2)),
    "tied_vision_1x2": ("paligemma-3b", {}, (1, 2)),
    "gpt2_tied_2x2": ("gpt2-small", {}, (2, 2)),
    # vocab 512 on a group of 3: the embedding, head and loss replicated
    "vocab_replicated_1x3": ("llama-130m", dict(ODD_HEADS, d_ff=96), (1, 3)),
    # 2 * 97 columns split in two, 97 rows of w_out not: gathered columns
    "ffn_cut_plain_1x2": ("llama-130m", dict(d_ff=97), (1, 2)),
    # MLA with q_lora, H = 3 on M = 2: wq_b's and wkv_b's columns gathered,
    # every head on every rank, wo's rows read the rank's span; tied head
    "mla_heads_replicated_1x2": ("minicpm3-4b", dict(n_heads=3, n_kv_heads=3), (1, 2)),
    # H = 4 on M = 3: wkv_b split (96 columns), wq_b and wo replicated, and
    # the tied vocabulary of 512 replicated
    "mla_vocab_replicated_1x3": ("minicpm3-4b", {}, (1, 3)),
    # MLA at H = 4 on M = 2, two heads a rank; a dense first layer, then
    # MoE with E = 4 top-2 and a shared expert
    "deepseek_1x2": ("deepseek-v2-lite-16b", DS3, (1, 2)),
    "deepseek_2x2": ("deepseek-v2-lite-16b", DS3, (2, 2)),
    "olmoe_1x2": ("olmoe-1b-7b", NODROP, (1, 2)),
    "olmoe_2x2": ("olmoe-1b-7b", NODROP, (2, 2)),
    "olmoe_per_row_1x2": ("olmoe-1b-7b", dict(moe=dict(NODROP["moe"], dispatch="per_row")),
                          (1, 2)),
    # E = 3 on M = 2: the stacks replicated, every rank runs every expert
    "experts_replicated_1x2": ("olmoe-1b-7b", dict(moe=dict(num_experts=3,
                                                            capacity_factor=1.5)), (1, 2)),
    # pairs dropped at capacity on a model group: capacity factor 1 (C = 24
    # slots an expert for the 96 pairs of training, 16 for the prefill's
    # 64), where the config's own 1.25 rounds C up to 32 and 24 and drops
    # nothing at these sizes (test_the_capacity_case_drops_pairs)
    "olmoe_drops_1x2": ("olmoe-1b-7b", dict(moe=dict(capacity_factor=1.0)), (1, 2)),
}
# the cases whose decode steps route as the forward does: a decode step's
# capacity buffer holds B tokens, the forward's B S, so only where nothing
# is dropped do both keep every pair
DECODE_CASES = [name for name in CASES if name != "olmoe_drops_1x2"]


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flatten(v, path))
        else:
            out[path] = np.asarray(v)
    return out


def _unflatten(flat):
    tree = {}
    for key, value in flat.items():
        node = tree
        *head, leaf = key.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[leaf] = value
    return tree


def _close(got, want, what):
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=ATOL_FRAC * float(np.abs(want).max()), err_msg=what)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each case's port results (per rank) and the JAX references. The
    cases of one world shape run in turn on one spawned world."""
    out, dirs, jobs = {}, {}, {}
    for name, (arch, overrides, dims) in CASES.items():
        d = dirs[name] = tmp_path_factory.mktemp(name)
        jcfg = W.reduced(jax_get_config, arch, overrides)
        jparams = jax.tree_util.tree_map(np.asarray, jax_init_params(jcfg,
                                                                       jax.random.PRNGKey(0)))
        np.savez(d / "params.npz", **_flatten(jparams))
        toks = np.asarray(jax.random.randint(jax.random.PRNGKey(7), (B, S + 1), 0, jcfg.vocab),
                          np.int32)
        np.save(d / "tokens.npy", toks)
        jobs.setdefault(dims, []).append(("parity", str(d), arch, overrides,
                                          str(d / "params.npz"), str(d / "tokens.npy"), T))
        out[name] = (jcfg, jparams, toks, dims)
    for dims, cases in jobs.items():
        W.spawn("in_turn", dims, tmp_path_factory.mktemp("world"), cases)
    return {name: (*out[name], [dict(np.load(dirs[name] / f"parity_{r}.npz"))
                                for r in range(dims[0] * dims[1])])
            for name, (_, _, _, dims) in out.items()}


def _exact(runs, name):
    """The case's JAX config and parameters in float64: the reference the
    port's fp32 results are held to (run under ``jax.enable_x64``). Each
    fp32 computation, JAX's own included, carries its order's rounding;
    against JAX in fp32 the limit would have to hold the sum of two such
    errors (reduced deepseek's router gradient: 0.77 of the limit for JAX's
    own fp32, 0.59 for the port's model axis, 1.36 between them)."""
    jcfg, jparams = runs[name][:2]
    return (dataclasses.replace(jcfg, dtype="float64"),
            jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), jparams))


def _jax_rows(runs, name, data_rank):
    jcfg, jparams, toks, dims, ranks = runs[name]
    n = B // dims[0]
    return jcfg, jparams, toks[data_rank * n:(data_rank + 1) * n], dims, ranks


@pytest.mark.parametrize("name", list(CASES))
def test_loss_and_every_gathered_gradient_match_jax(runs, name):
    arch, overrides, (D, M) = CASES[name]
    cfg = W.reduced(get_config, arch, overrides)
    jcfg, jparams = _exact(runs, name)
    grad_fn = jax.jit(jax.value_and_grad(lambda p, batch: jax_loss_fn(jcfg, p, batch)[0]))
    for dr in range(D):
        _, _, toks, _, ranks = _jax_rows(runs, name, dr)
        with jax.enable_x64(True):
            want_loss, want_grads = grad_fn(jparams, {"tokens": toks[:, :S],
                                                      "labels": toks[:, 1:]})
        mine = ranks[dr * M:(dr + 1) * M]
        for r in mine:
            np.testing.assert_allclose(r["loss"], np.asarray(want_loss), rtol=RTOL)
        shards = [tree_from_numpy(_unflatten({k[5:]: v for k, v in r.items()
                                              if k.startswith("grad:")})) for r in mine]
        whole = _flatten(gather_params(shards, cfg, make_local_world(D, M)))
        want = _flatten(jax.tree_util.tree_map(np.asarray, want_grads))
        assert sorted(whole) == sorted(want)
        for path in want:
            _close(whole[path], want[path], f"{name} d{dr} grad {path}")


@pytest.mark.parametrize("name", list(CASES))
def test_prefill_logits_and_cache_spans_match_jax(runs, name):
    arch, overrides, (D, M) = CASES[name]
    jcfg, jparams = _exact(runs, name)
    prefill = jax.jit(jax_make_prefill_step(jcfg))
    specs = dict(tree_paths(build_cache_specs(W.reduced(get_config, arch, overrides), B, T)))
    for dr in range(D):
        _, _, toks, _, ranks = _jax_rows(runs, name, dr)
        with jax.enable_x64(True):
            last, cache = prefill(jparams, {"tokens": toks[:, :T]})
        want_cache = _flatten(jax.tree_util.tree_map(np.asarray, cache))
        for m in range(M):
            r = ranks[dr * M + m]
            _close(r["prefill_logits"], np.asarray(last), f"{name} prefill logits")
            for path, w in want_cache.items():
                seq = list(specs[path].axes).index("kv_seq")
                if T % M == 0:   # the rules split kv_seq: the rank's span
                    w = np.take(w, range(m * T // M, (m + 1) * T // M), axis=seq)
                _close(r[f"prefill_cache:{path}"], w, f"{name} cache {path} rank {m}")


@pytest.mark.parametrize("name", DECODE_CASES)
def test_decode_matches_the_teacher_forced_forward(runs, name):
    _, _, (D, M) = CASES[name]
    jcfg, jparams = _exact(runs, name)
    forward = jax.jit(lambda p, b: jax_forward(jcfg, p, b, "train"))
    for dr in range(D):
        _, _, toks, _, ranks = _jax_rows(runs, name, dr)
        with jax.enable_x64(True):
            logits, _, _ = forward(jparams, {"tokens": toks[:, :S]})
        logits = np.asarray(logits)
        for m in range(M):
            r = ranks[dr * M + m]
            for i, pos in enumerate(range(T, S)):
                _close(r[f"decode_logits_{i}"], logits[:, pos],
                       f"{name} decode at {pos}, rank {m}")


def test_the_capacity_case_drops_pairs(runs, monkeypatch):
    """The drop case's training forward and prefill, on the port's
    single-rank code from the same parameters and tokens, drop pairs at
    capacity in every MoE layer while keeping most of them."""
    name = "olmoe_drops_1x2"
    arch, overrides, _ = CASES[name]
    cfg = W.reduced(get_config, arch, overrides)
    _, jparams, toks, _, _ = runs[name]
    params = tree_from_numpy(jparams)
    slots, seen = moe._slots, []

    def counting(expert_ids, E, C):
        out = slots(expert_ids, E, C)
        seen.append((int((~out[1]).sum()), out[1].numel()))
        return out

    monkeypatch.setattr(moe, "_slots", counting)
    for mode, n in (("train", S), ("prefill", T)):
        seen.clear()
        forward(cfg, params, {"tokens": torch.tensor(toks[:, :n], dtype=torch.long)}, mode)
        assert len(seen) == cfg.num_layers
        assert all(0 < dropped < pairs // 4 for dropped, pairs in seen), (mode, seen)
