"""The modality frontend stubs (paligemma-3b: vision embeddings in place of
the first token embeddings; musicgen-large: audio frames in place of the
token embeddings) in the port against the JAX package, on the CPU in fp32.

Each reduced model loads the JAX package's ``init_params`` through
``repro_torch.interop`` and takes a batch of the data stream both packages
share (tokens, labels and the frontend array, drawn with numpy from one
seed): train-mode logits, loss and every gradient; the prefill's last
logits and prompt cache, and 4 greedy decode steps from it against
``repro.train.step.make_prefill_step`` and ``make_serve_step``; one
single-pass RMNP step. Then what the frontend changes, in both packages:
new ``vision_embeds`` move the logits and new tokens under the image prefix
do not; a musicgen prefill needs no ``tokens``. Reduced paligemma keeps
K = 1 (4 query heads on one kv head) and ties its head to the embedding;
musicgen's token embedding is unused in a batch with frames, so its
gradient is zero in both packages.

Tolerances. fp32 on both sides with sums in other orders: logits, caches,
the loss and the gradients agree element by element to rtol 1e-5 plus 2e-6
of each tensor's largest magnitude (``tests/test_torch_serve.py``'s bound);
the parameters after a step to 1e-5 of each leaf's largest entry
(``tests/test_torch_ssm.py``'s), an AdamW element near eps widened by the
step's slope as there.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs.all_archs import ASSIGNED as JAX_ASSIGNED
from repro.core import constant as jax_constant
from repro.core import make_optimizer as jax_make_optimizer
from repro.data.pipeline import make_stream as jax_make_stream
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro.models.model import build_param_specs as jax_build_param_specs
from repro.models.model import forward as jax_forward
from repro.models.model import loss_fn as jax_loss_fn
from repro.train.step import make_prefill_step as jax_make_prefill_step
from repro.train.step import make_serve_step as jax_make_serve_step
from repro.train.step import make_train_step as jax_make_train_step
from repro_torch.configs import get_config
from repro_torch.configs.all_archs import ASSIGNED
from repro_torch.core import build_plan, constant, is_matrix_param, make_optimizer
from repro_torch.core.types import map_with_path, tree_paths
from repro_torch.data.pipeline import make_stream
from repro_torch.interop import to_numpy, tree_from_numpy
from repro_torch.launch.serve import generate, place_cache, prompt_batch
from repro_torch.models.model import (build_param_specs, forward, init_cache, loss_fn,
                                      plan_stack)
from repro_torch.train.step import make_prefill_step, make_serve_step, make_train_step
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

RTOL, ATOL_FRAC = 1e-5, 2e-6
B, S, T, DECODE_STEPS = 2, 32, 16, 4
ARCHS = ["paligemma-3b", "musicgen-large"]
FRONTEND_KEY = {"paligemma-3b": "vision_embeds", "musicgen-large": "frames"}


def _close(got, want, what, rtol=RTOL, atol_frac=ATOL_FRAC):
    want = np.asarray(want, np.float32)
    got = to_numpy(got) if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol_frac * max(float(np.abs(want).max()), 1e-30),
                               err_msg=what)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _torch_batch(np_batch):
    return {k: torch.from_numpy(v) for k, v in np_batch.items()}


def _jax_batch(np_batch):
    return {k: jnp.asarray(v) for k, v in np_batch.items()}


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    """A reduced frontend architecture with the JAX package's parameters, a
    batch of the shared data stream, and JAX's loss, logits and gradients
    there."""
    arch = request.param
    jcfg, cfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    params = tree_from_numpy(_np_tree(jparams))
    np_batch = make_stream(cfg, S, B, seed=0).sample(0)
    jbatch = jax_make_stream(jcfg, S, B, seed=0).sample(0)
    assert sorted(np_batch) == sorted(jbatch)
    assert FRONTEND_KEY[arch] in np_batch
    assert all(np.array_equal(np_batch[k], jbatch[k]) for k in np_batch)

    @jax.jit
    def run(p, batch):
        (loss, _), grads = jax.value_and_grad(
            lambda q: jax_loss_fn(jcfg, q, batch, remat="full"), has_aux=True)(p)
        return loss, jax_forward(jcfg, p, batch, "train")[0], grads

    loss, logits, grads = run(jparams, _jax_batch(np_batch))
    want = (float(loss), np.asarray(logits), dict(tree_paths(_np_tree(grads))))
    return arch, jcfg, cfg, jparams, params, np_batch, want


def test_configs_resolve_and_equal_the_jax_packages():
    """Both frontend configs, full and reduced, field by field (reduced:
    n_frontend_tokens 8), and the assigned list in the JAX package's order."""
    for arch in ARCHS:
        cfg, jcfg = get_config(arch), jax_get_config(arch)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        assert dataclasses.asdict(cfg.reduced()) == dataclasses.asdict(jcfg.reduced())
        assert cfg.reduced().n_frontend_tokens == 8
    assert ASSIGNED == JAX_ASSIGNED and ASSIGNED[-2:] == ARCHS
    assert all(get_config(a).name == a for a in ASSIGNED)


def test_stubs_add_no_parameter_and_paligemma_ties_its_head():
    """The frontend stubs carry their arrays in the batch: the parameter
    tree (paths and shapes) is the JAX package's, reduced and at full width,
    with no ``lm_head`` for the tied paligemma. Full width, from the specs
    alone (meta tensors): paligemma 2,508,793,856 parameters, the
    257280 x 2048 embedding bucket among its RMNP buckets; musicgen
    3,229,812,736."""
    for arch in ARCHS:
        for cfg, jcfg in ((get_config(arch), jax_get_config(arch)),
                          (get_config(arch).reduced(), jax_get_config(arch).reduced())):
            got = {p: tuple(s.shape) for p, s in tree_paths(build_param_specs(cfg))}
            want = {p: tuple(s.shape) for p, s in tree_paths(jax_build_param_specs(jcfg))}
            assert got == want, arch
            assert ("lm_head" in got) == (arch == "musicgen-large")
    counts = {}
    for arch in ARCHS:
        cfg = get_config(arch)
        shapes = {p: torch.empty(s.shape, device="meta")
                  for p, s in tree_paths(build_param_specs(cfg))}
        counts[arch] = sum(t.numel() for t in shapes.values())
        buckets = {(b.size, b.d_in, b.d_out)
                   for b in build_plan(shapes, predicate=is_matrix_param).buckets}
        if arch == "paligemma-3b":
            assert plan_stack(cfg.pattern) == (0, 1, 18)
            assert (1, 257280, 2048) in buckets
    assert counts == {"paligemma-3b": 2_508_793_856, "musicgen-large": 3_229_812_736}


def test_train_logits_loss_and_grads_match_jax(model):
    _, _, cfg, _, params, np_batch, (want_loss, want_logits, want_grads) = model
    batch = _torch_batch(np_batch)
    leaves = {p: t.detach().requires_grad_(True) for p, t in tree_paths(params)}
    loss, _ = loss_fn(cfg, map_with_path(lambda path, _t: leaves[path], params), batch)
    grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    with torch.no_grad():
        logits = forward(cfg, params, batch, "train")[0]
    np.testing.assert_allclose(float(loss.detach()), want_loss, rtol=RTOL)
    _close(logits, want_logits, "logits")
    assert sorted(leaves) == sorted(want_grads)
    for (path, leaf), g in zip(leaves.items(), grads, strict=True):
        if g is None:  # musicgen's embedding, unread with frames: zero in JAX
            assert cfg.frontend == "audio_frames" and path == "embed/tokens", path
            assert not np.any(want_grads[path]), path
            continue
        _close(g, want_grads[path], path)


def _jax_serve(jcfg, jparams, np_batch):
    """JAX's prefill on ``np_batch`` and DECODE_STEPS greedy steps from its
    placed cache: (last logits, prompt cache, [(token in, token out,
    logits)])."""
    last, pc = jax.jit(jax_make_prefill_step(jcfg))(jparams, _jax_batch(np_batch))
    full = jax_init_cache(jcfg, B, T + DECODE_STEPS)
    jcache = jax.tree_util.tree_map(
        lambda dst, src: dst.at[tuple(slice(0, n) for n in src.shape)].set(
            src.astype(dst.dtype)), full, pc)
    serve_fn = jax.jit(jax_make_serve_step(jcfg))
    tok = jnp.argmax(last[:, :jcfg.vocab], -1).astype(jnp.int32)[:, None]
    steps = []
    for i in range(DECODE_STEPS):
        tok_in = tok
        tok, logits, jcache = serve_fn(jparams, jcache, tok, jnp.int32(T + i))
        steps.append((np.asarray(tok_in), np.asarray(tok), np.asarray(logits)))
    return np.asarray(last), _np_tree(pc), steps


def _prompt(np_batch, cfg):
    """The first T positions of the batch as a prompt: the frontend array
    with its tokens, or an audio model's frames alone."""
    if cfg.frontend == "audio_frames":
        return {"frames": np_batch["frames"][:, :T]}
    return {"tokens": np_batch["tokens"][:, :T], "vision_embeds": np_batch["vision_embeds"]}


def test_prefill_and_decode_match_jax(model):
    """The prefill's last logits and every leaf of its cache, then 4 decode
    steps (each the same greedy token and logits, the cache written in
    place) against JAX's, and ``launch.serve.generate`` on the same prompt
    gives the same tokens."""
    _, jcfg, cfg, jparams, params, np_batch, _ = model
    prompt = _prompt(np_batch, cfg)
    want_last, want_pc, steps = _jax_serve(jcfg, jparams, prompt)
    last, pc = make_prefill_step(cfg)(params, _torch_batch(prompt))
    _close(last, want_last, "prefill logits")
    got_pc = dict(tree_paths(pc))
    assert sorted(got_pc) == sorted(p for p, _ in tree_paths(want_pc))
    for path, w in tree_paths(want_pc):
        _close(got_pc[path], w, f"prompt cache {path}")
    cache = place_cache(init_cache(cfg, B, T + DECODE_STEPS, device="cpu"), pc, cfg)
    serve_step = make_serve_step(cfg)
    for i, (tok_in, want_tok, want_logits) in enumerate(steps):
        tok, logits, cache = serve_step(params, cache, torch.from_numpy(np.array(tok_in)),
                                        T + i)
        _close(logits, want_logits, f"decode step {i}")
        assert np.array_equal(to_numpy(tok), want_tok), i
    res = generate(cfg, params, _torch_batch(prompt), DECODE_STEPS + 1)
    want_seq = np.concatenate([s[0] for s in steps] + [steps[-1][1]], axis=1)
    assert np.array_equal(to_numpy(res["tokens"]), want_seq)


def test_one_single_pass_rmnp_step_matches_jax(model):
    """One single-pass mixed RMNP step (constant rates, step 0, no clip):
    loss, grad norm and every parameter after it, at 1e-5 of each leaf's
    largest entry; an AdamW element's bound widened by the gradients' bound
    carried through the step's slope lr * eps / (|g| + eps)^2, as in
    ``tests/test_torch_ssm.py``."""
    _, jcfg, cfg, jparams, params, np_batch, (_, _, grads) = model
    lr, eps = 1e-2, 1e-8
    conf = dict(use_kernel=True, fused=True, fused_apply=True, adam_eps=eps)
    jopt = jax_make_optimizer("rmnp", dict(conf, lr_matrix=jax_constant(2e-2),
                                           lr_adamw=jax_constant(lr)))
    opt = make_optimizer("rmnp", dict(conf, lr_matrix=constant(2e-2), lr_adamw=constant(lr)))
    jnew, _, jm = jax.jit(jax_make_train_step(jcfg, jopt, clip_norm=0.0, remat="full"))(
        jparams, jopt.init(jparams), _jax_batch(np_batch), 0)
    new, _, m = make_train_step(cfg, opt, clip_norm=0.0, remat="full")(
        params, opt.init(params), _torch_batch(np_batch), 0)
    np.testing.assert_allclose([float(m["loss"]), float(m["grad_norm"])],
                               [float(jm["loss"]), float(jm["grad_norm"])], rtol=RTOL)
    after = dict(tree_paths(_np_tree(jnew)))
    for path, t in tree_paths(new):
        want = after[path].astype(np.float32)
        atol = 1e-5 * float(np.abs(want).max())
        if not is_matrix_param(path, t):
            g = grads[path]
            atol = atol + lr * eps * 1e-5 * float(np.abs(g).max()) / (np.abs(g) + eps) ** 2
        np.testing.assert_array_less(np.abs(to_numpy(t) - want), atol + 1e-30, err_msg=path)


def _both_logits(jcfg, jparams, cfg, params, np_batch):
    jl = np.asarray(jax.jit(lambda p, b: jax_forward(jcfg, p, b, "train")[0])(
        jparams, _jax_batch(np_batch)))
    with torch.no_grad():
        return jl, to_numpy(forward(cfg, params, _torch_batch(np_batch), "train")[0])


def test_the_frontend_is_read(model):
    """In both packages: paligemma's logits move with new ``vision_embeds``
    and stay (bit for bit) under new tokens at the image positions;
    musicgen's move with new frames and stay under new tokens, and its
    prefill runs from frames alone. Each port's reading equals JAX's."""
    arch, jcfg, cfg, jparams, params, np_batch, _ = model
    rng = np.random.default_rng(5)
    key = FRONTEND_KEY[arch]
    base = _both_logits(jcfg, jparams, cfg, params, np_batch)
    moved = dict(np_batch, **{key: (rng.standard_normal(np_batch[key].shape) * 0.02)
                              .astype(np.float32)})
    toks = np_batch["tokens"].copy()
    nf = np_batch[key].shape[1] if arch == "paligemma-3b" else S
    toks[:, :nf] = rng.integers(0, cfg.vocab, size=(B, nf), dtype=np.int32)
    same = dict(np_batch, tokens=toks)
    for name, batch, changes in (("frontend", moved, True), ("tokens", same, False)):
        got = _both_logits(jcfg, jparams, cfg, params, batch)
        for pkg in (0, 1):
            assert (not np.array_equal(got[pkg], base[pkg])) == changes, (name, pkg)
        _close(got[1], got[0], f"logits with new {name}")
    if arch == "musicgen-large":
        frames = {"frames": np_batch["frames"][:, :T]}
        jlast = np.asarray(jax.jit(jax_make_prefill_step(jcfg))(jparams, _jax_batch(frames))[0])
        last = make_prefill_step(cfg)(params, _torch_batch(frames))[0]
        _close(last, jlast, "prefill from frames alone")


def test_entry_points_serve_and_train_the_frontends_on_the_cpu(capsys):
    """``python -m repro_torch.launch.train`` and ``.serve`` with both
    archs, reduced, on the CPU: single-pass RMNP steps through the normal
    entry point (the data stream's frontend arrays moved to the device with
    the batch), and serving whose prompt batch carries the frontend array
    (``prompt_batch``: image embeddings beside the tokens, frames alone)."""
    from repro_torch.launch import serve as serve_mod
    from repro_torch.launch import train as train_mod
    common = ["--steps", "2", "--batch", "2", "--seq", "16", "--log-every", "1",
              "--optimizer", "rmnp", "--engine", "single-pass", "--device", "cpu"]
    for arch in ARCHS:
        train_mod.main(["--arch", arch] + common)
        serve_mod.main(["--arch", arch, "--device", "cpu", "--batch", "2", "--prompt-len",
                        "12", "--tokens", "3", "--attn-impl", "pallas"])
    out = capsys.readouterr().out
    assert out.count("[train] step=1") == 2 and out.count("seq[1]") == 2
    pali, music = (get_config(a).reduced() for a in ARCHS)
    b = prompt_batch(pali, 2, 12, 1, "cpu")
    assert sorted(b) == ["tokens", "vision_embeds"]
    assert b["vision_embeds"].shape == (2, 8, 64) and b["tokens"].shape == (2, 12)
    b = prompt_batch(music, 2, 12, 1, "cpu")
    assert sorted(b) == ["frames"] and b["frames"].shape == (2, 12, 64)
    assert 0.015 < float(b["frames"].std()) < 0.025
