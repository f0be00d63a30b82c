"""The port's train step and driver against the JAX package's.

Three steps of ``make_train_step`` on reduced gpt2 from the same parameters
(exported from ``repro.models.init_params``) and the same ``make_stream``
batches, port against JAX, with the single-pass engine and ``use_kernel``
(Pallas in interpret mode on the JAX side; the kernels' plain versions on
the port's CPU tensors). Then the port's ``train()`` driver on the CPU.

Tolerances. The losses agree to 1e-6 relative and the parameters to 1e-5 of
each leaf's largest entry: the forward and backward agree to an ulp or two
(tests/test_torch_model.py), and the optimizer divides each gradient column
by its norm, which keeps a gradient's relative error in the update, so
three steps move the parameters by lr-sized steps that agree to about that
relative error (measured 2e-7 of the largest entry).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import cosine_with_warmup as jax_cosine
from repro.core import make_optimizer as jax_make_optimizer
from repro.data.pipeline import make_stream as jax_make_stream
from repro.models import init_params as jax_init_params
from repro.train.step import make_train_step as jax_make_train_step
from repro_torch.configs import get_config
from repro_torch.core import apply_updates, cosine_with_warmup, make_optimizer
from repro_torch.core.types import map_with_path, tree_paths
from repro_torch.data.pipeline import make_stream
from repro_torch.interop import to_numpy, tree_from_numpy
from repro_torch.kernels import LAUNCHES
from repro_torch.launch import train as train_mod
from repro_torch.train.step import make_train_step

STEPS, BATCH, SEQ = 3, 2, 16


def _opt_config(cosine, engine):
    return dict(lr_matrix=cosine(2e-2, STEPS), lr_adamw=cosine(1e-2, STEPS),
                use_kernel=True, fused=engine != "per-leaf",
                fused_apply=engine == "single-pass")


@pytest.mark.parametrize("engine,accum,clip", [("single-pass", 1, 1.0),
                                               ("single-pass", 2, 0.0),
                                               ("bucketed", 1, 0.5)],
                         ids=["single_pass", "accum2_noclip", "bucketed_clip"])
def test_three_steps_match_jax(engine, accum, clip):
    jcfg = jax_get_config("gpt2-small").reduced(attn_impl="pallas", attn_chunk_q=8,
                                                attn_chunk_k=8)
    cfg = get_config("gpt2-small").reduced(attn_impl="pallas", attn_chunk_q=8,
                                           attn_chunk_k=8)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    params = tree_from_numpy(jax.tree_util.tree_map(np.asarray, jparams))

    jopt = jax_make_optimizer("rmnp", _opt_config(jax_cosine, engine))
    jstep = jax.jit(jax_make_train_step(jcfg, jopt, clip_norm=clip, remat="full",
                                        num_microbatches=accum))
    opt = make_optimizer("rmnp", _opt_config(cosine_with_warmup, engine))
    step_fn = make_train_step(cfg, opt, clip_norm=clip, remat="full",
                              num_microbatches=accum)
    jstate, state = jopt.init(jparams), opt.init(params)
    jstream, stream = jax_make_stream(jcfg, SEQ, BATCH, seed=0), make_stream(cfg, SEQ, BATCH)
    want, got = [], []
    for step in range(STEPS):
        np_batch = next(stream)
        assert all(np.array_equal(np_batch[k], v) for k, v in next(jstream).items())
        jparams, jstate, jm = jstep(jparams, jstate,
                                    {k: jnp.asarray(v) for k, v in np_batch.items()}, step)
        params, state, m = step_fn(params, state,
                                   {k: torch.from_numpy(v) for k, v in np_batch.items()},
                                   step)
        want.append([float(jm[k]) for k in ("loss", "grad_norm", "clip_rate")])
        got.append([float(m[k]) for k in ("loss", "grad_norm", "clip_rate")])
    np.testing.assert_allclose(np.array(got), np.array(want), rtol=1e-6, atol=0)
    assert len({round(w[0], 6) for w in want}) == STEPS  # the loss moved
    jflat = dict(tree_paths(jax.tree_util.tree_map(np.asarray, jparams)))
    for path, t in tree_paths(params):
        w = jflat[path].astype(np.float32)
        np.testing.assert_allclose(to_numpy(t), w, rtol=0,
                                   atol=1e-5 * float(np.abs(w).max()), err_msg=path)


def test_train_driver_on_the_cpu(tmp_path):
    log = tmp_path / "log.json"
    params, state, hist = train_mod.train(
        "llama-60m", steps=4, batch=2, seq=16, log_every=1, use_kernel=True,
        fused=True, fused_apply=True, momentum_dtype="bfloat16", device="cpu",
        log_file=str(log), dump_params=str(tmp_path / "p.npz"))
    assert [h["step"] for h in hist] == [0, 1, 2, 3]
    assert all(np.isfinite(h["loss"]) for h in hist)
    # CPU tensors take the plain versions: no kernel launch is counted
    assert all(n == 0 for h in hist for n in h["launches"].values())
    assert all(b.dtype == torch.bfloat16 and b.device.type == "cpu"
               for b in state.buckets.values())
    assert log.exists() and (tmp_path / "p.npz").exists()
    dumped = np.load(tmp_path / "p.npz")
    assert sorted(dumped.files) == sorted(p for p, _ in tree_paths(params))
    assert sum(LAUNCHES.values()) == 0


def test_cli_runs_the_engines_on_the_cpu(capsys):
    for engine in ("per-leaf", "bucketed", "single-pass"):
        train_mod.main(["--arch", "gpt2-small", "--steps", "2", "--batch", "2",
                        "--seq", "16", "--log-every", "1", "--engine", engine,
                        "--use-kernel", "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.count("[train] step=1") == 3


@pytest.mark.parametrize("flag,item", [
    ("--zero2", "Queue 1, item 6"), ("--inject-fault=bitflip:768x768:1", "Queue 1, item 6")])
def test_unported_flags_raise_and_name_their_item(flag, item, capsys):
    """ZeRO-2 (item 6) is ported: ``--zero2`` trains on a group of one gloo
    rank, and the int8 wire's bit-flip fault arms on it; neither names the
    item any more."""
    import torch.distributed as dist
    try:
        train_mod.main(["--arch", "gpt2-small", "--steps", "2", "--batch", "2",
                        "--seq", "16", "--log-every", "1", "--device", "cpu",
                        "--zero2", flag])
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    out = capsys.readouterr().out
    assert out.count("[train] step=") == 2 and item not in out
    assert "launches={'rmnp_precondition': 0, 'rmnp_apply': 0" in out


def test_no_overlap_is_the_deprecated_alias_of_overlap_off(monkeypatch, capsys):
    """As in the JAX package's driver: ``--no-overlap`` warns that it is
    deprecated and runs the serialized schedule, as ``--overlap off`` does;
    with ``--zero2`` it trains on a group of one gloo rank."""
    import torch.distributed as dist
    argv = ["--arch", "gpt2-small", "--steps", "2", "--batch", "2", "--seq", "16",
            "--log-every", "1", "--device", "cpu", "--zero2"]
    seen = []
    real_train = train_mod.train
    monkeypatch.setattr(train_mod, "train", lambda *a, **kw: seen.append((a, kw)))
    train_mod.main(argv + ["--overlap", "off"])
    with pytest.warns(DeprecationWarning, match="--no-overlap is deprecated"):
        train_mod.main(argv + ["--no-overlap"])
    assert seen[0] == seen[1] and seen[1][1]["overlap"] is False
    monkeypatch.setattr(train_mod, "train", real_train)
    try:
        with pytest.warns(DeprecationWarning):
            train_mod.main(argv + ["--no-overlap"])
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    assert capsys.readouterr().out.count("[train] step=") == 2


@pytest.mark.parametrize("flags", [
    ["--ckpt-dir={d}", "--ckpt-every=1"], ["--guard"],
    ["--guard", "--inject-fault=nan:*:1"], ["--ckpt-dir={d}", "--kill-at=0"],
    ["--ckpt-dir={d}", "--watchdog-deadline=60"]],
    ids=["ckpt-dir", "guard", "inject-fault", "kill-at", "watchdog-deadline"])
def test_resilience_flags_run_on_the_cpu(flags, tmp_path, capsys):
    """The flags of checkpointing and the guard, once refused, now run."""
    train_mod.main(["--arch", "gpt2-small", "--steps", "2", "--batch", "2", "--seq", "16",
                    "--log-every", "1", "--device", "cpu"]
                   + [f.format(d=tmp_path / "ck") for f in flags])
    out = capsys.readouterr().out
    assert out.count("[train] step=") == 2
    if "--inject-fault=nan:*:1" in flags:
        assert "step 1 SKIPPED bitwise" in out
    if any(f.startswith("--ckpt-dir") for f in flags):
        assert (tmp_path / "ck" / "step_000000002" / "COMMITTED").exists()


def test_guard_and_fault_in_the_step_raise():
    """The guard and gradient faults are ported; the int8 wire's bit-flip
    fault belongs to the ZeRO-2 step and, as in the JAX package, leaves the
    single-device step's bits alone."""
    from repro_torch.models import init_params
    from repro_torch.train.faults import parse_fault
    cfg = get_config("gpt2-small").reduced()
    opt = make_optimizer("rmnp", dict(lr_matrix=1e-3))
    make_train_step(cfg, opt, guard=True, fault=parse_fault("nan:*:1"))
    params = init_params(cfg, seed=3, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in
             make_stream(cfg, 16, 2, seed=3).sample(0).items()}
    outs = [make_train_step(cfg, opt, guard=True, fault=fault)(
        params, opt.init(params), batch, 1)[0]
        for fault in (None, parse_fault("bitflip:64x64:1"))]
    assert all(torch.equal(a, b) for (_, a), (_, b) in
               zip(tree_paths(outs[0]), tree_paths(outs[1]), strict=True))


def test_entry_points_default_to_the_card():
    """Nothing picks the CPU for the caller: without a card, the default
    device fails instead of carrying on."""
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default device works")
    with pytest.raises((RuntimeError, AssertionError)):
        train_mod.train("gpt2-small", steps=1, batch=2, seq=16)


MOE_ARCHS = ["deepseek-v2-lite-16b", "olmoe-1b-7b"]


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_two_rmnp_steps_of_moe_archs_match_jax(arch):
    """Two single-pass RMNP steps of the reduced MoE configs (deepseek: MLA,
    a dense prefix layer and MoE units with a shared expert; olmoe: GQA
    with qk-norm and MoE in every layer) from the JAX package's parameters
    and batches: loss, its aux term, grad norm, and every parameter (the
    4-D expert stacks included), at this file's tolerances."""
    jcfg, cfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    params = tree_from_numpy(jax.tree_util.tree_map(np.asarray, jparams))
    jopt = jax_make_optimizer("rmnp", _opt_config(jax_cosine, "single-pass"))
    jstep = jax.jit(jax_make_train_step(jcfg, jopt, remat="full"))
    opt = make_optimizer("rmnp", _opt_config(cosine_with_warmup, "single-pass"))
    step_fn = make_train_step(cfg, opt, remat="full")
    jstate, state = jopt.init(jparams), opt.init(params)
    stream = make_stream(cfg, SEQ, BATCH)
    want, got = [], []
    keys = ("loss", "aux", "nll", "grad_norm")
    for step in range(2):
        np_batch = next(stream)
        jparams, jstate, jm = jstep(jparams, jstate,
                                    {k: jnp.asarray(v) for k, v in np_batch.items()}, step)
        params, state, m = step_fn(params, state,
                                   {k: torch.from_numpy(v) for k, v in np_batch.items()},
                                   step)
        want.append([float(jm[k]) for k in keys])
        got.append([float(m[k]) for k in keys])
    np.testing.assert_allclose(np.array(got), np.array(want), rtol=1e-6, atol=0)
    assert all(w[1] > 0 for w in want)  # the MoE layers' aux losses are in the loss
    jflat = dict(tree_paths(jax.tree_util.tree_map(np.asarray, jparams)))
    assert any(t.ndim == 4 for _, t in tree_paths(params))
    for path, t in tree_paths(params):
        w = jflat[path].astype(np.float32)
        np.testing.assert_allclose(to_numpy(t), w, rtol=0,
                                   atol=1e-5 * float(np.abs(w).max()), err_msg=path)


def test_engines_bitwise_equal_on_expert_stacks():
    """Inside the port, on reduced deepseek's parameters with random
    gradients: per-leaf == bucketed two-pass == single-pass, bit for bit,
    the 4-D expert stacks ``(n_units, E, d_in, d_out)`` included (each
    expert's matrix normalized over its own d_in)."""
    from repro_torch.models import init_params
    cfg = get_config("deepseek-v2-lite-16b").reduced()
    params = init_params(cfg, seed=0, device="cpu")
    gen = torch.Generator().manual_seed(4)
    grads = [map_with_path(lambda _path, t: 0.01 * torch.randn(t.shape, generator=gen), params)
             for _ in range(2)]
    results = {}
    for engine in ("per-leaf", "bucketed", "single-pass"):
        opt = make_optimizer("rmnp", _opt_config(cosine_with_warmup, engine))
        p, state = params, opt.init(params)
        for step, g in enumerate(grads):
            if opt.update_apply is not None:
                p, state = opt.update_apply(g, state, p, step)
            else:
                updates, state = opt.update(g, state, p, step)
                p = apply_updates(p, updates)
        results[engine] = dict(tree_paths(p))
    stacks = [path for path, t in results["per-leaf"].items() if t.ndim == 4]
    assert stacks == ["stack/layer_1/ffn/w_in", "stack/layer_1/ffn/w_out"]
    for engine in ("bucketed", "single-pass"):
        for path, t in results[engine].items():
            assert torch.equal(t, results["per-leaf"][path]), (engine, path)


def test_moe_arch_trains():
    """The port's form of the JAX package's ``test_moe_arch_trains``."""
    _, _, hist = train_mod.train("olmoe-1b-7b", "rmnp", steps=40, batch=4, seq=32,
                                 log_every=1, device="cpu")
    assert np.isfinite(hist[-1]["loss"])
    assert hist[-1]["loss"] < hist[0]["loss"] + 0.05
    assert all(h["aux"] > 0 for h in hist)
