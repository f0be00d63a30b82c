"""The port's examples (``examples_torch/``) against the JAX package's
(``examples/``) on the CPU, from the same parameters and inputs.

Each JAX example runs in this process as a user runs it (``runpy``, its
own command line); each port example through its ``main(argv)`` with
``--device cpu``. The port's ``init_params`` (and serve_batched's prompt
draw) are patched here, never in the example, to give the JAX package's
``init_params(cfg, PRNGKey(seed))`` and ``randint(PRNGKey(1), ...)``,
exported as numpy and carried over with ``repro_torch.interop``. Where a
JAX example prints a number rounded, its full value is read where it is
made: the jitted train step's metrics (quickstart) and ``train()``'s
history (faceoff), both wrapped for the run.

Tolerances, all fp32 (the reduced configs are fp32). The port and JAX
agree to an ulp or two on a step (``tests/test_torch_train.py``: losses at
rtol 1e-6 over 3 steps), and training feeds each step's difference into
the next. Measured on the CPU (the port on one torch thread, as here):
quickstart's 50 steps at a peak lr of 2e-2 keep the logged losses within
5.5e-7 relative and the grad norms within 2.1e-7 (both held at 2e-6), the
final momentum's dominance ratios within 7.0e-7 (r_max; held at 5e-6);
the faceoff's 6 steps keep every logged loss within 4.6e-7 (held at 2e-6);
act 1's uninterrupted 60 steps within 7.4e-8 (held at 1e-6). Printed values agree to the printed digit (one unit
of the last digit apart at most, where a value straddles the rounding).
Served tokens are greedy argmaxes and must be equal. The restart is held
to the JAX example's own claims: act 1 bit for bit, act 2 within 2e-3
after the 8 -> 4 reshard.
"""
import contextlib
import importlib.util
import io
import re
import runpy
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import init_params as jax_init_params
from repro_torch.interop import tree_from_numpy
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
STEP_LINE = re.compile(r"step\s+(\d+)\s+loss ([\d.]+)\s+grad-norm ([\d.]+)")
DOM_LINE = re.compile(r"r_avg=([\d.]+) r_min=([\d.]+) r_max=([\d.]+)")


def _port_example(name):
    spec = importlib.util.spec_from_file_location(f"examples_torch_{name}",
                                                  ROOT / "examples_torch" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_jax_example(name, argv, monkeypatch):
    """Run ``examples/<name>.py`` as a script; returns (its globals, stdout)."""
    monkeypatch.setattr(sys, "argv", [name] + list(argv))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        env = runpy.run_path(str(ROOT / "examples" / f"{name}.py"), run_name="__main__")
    return env, out.getvalue()


def _run_port(fn, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = fn(argv)
    return res, out.getvalue()


def _jax_params_np(arch, seed):
    cfg = jax_get_config(arch).reduced()
    return jax.tree_util.tree_map(np.asarray, jax_init_params(cfg, jax.random.PRNGKey(seed)))


def _init_from(np_params):
    """A stand-in for the port's ``init_params``: fresh tensors of the JAX
    package's parameters on the device asked for."""
    def init_params(cfg, seed=0, device="cuda"):
        return tree_from_numpy(np_params, device)
    return init_params


def _printed_close(got, want):
    """Printed numbers agree to one unit of their last digit."""
    for g, w in zip(got, want, strict=True):
        digits = len(w.split(".")[1]) if "." in w else 0
        assert abs(float(g) - float(w)) <= 1.01 * 10.0 ** -digits, (got, want)


@contextlib.contextmanager
def _recording_jit(records):
    """``jax.jit`` whose jitted functions append the scalar metrics of each
    call that returns them (a train step's last output) to ``records``."""
    real = jax.jit

    def jit(fun, *args, **kwargs):
        jitted = real(fun, *args, **kwargs)

        def call(*a, **kw):
            out = jitted(*a, **kw)
            if isinstance(out, tuple) and out and isinstance(out[-1], dict) \
                    and "loss" in out[-1]:
                records.append({k: float(v) for k, v in out[-1].items() if np.ndim(v) == 0})
            return out
        return call
    jax.jit = jit
    try:
        yield
    finally:
        jax.jit = real


def test_quickstart_matches_jax(monkeypatch):
    jax_steps = []
    with _recording_jit(jax_steps):
        env, jax_out = _run_jax_example("quickstart", [], monkeypatch)
    mod = _port_example("quickstart")
    monkeypatch.setattr(mod, "init_params", _init_from(_jax_params_np("gpt2-small", 0)))
    res, out = _run_port(mod.main, ["--device", "cpu"])

    # the same lines at the same steps, the printed numbers to their digit
    printed, jax_printed = STEP_LINE.findall(out), STEP_LINE.findall(jax_out)
    assert [int(s) for s, _, _ in printed] == [int(s) for s, _, _ in jax_printed] \
        == [0, 10, 20, 30, 40, 49]
    _printed_close([x for row in printed for x in row[1:]],
                   [x for row in jax_printed for x in row[1:]])
    _printed_close(DOM_LINE.search(out).groups(), DOM_LINE.search(jax_out).groups())

    # the full values: every logged loss and grad norm, the dominance ratios
    assert len(jax_steps) == 50
    steps = [s for s, _, _ in res["logged"]]
    np.testing.assert_allclose([loss for _, loss, _ in res["logged"]],
                               [jax_steps[s]["loss"] for s in steps], rtol=2e-6, atol=0)
    np.testing.assert_allclose([g for _, _, g in res["logged"]],
                               [jax_steps[s]["grad_norm"] for s in steps], rtol=2e-6, atol=0)
    jdom = env["dom"]
    for k in ("r_avg", "r_min", "r_max"):
        np.testing.assert_allclose(res["dominance"][k], float(jdom[k]), rtol=5e-6, err_msg=k)
    assert res["dominance"]["r_avg"] > 1.0  # the paper's Sec. 3.2 claim holds here too


# GQA (the default), MLA's latent cache with MoE, jamba's mamba state beside
# its GQA cache and MoE, xlstm's mLSTM and sLSTM states
SERVE_ARCHS = ("qwen3-4b", "deepseek-v2-lite-16b", "jamba-v0.1-52b", "xlstm-350m")


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_serve_batched_matches_jax(arch, monkeypatch):
    """Greedy tokens equal to the JAX example's, every one of them printed
    (``--tokens 16``: the examples print the first 16 of each sequence)."""
    argv = ["--arch", arch, "--batch", "3", "--prompt-len", "8", "--tokens", "16"]
    _, jax_out = _run_jax_example("serve_batched", argv, monkeypatch)
    mod = _port_example("serve_batched")
    monkeypatch.setattr(mod, "init_params", _init_from(_jax_params_np(arch, 0)))
    jcfg = jax_get_config(arch).reduced()
    prompts = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (3, 8), 0, jcfg.vocab))
    monkeypatch.setattr(mod, "prompt_tokens", lambda cfg, b, t, device: torch.from_numpy(
        prompts.copy()).long().to(device))
    res, out = _run_port(mod.main, argv + ["--device", "cpu"])
    seq_line = re.compile(r"seq\[(\d)\]: (\[[\d, ]*\]) \.\.\.")
    got, want = seq_line.findall(out), seq_line.findall(jax_out)
    assert len(want) == 3 and got == want
    assert res["tokens"].shape == (3, 16)
    assert [str(row) for row in res["tokens"].tolist()] == [w for _, w in want]
    assert re.search(r"decoded 3x16 tokens in [\d.]+s \([\d.]+ tok/s on cpu\)", out)


def test_faceoff_matches_jax_at_equal_steps(monkeypatch):
    import repro.launch.train as jax_train_mod
    import repro_torch.launch.train as train_mod
    argv = ["--steps", "6", "--only", "adamw", "muon", "rmnp"]
    jax_hist = {}
    real_train = jax_train_mod.train

    def recording_train(arch, optimizer="rmnp", **kw):
        out = real_train(arch, optimizer=optimizer, **kw)
        jax_hist[optimizer] = out[2]
        return out
    monkeypatch.setattr(jax_train_mod, "train", recording_train)
    _, jax_out = _run_jax_example("train_optimizer_faceoff", argv, monkeypatch)
    monkeypatch.setattr(train_mod, "init_params", _init_from(_jax_params_np("gpt2-small", 0)))
    mod = _port_example("train_optimizer_faceoff")
    res, out = _run_port(mod.main, argv + ["--device", "cpu"])

    assert list(res) == list(jax_hist) == ["adamw", "muon", "rmnp"]
    for opt, r in res.items():
        assert [h["step"] for h in r["history"]] == [h["step"] for h in jax_hist[opt]]
        np.testing.assert_allclose([h["loss"] for h in r["history"]],
                                   [h["loss"] for h in jax_hist[opt]], rtol=2e-6, atol=0,
                                   err_msg=opt)
    # the same summary: its rows and final losses, and the same winner
    row = re.compile(r"^(\w+)\s+final-loss ([\d.]+)\s+loss@\d+s [\d.]+\s+wall [\d.]+s$", re.M)
    got, want = row.findall(out), row.findall(jax_out)
    assert [o for o, _ in got] == [o for o, _ in want] == ["adamw", "muon", "rmnp"]
    _printed_close([x for _, x in got], [x for _, x in want])
    assert "=== summary (equal-wall budget" in out
    best = re.compile(r"best final loss: (\w+)")
    assert best.search(out).group(1) == best.search(jax_out).group(1)
    # the equal-wall reading is the copied loss_at_wall of each history
    budget = min(r["wall_s"] for r in res.values())
    for r in res.values():
        assert r["at_budget"] == mod.loss_at_wall(r["history"], budget)


def test_fault_tolerant_restart_holds_the_jax_example_claims(monkeypatch):
    """Act 1 (on the CPU here) resumes bit for bit; act 2's 8-rank torchrun
    run dies of SIGKILL and resumes on 4 ranks through the elastic reshard
    within the JAX example's 2e-3 of an uninterrupted 4-rank run. Act 1
    starts from the JAX package's llama-60m init (seed 3), so its
    uninterrupted losses are also held against JAX's ``train``."""
    from repro.launch.train import train as jax_train
    import repro_torch.launch.train as train_mod
    _, _, jax_hist = jax_train("llama-60m", steps=60, batch=4, seq=32, log_every=10, seed=3)
    monkeypatch.setattr(train_mod, "init_params", _init_from(_jax_params_np("llama-60m", 3)))
    mod = _port_example("fault_tolerant_restart")
    res, out = _run_port(mod.main, ["--device", "cpu"])

    assert res["act1"]["worst"] == 0.0 and "restart is exact" in out
    hist = res["act1"]["history"]
    assert [h["step"] for h in hist] == [h["step"] for h in jax_hist]
    np.testing.assert_allclose([h["loss"] for h in hist], [h["loss"] for h in jax_hist],
                               rtol=1e-6, atol=0)
    assert "(the ranks died with SIGKILL as injected" in out
    assert "[train] resumed from step 20 (elastic reshard 8-way -> 4-way)" in out
    assert res["act2"]["worst"] < 2e-3
    assert "elastic restart tracks the uninterrupted run" in out
