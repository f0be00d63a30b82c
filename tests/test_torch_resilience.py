"""The port's numerical resilience and crash recovery against the JAX
package's: fault parsing, the anomaly ladder, the non-finite guard, and
resume after a stop or a SIGKILL.

- ``parse_fault`` accepts and refuses what JAX's does
  (``tests/test_resilience.py::TestFaultSpec``), field for field.
- ``AnomalyMonitor`` answers the same sequences of loss and skips with the
  same rungs as JAX's: fixed sequences, plus 40 drawn from a numpy seed.
- ``finite_guard`` gives JAX's flags on the same gradients; a guarded NaN
  step leaves params and optimizer state bit for bit unchanged (the mirror
  of ``TestSingleDeviceGuard::test_guarded_step_skips_bitwise``); and a
  guarded run with ``nan:*:1`` follows JAX's guarded run within the train
  parity tolerance (losses to 1e-6 relative, parameters to 1e-5 of each
  leaf's largest entry, tests/test_torch_train.py).
- A run stopped and resumed through ``repro_torch.launch.train.train``
  equals an uninterrupted run bit for bit, parameters and optimizer state,
  for reduced gpt2 and reduced llama (the mirror of
  ``tests/test_substrate.py::test_crash_restart_bitwise_exact``); so does a
  run SIGKILLed in a subprocess; the anomaly ladder rewinds to the
  last-known-good checkpoint and aborts past its budget.
"""
import os
import signal
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import cosine_with_warmup as jax_cosine
from repro.core import make_optimizer as jax_make_optimizer
from repro.core.types import tree_paths as jax_tree_paths
from repro.data.pipeline import make_stream as jax_make_stream
from repro.distributed.monitor import AnomalyMonitor as JaxAnomalyMonitor
from repro.models import init_params as jax_init_params
from repro.train import faults as jax_faults
from repro.train import pipeline as jax_pipeline
from repro.train.step import make_train_step as jax_make_train_step
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.core import constant, cosine_with_warmup, make_optimizer, mixed_optimizer
from repro_torch.core.types import tree_paths
from repro_torch.distributed.monitor import AnomalyMonitor, HangGuard, StepTimeMonitor, Watchdog
from repro_torch.interop import to_numpy, tree_from_numpy
from repro_torch.launch.train import train
from repro_torch.models import init_params
from repro_torch.train import faults, pipeline
from repro_torch.train.step import make_train_step
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _bits(t):
    t = t.detach().cpu()
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy().tobytes()


def _assert_trees_bitwise(a, b):
    pa, pb = tree_paths(a), tree_paths(b)
    assert [p for p, _ in pa] == [p for p, _ in pb]
    for (path, x), (_, y) in zip(pa, pb, strict=True):
        assert _bits(x) == _bits(y), path


# ---------------------------------------------------------------------------
# faults
# ---------------------------------------------------------------------------

_SPECS = ["nan:embed/tokens:3", "inf:*:7:2", "nan:*:6+", "bitflip:768x768:2",
          "nan", "nan:*", "frob:*:3", "nan:*:x", "bitflip:k:2:1", "inf:a/w:2+:0",
          "nan:a:b:c:d", "nan:*:-1"]


@pytest.mark.parametrize("spec", _SPECS)
def test_parse_fault_accepts_and_refuses_what_jax_does(spec):
    try:
        want = jax_faults.parse_fault(spec)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            faults.parse_fault(spec)
        assert str(got.value) == str(e)
        return
    got = faults.parse_fault(spec)
    assert (got.kind, got.leaf, got.step, got.microbatch, got.sticky) == \
        (want.kind, want.leaf, want.step, want.microbatch, want.sticky)
    assert got.describe() == want.describe()


def test_grad_fault_fires_only_at_its_step_and_names_the_leaves():
    grads = {"a": {"w": torch.ones(2, 2)}, "b": torch.ones(3)}
    spec = faults.parse_fault("nan:a/w:2")
    assert faults.apply_grad_fault(spec, grads, 1) is grads
    hit = faults.apply_grad_fault(spec, grads, 2)
    assert torch.isnan(hit["a"]["w"][0, 0]) and torch.isfinite(hit["a"]["w"][1:]).all()
    assert torch.equal(grads["a"]["w"], torch.ones(2, 2))  # the input is untouched
    assert faults.apply_grad_fault(spec, grads, 3) is grads
    sticky = faults.parse_fault("inf:a/w:2+")
    assert all(torch.isinf(faults.apply_grad_fault(sticky, grads, t)["a"]["w"][0, 0])
               for t in (2, 5, 9))
    pinned = faults.parse_fault("nan:b:1:1")
    assert faults.apply_grad_fault(pinned, grads, 1, microbatch=0) is grads
    assert torch.isnan(faults.apply_grad_fault(pinned, grads, 1, microbatch=1)["b"][0])
    with pytest.raises(ValueError, match="a/w"):
        faults.apply_grad_fault(faults.parse_fault("nan:no/such/leaf:0"), grads, 0)
    assert faults.apply_grad_fault(None, grads, 0) is grads
    rank0, rank1 = SimpleNamespace(rank=0), SimpleNamespace(rank=1)
    assert faults.wire_fault_for(None, "k", 0, rank0) is None
    assert faults.wire_fault_for(spec, "k", 0, rank0) is None
    flip = faults.parse_fault("bitflip:k:2")
    assert faults.wire_fault_for(flip, "other", 2, rank0) is None
    q, scale = torch.ones(2, 512, dtype=torch.int8), torch.full((2, 1), 0.5)
    for step, comm, fires in ((2, rank0, True), (2, rank1, False), (1, rank0, False)):
        q2, s2 = faults.wire_fault_for(flip, "k", step, comm)(q, scale)
        assert q2 is q and torch.equal(scale, torch.full((2, 1), 0.5))  # input untouched
        want = scale.clone()
        if fires:  # bit 30 of the first scale, rank 0's outgoing wire only
            want.view(torch.int32)[0, 0] ^= 1 << 30
        assert torch.equal(s2.view(torch.int32), want.view(torch.int32))


# ---------------------------------------------------------------------------
# the anomaly ladder
# ---------------------------------------------------------------------------

def _ladder(monitor_cls, events, **kw):
    mon = monitor_cls(leaf_names=["embed/w", "blk/w"], **kw)
    out = [mon.record(t, loss, skipped=skipped, flags=flags)
           for t, (loss, skipped, flags) in enumerate(events)]
    return out, mon.post_mortem(), mon.rewinds, mon.skips, mon.spikes


_NAN, _INF = float("nan"), float("inf")
_SEQUENCES = {
    "skip_budget": ([(2.0, False, None), (_NAN, True, [0.0, 1.0]), (2.0, True, None),
                     (2.0, True, [1.0, 0.0])], dict(skip_budget=2, rewind_budget=2)),
    "healthy_resets": ([(2.0, False, None), (2.0, True, None), (2.0, True, None),
                        (2.0, False, None), (2.0, True, None)], dict(skip_budget=2)),
    "nonfinite_loss": ([(2.0, False, None), (_INF, False, None), (_NAN, False, None)],
                       dict(skip_budget=1)),
    "spike": ([(2.0 + 0.01 * t, False, None) for t in range(8)] + [(20.0, False, None)],
              dict(warmup_steps=4, abs_factor=3.0)),
    "drop": ([(5.0, False, None)] * 6 + [(0.01, False, None)], dict(warmup_steps=2)),
    "abort": ([(2.0, False, None), (2.0, True, None), (2.0, True, None)],
              dict(skip_budget=0, rewind_budget=1)),
}


def _random_sequences(n=40, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        events = []
        for _ in range(int(rng.integers(5, 30))):
            r = rng.random()
            loss = float(3.0 + rng.normal() * 0.1)
            if r < 0.1:
                loss = float(rng.choice([_NAN, _INF, 40.0, 0.5]))
            skipped = bool(rng.random() < 0.15)
            flags = (rng.random(2) > 0.5).astype(np.float32).tolist() if skipped else None
            events.append((loss, skipped, flags))
        kw = dict(skip_budget=int(rng.integers(0, 4)), rewind_budget=int(rng.integers(0, 3)),
                  warmup_steps=int(rng.integers(1, 6)), spike_k=float(rng.uniform(2, 8)))
        out.append((events, kw))
    return out


@pytest.mark.parametrize("name", list(_SEQUENCES) + ["random"])
def test_anomaly_monitor_answers_as_jax_does(name):
    cases = _random_sequences() if name == "random" else [_SEQUENCES[name]]
    for events, kw in cases:
        want = _ladder(JaxAnomalyMonitor, events, **kw)
        got = _ladder(AnomalyMonitor, events, **kw)
        assert repr(got) == repr(want)
    if name == "skip_budget":
        assert got[0] == ["ok", "skip", "skip", "rewind"] and "blk/w" in got[1]


def test_hang_guard_writes_the_snapshot_when_the_deadline_passes(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.snapshot(3, {"w": torch.ones(4)}, data_step=3)
    fired = []
    guard = HangGuard(0.05, lambda: fired.append(mgr.emergency_save()))
    guard.arm()
    time.sleep(0.5)
    guard.stop()
    assert guard.fired and fired == [3] and mgr.latest_step() == 3
    mon = StepTimeMonitor(warmup_steps=2)
    assert not any(mon.record(t, 1.0) for t in range(5)) and mon.record(5, 10.0)
    dog = Watchdog(10.0, lambda: fired.append("late"))
    dog.pet()
    dog.stop()
    assert fired == [3]


# ---------------------------------------------------------------------------
# the guard
# ---------------------------------------------------------------------------

def test_finite_guard_flags_equal_jax():
    rng = np.random.default_rng(0)
    grads = {"a": {"w": rng.standard_normal((3, 4)).astype(np.float32)},
             "b": {"w": rng.standard_normal((2, 5)).astype(np.float32)},
             "c": rng.standard_normal((7,)).astype(np.float32),
             "d": np.full((2, 2), 1e30, np.float32)}  # finite, its square overflows
    grads["b"]["w"][1, 2] = np.nan
    grads["c"][0] = np.inf
    want = jax_pipeline.finite_guard(jax.tree_util.tree_map(jnp.asarray, grads))
    got = pipeline.finite_guard(tree_from_numpy(grads))
    assert got.flags.tolist() == np.asarray(want.flags).tolist() == [True, False, False, False]
    assert bool(got.ok) == bool(want.ok) is False
    assert pipeline.guard_flag_names(grads) == [p for p, _ in jax_tree_paths(grads)]
    clean = {"a": torch.ones(2)}
    info = pipeline.finite_guard(clean)
    assert bool(info.ok) and info.flags.tolist() == [True]


def test_guarded_step_skips_bitwise():
    """A NaN gradient at step 1 leaves params and optimizer state bit for bit
    as they were, and the next healthy step goes on exactly as if the bad
    step never ran."""
    cfg = get_config("gpt2-60m").reduced()
    params = init_params(cfg, seed=0, device="cpu")
    opt = mixed_optimizer("rmnp", constant(1e-2), constant(1e-2), fused_apply=True)
    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (2, 16), generator=gen, dtype=torch.int32)
    batch = {"tokens": toks, "labels": toks}
    guarded = make_train_step(cfg, opt, remat="none", guard=True,
                              fault=faults.parse_fault("nan:*:1"))
    clean = make_train_step(cfg, opt, remat="none")
    p_g, s_g = params, opt.init(params)
    p_c, s_c = params, opt.init(params)
    for t in range(3):
        before = (p_g, s_g)
        p_g, s_g, m = guarded(p_g, s_g, batch, t)
        assert float(m["skipped"]) == (1.0 if t == 1 else 0.0), t
        if t == 1:
            _assert_trees_bitwise(before, (p_g, s_g))
            assert m["guard_flags"].tolist() == [0.0] + [1.0] * (len(tree_paths(params)) - 1)
        else:
            p_c, s_c, _ = clean(p_c, s_c, batch, t)
    assert float(m["guard_flags"].min()) == 1.0
    _assert_trees_bitwise((p_c, s_c), (p_g, s_g))


def test_guarded_trajectory_with_a_nan_step_follows_jax():
    """Reduced gpt2, single-pass RMNP, ``nan:*:1`` under the guard, 3 steps
    in both packages from JAX's init: the same steps skip and the rest
    agree within the train parity tolerance."""
    jcfg = jax_get_config("gpt2-small").reduced()
    cfg = get_config("gpt2-small").reduced()
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    params = tree_from_numpy(_np(jparams))

    def config(cos):
        return dict(lr_matrix=cos(2e-2, 3), lr_adamw=cos(1e-2, 3), fused=True, fused_apply=True)
    jopt, opt = jax_make_optimizer("rmnp", config(jax_cosine)), make_optimizer(
        "rmnp", config(cosine_with_warmup))
    jstep = jax.jit(jax_make_train_step(jcfg, jopt, remat="none", guard=True,
                                        fault=jax_faults.parse_fault("nan:*:1")))
    step = make_train_step(cfg, opt, remat="none", guard=True,
                           fault=faults.parse_fault("nan:*:1"))
    jstate, state = jopt.init(jparams), opt.init(params)
    stream = jax_make_stream(jcfg, 16, 2, seed=0)
    for t in range(3):
        b = next(stream)
        jparams, jstate, jm = jstep(jparams, jstate, {k: jnp.asarray(v) for k, v in b.items()}, t)
        params, state, m = step(params, state, {k: torch.from_numpy(v) for k, v in b.items()}, t)
        assert float(m["skipped"]) == float(jm["skipped"]) == float(t == 1)
        assert m["guard_flags"].tolist() == np.asarray(jm["guard_flags"]).tolist()
        if t != 1:
            np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-6, atol=0)
    for (path, a), (_, b) in zip(jax_tree_paths(_np((jparams, jstate))),
                                 tree_paths((params, state)), strict=True):
        w = np.asarray(a, np.float32)
        np.testing.assert_allclose(to_numpy(b), w, rtol=0,
                                   atol=1e-5 * max(float(np.abs(w).max()), 1e-30),
                                   err_msg=path)


# ---------------------------------------------------------------------------
# resume and the ladder through the driver
# ---------------------------------------------------------------------------

def _run(arch, **kw):
    base = dict(batch=2, seq=16, seed=11, log_every=100, device="cpu", fused=True,
                fused_apply=True, lr_matrix=2e-2, lr_adamw=1e-2)
    return train(arch, **{**base, **kw})


@pytest.mark.parametrize("arch", ["gpt2-small", "llama-130m"])
def test_crash_restart_bitwise_exact(arch, tmp_path):
    """Stop at step 4 of 8 with a checkpoint every 2 steps, restart: the
    resumed run's parameters and optimizer state equal the uninterrupted
    run's bit for bit."""
    p_ref, s_ref, _ = _run(arch, steps=8)
    _run(arch, steps=8, stop_at=4, ckpt_dir=str(tmp_path), ckpt_every=2)
    assert CheckpointManager(str(tmp_path)).latest_step() == 4
    p_res, s_res, hist = _run(arch, steps=8, ckpt_dir=str(tmp_path), ckpt_every=2,
                              log_every=1)
    assert [h["step"] for h in hist] == [4, 5, 6, 7]
    _assert_trees_bitwise((p_ref, s_ref), (p_res, s_res))


def test_sigkill_restart_bitwise_exact(tmp_path):
    """``kill_at`` SIGKILLs a driver process after step 3 with the step-3
    save in flight; the restart removes the torn write, resumes from the
    last committed step and ends bit for bit where an uninterrupted run
    does."""
    kw = dict(steps=6, ckpt_every=3)
    code = ("import sys; from repro_torch.launch.train import train; "
            f"train('gpt2-small', batch=2, seq=16, seed=11, log_every=100, device='cpu', "
            f"fused=True, fused_apply=True, lr_matrix=2e-2, lr_adamw=1e-2, steps=6, "
            f"ckpt_every=1, kill_at=4, ckpt_dir=sys.argv[1])")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", code, str(tmp_path)], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == -signal.SIGKILL, r.stderr[-2000:]
    assert "SIGKILL at step 4" in r.stdout
    p_ref, s_ref, _ = _run("gpt2-small", **kw)
    with pytest.warns(RuntimeWarning) if list(tmp_path.glob(".tmp_step_*")) else _nothing():
        p_res, s_res, _ = _run("gpt2-small", ckpt_dir=str(tmp_path), **kw)
    assert not list(tmp_path.glob(".tmp_step_*"))
    _assert_trees_bitwise((p_ref, s_ref), (p_res, s_res))


class _nothing:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_guard_ladder_rewinds_to_last_known_good(tmp_path):
    """A sticky NaN from step 3 skips steps 3 and 4; the second skip
    exhausts ``anomaly_skip_budget=1`` and the run rewinds to the newest
    last-known-good checkpoint with the fault disarmed and the learning
    rates halved, then runs to the end."""
    _, _, hist = _run("gpt2-small", steps=6, guard=True, inject_fault="nan:*:3+",
                      ckpt_dir=str(tmp_path), ckpt_every=1, anomaly_skip_budget=1,
                      anomaly_health_window=1, log_every=1)
    actions = [(h["step"], h.get("action")) for h in hist]
    rewind = [h for h in hist if h.get("action") == "rewind"]
    assert actions[:5] == [(0, "ok"), (1, "ok"), (2, "ok"), (3, "skip"), (4, "rewind")]
    assert rewind[0]["rewind_to"] == 2 and rewind[0]["lr_scale"] == 0.5
    assert [s for s, a in actions[5:]] == [2, 3, 4, 5]
    assert all(a == "ok" for _, a in actions[5:])


def test_guard_ladder_aborts_past_its_rewind_budget(tmp_path):
    with pytest.raises(RuntimeError, match="ladder exhausted at step 1"):
        _run("gpt2-small", steps=4, guard=True, inject_fault="nan:*:1+",
             anomaly_skip_budget=0, anomaly_rewind_budget=0, ckpt_dir=str(tmp_path),
             ckpt_every=1)
