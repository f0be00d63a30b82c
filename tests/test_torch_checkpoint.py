"""Checkpoints of the port against the JAX package's, and the port's
checkpoint manager on its own.

The two packages exchange checkpoints: the files are the exchange format.
Every leaf is keyed by its tree path, so the port's paths must equal JAX's,
string for string and in order, for every kind of optimizer state. A JAX
checkpoint (fp32 state, and bf16 momentum) restores into the port bit for
bit and the port's run continues within the train parity tolerance
(tests/test_torch_train.py: losses to 1e-6 relative, parameters to 1e-5 of
each leaf's largest entry); a port checkpoint of fp32 state restores into
JAX bit for bit; and for a tree with bf16 leaves each ``leaf_<i>.npy``
member of the port's npz and its manifest (all but ``time``) equal JAX's.
JAX itself cannot restore a bf16 leaf (ROADMAP Queue 3), which
:func:`test_jax_manager_cannot_restore_a_bf16_leaf` shows.

The manager's own tests mirror ``tests/test_substrate.py::TestCheckpoint``
and ``tests/test_resilience.py::TestLastKnownGood``, plus the four storage
faults of ``repro_torch.checkpoint.faults``, each detected by name.
"""
import json
import shutil
import threading
import warnings
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JaxManager
from repro.configs import get_config as jax_get_config
from repro.core import cosine_with_warmup as jax_cosine
from repro.core import make_optimizer as jax_make_optimizer
from repro.core.engine import matrix_optimizer as jax_matrix_optimizer
from repro.core.rules import make_rule as jax_make_rule
from repro.core.rules import per_leaf_reference as jax_per_leaf_reference
from repro.core.types import tree_paths as jax_tree_paths
from repro.data.pipeline import make_stream as jax_make_stream
from repro.distributed import elastic as jax_elastic
from repro.models import init_params as jax_init_params
from repro.train.step import make_train_step as jax_make_train_step
from repro_torch.checkpoint import faults as ckpt_faults
from repro_torch.checkpoint import manager as manager_mod
from repro_torch.checkpoint.manager import CheckpointCorruptionError, CheckpointManager
from repro_torch.configs import get_config
from repro_torch.core import cosine_with_warmup, make_optimizer
from repro_torch.core.engine import matrix_optimizer
from repro_torch.core.rules import make_rule, per_leaf_reference
from repro_torch.core.types import map_with_path, tree_paths
from repro_torch.data.pipeline import make_stream
from repro_torch.distributed import elastic
from repro_torch.interop import to_numpy, tree_from_numpy
from repro_torch.train.step import make_train_step
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

STEPS, BATCH, SEQ = 4, 2, 16


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_params(dtype=None, arch="gpt2-small"):
    cfg = jax_get_config(arch).reduced()
    params = jax_init_params(cfg, jax.random.PRNGKey(0))
    if dtype is not None:
        params = jax.tree_util.tree_map(lambda x: x.astype(dtype), params)
    return cfg, params


def _bits(x):
    """A leaf's bytes, numpy or tensor, bf16 included."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu()
        return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy().tobytes()
    return np.ascontiguousarray(np.asarray(x)).tobytes()


def _assert_bitwise(want_tree, got_tree, jax_paths=True):
    want = (jax_tree_paths(want_tree) if jax_paths else tree_paths(want_tree))
    got = tree_paths(got_tree)
    assert [p for p, _ in want] == [p for p, _ in got]
    for (path, a), (_, b) in zip(want, got, strict=True):
        assert _bits(a) == _bits(b), path


# ---------------------------------------------------------------------------
# paths
# ---------------------------------------------------------------------------

_STATES = {
    "adamw": lambda m, c: m("adamw", c(False, False)),
    "rmnp-per-leaf": lambda m, c: m("rmnp", c(False, False)),
    "rmnp-bucketed": lambda m, c: m("rmnp", c(True, False)),
    "rmnp-single-pass": lambda m, c: m("rmnp", c(True, True)),
    "muon": lambda m, c: m("muon", c(False, False)),
    "normuon-slots": lambda m, c: m("normuon", c(True, False)),
}


@pytest.mark.parametrize("kind", list(_STATES))
def test_tree_paths_equal_jax(kind):
    """``tree_paths((params, opt_state))``, string for string and in order:
    a NamedTuple field is ``.field`` in both packages."""
    _, jparams = _jax_params()
    params = tree_from_numpy(_np(jparams))

    def config(cos):
        return lambda fused, fa: dict(lr_matrix=cos(1e-2, 4), lr_adamw=cos(1e-2, 4),
                                      fused=fused, fused_apply=fa)
    jstate = _STATES[kind](jax_make_optimizer, config(jax_cosine)).init(jparams)
    state = _STATES[kind](make_optimizer, config(cosine_with_warmup)).init(params)
    want = [p for p, _ in jax_tree_paths((jparams, jstate))]
    got = [p for p, _ in tree_paths((params, state))]
    assert got == want
    assert any("/.momentum/" in p for p in got) or any(p.startswith("1/.") for p in got)


@pytest.mark.parametrize("form", ["bucketed-state", "per-leaf-reference"])
def test_tree_paths_of_the_rule_states_equal_jax(form):
    """The engine's ``BucketedState`` and the per-leaf reference's
    ``PerLeafRefState``, with NorMuon's slots."""
    _, jparams = _jax_params()
    jmat = {k: v for k, v in jparams["stack"]["layer_0"]["ffn"].items()}
    mat = tree_from_numpy(_np(jmat))
    if form == "bucketed-state":
        jstate = jax_matrix_optimizer(jax_make_rule("normuon"), jax_cosine(1e-2, 4)).init(jmat)
        state = matrix_optimizer(make_rule("normuon"), cosine_with_warmup(1e-2, 4)).init(mat)
    else:
        jstate = jax_per_leaf_reference(jax_make_rule("normuon"), jax_cosine(1e-2, 4)).init(jmat)
        state = per_leaf_reference(make_rule("normuon"), cosine_with_warmup(1e-2, 4)).init(mat)
    want = [p for p, _ in jax_tree_paths(jstate)]
    assert [p for p, _ in tree_paths(state)] == want
    assert want and all(p.startswith(".") for p in want)


def test_map_with_path_names_namedtuple_fields():
    from repro_torch.core.mixed import MixedState
    seen = []
    out = map_with_path(lambda p, x: seen.append(p) or x + 1,
                        MixedState(momentum={"b": torch.ones(1), "a": torch.ones(1)},
                                   nu=[torch.zeros(1)]))
    assert isinstance(out, MixedState) and float(out.nu[0]) == 1.0
    assert sorted(seen) == [".momentum/a", ".momentum/b", ".nu/0"]


# ---------------------------------------------------------------------------
# exchange with the JAX package
# ---------------------------------------------------------------------------

def _opt_config(cos, momentum_dtype):
    return dict(lr_matrix=cos(2e-2, STEPS), lr_adamw=cos(1e-2, STEPS), fused=True,
                fused_apply=True, momentum_dtype=momentum_dtype)


def _jax_two_steps(momentum_dtype, arch="gpt2-small"):
    cfg, params = _jax_params(arch=arch)
    opt = jax_make_optimizer("rmnp", _opt_config(jax_cosine, momentum_dtype))
    step = jax.jit(jax_make_train_step(cfg, opt, remat="none"))
    state = opt.init(params)
    stream = jax_make_stream(cfg, SEQ, BATCH, seed=0)
    for t in range(2):
        params, state, _ = step(params, state,
                                {k: jnp.asarray(v) for k, v in next(stream).items()}, t)
    return cfg, opt, step, params, state, stream


@pytest.mark.parametrize("momentum_dtype", ["float32", "bfloat16"])
def test_jax_checkpoint_restores_into_the_port_bitwise(momentum_dtype, tmp_path):
    """JAX saves reduced gpt2's (params, opt_state) after two single-pass
    RMNP steps; the port restores every leaf bit for bit (bf16 momentum
    through its uint16 bits) and one more step of each agrees within the
    train parity tolerance."""
    _jax_to_port(momentum_dtype, tmp_path, "gpt2-small")


@pytest.mark.parametrize("momentum_dtype", ["float32", "bfloat16"])
def test_jax_moe_checkpoint_restores_into_the_port_bitwise(momentum_dtype, tmp_path):
    """The same with reduced deepseek-v2-lite-16b (MLA, MoE): its 4-D
    expert stacks and their momentum buckets cross bit for bit."""
    _jax_to_port(momentum_dtype, tmp_path, "deepseek-v2-lite-16b")


def _jax_to_port(momentum_dtype, tmp_path, arch):
    jcfg, jopt, jstep, jparams, jstate, jstream = _jax_two_steps(momentum_dtype, arch)
    jmgr = JaxManager(str(tmp_path), async_save=False)
    jlayout = jax_elastic.state_layout(jopt, jparams, mesh_size=1, rule="rmnp",
                                       opt_state=jstate)
    jmgr.save(2, (jparams, jstate), data_step=jstream.step, layout=jlayout)

    cfg = get_config(arch).reduced()
    opt = make_optimizer("rmnp", _opt_config(cosine_with_warmup, momentum_dtype))
    like_params = tree_from_numpy(_np(jparams))
    like = (like_params, opt.init(like_params))
    mgr = CheckpointManager(str(tmp_path))
    layout = elastic.state_layout(opt, like_params, mesh_size=1, rule="rmnp",
                                  opt_state=like[1])
    assert mgr.read_layout(2) == layout
    (params, state), step, data_step = mgr.restore_latest(like)
    assert (step, data_step) == (2, 2)
    _assert_bitwise((_np(jparams), _np(jstate)), (params, state))
    if momentum_dtype == "bfloat16":
        assert all(b.dtype == torch.bfloat16 for b in state.buckets.values())
    if arch != "gpt2-small":
        assert any(t.ndim == 4 for _, t in tree_paths(params))

    batch = next(jstream)
    assert all(np.array_equal(batch[k], v)
               for k, v in make_stream(cfg, SEQ, BATCH, start_step=data_step).sample().items())
    jparams, jstate, jm = jstep(jparams, jstate, {k: jnp.asarray(v) for k, v in batch.items()}, 2)
    params, state, m = make_train_step(cfg, opt, remat="none")(
        params, state, {k: torch.from_numpy(v) for k, v in batch.items()}, 2)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-6, atol=0)
    for (path, a), (_, b) in zip(jax_tree_paths(_np(jparams)), tree_paths(params), strict=True):
        w = np.asarray(a, np.float32)
        np.testing.assert_allclose(to_numpy(b), w, rtol=0,
                                   atol=1e-5 * float(np.abs(w).max()), err_msg=path)


def test_port_checkpoint_restores_into_jax_bitwise(tmp_path):
    """The port saves fp32 (params, opt_state) after two of its own steps;
    JAX's manager restores them into its template bit for bit."""
    _port_to_jax(tmp_path, "gpt2-small")


def test_port_moe_checkpoint_restores_into_jax_bitwise(tmp_path):
    """The same with reduced deepseek-v2-lite-16b: the expert stacks and the
    MoE buckets restore into JAX's template bit for bit."""
    _port_to_jax(tmp_path, "deepseek-v2-lite-16b")


def _port_to_jax(tmp_path, arch):
    _, jparams = _jax_params(arch=arch)
    cfg = get_config(arch).reduced()
    opt = make_optimizer("rmnp", _opt_config(cosine_with_warmup, "float32"))
    params = tree_from_numpy(_np(jparams))
    state = opt.init(params)
    step_fn = make_train_step(cfg, opt, remat="none")
    stream = make_stream(cfg, SEQ, BATCH)
    for t in range(2):
        params, state, _ = step_fn(params, state,
                                   {k: torch.from_numpy(v) for k, v in next(stream).items()}, t)
    CheckpointManager(str(tmp_path), async_save=False).save(2, (params, state),
                                                            data_step=stream.step)
    jopt = jax_make_optimizer("rmnp", _opt_config(jax_cosine, "float32"))
    (jp, js), step, data_step = JaxManager(str(tmp_path)).restore_latest(
        (jparams, jopt.init(jparams)))
    assert (step, data_step) == (2, 2)
    _assert_bitwise((jp, js), (params, state))


def _bf16_tree():
    """Reduced gpt2 in bf16 with bf16 bucketed momentum after init, plus a
    one-step-moved copy of the momentum so the buckets are not all zero."""
    cfg = jax_get_config("gpt2-small").reduced()
    jparams = jax.tree_util.tree_map(lambda x: x.astype(jnp.bfloat16),
                                     jax_init_params(cfg, jax.random.PRNGKey(3)))
    jopt = jax_make_optimizer("rmnp", _opt_config(jax_cosine, "bfloat16"))
    jstate = jopt.init(jparams)
    jstate = jstate._replace(buckets={
        k: (jax.random.normal(jax.random.PRNGKey(i), b.shape) * 1e-3).astype(b.dtype)
        for i, (k, b) in enumerate(sorted(jstate.buckets.items()))})
    return jopt, jparams, jstate


def _payloads(step_dir):
    with zipfile.ZipFile(step_dir / "shard_00000.npz") as z:
        return {n: z.read(n) for n in z.namelist()}


def test_bf16_payloads_and_manifest_equal_jax(tmp_path):
    """For a tree with bf16 leaves, the port writes each ``leaf_<i>.npy``
    member with the bytes JAX writes (a ``'<V2'`` header over the bits) and
    the same manifest but for ``time``; the port reads JAX's bf16 file bit
    for bit."""
    jopt, jparams, jstate = _bf16_tree()
    jlayout = jax_elastic.state_layout(jopt, jparams, mesh_size=1, rule="rmnp",
                                       opt_state=jstate)
    JaxManager(str(tmp_path / "jax"), async_save=False).save(
        5, (jparams, jstate), data_step=9, layout=jlayout)

    opt = make_optimizer("rmnp", _opt_config(cosine_with_warmup, "bfloat16"))
    params = tree_from_numpy(_np(jparams))
    from repro_torch.interop import mixed_state_from_numpy
    state = mixed_state_from_numpy(_np(jstate._asdict()))
    assert [p for p, _ in tree_paths((params, state))] == \
        [p for p, _ in jax_tree_paths((jparams, jstate))]
    layout = elastic.state_layout(opt, params, mesh_size=1, rule="rmnp", opt_state=state)
    assert layout == jlayout
    CheckpointManager(str(tmp_path / "port"), async_save=False).save(
        5, (params, state), data_step=9, layout=layout)

    jdir, pdir = tmp_path / "jax" / "step_000000005", tmp_path / "port" / "step_000000005"
    want, got = _payloads(jdir), _payloads(pdir)
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name] == want[name], name
    man = [json.loads((d / "manifest.json").read_text()) for d in (jdir, pdir)]
    for m in man:
        del m["time"]
    assert man[1] == man[0]
    bf16 = [f"leaf_{i}.npy" for i, leaf in enumerate(man[0]["leaves"])
            if leaf["dtype"] == "bfloat16"]
    assert len(bf16) == len(tree_paths(params)) + len(state.buckets)
    assert all(b"'descr': '<V2'" in got[name] for name in bf16)

    restored, data_step = CheckpointManager(str(tmp_path / "jax")).restore(5, (params, state))
    assert data_step == 9
    _assert_bitwise((_np(jparams), _np(jstate)), restored)


def test_jax_manager_cannot_restore_a_bf16_leaf(tmp_path):
    """A fault of the reference, recorded in ROADMAP Queue 3: JAX's
    ``_load_arrays`` assembles a bf16 leaf with ``out[idx] = piece`` from a
    ``'<V2'`` array, which numpy cannot cast, so the JAX manager cannot
    restore its own (or the port's) bf16 checkpoints. The port reads both."""
    jopt, jparams, jstate = _bf16_tree()
    JaxManager(str(tmp_path), async_save=False).save(1, (jparams, jstate))
    with pytest.raises(ValueError, match="No cast function"):
        JaxManager(str(tmp_path)).restore(1, (jparams, jstate))
    params = tree_from_numpy(_np(jparams))
    from repro_torch.interop import mixed_state_from_numpy
    state = mixed_state_from_numpy(_np(jstate._asdict()))
    restored, _ = CheckpointManager(str(tmp_path)).restore(1, (params, state))
    _assert_bitwise((_np(jparams), _np(jstate)), restored)


def test_plan_layout_equals_jax_and_a_shard_size_change_is_refused():
    _, jparams = _jax_params()
    jopt = jax_make_optimizer("rmnp", _opt_config(jax_cosine, "float32"))
    jlayout = jax_elastic.state_layout(jopt, jparams, mesh_size=1, rule="rmnp",
                                       opt_state=jopt.init(jparams))
    params = tree_from_numpy(_np(jparams))
    opt = make_optimizer("rmnp", _opt_config(cosine_with_warmup, "float32"))
    layout = elastic.state_layout(opt, params, mesh_size=1, rule="rmnp",
                                  opt_state=opt.init(params))
    assert json.dumps(layout, sort_keys=True) == json.dumps(jlayout, sort_keys=True)
    assert elastic.check_restorable(None, layout)
    assert elastic.check_restorable(jlayout, layout)
    # another shard size is refused as a plain restore and goes to the
    # elastic reshard (restore_resharded); only another layout raises
    assert not elastic.check_restorable(dict(jlayout, shard_size=4, mesh_size=4), layout)
    with pytest.raises(elastic.LayoutMismatchError, match="rule"):
        elastic.check_restorable(dict(jlayout, shard_size=4, rule="muon"), layout)


# ---------------------------------------------------------------------------
# the manager (mirrors of tests/test_substrate.py and test_resilience.py)
# ---------------------------------------------------------------------------

def test_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    state = {"w": torch.arange(12.0).reshape(3, 4), "n": torch.ones(2),
             "h": torch.arange(6.0).to(torch.bfloat16), "i": torch.arange(3, dtype=torch.int32)}
    mgr.save(7, state, data_step=70)
    restored, step, data_step = mgr.restore_latest(state)
    assert step == 7 and data_step == 70
    _assert_bitwise(state, restored, jax_paths=False)
    assert all(restored[k].dtype == state[k].dtype for k in state)


def test_restore_refuses_a_dtype_change(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(1, {"w": torch.ones(2, 2)})
    with pytest.raises(ValueError, match="refusing to cast"):
        mgr.restore(1, {"w": torch.ones(2, 2, dtype=torch.bfloat16)})
    with pytest.raises(ValueError, match="shape"):
        mgr.restore(1, {"w": torch.ones(2, 3)})


def test_uncommitted_ignored(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(1, {"w": torch.ones(2, 2)})
    d = tmp_path / "step_000000002"
    d.mkdir()
    (d / "manifest.json").write_text(json.dumps({"step": 2, "data_step": 2, "leaves": []}))
    assert mgr.latest_step() == 1


def test_retention_prunes(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=False)
    for s in (1, 2, 3, 4):
        mgr.save(s, {"w": torch.ones(2)})
    assert mgr._committed_steps() == [3, 4]


def test_torn_write_is_invisible(tmp_path, monkeypatch):
    """A save killed mid-write is a tmp dir, never a visible step; retention
    keeps the last committed step; a retried save at the same step wins;
    and a new manager on the directory removes the torn write."""
    mgr = CheckpointManager(str(tmp_path), keep=1, async_save=False)
    state = {"w": torch.arange(4.0)}
    mgr.save(1, state, data_step=10)
    real_savez = manager_mod.savez

    def torn_savez(path, arrays):
        with open(path, "wb") as f:
            f.write(b"PK\x03\x04 torn")
        raise KeyboardInterrupt("killed mid-save")

    monkeypatch.setattr(manager_mod, "savez", torn_savez)
    with pytest.raises(KeyboardInterrupt):
        mgr.save(2, {"w": torch.arange(4.0) * 2}, data_step=20)
    monkeypatch.setattr(manager_mod, "savez", real_savez)
    assert (tmp_path / ".tmp_step_000000002").exists()
    assert not (tmp_path / "step_000000002").exists()
    assert mgr.latest_step() == 1
    out, step, data_step = mgr.restore_latest(state)
    assert (step, data_step) == (1, 10)
    assert torch.equal(out["w"], state["w"])

    d = tmp_path / "step_000000005"
    d.mkdir()
    (d / "manifest.json").write_text("{}")
    mgr._prune()
    assert mgr.latest_step() == 1

    with pytest.warns(RuntimeWarning, match=".tmp_step_000000002"):
        CheckpointManager(str(tmp_path), keep=1)
    assert not list(tmp_path.glob(".tmp_step_*"))
    mgr.save(2, {"w": torch.arange(4.0) * 2}, data_step=20)
    assert mgr.latest_step() == 2
    assert mgr._committed_steps() == [2]


def test_torn_manifest_falls_back(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    state = {"w": torch.arange(4.0)}
    mgr.save(1, state, data_step=10)
    mgr.save(2, state, data_step=20)
    (tmp_path / "step_000000002" / "manifest.json").write_text("{ garbage")
    with pytest.warns(RuntimeWarning, match="manifest.json"):
        assert mgr.latest_step() == 1
    with pytest.warns(RuntimeWarning, match="manifest.json"):
        out, step, data_step = mgr.restore_latest(state)
    assert (step, data_step) == (1, 10)
    assert torch.equal(out["w"], state["w"])


def test_async_save(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    mgr.save(5, {"w": torch.ones(64, 64)})
    mgr.wait()
    assert mgr.latest_step() == 5


def test_failed_async_write_surfaces_at_the_next_save_and_wait(tmp_path, monkeypatch):
    """No silent fallback: the writer thread's failure is raised by the next
    ``save()`` (or ``wait()``), and nothing was committed."""
    mgr = CheckpointManager(str(tmp_path), async_save=True)

    def broken(path, arrays):
        raise OSError("disk full")

    monkeypatch.setattr(manager_mod, "savez", broken)
    mgr.save(1, {"w": torch.ones(4)})
    with pytest.raises(RuntimeError, match="disk full"):
        mgr.save(2, {"w": torch.ones(4)})
    mgr.save(3, {"w": torch.ones(4)})
    with pytest.raises(RuntimeError, match="disk full"):
        mgr.wait()
    assert mgr.latest_step() is None


def test_async_save_keeps_what_was_saved(tmp_path):
    """The state is copied at ``save()``: later changes to the caller's
    tensors do not reach the checkpoint, and the two buffers alternate."""
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    w = torch.arange(1000.0)
    mgr.save(1, {"w": w})
    w += 1
    mgr.save(2, {"w": w})
    w += 1
    mgr.wait()
    assert torch.equal(mgr.restore(1, {"w": w})[0]["w"], torch.arange(1000.0))
    assert torch.equal(mgr.restore(2, {"w": w})[0]["w"], torch.arange(1000.0) + 1)


def test_snapshot_and_emergency_save(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    assert mgr.emergency_save() is None
    mgr.save(1, {"w": torch.zeros(3)})
    mgr.snapshot(2, {"w": torch.ones(3)}, data_step=4)
    assert mgr.emergency_save() == 2
    assert mgr.emergency_save() is None  # nothing newer than step 2
    restored, data_step = mgr.restore(2, {"w": torch.zeros(3)})
    assert data_step == 4 and torch.equal(restored["w"], torch.ones(3))


def test_prune_pins_newest_good_step(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=False)
    state = {"w": torch.arange(8.0)}
    mgr.save(1, state, data_step=10)
    mgr.mark_good(1)
    for s in (2, 3, 4):
        mgr.save(s, state)
    assert mgr._committed_steps() == [1, 3, 4]
    assert mgr.latest_good_step() == 1
    mgr.mark_good(4)
    mgr._prune()
    assert mgr._committed_steps() == [3, 4]


def test_prune_never_deletes_mid_restore(tmp_path, monkeypatch):
    mgr = CheckpointManager(str(tmp_path), keep=1, async_save=False)
    state = {"w": torch.arange(256.0)}
    mgr.save(1, state, data_step=10)
    real = CheckpointManager._load_arrays
    entered, release = threading.Event(), threading.Event()

    def slow(self, d, manifest):
        entered.set()
        assert release.wait(10)
        return real(self, d, manifest)

    monkeypatch.setattr(CheckpointManager, "_load_arrays", slow)
    out = {}
    th = threading.Thread(target=lambda: out.update(r=mgr.restore(1, state)))
    th.start()
    assert entered.wait(10)
    monkeypatch.setattr(CheckpointManager, "_load_arrays", real)
    mgr.save(2, state)
    mgr.save(3, state)
    assert (tmp_path / "step_000000001" / "COMMITTED").exists()
    release.set()
    th.join(10)
    restored, data_step = out["r"]
    assert data_step == 10 and torch.equal(restored["w"], state["w"])
    mgr._prune()
    assert mgr._committed_steps() == [3]


def test_manifest_parse_cached(tmp_path, monkeypatch):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    state = {"w": torch.arange(4.0)}
    mgr.save(1, state, data_step=10)
    mgr.save(2, state, data_step=20)
    calls = []
    real_loads = manager_mod.json.loads

    def counting_loads(s, *a, **k):
        calls.append(1)
        return real_loads(s, *a, **k)

    monkeypatch.setattr(manager_mod.json, "loads", counting_loads)
    for _ in range(5):
        assert mgr.latest_step() == 2
        assert mgr.good_steps() == []
        assert mgr.restore_latest(state) is not None
    assert not calls, f"{len(calls)} manifest re-parses despite the cache"
    mgr.save(3, state, data_step=30)
    assert calls, "a save must invalidate the manifest cache"
    calls.clear()
    assert mgr.latest_step() == 3
    assert mgr.restore_latest(state) is not None
    assert not calls


def test_mark_good_and_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(1, {"w": torch.ones(2)})
    mgr.save(2, {"w": torch.ones(2)})
    assert mgr.latest_good_step() is None
    mgr.mark_good(1)
    assert mgr.good_steps() == [1] and mgr.latest_good_step() == 1
    mgr.mark_good(2)
    assert mgr.latest_good_step() == 2
    with pytest.raises(ValueError, match="committed"):
        mgr.mark_good(9)


def test_prune_never_drops_newest_good(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=False)
    state = {"w": torch.ones(2)}
    mgr.save(2, state)
    mgr.mark_good(2)
    for s in (4, 6, 8):
        mgr.save(s, state)
    assert mgr._committed_steps() == [2, 6, 8]
    assert mgr.latest_good_step() == 2
    _, step, _ = mgr.restore_latest(state)
    assert step == 8
    out, _ = mgr.restore(2, state)
    assert torch.equal(out["w"], torch.ones(2))


@pytest.mark.parametrize("kind,named", [
    # the zip member's own CRC-32 or the manifest's, whichever reads first
    ("bit_rot", "checksum mismatch on leaf 'b/big' shard rank 0|"
                "leaf 'b/big' shard rank 0 is truncated/unreadable"),
    ("truncated", "shard rank 0 is truncated/unreadable"),
    ("missing_shard", r"missing shard file shard_00000.npz \(rank 0\)"),
    ("torn_manifest", "torn/unparseable manifest.json")])
def test_corruption_is_detected_by_name_and_restore_falls_back(kind, named, tmp_path):
    """Each storage fault on the newest step raises
    CheckpointCorruptionError naming the leaf, shard or file, and
    ``restore_latest`` falls back to the step before with a warning."""
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    gen = torch.Generator().manual_seed(0)
    old = {"a": torch.ones(3), "b": {"big": torch.randn(64, 256, generator=gen)}}
    new = {"a": torch.zeros(3), "b": {"big": torch.randn(64, 256, generator=gen)}}
    mgr.save(1, old, data_step=1)
    mgr.save(2, new, data_step=2)
    ckpt_faults.CORRUPTIONS[kind](tmp_path / "step_000000002")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with pytest.raises(CheckpointCorruptionError, match=named):
            mgr.restore(2, new)
    with pytest.warns(RuntimeWarning, match="step_000000002|manifest.json"):
        restored, step, data_step = mgr.restore_latest(new)
    assert (step, data_step) == (1, 1)
    _assert_bitwise(old, restored, jax_paths=False)


def test_torn_multi_rank_commit_is_detected(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(1, {"w": torch.ones(2)})
    (tmp_path / "step_000000001" / "shard_00000.SHARD_COMMITTED").unlink()
    with pytest.raises(CheckpointCorruptionError, match="SHARD_COMMITTED"):
        mgr.restore(1, {"w": torch.ones(2)})


def test_restore_puts_tensors_on_the_template_device(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(1, {"w": torch.ones(2)})
    restored, _ = mgr.restore(1, {"w": torch.empty(2, device="meta")})
    assert restored["w"].device.type == "meta"
    shutil.rmtree(tmp_path / "step_000000001")
    assert mgr.restore_latest({"w": torch.ones(2)}) is None
