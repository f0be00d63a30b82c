"""Multi-rank scenarios of the port's model axis, run by
``tests/test_torch_model_axis*.py``.

Each scenario runs on every rank of a ``data x model`` gloo world of
``torch.multiprocessing`` workers (``spawn``) that meet on a ``FileStore``
(``distributed/comm.file_world``), and writes each rank's results as
``.npz`` into the test's directory; the tests hold the claims (against the
JAX package in the parent process). This module imports torch and the port
only, never JAX. A rank that raises writes ``error_<scenario>_<rank>.txt``
and the parent fails with it.
"""
from __future__ import annotations

import os
import sys
import traceback
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
LR = dict(lr_matrix=2e-2, lr_adamw=1e-2)


def _entry(name, rank, dims, store, out, args):
    sys.path.insert(0, str(ROOT / "src"))
    torch.set_num_threads(1)
    import warnings
    warnings.simplefilter("ignore", FutureWarning)  # all_gather_into_tensor's
    try:
        from repro_torch.distributed.comm import file_world
        from repro_torch.launch.mesh import make_local_world
        world = file_world(store, rank, make_local_world(*dims))
        globals()[name](world, Path(out), *args)
        torch.distributed.destroy_process_group()
    except Exception:  # noqa: BLE001 — reported to the parent, which fails
        Path(out, f"error_{name}_{rank}.txt").write_text(traceback.format_exc())
        os._exit(1)


def spawn(name, dims, out, *args, timeout=300):
    """Run scenario ``name`` on a ``dims = (data, model)`` world; raise with
    the ranks' tracebacks unless every rank exits 0."""
    import torch.multiprocessing as mp
    out = Path(out)
    out.mkdir(parents=True, exist_ok=True)
    n = dims[0] * dims[1]
    store = out / f"store_{name}_{os.getpid()}_{len(list(out.iterdir()))}"
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_entry, args=(name, r, dims, str(store), str(out), args))
             for r in range(n)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout)
    codes = [p.exitcode for p in procs]
    for p in procs:
        if p.is_alive():
            p.kill()
    errors = sorted(out.glob(f"error_{name}_*.txt"))
    if errors or any(c != 0 for c in codes):
        raise AssertionError(f"scenario {name} on {dims}: exit codes {codes}\n"
                             + "\n".join(e.read_text() for e in errors))


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _np(t):
    t = t.detach().cpu()
    return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.float().numpy()


def _flat(prefix, tree):
    from repro_torch.core.types import tree_paths
    return {f"{prefix}:{p}": _np(t) for p, t in tree_paths(tree)}


def reduced(get_config, arch, overrides):
    """``get_config(arch).reduced(**overrides)`` (either package's
    ``get_config``), an override ``moe`` a dict of fields replaced on the
    reduced config's ``MoEConfig``."""
    import dataclasses
    overrides = dict(overrides)
    moe = overrides.pop("moe", None)
    cfg = get_config(arch).reduced(**overrides)
    if moe:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe))
    return cfg


def _config(arch, overrides):
    from repro_torch.configs import get_config
    return reduced(get_config, arch, overrides)


def _whole_params(path):
    from repro_torch.interop import tree_from_numpy
    data = np.load(path)
    tree = {}
    for key in data.files:
        node = tree
        *head, leaf = key.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[leaf] = data[key]
    return tree_from_numpy(tree)


def _rows(x, world):
    n = x.shape[0] // world.data.world
    return x[world.data.rank * n:(world.data.rank + 1) * n]


# ---------------------------------------------------------------------------
# scenarios
# ---------------------------------------------------------------------------

def parity(world, out, arch, overrides, params_path, tokens_path, prompt_len):
    """The model-axis port on this rank's shards of the given (JAX) params:
    loss and gradients on the rank's data rows, the prefill's last logits
    and cache over the first ``prompt_len`` tokens, then one decode step a
    following token, teacher-forced."""
    from repro_torch.distributed import tensor_parallel as tp
    from repro_torch.interop import shard_params
    from repro_torch.launch.serve import place_cache
    from repro_torch.models.model import init_cache
    from repro_torch.train import pipeline
    from repro_torch.train.step import make_prefill_step, make_serve_step

    cfg = _config(arch, overrides)
    params = shard_params(_whole_params(params_path), cfg, world.mesh, world.model.rank)
    toks = _rows(torch.from_numpy(np.load(tokens_path)), world)
    T = prompt_len
    S = toks.shape[1] - 1
    res = {}
    with tp.use(tp.axis_for(cfg, world)):
        grads, metrics = pipeline.grads_of(cfg, params, {"tokens": toks[:, :S],
                                                         "labels": toks[:, 1:]}, "full")
    res["loss"] = _np(metrics["loss"])
    res.update(_flat("grad", grads))
    last, cache = make_prefill_step(cfg, world)(params, {"tokens": toks[:, :T]})
    res["prefill_logits"] = _np(last)
    res.update(_flat("prefill_cache", cache))
    full = init_cache(cfg, toks.shape[0], S, device="cpu", world=world.mesh)
    cache = place_cache(full, cache, cfg, world, T, S)
    decode = make_serve_step(cfg, world, cache_len=S)
    for i, pos in enumerate(range(T, S)):
        _, logits, cache = decode(params, cache, toks[:, pos:pos + 1], pos)
        res[f"decode_logits_{i}"] = _np(logits[:, 0])
    np.savez(out / f"parity_{world.rank}.npz", **res)


def in_turn(world, out, jobs):
    """Each ``(scenario, directory, *args)`` of ``jobs`` in turn on one
    world, writing into its own directory."""
    del out
    for name, directory, *args in jobs:
        globals()[name](world, Path(directory), *args)


def steps(world, out, arch, overrides, params_path, tokens_path, n_steps, tag):
    """``n_steps`` mixed-RMNP single-pass steps of the ZeRO-2 step over the
    data group on the rank's model shards; each step's batch is the next
    rows of the tokens file."""
    from repro_torch.core import make_optimizer
    from repro_torch.distributed import tensor_parallel as tp
    from repro_torch.interop import shard_params
    from repro_torch.train.dp_step import init_dp_state, make_dp_train_step

    cfg = _config(arch, overrides)
    params = shard_params(_whole_params(params_path), cfg, world.mesh, world.model.rank)
    axis = tp.axis_for(cfg, world)
    D = world.data.world
    opt = make_optimizer("rmnp", dict(LR, shard_axis=world.data, shard_size=D))
    step = make_dp_train_step(cfg, opt, world.data, zero2=True, compress=False,
                              remat="full", world=world)
    with tp.use(axis):
        state, comp = init_dp_state(opt, params, world.data, shard_state=True)
    toks = torch.from_numpy(np.load(tokens_path))
    res = {}
    for i in range(n_steps):
        batch = {"tokens": toks[i, :, :-1], "labels": toks[i, :, 1:]}
        params, state, comp, m = step(params, state, comp, batch, i)
        res[f"loss_{i}"] = _np(m["loss"])
        res[f"grad_norm_{i}"] = _np(m["grad_norm"])
    res.update(_flat("param", params))
    np.savez(out / f"steps_{tag}_{world.rank}.npz", **res)


def world_one(world, out, arch, overrides, tokens_path):
    """The model-axis code on a world of one against the single-rank code,
    in the same process from the same seed: three mixed-RMNP steps (fp32
    and bf16 momentum, single-pass and two-pass), three steps of Muon
    (per leaf) and of NorMuon (bucketed), which run whole leaves at one
    rank, prefill and decode."""
    from repro_torch.core import make_optimizer
    from repro_torch.distributed import tensor_parallel as tp
    from repro_torch.launch.serve import generate
    from repro_torch.models.model import init_params
    from repro_torch.train.step import make_train_step

    cfg = _config(arch, overrides)
    toks = torch.from_numpy(np.load(tokens_path))
    res = {}
    for tag, w in (("single", None), ("axis", world)):
        params = init_params(cfg, 0, "cpu", world=None if w is None else w.mesh)
        axis = tp.axis_for(cfg, w)
        runs = {f"{md}_{'apply' if fa else 'two_pass'}":
                ("rmnp", dict(fused_apply=fa, fused=True, momentum_dtype=md))
                for md in ("float32", "bfloat16") for fa in (True, False)}
        runs.update(muon=("muon", {}), normuon=("normuon", dict(fused_apply=True)))
        for key, (kind, config) in runs.items():
            opt = make_optimizer(kind, dict(LR, **config))
            step = make_train_step(cfg, opt, remat="full", world=w)
            with tp.use(axis):
                p, state = params, opt.init(params)
            for i in range(3):
                p, state, m = step(p, state, {"tokens": toks[i, :, :-1],
                                              "labels": toks[i, :, 1:]}, i)
            res.update(_flat(f"{tag}:{key}:param", p))
            res[f"{tag}:{key}:loss"] = _np(m["loss"])
        gen = generate(cfg, params, toks[0, :, :8], 4, keep_logits=True, world=w)
        for i, lg in enumerate(gen["logits"]):
            res[f"{tag}:gen_logits_{i}"] = _np(lg)
    np.savez(out / f"world_one_{world.rank}.npz", **res)
