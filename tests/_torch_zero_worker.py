"""Multi-rank scenarios of the port's ZeRO data parallelism, run by
``tests/test_torch_zero.py`` and ``tests/test_torch_compression.py``.

Each scenario runs on every rank of a gloo group of ``torch.multiprocessing``
workers (``spawn``) that meet on a ``FileStore``, and writes its results as
``.npz`` files into the test's directory; the tests hold the claims. This
module imports torch and the port only, never JAX: the JAX side runs in its
own subprocess (``tests/_torch_zero_jax.py``).
"""
from __future__ import annotations

import os
import sys
import traceback
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
RULES = ("rmnp", "muon", "normuon", "muown", "nora")
# uneven buckets under shard_size 4: 8x16 has L = 8, 8x24 L = 3 (< 4), 16x8
# L = 6; padded to 8, 4 and 8
SHAPES = {**{f"l{i}/w": (2, 8, 16) for i in range(4)},
          "odd/w": (3, 8, 24), "six/w": (6, 16, 8)}
LR = dict(lr_matrix=2e-2, lr_adamw=1e-2)
BATCH, SEQ = 8, 16


# ---------------------------------------------------------------------------
# running a scenario on N ranks
# ---------------------------------------------------------------------------

def _entry(name, rank, world, store, out, args):
    sys.path.insert(0, str(ROOT / "src"))
    torch.set_num_threads(1)
    import warnings
    warnings.simplefilter("ignore", FutureWarning)  # all_gather_into_tensor's
    try:
        from repro_torch.distributed.comm import file_comm
        comm = file_comm(store, rank, world)
        globals()[name](comm, Path(out), *args)
        torch.distributed.destroy_process_group()
    except Exception:  # noqa: BLE001 — reported to the parent, which fails
        Path(out, f"error_{name}_{rank}.txt").write_text(traceback.format_exc())
        os._exit(1)


def spawn(name, world, out, *args, timeout=300, expect_codes=(0,)):
    """Run scenario ``name`` on ``world`` gloo ranks; raise with the first
    rank's traceback unless every rank exits with one of ``expect_codes``."""
    import torch.multiprocessing as mp
    out = Path(out)
    out.mkdir(parents=True, exist_ok=True)
    store = out / f"store_{name}_{world}_{os.getpid()}_{len(list(out.iterdir()))}"
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_entry, args=(name, r, world, str(store), str(out), args))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout)
    codes = [p.exitcode for p in procs]
    for p in procs:
        if p.is_alive():
            p.kill()
    errors = sorted(out.glob(f"error_{name}_*.txt"))
    if errors or any(c not in expect_codes for c in codes):
        raise AssertionError(f"scenario {name} on {world} ranks: exit codes {codes}\n"
                             + "\n".join(e.read_text() for e in errors))


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _np(t):
    t = t.detach().cpu()
    return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _flat(prefix, tree):
    from repro_torch.core.types import tree_paths
    return {f"{prefix}{p}": _np(t) for p, t in tree_paths(tree)}


def _save(path, **trees):
    arrays = {}
    for name, tree in trees.items():
        arrays.update(_flat(f"{name}:", tree) if not torch.is_tensor(tree)
                      else {name: _np(tree)})
    np.savez(path, **arrays)


def _model(jax_dir=None, arch="gpt2-small"):
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    cfg = get_config(arch).reduced()
    if jax_dir is None:
        return cfg, init_params(cfg, seed=0, device="cpu")
    from repro_torch.core.types import map_with_path
    z = np.load(Path(jax_dir) / "params.npz")
    like = init_params(cfg, seed=0, device="cpu")
    return cfg, map_with_path(lambda p, _t: torch.from_numpy(z[p].copy()), like)


def _batches(cfg, n=2, batch=BATCH):
    from repro_torch.data.pipeline import make_stream
    stream = make_stream(cfg, SEQ, batch, seed=0)
    return [{k: torch.from_numpy(v) for k, v in stream.sample(t).items()} for t in range(n)]


def _opt(comm, rule="rmnp", shard_size=None):
    from repro_torch.core import make_optimizer
    return make_optimizer(rule, dict(LR, fused_apply=True, shard_axis=comm,
                                     shard_size=shard_size or comm.world))


MODES = {  # name: (shard_state, zero2, overlap)
    "z0": (False, False, None), "z1": (True, False, None),
    "z2s": (True, True, False), "z2p": (True, True, True)}


def _run_dp(comm, cfg, params, batches, mode, *, rule="rmnp", compress=False,
            accum=1, clip_norm=0.5, guard=False, fault=None, steps=2, keep_steps=False):
    """``steps`` dp steps of ``mode`` from ``params``; returns (params, full
    opt state, this rank's residual, metrics per step[, state per step])."""
    from repro_torch.distributed.sharding import gather_state
    from repro_torch.train.dp_step import init_dp_state, make_dp_train_step
    shard_state, zero2, overlap = MODES[mode]
    opt = _opt(comm, rule)
    st, comp = init_dp_state(opt, params, comm, shard_state=shard_state)
    fn = make_dp_train_step(cfg, opt, comm, clip_norm=clip_norm, compress=compress,
                            shard_state=shard_state, zero2=zero2, accum=accum,
                            overlap=overlap, guard=guard, fault=fault)
    p, ms, seen = params, [], []
    for t in range(steps):
        p, st, comp, m = fn(p, st, comp, batches[t % len(batches)], t)
        ms.append(m)
        seen.append((p, gather_state(st, opt.bucket_plan(p), comm), comp))
    out = (p, gather_state(st, opt.bucket_plan(p), comm), comp, ms)
    return out + (seen,) if keep_steps else out


# ---------------------------------------------------------------------------
# scenarios
# ---------------------------------------------------------------------------

def synthetic(comm, out):
    """The optimizer alone on the uneven synthetic tree, every rule, two
    steps: replicated, ZeRO-1 (full gradient, sharded state) and ZeRO-2
    (reduce-scattered gradient shards)."""
    from repro_torch.core import bucketing, constant
    from repro_torch.core.engine import matrix_optimizer
    from repro_torch.core.rules import make_rule
    from repro_torch.distributed.compression import exact_reduce_scatter
    from repro_torch.distributed.sharding import gather_state, shard_state

    def tree(seed):
        g = torch.Generator().manual_seed(seed)
        return {k.split("/")[0]: {"w": torch.randn(s, generator=g)}
                for k, s in sorted(SHAPES.items())}

    params = tree(0)
    res = {}
    for rule in RULES:
        r = make_rule(rule, beta=0.9)
        rep = matrix_optimizer(r, constant(0.1), fused_apply=True)
        sh = matrix_optimizer(r, constant(0.1), shard_axis=comm, shard_size=comm.world)
        p_r, s_r = params, rep.init(params)
        p1 = p2 = params
        s1 = s2 = shard_state(sh.init(params), comm)
        local = {k: list(v.shape) for k, v in s2.buckets.items()}
        for t in range(2):
            grads = tree(10 + t + 100 * comm.rank)  # each rank its own gradient
            mean = {k: {"w": comm.all_reduce(v["w"]) / comm.world} for k, v in grads.items()}
            p_r, s_r = rep.update_apply(mean, s_r, p_r, t)
            p1, s1 = sh.update_apply(mean, s1, p1, t)
            plan = sh.bucket_plan(p2)
            chunks = bucketing.gather_chunks(plan, grads, comm.world, dtype=torch.float32)
            shards = {k: exact_reduce_scatter(v, comm) for k, v in chunks.items()}
            p2, s2 = sh.update_apply_sharded(shards, None, s2, p2, t)
        plan = sh.bucket_plan(params)
        if rule == "rmnp":
            _bucket_helpers(comm, out, plan, mean, params, tree(20 + comm.rank))
        res[rule] = dict(rep_p=p_r, rep_s=s_r, z1_p=p1, z2_p=p2,
                         z1_s=gather_state(s1, plan, comm), z2_s=gather_state(s2, plan, comm))
        if comm.rank == 0:
            np.savez(out / f"synthetic_{rule}_local.npz",
                     **{k: np.array(v) for k, v in local.items()})
            _save(out / f"synthetic_{rule}.npz", **res[rule])


def _bucket_helpers(comm, out, plan, mean, params, local):
    """``bucketing.bucket_update_apply`` (ZeRO-1) and
    ``bucket_update_apply_sharded`` (ZeRO-2) against the engine's
    ``bucket_apply`` and ``bucket_apply_sharded``, bucket by bucket."""
    from repro_torch.core import bucketing, constant
    from repro_torch.core.engine import BucketedEngine
    from repro_torch.core.rules import RmnpRule
    from repro_torch.distributed.compression import exact_reduce_scatter
    eng = BucketedEngine(RmnpRule(beta=0.9), constant(0.1), shard_axis=comm,
                         shard_size=comm.world, strict=True)
    g = bucketing.gather(plan, mean, dtype=torch.float32)
    w = bucketing.gather(plan, params)
    g_sh = {k: exact_reduce_scatter(v, comm) for k, v in bucketing.gather_chunks(
        plan, local, comm.world, dtype=torch.float32).items()}
    w_sh = bucketing.gather_chunks(plan, params, comm.world, only=comm.rank)
    v = {k: t + 0.5 for k, t in bucketing.gather_chunks(
        plan, local, comm.world, only=comm.rank).items()}
    same = []
    for b in plan.buckets:
        kw = dict(scale=eng.scale(b, 1), weight_decay=0.1, beta=0.9, eps=1e-8,
                  shard_axis=comm)
        a = bucketing.bucket_update_apply(b, g[b.key], v[b.key], w[b.key], **kw)
        e = eng.bucket_apply(b, g[b.key], v[b.key], {}, w[b.key], 1)
        a2 = bucketing.bucket_update_apply_sharded(b, g_sh[b.key], v[b.key], w_sh[b.key], **kw)
        e2 = eng.bucket_apply_sharded(b, g_sh[b.key], v[b.key], {}, w_sh[b.key], 1)
        same += [torch.equal(a[0], e[0]) and torch.equal(a[1], e[1]),
                 torch.equal(a2[0], e2[0]) and torch.equal(a2[1], e2[1])]
    np.save(out / f"bucket_helpers_r{comm.rank}.npy", np.array(same))


def dp_rules(comm, out):
    """Every rule through the dp step on reduced gpt2, two steps with the
    clip active, exact wire: ZeRO-0, ZeRO-1, ZeRO-2 serialized and
    pipelined."""
    cfg, params = _model()
    batches = _batches(cfg)
    for rule in RULES:
        for mode in MODES:
            p, st, _, ms = _run_dp(comm, cfg, params, batches, mode, rule=rule)
            if comm.rank == 0:
                _save(out / f"dp_{rule}_{mode}.npz", p=p, s=st,
                      gnorm=torch.stack([m["grad_norm"] for m in ms]),
                      clip=torch.stack([m["clip_rate"] for m in ms]))


def dp_wires(comm, out):
    """RMNP on both wires and at accum 1 and 4: serialized and pipelined
    ZeRO-2 (and ZeRO-0 on the exact wire at accum 4); each rank saves its
    own residual."""
    cfg, params = _model()
    batches = _batches(cfg, batch=2 * BATCH)
    for compress in (False, True):
        for accum in (1, 4):
            modes = ("z2s", "z2p") + (("z0",) if not compress and accum == 4 else ())
            for mode in modes:
                p, st, comp, ms = _run_dp(comm, cfg, params, batches, mode,
                                          compress=compress, accum=accum)
                tag = f"{'int8' if compress else 'exact'}_a{accum}_{mode}"
                _save(out / f"wire_{tag}_r{comm.rank}.npz", c=comp)
                if comm.rank == 0:
                    _save(out / f"wire_{tag}.npz", p=p, s=st,
                          gnorm=torch.stack([m["grad_norm"] for m in ms]))


def dp_moe(comm, out):
    """Reduced deepseek-v2-lite-16b (MLA, a dense prefix layer, MoE units
    whose 4-D expert stacks ``(n_units, E, d_in, d_out)`` join the buckets)
    through the dp step, RMNP, two steps with the clip active, on both
    wires: every mode, and each rank's residual."""
    cfg, params = _model(arch="deepseek-v2-lite-16b")
    batches = _batches(cfg)
    for compress in (False, True):
        for mode in MODES:
            p, st, comp, ms = _run_dp(comm, cfg, params, batches, mode, compress=compress)
            tag = f"{'int8' if compress else 'exact'}_{mode}"
            _save(out / f"moe_{tag}_r{comm.rank}.npz", c=comp)
            if comm.rank == 0:
                _save(out / f"moe_{tag}.npz", p=p, s=st,
                      gnorm=torch.stack([m["grad_norm"] for m in ms]),
                      clip=torch.stack([m["clip_rate"] for m in ms]))


def guard(comm, out):
    """The guard on the pipelined ZeRO-2 step: a NaN at step 1 on either
    wire, and (int8) a bit-flip of a block scale on rank 0's wire at step
    1, leave params, state and residual as step 0 left them."""
    from repro_torch.train.faults import parse_fault
    cfg, params = _model()
    batches = _batches(cfg)
    for compress, spec in ((False, "nan:*:1"), (True, "nan:*:1"), (True, "bitflip:64x64:1")):
        _, _, _, ms, seen = _run_dp(comm, cfg, params, batches, "z2p", compress=compress,
                                    guard=True, fault=parse_fault(spec), keep_steps=True)
        tag = f"{'int8' if compress else 'exact'}_{spec.split(':')[0]}"
        for t, (p, st, comp) in enumerate(seen):
            _save(out / f"guard_{tag}_s{t}_r{comm.rank}.npz", p=p, s=st, c=comp,
                  skipped=ms[t]["skipped"], flags=ms[t]["guard_flags"])


def wire_fault(comm, out):
    """One int8 reduce-scatter with and without a bit-flip on rank 0's
    outgoing wire: this rank's mean shard and residual, both ways."""
    from repro_torch.distributed.compression import compressed_reduce_scatter_leaf
    from repro_torch.train.faults import parse_fault, wire_fault_for
    g = torch.Generator().manual_seed(7 + comm.rank)
    v = torch.randn(comm.world, 3, 8, 16, generator=g)
    spec = parse_fault("bitflip:8x16:0")
    clean = compressed_reduce_scatter_leaf(v, comm)
    hit = compressed_reduce_scatter_leaf(v, comm, wire_fault=wire_fault_for(spec, "8x16", 0, comm))
    np.savez(out / f"wirefault_r{comm.rank}.npz", mean=_np(clean[0]), resid=_np(clean[1]),
             mean_hit=_np(hit[0]), resid_hit=_np(hit[1]))


def compression_fns(comm, out):
    """The int8 functions on the inputs the test wrote (``crs_in.npz``: one
    ``(N, chunk, d_in, d_out)`` operand and one leaf a rank), and error
    feedback over 8 steps of one fixed gradient."""
    from repro_torch.distributed.compression import (
        compressed_mean_leaf, compressed_reduce_scatter_leaf)
    z = np.load(out / "crs_in.npz")
    v = torch.from_numpy(z[f"chunks_{comm.rank}"])
    leaf = torch.from_numpy(z[f"leaf_{comm.rank}"])
    mean, resid = compressed_reduce_scatter_leaf(v, comm)
    lmean, lerr = compressed_mean_leaf(leaf, torch.zeros_like(leaf), comm)
    # error feedback: the running sum of 8 compressed means of one gradient
    err, total = torch.zeros_like(v), torch.zeros(v.shape[1:])
    for _ in range(8):
        m, r = compressed_reduce_scatter_leaf(v + err, comm)
        err, total = r, total + m
    np.savez(out / f"crs_out_r{comm.rank}.npz", mean=_np(mean), resid=_np(resid),
             lmean=_np(lmean), lerr=_np(lerr), ef_total=_np(total), ef_err=_np(err))


def jax_dp(comm, out, jax_dir):
    """The ZeRO-2 step from the JAX package's params and batches: two steps
    on the exact wire, one on the int8 wire."""
    cfg, params = _model(jax_dir)
    batches = _batches(cfg)
    for compress, steps in ((False, 2), (True, 1)):
        p, st, _, ms = _run_dp(comm, cfg, params, batches, "z2p", compress=compress,
                               clip_norm=1.0, steps=steps)
        if comm.rank == 0:
            _save(out / f"jaxcmp_{'int8' if compress else 'exact'}_n{comm.world}.npz",
                  p=p, s=st, gnorm=torch.stack([m["grad_norm"] for m in ms]))


def _views(opt, p, st, comp, comm):
    from repro_torch.distributed import compression, sharding
    return (p, sharding.checkpoint_view(st, opt.bucket_plan(p), comm),
            compression.checkpoint_view(comp, comm))


def ckpt_save(comm, out, jax_dir):
    """A 4-rank int8 ZeRO-2 step from the JAX params, saved through the
    sharded manager; then that checkpoint and the JAX package's 4-device
    one restored onto these ranks."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.distributed import elastic
    from repro_torch.distributed.sharding import gather_state
    from repro_torch.train.dp_step import init_dp_state, make_dp_train_step
    cfg, params = _model(jax_dir)
    opt = _opt(comm)
    st, comp = init_dp_state(opt, params, comm, shard_state=True)
    fn = make_dp_train_step(cfg, opt, comm, clip_norm=1.0, compress=True, zero2=True)
    p, st, comp, _ = fn(params, st, comp, _batches(cfg)[0], 0)
    layout = elastic.state_layout(opt, p, mesh_size=comm.world, rule="rmnp",
                                  compress=True, opt_state=st)
    mgr = CheckpointManager(str(out / "port_ckpt"), comm=comm)
    mgr.save(1, _views(opt, p, st, comp, comm), data_step=1, layout=layout)
    mgr.wait()
    comm.barrier()
    full = gather_state(st, opt.bucket_plan(p), comm)
    _save(out / f"ckpt_saved_r{comm.rank}.npz", p=p, s=full, c=comp)
    for name, d in (("port", out / "port_ckpt"), ("jax", Path(jax_dir) / "jax_ckpt")):
        template = _views(opt, p, st, comp, comm)
        (rp, rs, rc), data_step = CheckpointManager(str(d), comm=comm).restore(1, template)
        _save(out / f"ckpt_{name}_restored_r{comm.rank}.npz", p=rp,
              s=gather_state(rs, opt.bucket_plan(rp), comm), c=rc)


def ckpt_restore(comm, out):
    """The 4-rank port checkpoint resumed on this group: restored as it is
    at the same size, resharded at another."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.distributed import elastic
    from repro_torch.distributed.sharding import gather_state
    from repro_torch.train.dp_step import init_dp_state
    cfg, params = _model()
    opt = _opt(comm)
    st, comp = init_dp_state(opt, params, comm, shard_state=True)
    mgr = CheckpointManager(str(out / "port_ckpt"), comm=comm)
    layout = elastic.state_layout(opt, params, mesh_size=comm.world, rule="rmnp",
                                  compress=True, opt_state=st)
    old = mgr.read_layout(1)
    if elastic.check_restorable(old, layout):
        (p, st, comp), _ = mgr.restore(1, _views(opt, params, st, comp, comm))
    else:
        (p, st, comp), _ = elastic.restore_resharded(
            mgr, 1, params, st, comp, opt_new=opt,
            opt_old=_opt(comm, shard_size=int(old["shard_size"])), comm=comm)
    _save(out / f"ckpt_on{comm.world}_r{comm.rank}.npz", p=p,
          s=gather_state(st, opt.bucket_plan(p), comm), c=comp,
          local=torch.tensor([v.shape[0] for v in st.buckets.values()]))


def driver(comm, out, ckpt_dir, tag, kw):
    """``launch.train.train(zero2=True)`` on this group (the driver reuses
    the group); rank 0 dumps the final params."""
    from repro_torch.launch.train import train
    params, _, hist = train("gpt2-small", zero2=True, device="cpu", batch=4, seq=16,
                            seed=5, log_every=1, ckpt_dir=str(ckpt_dir), **kw)
    if comm.rank == 0:
        _save(out / f"driver_{tag}.npz", p=params,
              steps=torch.tensor([h["step"] for h in hist if "step" in h]))


def all4(comm, out, jax_dir):
    """Every 4-rank scenario of ``tests/test_torch_zero.py``, in one group."""
    synthetic(comm, out)
    dp_rules(comm, out)
    dp_wires(comm, out)
    dp_moe(comm, out)
    guard(comm, out)
    wire_fault(comm, out)
    jax_dp(comm, out, jax_dir)
    ckpt_save(comm, out, jax_dir)
    ckpt_restore(comm, out)


def all2(comm, out, jax_dir):
    """The 2-rank scenarios: the JAX comparison and the 4-rank checkpoint
    resharded onto 2 ranks."""
    jax_dp(comm, out, jax_dir)
    ckpt_restore(comm, out)
