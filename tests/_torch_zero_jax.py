"""The JAX side of the port's ZeRO tests, run in a subprocess with four CPU
devices (``XLA_FLAGS=--xla_force_host_platform_device_count=4``, set by the
caller before JAX starts):

    python tests/_torch_zero_jax.py dp DIR        params, 2- and 4-device
                                                  ZeRO-2 steps, a checkpoint
    python tests/_torch_zero_jax.py moe DIR       the same 4-device steps for
                                                  reduced deepseek-v2-lite-16b
                                                  and olmoe-1b-7b
    python tests/_torch_zero_jax.py crs DIR       the int8 functions on 4
                                                  devices (DIR/crs_in.npz)
    python tests/_torch_zero_jax.py restore DIR   restore DIR/port_ckpt

Results go to ``.npz`` files in DIR, keyed by the JAX package's tree paths.
Nothing here edits a file of the JAX package.
"""
from __future__ import annotations

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as P

from repro.checkpoint.manager import CheckpointManager
from repro.configs import get_config
from repro.core import make_optimizer
from repro.core.types import tree_paths
from repro.data.pipeline import make_stream
from repro.distributed import compression, elastic
from repro.models import init_params
from repro.train.dp_step import init_dp_state, make_dp_train_step

LR = dict(lr_matrix=2e-2, lr_adamw=1e-2)
BATCH, SEQ = 8, 16
# the MoE archs whose ZeRO-2 step the port is held against (reduced: MLA
# with a dense prefix layer; qk_norm GQA; each with 4 experts, top-2)
MOE_ARCHS = ("deepseek-v2-lite-16b", "olmoe-1b-7b")


def _flat(prefix, tree):
    return {f"{prefix}{p}": np.asarray(x) for p, x in tree_paths(tree)}


def _save(path, **trees):
    arrays = {}
    for name, tree in trees.items():
        arrays.update(_flat(f"{name}:", tree))
    np.savez(path, **arrays)


def _mesh(n):
    return jax.make_mesh((n,), ("data",), devices=jax.devices()[:n])


def _setup(n, arch="gpt2-small"):
    cfg = get_config(arch).reduced()
    params = init_params(cfg, jax.random.PRNGKey(0))
    opt = make_optimizer("rmnp", dict(LR, fused_apply=True, shard_axis="data",
                                      shard_size=n))
    return cfg, params, opt


def _batch(cfg, t):
    return {k: jnp.asarray(v) for k, v in make_stream(cfg, SEQ, BATCH, seed=0).sample(t).items()}


def _dp_steps(out: Path, cfg, params, opt, n, compress, steps, prefix):
    """``steps`` n-device ZeRO-2 steps from ``params``; the final params,
    state and residuals to ``<prefix>_n<n>.npz``, the grad norms beside."""
    mesh = _mesh(n)
    st, comp = opt.init(params), init_dp_state(params, n)
    fn = jax.jit(make_dp_train_step(cfg, opt, mesh, zero2=True, opt_state=st,
                                    compress=compress, clip_norm=1.0, overlap=True))
    p, norms = params, []
    with mesh:
        for t in range(steps):
            p, st, comp, m = fn(p, st, comp, _batch(cfg, t), jnp.int32(t))
            norms.append(np.asarray(m["grad_norm"]))
    _save(out / f"{prefix}_n{n}.npz", p=p, s=st, c=comp)
    np.save(out / f"{prefix}_n{n}_gnorm.npy", np.stack(norms))
    return p, st, comp


def dp(out: Path):
    cfg, params, _ = _setup(1)
    np.savez(out / "params.npz", **{p: np.asarray(x) for p, x in tree_paths(params)})
    for n in (2, 4):
        _, _, opt = _setup(n)
        for compress, steps in ((False, 2), (True, 1)):
            p, st, comp = _dp_steps(out, cfg, params, opt, n, compress, steps,
                                    f"jax_{'int8' if compress else 'exact'}")
            if compress and n == 4:
                mgr = CheckpointManager(str(out / "jax_ckpt"), async_save=False)
                mgr.save(1, (p, st, comp), data_step=1, layout=elastic.state_layout(
                    opt, p, mesh_size=n, rule="rmnp", compress=True, opt_state=st))
                _save(out / "jax_ckpt_state.npz", p=p, s=st, c=comp)


def moe(out: Path):
    """Each MoE arch's params, two exact-wire and one int8-wire 4-device
    ZeRO-2 steps (the expert stacks join the sharded buckets)."""
    for arch in MOE_ARCHS:
        cfg, params, opt = _setup(4, arch)
        np.savez(out / f"params_{arch}.npz",
                 **{p: np.asarray(x) for p, x in tree_paths(params)})
        for compress, steps in ((False, 2), (True, 1)):
            _dp_steps(out, cfg, params, opt, 4, compress, steps,
                      f"jax_{arch}_{'int8' if compress else 'exact'}")


def crs(out: Path):
    n = 4
    mesh = _mesh(n)
    z = np.load(out / "crs_in.npz")
    chunks = jnp.stack([jnp.asarray(z[f"chunks_{r}"]) for r in range(n)])
    leaves = jnp.stack([jnp.asarray(z[f"leaf_{r}"]) for r in range(n)])

    def body(v, leaf):
        mean, resid = compression.compressed_reduce_scatter_leaf(v[0], "data", n)
        lmean, lerr = compression.compressed_mean_leaf(leaf[0], jnp.zeros_like(leaf[0]),
                                                       "data", n)
        return mean[None], resid[None], lmean[None], lerr[None]

    f = jax.jit(shard_map(body, mesh=mesh, in_specs=(P("data"), P("data")),
                          out_specs=(P("data"),) * 4, check_rep=False))
    mean, resid, lmean, lerr = f(chunks, leaves)
    np.savez(out / "crs_jax.npz", mean=np.asarray(mean), resid=np.asarray(resid),
             lmean=np.asarray(lmean), lerr=np.asarray(lerr))


def restore(out: Path):
    n = 4
    cfg, params, opt = _setup(n)
    template = (params, opt.init(params), init_dp_state(params, n))
    state, data_step = CheckpointManager(str(out / "port_ckpt")).restore(1, template)
    assert data_step == 1
    p, st, comp = state
    _save(out / "jax_restored_port.npz", p=p, s=st, c=comp)


if __name__ == "__main__":
    {"dp": dp, "moe": moe, "crs": crs, "restore": restore}[sys.argv[1]](Path(sys.argv[2]))
