"""ZeRO data parallelism of the port (``train/dp_step.py``, ``train/pipeline.py``,
``core/engine.py``, ``core/bucketing.py``, ``distributed/``) against itself
and against the JAX package.

The port's ranks run as gloo processes (``tests/_torch_zero_worker.py``);
the JAX package's N-device functions run in a subprocess with four CPU
devices (``tests/_torch_zero_jax.py``). Each runs once per module (the
``runs`` fixture) and every claim below reads its results.

Tolerances: the port against itself is held bit for bit. Against JAX on the
exact wire, fp32 is held at ``2e-6 * |want| + 1e-6 * max|want|`` (the two
frameworks' fp32 sums differ in order; reduced models agree to about 2e-6,
ROADMAP Queue 3). On the int8 wire a gradient that differs by an fp32 ulp
can round to the neighbouring int8 code, which moves that element's mean
by one step of its block; so there the same limit holds for all but 0.05 %
of each momentum bucket's elements, and those stay within one int8 step of
the bucket (``max |v| / 127``); a parameter column whose norm such an
element enters moves with it, so at most 1 % of a leaf's parameters may
leave the fp32 limit.
"""
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_zero_worker as W
from repro.core import bucketing as jax_bucketing
from repro_torch.core import bucketing, make_optimizer
from repro_torch.configs import get_config
from repro_torch.train.dp_step import make_dp_train_step
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
RULES = W.RULES


def run_jax(mode, out):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "")
                          + " --xla_force_host_platform_device_count=4").strip(),
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]).rstrip(os.pathsep))
    r = subprocess.run([sys.executable, str(ROOT / "tests" / "_torch_zero_jax.py"), mode,
                        str(out)], env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("zero")
    run_jax("dp", d)
    W.spawn("all4", 4, d, str(d))
    W.spawn("all2", 2, d, str(d))
    run_jax("restore", d)
    kw = dict(steps=5, ckpt_every=1, compress=True, lr_matrix=2e-2, lr_adamw=1e-2)
    W.spawn("driver", 2, d, str(d / "ck_clean"), "clean", kw)
    W.spawn("driver", 2, d, str(d / "ck_kill"), "killed", dict(kw, kill_at=3),
            expect_codes=(-9,))
    W.spawn("driver", 2, d, str(d / "ck_kill"), "resumed", kw)
    return d


def load(d, name):
    return dict(np.load(Path(d) / name))


def part(z, prefix):
    return {k[len(prefix):]: v for k, v in z.items() if k.startswith(prefix)}


def assert_bitwise(a, b, what=""):
    assert sorted(a) == sorted(b), (what, sorted(a), sorted(b))
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=f"{what} {k}")


def assert_close(got, want, what="", rtol=2e-6, atol_frac=1e-6):
    got, want = got.astype(np.float64), want.astype(np.float64)
    lim = rtol * np.abs(want) + atol_frac * np.abs(want).max()
    assert (np.abs(got - want) <= lim).all(), (what, np.abs(got - want).max())


# ---------------------------------------------------------------------------
# the chunk layout against the JAX package (one process)
# ---------------------------------------------------------------------------

def _trees(seed, shapes=W.SHAPES):
    rng = np.random.default_rng(seed)
    tree = {k.split("/")[0]: {"w": rng.standard_normal(s).astype(np.float32)}
            for k, s in sorted(shapes.items())}
    return (jax.tree_util.tree_map(jnp.asarray, tree),
            {k: {"w": torch.from_numpy(v["w"])} for k, v in tree.items()})


@pytest.mark.parametrize("n", [1, 2, 4])
def test_chunk_layout_equals_jax(n):
    jt, pt = _trees(0)
    jplan = jax_bucketing.build_plan(jt, pad_multiple=n)
    plan = bucketing.build_plan(pt, pad_multiple=n)
    assert [(b.key, b.size, b.padded) for b in plan.buckets] == \
        [(b.key, b.size, b.padded) for b in jplan.buckets]
    jc = jax_bucketing.gather_chunks(jplan, jt, n)
    pc = bucketing.gather_chunks(plan, pt, n)
    jacc = jax_bucketing.init_chunk_acc(jplan, n)
    pacc = bucketing.init_chunk_acc(plan, n)
    for k in jc:
        np.testing.assert_array_equal(pc[k].numpy(), np.asarray(jc[k]))
        assert pacc[k].shape == jacc[k].shape and not pacc[k].any()
        b = next(b for b in plan.buckets if b.key == k)
        assert not pc[k].reshape(b.padded, b.d_in, b.d_out)[b.size:].any()  # pads zero
        for j in range(n):
            np.testing.assert_array_equal(
                bucketing.gather_chunks(plan, pt, n, only=j)[k].numpy(), np.asarray(jc[k][j]))
    jt2, pt2 = _trees(1)
    jacc = jax_bucketing.accumulate_chunks(
        jplan, jt2, jax_bucketing.accumulate_chunks(jplan, jt, jacc, n), n)
    pacc = bucketing.accumulate_chunks(plan, pt2, bucketing.accumulate_chunks(plan, pt, pacc, n), n)
    for k in jacc:
        np.testing.assert_array_equal(pacc[k].numpy(), np.asarray(jacc[k]))
    back = bucketing.scatter_chunks(plan, pc, pt2)
    jback = jax_bucketing.scatter_chunks(jplan, jc, jt2)
    for name in back:
        np.testing.assert_array_equal(back[name]["w"].numpy(), np.asarray(jback[name]["w"]))
        np.testing.assert_array_equal(back[name]["w"].numpy(), pt[name]["w"].numpy())


def test_unpad_repad_and_shard_count_equal_jax():
    jt, pt = _trees(2)
    for old, new in ((4, 2), (2, 8), (3, 1)):
        jo, jn = (jax_bucketing.build_plan(jt, pad_multiple=m) for m in (old, new))
        po, pn = (bucketing.build_plan(pt, pad_multiple=m) for m in (old, new))
        jbuf = jax_bucketing.gather(jo, jt)
        pbuf = bucketing.gather(po, pt)
        jout = jax_bucketing.repad_buckets(jn, jax_bucketing.unpad_buckets(jo, jbuf))
        pout = bucketing.repad_buckets(pn, bucketing.unpad_buckets(po, pbuf))
        for k in jout:
            np.testing.assert_array_equal(pout[k].numpy(), np.asarray(jout[k]))
        for b in po.buckets:
            for l_loc in (b.padded, b.padded // old, b.padded + 1, 0):
                want = jax_raised = None
                try:
                    want = jax_bucketing.shard_count(b, l_loc)
                except ValueError:
                    jax_raised = True
                if jax_raised:
                    with pytest.raises(ValueError, match="different mesh or built"):
                        bucketing.shard_count(b, l_loc)
                else:
                    assert bucketing.shard_count(b, l_loc) == want
    with pytest.raises(ValueError, match="pad_multiple=n_chunks"):
        bucketing.gather_chunks(bucketing.build_plan(pt), pt, 4)


def test_dp_step_refuses_what_the_jax_step_refuses():
    """The up-front errors: shard_size other than the group size, ZeRO-2
    without its entry points, sharded state without update_apply."""
    cfg = get_config("gpt2-small").reduced()
    comm = SimpleNamespace(rank=0, world=4, device=torch.device("cpu"))
    wrong = make_optimizer("rmnp", dict(lr_matrix=1e-2, shard_axis=comm, shard_size=2))
    with pytest.raises(ValueError, match="shard_size=4"):
        make_dp_train_step(cfg, wrong, comm, zero2=True)
    plain = make_optimizer("rmnp", dict(lr_matrix=1e-2, fused_apply=True))
    with pytest.raises(ValueError, match="update_apply_sharded"):
        make_dp_train_step(cfg, plain, comm, zero2=True)
    two_pass = make_optimizer("rmnp", dict(lr_matrix=1e-2, fused=True))
    with pytest.raises(ValueError, match="fused-apply"):
        make_dp_train_step(cfg, two_pass, comm, shard_state=True)
    with pytest.raises(ValueError, match="needs shard_axis"):
        make_optimizer("rmnp", dict(lr_matrix=1e-2, shard_size=4))


# ---------------------------------------------------------------------------
# 4 ranks against the replicated step, within the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rule", RULES)
def test_synthetic_zero1_and_zero2_equal_replicated(runs, rule):
    """The optimizer alone over uneven buckets (L = 8, 3 < 4, 6) padded by
    shard_size 4, two steps: params, momentum and slots bit for bit, pad
    slices zero, and each rank holds padded L / 4 slices."""
    z = load(runs, f"synthetic_{rule}.npz")
    rep_p = part(z, "rep_p:")
    assert_bitwise(part(z, "z1_p:"), rep_p, "zero1 params")
    assert_bitwise(part(z, "z2_p:"), rep_p, "zero2 params")
    rep_s = part(z, "rep_s:")
    sizes = {".buckets/8x16": 8, ".buckets/8x24": 3, ".buckets/16x8": 6}
    for mode in ("z1_s:", "z2_s:"):
        full = part(z, mode)
        assert sorted(full) == sorted(rep_s)
        for k, v in full.items():
            size = sizes[".buckets/" + k.rsplit("/", 1)[1]]
            np.testing.assert_array_equal(v[:size], rep_s[k], err_msg=f"{mode}{k}")
            assert v.shape[0] == {3: 4}.get(size, 8) and not v[size:].any()
    local = load(runs, f"synthetic_{rule}_local.npz")
    assert {k: tuple(v) for k, v in local.items()} == {
        "8x16": (2, 8, 16), "8x24": (1, 8, 24), "16x8": (2, 16, 8)}


def test_bucketing_zero_helpers_equal_the_engine(runs):
    """``bucketing.bucket_update_apply`` (ZeRO-1: full gradient, momentum
    shard) and ``bucket_update_apply_sharded`` (ZeRO-2: reduced gradient
    shard) give the engine's bits on every bucket and rank."""
    for r in range(4):
        same = np.load(runs / f"bucket_helpers_r{r}.npy")
        assert same.size == 6 and same.all(), same


@pytest.mark.parametrize("rule", RULES)
def test_dp_zero1_and_zero2_equal_replicated_bitwise(runs, rule):
    """Reduced gpt2 on 4 ranks (its 512x64 embedding bucket has L = 1 < 4),
    two steps with the clip active: ZeRO-1, serialized ZeRO-2 and pipelined
    ZeRO-2 equal ZeRO-0 in params, momentum, slots and grad_norm."""
    ref = load(runs, f"dp_{rule}_z0.npz")
    assert (ref["clip"] == 1).all()
    for mode in ("z1", "z2s", "z2p"):
        assert_bitwise(load(runs, f"dp_{rule}_{mode}.npz"), ref, mode)


@pytest.mark.parametrize("wire", ["exact", "int8"])
def test_moe_expert_stacks_through_zero1_and_zero2_bitwise(runs, wire):
    """Reduced deepseek-v2-lite-16b on 4 ranks, two RMNP steps with the clip
    active: its 4-D expert stacks ``(n_units, E, d_in, d_out)`` join the
    buckets that ZeRO-1 and ZeRO-2 shard (2 units x 4 experts = 8 slices a
    stack). Exact wire: ZeRO-1 and both ZeRO-2 schedules equal ZeRO-0 in
    params, momentum and grad_norm. int8 wire: ZeRO-1 equals ZeRO-0 (the
    same per-leaf wire) and pipelined ZeRO-2 equals serialized ZeRO-2,
    every rank's residual included; ZeRO-2's int8 blocks are laid over the
    chunked buckets and ZeRO-0's over the leaves, so those two wires round
    different blocks, in the JAX package as here."""
    ref = load(runs, f"moe_{wire}_z0.npz")
    assert (ref["clip"] == 1).all()
    stacks = [k for k, v in ref.items() if k.startswith("p:") and v.ndim == 4]
    assert stacks == ["p:stack/layer_1/ffn/w_in", "p:stack/layer_1/ffn/w_out"]
    z2 = {m: load(runs, f"moe_{wire}_{m}.npz") for m in ("z2s", "z2p")}
    assert_bitwise(load(runs, f"moe_{wire}_z1.npz"), ref, "z1")
    if wire == "exact":
        for mode, got in z2.items():
            assert_bitwise(got, ref, mode)
    else:
        assert_bitwise(z2["z2p"], z2["z2s"], "z2p")
        for r in range(4):
            assert_bitwise(load(runs, f"moe_int8_z2p_r{r}.npz"),
                           load(runs, f"moe_int8_z2s_r{r}.npz"), f"residual {r}")
            assert_bitwise(load(runs, f"moe_int8_z1_r{r}.npz"),
                           load(runs, f"moe_int8_z0_r{r}.npz"), f"z1 residual {r}")


@pytest.mark.parametrize("wire,accum", [("exact", 1), ("exact", 4), ("int8", 1), ("int8", 4)])
def test_pipelined_equals_serialized_bitwise(runs, wire, accum):
    tag = f"{wire}_a{accum}"
    assert_bitwise(load(runs, f"wire_{tag}_z2p.npz"), load(runs, f"wire_{tag}_z2s.npz"), tag)
    for r in range(4):
        assert_bitwise(load(runs, f"wire_{tag}_z2p_r{r}.npz"),
                       load(runs, f"wire_{tag}_z2s_r{r}.npz"), f"{tag} residual {r}")


def test_chunked_accumulation_equals_replicated_at_accum_4(runs):
    """accum = 4: the gradient accumulated straight into the chunks equals
    the replicated per-leaf accumulation, bit for bit."""
    assert_bitwise(load(runs, "wire_exact_a4_z2s.npz"), load(runs, "wire_exact_a4_z0.npz"))


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------

def hold_exact_wire(d, got_name, want_prefix, rtol=2e-6, atol_frac=1e-6):
    """The port's ZeRO-2 result against JAX's on the exact wire: grad norms
    at rtol 2e-6, every parameter and state leaf at the fp32 limit
    (``rtol * |want| + atol_frac * max|want|``)."""
    got, want = load(d, got_name), load(d, f"{want_prefix}.npz")
    np.testing.assert_allclose(got["gnorm"], np.load(d / f"{want_prefix}_gnorm.npy"),
                               rtol=2e-6)
    held = [k for k in got if k.startswith(("p:", "s:"))]
    assert held and sorted(held) == sorted(k for k in want if k.startswith(("p:", "s:")))
    for k in held:
        assert_close(got[k], want[k], k, rtol, atol_frac)


def hold_int8_wire(d, got_name, want_prefix, gnorm_rtol=2e-6, rescale=False):
    """The same on the int8 wire, with the neighbouring-code allowance the
    module's docstring states. With ``rescale`` the grad norm is held at
    ``gnorm_rtol`` and the clip scale it sets is divided out of the state
    (momentum by the ratio of the two norms, AdamW's second moment by its
    square) before the allowance is applied."""
    got, want = load(d, got_name), load(d, f"{want_prefix}.npz")
    want_gnorm = np.load(d / f"{want_prefix}_gnorm.npy")
    np.testing.assert_allclose(got["gnorm"], want_gnorm, rtol=gnorm_rtol)
    ratio = float(got["gnorm"][-1]) / float(want_gnorm[-1]) if rescale else 1.0
    for k in got:
        if not k.startswith(("p:", "s:")):
            continue
        g, w = got[k].astype(np.float64), want[k].astype(np.float64)
        if k.startswith(("s:.buckets", "s:.momentum")):
            g = g * ratio
        elif k.startswith("s:.nu"):
            g = g * ratio ** 2
        off = np.abs(g - w) > 2e-6 * np.abs(w) + 1e-6 * np.abs(w).max()
        if k.startswith("s:.buckets"):
            assert off.mean() <= 5e-4, (k, off.sum())
            assert (np.abs(g - w) <= np.abs(w).max() / 127).all(), k
        else:
            assert off.mean() <= 1e-2, (k, off.sum())


@pytest.mark.parametrize("n", [2, 4])
def test_zero2_matches_jax_exact_wire(runs, n):
    """Two ZeRO-2 steps on n ranks from the JAX package's params against
    its n-device ``make_dp_train_step(zero2=True)``."""
    hold_exact_wire(runs, f"jaxcmp_exact_n{n}.npz", f"jax_exact_n{n}")


@pytest.mark.parametrize("n", [2, 4])
def test_zero2_matches_jax_int8_wire(runs, n):
    hold_int8_wire(runs, f"jaxcmp_int8_n{n}.npz", f"jax_int8_n{n}")


@pytest.fixture(scope="module")
def moe_runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("zero_moe")
    run_jax("moe", d)
    W.spawn("jax_moe", 4, d, str(d))
    return d


MOE_ARCHS = ("deepseek-v2-lite-16b", "olmoe-1b-7b")


# The exact wire's element limit per arch. olmoe-1b-7b holds gpt2-small's
# (worst element 0.92 of it). deepseek-v2-lite-16b's MLA differs from JAX by
# more fp32 rounding already in one rank's gradient (3.0e-6 of a leaf's
# largest element, against olmoe's 1.6e-6), and its two steps read 1.46x
# gpt2's limit; it is held at the limit the MLA tests state for the model's
# outputs and gradients (tests/test_torch_mla.py: rtol 1e-5 plus 2e-6 of
# the leaf's largest magnitude).
MOE_EXACT_LIMITS = {"deepseek-v2-lite-16b": (1e-5, 2e-6), "olmoe-1b-7b": (2e-6, 1e-6)}


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_zero2_matches_jax_exact_wire(moe_runs, arch):
    """Reduced deepseek-v2-lite-16b (MLA, a dense prefix, MoE units) and
    olmoe-1b-7b (qk_norm, MoE on every layer), each with its 4-D expert
    stacks in the sharded buckets: two ZeRO-2 steps on 4 ranks from the JAX
    package's params against its 4-device step, grad norms at gpt2-small's
    rtol 2e-6 and every leaf at ``MOE_EXACT_LIMITS``. Reduced MoE routes
    top-2, where the port's combine (a token's K expert outputs added in k
    order) and JAX's scatter-add sum the same pair."""
    hold_exact_wire(moe_runs, f"jaxcmp_{arch}_exact_n4.npz", f"jax_{arch}_exact_n4",
                    *MOE_EXACT_LIMITS[arch])


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_zero2_matches_jax_int8_wire(moe_runs, arch):
    """One int8-wire ZeRO-2 step. A gradient an fp32 ulp apart rounds to the
    neighbouring int8 code a few times a bucket on each rank (1-5 of 65536
    codes here, in both archs); one such code in a block of large gradients
    moves the global grad norm: olmoe's by 1.9e-5 relative. The clip
    (clip_norm 1 against a norm near 10) multiplies every gradient by
    1 / norm, so the whole momentum moves by that ratio and most of its
    elements leave the fp32 limit. So the norm is held at 1e-4 (one such
    code, with room), and the state with the ratio of the two norms divided
    out, at the module's int8 allowance."""
    hold_int8_wire(moe_runs, f"jaxcmp_{arch}_int8_n4.npz", f"jax_{arch}_int8_n4",
                   gnorm_rtol=1e-4, rescale=True)


# ---------------------------------------------------------------------------
# the guard and the wire fault
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tag", ["exact_nan", "int8_nan", "int8_bitflip"])
def test_guard_skips_the_faulted_step_bitwise(runs, tag):
    """A NaN in the gradient (either wire) or a flipped block scale on rank
    0's int8 wire at step 1: the guarded pipelined step reports a skip and
    leaves params, momentum and every rank's residual as step 0 left them."""
    for r in range(4):
        before = load(runs, f"guard_{tag}_s0_r{r}.npz")
        after = load(runs, f"guard_{tag}_s1_r{r}.npz")
        assert before.pop("skipped") == 0 and after.pop("skipped") == 1
        flags = after.pop("flags")
        before.pop("flags")
        assert not flags.all()
        assert_bitwise(after, before, f"rank {r}")


def test_bitflip_is_seen_by_the_receiver_only(runs):
    """Rank 0's first outgoing block scale flipped: the chunk's receiver
    (rank 0) gets a non-finite mean, every other rank's mean and every
    sender's residual are those of the clean exchange."""
    for r in range(4):
        z = load(runs, f"wirefault_r{r}.npz")
        np.testing.assert_array_equal(z["resid_hit"], z["resid"])
        if r == 0:
            assert not np.isfinite(z["mean_hit"]).all()
        else:
            np.testing.assert_array_equal(z["mean_hit"], z["mean"])


# ---------------------------------------------------------------------------
# checkpoints and resharding
# ---------------------------------------------------------------------------

def _saved(runs):
    z = load(runs, "ckpt_saved_r0.npz")
    return part(z, "p:"), part(z, "s:")


def test_sharded_checkpoint_restores_on_4_ranks_bitwise(runs):
    for r in range(4):
        saved = load(runs, f"ckpt_saved_r{r}.npz")
        assert_bitwise(load(runs, f"ckpt_port_restored_r{r}.npz"), saved, f"rank {r}")
        got = load(runs, f"ckpt_on4_r{r}.npz")
        assert list(got.pop("local")) == [2, 1, 1, 1]  # padded L / 4 a bucket
        assert_bitwise(got, saved, f"rank {r}")
    man = (runs / "port_ckpt" / "step_000000001" / "manifest.json").read_text()
    assert '"n_shards": 4' in man
    assert all((runs / "port_ckpt" / "step_000000001" / f"shard_{r:05d}.SHARD_COMMITTED").exists()
               for r in range(4))


def test_sharded_checkpoint_reshards_onto_2_ranks(runs):
    """4 -> 2 ranks: params and every real momentum slice bit for bit, pads
    zero; the residual's mass moves to rank 0 (``reshard_error``)."""
    p4, s4 = _saved(runs)
    rows = [part(load(runs, f"ckpt_saved_r{r}.npz"), "c:") for r in range(4)]
    # reduced gpt2's buckets and their true L (padded to 8, 4, 4, 4 on 4
    # ranks and to 8, 2, 2, 2 on 2)
    sizes = {".buckets/64x64": 8, ".buckets/64x256": 2, ".buckets/128x64": 2,
             ".buckets/512x64": 1}
    for r in range(2):
        got = load(runs, f"ckpt_on2_r{r}.npz")
        assert list(got.pop("local")) == [4, 1, 1, 1]  # padded L / 2 a bucket
        assert_bitwise(part(got, "p:"), p4, "params")
        for k, v in part(got, "s:").items():
            if k.startswith(".buckets"):
                size = sizes[k]
                assert v.shape[0] == max(2, size)
                np.testing.assert_array_equal(v[:size], s4[k][:size], err_msg=k)
                assert not v[size:].any() and not s4[k][size:].any()
            else:
                np.testing.assert_array_equal(v, s4[k], err_msg=k)
        for k, v in part(got, "c:").items():
            want = sum(row[k] for row in rows) * np.float32(0.5) if r == 0 else 0 * v
            np.testing.assert_allclose(v, want, rtol=1e-6, atol=1e-9, err_msg=k)


def test_port_checkpoint_restores_in_jax(runs):
    got = load(runs, "jax_restored_port.npz")
    saved = load(runs, "ckpt_saved_r0.npz")
    assert_bitwise({k: got[k] for k in saved if not k.startswith("c:")},
                   {k: v for k, v in saved.items() if not k.startswith("c:")})
    for r in range(4):
        row = load(runs, f"ckpt_saved_r{r}.npz")
        for k in part(row, "c:"):
            np.testing.assert_array_equal(got["c:" + k][r], row["c:" + k])


def test_jax_checkpoint_restores_in_port(runs):
    want = load(runs, "jax_ckpt_state.npz")
    for r in range(4):
        got = load(runs, f"ckpt_jax_restored_r{r}.npz")
        assert_bitwise({k: v for k, v in got.items() if not k.startswith("c:")},
                       {k: v for k, v in want.items() if not k.startswith("c:")})
        for k in part(got, "c:"):
            np.testing.assert_array_equal(got["c:" + k], want["c:" + k][r])


def test_sigkill_resume_of_a_2_rank_run_is_bitwise(runs):
    """The driver (``train(zero2=True)``, int8 wire, a checkpoint every
    step) SIGKILLed on both ranks after step 3 with a save in flight, then
    resumed: it ends on the clean run's bits."""
    clean, resumed = load(runs, "driver_clean.npz"), load(runs, "driver_resumed.npz")
    assert list(resumed.pop("steps")) == [2, 3, 4]
    clean.pop("steps")
    assert_bitwise(resumed, clean)
    assert not list((runs / "ck_kill").glob(".tmp_step_*"))
