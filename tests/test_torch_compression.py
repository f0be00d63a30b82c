"""The int8 error-feedback wire of the port (``distributed/compression.py``)
against the JAX package's ``repro.distributed.compression``.

The quantizer runs here in one process on both sides. The collective forms
run on 4 gloo ranks (``tests/_torch_zero_worker.py``) and on 4 JAX CPU
devices in a subprocess (``tests/_torch_zero_jax.py``), once per module.

Tolerances: the quantizer's codes and scales, and every residual, are held
bit for bit (the same fp32 operations on the same inputs). A mean sums the
N dequantized chunks, in rank order in the port and in XLA's order in JAX,
so it is held at 4 fp32 ulps of the largest addend's magnitude.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_zero_worker as W
from repro.distributed import compression as jax_compression
from repro_torch.distributed import compression
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
N = 4


def _blocks(seed, nblocks):
    """fp32 blocks of assorted scales, with an all-zero block, a block of
    exact half-way points (x / scale = k + 0.5) and a negative-only block."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((nblocks, 512))
         * 10.0 ** rng.uniform(-8, 4, (nblocks, 1))).astype(np.float32)
    if nblocks >= 4:
        x[1] = 0.0
        x[2] = (2 * (np.arange(512) % 127) - 125).astype(np.float32)  # odd values
        x[2, 0] = 254.0  # scale exactly 2.0: every odd x / 2 is a tie k + 0.5
        x[3] = -np.abs(x[3])
    return x.reshape(-1)


@pytest.mark.parametrize("seed", range(6))
def test_quantize_equals_jax_bitwise(seed):
    flat = _blocks(seed, 2 + 3 * seed)
    q, s = compression.quantize_blockwise(torch.from_numpy(flat))
    jq, js = jax_compression.quantize_blockwise(jnp.asarray(flat))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy().view(np.uint32), np.asarray(js).view(np.uint32))
    assert q.dtype == torch.int8 and int(q.abs().max()) <= 127
    deq = compression.dequantize_blockwise(q, s)
    jdeq = jax_compression.dequantize_blockwise(jq, js)
    np.testing.assert_array_equal(deq.numpy(), np.asarray(jdeq))


def test_quantize_rounds_half_to_even():
    x = torch.tensor([254.0, 1.0, 3.0, 5.0, -1.0, -3.0] + [0.0] * 506)  # scale 2.0
    q, s = compression.quantize_blockwise(x)
    assert float(s[0]) == 2.0
    assert q[:6].tolist() == [127, 0, 2, 2, 0, -2]


@pytest.mark.parametrize("seed", range(20))
def test_quantize_roundtrip_error_bounded_relative_to_the_ulp(seed):
    """|x - deq(q(x))| <= scale / 2 plus the fp32 rounding of the divide and
    the multiply: 2 ulps of the block's largest magnitude. (The JAX test's
    ``scale / 2 + 1e-7`` drops the ulps and fails on the reference, ROADMAP
    Queue 3.)"""
    flat = _blocks(100 + seed, 5)
    q, s = compression.quantize_blockwise(torch.from_numpy(flat))
    y = compression.dequantize_blockwise(q, s).numpy().reshape(-1, 512)
    xb = flat.reshape(-1, 512)
    scale = s.numpy()[:, None].astype(np.float64)
    ulp = np.spacing(np.abs(xb).max(axis=1, keepdims=True)).astype(np.float64)
    err = np.abs(xb.astype(np.float64) - y)
    assert (err <= scale / 2 + 2 * ulp).all(), (err - scale / 2).max()


def test_reshard_error_keeps_the_mass():
    rng = np.random.default_rng(0)
    rows = {"a": rng.standard_normal((4, 3, 5)).astype(np.float32), "b": np.zeros((4, 7), np.float32)}
    out = compression.reshard_error(rows, 4, 2)
    np.testing.assert_allclose(out["a"][0] / 2, rows["a"].sum(0) / 4, rtol=1e-6)
    assert not out["a"][1].any() and out["a"].shape == (2, 3, 5)
    assert not out["b"].any()  # zero residuals stay zero, bit for bit
    jout = jax_compression.reshard_error(
        jax_compression.CompressionState(error={k: jnp.asarray(v) for k, v in rows.items()}), 4, 2)
    for k in rows:
        np.testing.assert_array_equal(out[k], np.asarray(jout.error[k]))


@pytest.fixture(scope="module")
def crs(tmp_path_factory):
    d = tmp_path_factory.mktemp("crs")
    rng = np.random.default_rng(3)
    np.savez(d / "crs_in.npz",
             **{f"chunks_{r}": (rng.standard_normal((N, 3, 8, 20))
                                * rng.uniform(0.5, 2.0)).astype(np.float32) for r in range(N)},
             **{f"leaf_{r}": rng.standard_normal((5, 300)).astype(np.float32) for r in range(N)})
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "")
                          + " --xla_force_host_platform_device_count=4").strip(),
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]).rstrip(os.pathsep))
    r = subprocess.run([sys.executable, str(ROOT / "tests" / "_torch_zero_jax.py"), "crs",
                        str(d)], env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    W.spawn("compression_fns", N, d)
    return d, dict(np.load(d / "crs_jax.npz")), [dict(np.load(d / f"crs_out_r{r}.npz"))
                                                  for r in range(N)]


def _addend_ulps(d, r):
    """4 fp32 ulps of the largest dequantized addend of rank r's chunk."""
    z = np.load(d / "crs_in.npz")
    biggest = max(np.abs(z[f"chunks_{s}"][r]).max() for s in range(N))
    return 4 * np.spacing(np.float32(biggest))


def test_compressed_reduce_scatter_matches_jax_4_ranks(crs):
    d, jax_out, port = crs
    for r in range(N):
        np.testing.assert_array_equal(port[r]["resid"], jax_out["resid"][r])
        np.testing.assert_allclose(port[r]["mean"], jax_out["mean"][r], rtol=0,
                                   atol=_addend_ulps(d, r))


def test_compressed_mean_leaf_matches_jax_4_ranks(crs):
    """The replicated form: int8 all-to-all, fp32 sum, bf16 all-gather; both
    residuals (int8 and this rank's bf16 rounding) fed back."""
    d, jax_out, port = crs
    z = np.load(d / "crs_in.npz")
    top = max(np.abs(z[f"leaf_{r}"]).max() for r in range(N))
    for r in range(N):
        # the bf16 stage rounds the sum; a sum an ulp apart can round to the
        # neighbouring bf16 value, 2^-8 of the element
        np.testing.assert_allclose(port[r]["lmean"], jax_out["lmean"][r],
                                   rtol=2 ** -8, atol=4 * np.spacing(np.float32(top)))
        np.testing.assert_allclose(port[r]["lerr"], jax_out["lerr"][r], rtol=0,
                                   atol=2 ** -8 * N * top)


def test_error_feedback_accumulates_to_the_truth(crs):
    """Eight int8 reduce-scatters of one fixed gradient with the residual fed
    back: their running sum stays within one step's quantization error of 8
    exact means (the error does not grow with the steps)."""
    d, _, port = crs
    z = np.load(d / "crs_in.npz")
    for r in range(N):
        exact = sum(z[f"chunks_{s}"][r].astype(np.float64) for s in range(N)) / N
        one_step = np.abs(port[r]["mean"] - exact).max()
        drift = np.abs(port[r]["ef_total"] - 8 * exact).max()
        assert one_step > 0 and drift <= 2 * one_step, (drift, one_step)
