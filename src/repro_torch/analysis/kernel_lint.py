"""Kernel lint: every launch the port would make fits the card and covers
its operands (counterpart of ``repro.analysis.kernel_lint``).

Launches are recorded, never made (``kernels/introspect.py``: each wrapper
runs on meta tensors up to its launch), over ``LINT_SHAPES``: the JAX
package's sweep (square, MLP-wide, MLP-tall, a ragged ``d_out``, a tall
fan-in), the port's real buckets (gpt2-small's embedding ``1x50432x768``,
paligemma-3b's tied embedding ``1x257280x2048`` on the two-sweep path,
jamba's expert stack ``17x4096x28672``), gpt2-small's Newton-Schulz
buckets, and the flash kernels at every ``(hd, hdv)`` of
``HEAD_DIM_PAIRS`` in both types at a ragged sequence length. Checks per
launch:

* **smem-over-limit**: dynamic shared memory within the H100's 227 KB
  opt-in per block;
* **cluster-too-large**: a thread-block cluster of at most 16 blocks
  (above 8 only with the non-portable attribute the RMNP kernel sets),
  dividing the grid;
* **launch-limits**: at most 1024 threads a block and a grid within
  ``(2^31 - 1, 65535, 65535)``;
* **split-accounting**: the RMNP launch agrees with the ``Split`` it was
  built from (cluster ``K``, threads, ``Split.smem_bytes``) and meets the
  C side's ``configure`` preconditions, so the accounting in
  ``kernels/rmnp_update.py`` and the launch cannot drift apart (the JAX
  package's grow and shrink loops once disagreed about a block's VMEM);
* **grid-gap** and **tile-out-of-bounds**: ``launch_coverage``.

The JAX package also flags a widening convert in the middle of a kernel
body's arithmetic, read from the body's jaxpr. A CUDA source has no such
trace to read, so that check has no counterpart here; the kernels' types
are held by the CPU emulation tests and by phase B on the card.
"""
from __future__ import annotations

from typing import List, Tuple

from repro_torch.analysis.findings import Finding, Severity
from repro_torch.analysis.framework import AnalysisPass, register_pass

# (L, d_in, d_out) stacked-bucket operands of the RMNP kernel
LINT_SHAPES: Tuple[Tuple[int, int, int], ...] = (
    (4, 768, 768),
    (2, 768, 3072),
    (2, 3072, 768),
    (3, 64, 80),
    (1, 16384, 256),
    (1, 50432, 768),
    (1, 257280, 2048),
    (17, 4096, 28672),
)
# (L, m, n) Newton-Schulz buckets, smaller side first: gpt2-small's four
NS_SHAPES: Tuple[Tuple[int, int, int], ...] = (
    (4, 256, 256), (48, 768, 768), (12, 768, 6144), (12, 768, 3072), (1, 768, 50432))
# (B, S, H, K) of the flash launches: a ragged S and GQA
FLASH_SHAPE = (2, 1000, 8, 2)


def trace_targets():
    """(label, thunk) pairs, each making one or more launches of a kernel
    entry on meta tensors."""
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops

    def meta(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device="meta")

    targets = []
    for (L, d_in, d_out) in LINT_SHAPES:
        g = meta(L, d_in, d_out)
        w = meta(L, d_in, d_out, dtype=torch.bfloat16)
        targets.append((f"rmnp_bucket_update[{L}x{d_in}x{d_out}]",
                        lambda g=g: ops.rmnp_bucket_update(g, g, beta=0.95)))
        targets.append((f"rmnp_bucket_update_apply[{L}x{d_in}x{d_out}]",
                        lambda g=g, w=w: ops.rmnp_bucket_update_apply(
                            g, g, w, torch.tensor(0.1), 0.1, beta=0.95)))
    for (L, m, n) in NS_SHAPES:
        x = meta(L, m, n)
        targets.append((f"ns_step[{L}x{m}x{n}]",
                        lambda x=x: ops.ns_step(x, 3.4445, -4.7750, 2.0315)))
    a, b = meta(768, 50432), meta(50432, 768)
    targets.append(("matmul[768x50432x768]", lambda: ops.matmul(a, b)))
    B, S, H, K = FLASH_SHAPE
    for dt, pairs in fa.HEAD_DIM_PAIRS.items():
        for hd, hdv in pairs:
            q, k = meta(B, S, H, hd, dtype=dt), meta(B, S, K, hd, dtype=dt)
            v = meta(B, S, K, hdv, dtype=dt)
            targets.append((f"flash_attention_fwd[{str(dt)[6:]},{hd},{hdv}]",
                            lambda q=q, k=k, v=v: fa.flash_attention_fwd(q, k, v)))
    return targets


def split_findings(launch, where: str) -> List[str]:
    """What is wrong with an RMNP launch against its ``Split`` and the C
    side's ``configure``: [message]."""
    from repro_torch.kernels.rmnp_update import COLUMNS, TALL_THREADS

    s = launch.layout
    _, d_in, _ = launch.tiles[0].shape
    bad = []
    if launch.cluster[0] != s.K or launch.grid[0] != s.K:
        bad.append(f"cluster {launch.cluster} / grid.x {launch.grid[0]} is not K = {s.K}")
    if launch.block[0] != s.threads:
        bad.append(f"block {launch.block} is not {s.threads} threads")
    if launch.smem_bytes != s.smem_bytes():
        bad.append(f"shared memory {launch.smem_bytes} is not Split.smem_bytes() "
                   f"{s.smem_bytes()}")
    if s.K * s.R < d_in:
        bad.append(f"K * R = {s.K * s.R} rows < d_in {d_in}")
    if s.C not in COLUMNS or not (s.one_read or s.C == 32):
        bad.append(f"no kernel is built for C = {s.C}, one_read = {s.one_read}")
    if s.threads % 32 or s.threads > TALL_THREADS or s.threads % (s.C // 4):
        bad.append(f"{s.threads} threads do not fit the kernel's {s.C}-column block")
    return [f"{where}: {b}" for b in bad]


def lint_launch(launch, where: str) -> List[Tuple[str, str]]:
    """[(code, message)] of what is wrong with one recorded launch."""
    from repro_torch.kernels import introspect

    bad: List[Tuple[str, str]] = []
    if launch.smem_bytes > introspect.SMEM_LIMIT:
        bad.append(("smem-over-limit",
                    f"{where}: {launch.smem_bytes} bytes of dynamic shared memory, over "
                    f"the {introspect.SMEM_LIMIT} a block may use"))
    size = launch.cluster[0] * launch.cluster[1] * launch.cluster[2]
    if size > introspect.MAX_CLUSTER or any(
            g % c for g, c in zip(launch.grid, launch.cluster, strict=True)):
        bad.append(("cluster-too-large",
                    f"{where}: cluster {launch.cluster} of {size} blocks over grid "
                    f"{launch.grid} (at most {introspect.MAX_CLUSTER}, dividing the grid)"))
    if (launch.block[0] * launch.block[1] * launch.block[2] > introspect.MAX_THREADS
            or any(g < 1 or g > m for g, m in zip(launch.grid, introspect.MAX_GRID,
                                                  strict=True))):
        bad.append(("launch-limits", f"{where}: block {launch.block}, grid {launch.grid} "
                                     f"outside the card's limits"))
    if launch.kernel == "rmnp_kernel":
        bad += [("split-accounting", m) for m in split_findings(launch, where)]
    cov = introspect.launch_coverage(launch)
    bad += [("grid-gap", f"{where}: {name} dim {d} [{lo}, {hi}) is never covered by any "
                         f"block") for name, d, lo, hi in cov["uncovered"]]
    bad += [("tile-out-of-bounds", f"{where}: {name} dim {d} has a tile starting at "
                                   f"{start}, past its extent")
            for name, d, start in cov["out_of_bounds"]]
    return bad


@register_pass
class KernelLintPass(AnalysisPass):
    name = "kernel-lint"
    description = ("recorded CUDA launches fit the card's shared memory and "
                   "cluster limits, agree with their layout, and cover their operands")
    scope = "repo"

    def run(self, _artifacts=None) -> List[Finding]:
        from repro_torch.kernels import introspect

        out: List[Finding] = []
        n_launches = 0
        targets = trace_targets()
        for label, thunk in targets:
            try:
                launches = introspect.collect_kernel_launches(thunk)
            except Exception as e:  # a target that fails to trace is itself a finding
                out.append(Finding(pass_name=self.name, severity=Severity.ERROR,
                                   code="trace-failed",
                                   message=f"{label}: recording raised "
                                           f"{type(e).__name__}: {e}", location=label))
                continue
            if not launches:
                out.append(Finding(pass_name=self.name, severity=Severity.WARNING,
                                   code="no-launches",
                                   message=f"{label}: no launch recorded; kernel not linted",
                                   location=label))
                continue
            for launch in launches:
                n_launches += 1
                where = f"{label}/{launch.signature}"
                out += [Finding(pass_name=self.name, severity=Severity.ERROR, code=code,
                                message=message, location=where)
                        for code, message in lint_launch(launch, where)]
        out.append(Finding(pass_name=self.name, severity=Severity.INFO, code="summary",
                           message=f"linted {n_launches} launches across "
                                   f"{len(targets)} trace targets"))
        return out
