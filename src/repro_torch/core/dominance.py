"""Diagonal-dominance diagnostics of the Muon/RMNP preconditioner (mirror of
``repro.core.dominance``; paper Section 3.2 / Appendix B).

For a momentum matrix V (paper convention rows = d_out) the Gram matrix is
G = V V^T in R^{m x m} and

    r_i = G_ii / mean_{j != i} |G_ij|

Matrices are stored (..., d_in, d_out), so the paper's Gram is
``stored^T @ stored`` over the last two dims. That Gram is a plain
``torch.matmul``: the JAX package computes it outside any kernel too.
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import torch

from repro_torch.core.mixed import is_matrix_param
from repro_torch.core.types import PyTree, tree_paths


class DominanceStats(NamedTuple):
    r_avg: torch.Tensor
    r_min: torch.Tensor
    r_max: torch.Tensor


def dominance_ratios(v: torch.Tensor, eps: float = 1e-12) -> DominanceStats:
    """r_avg/min/max for one stored (d_in, d_out) matrix (batched over any
    leading dims, then averaged)."""
    v = v.float()
    gram = v.transpose(-1, -2) @ v                   # (..., m, m), m = d_out
    m = gram.shape[-1]
    diag = torch.diagonal(gram, dim1=-2, dim2=-1)    # (..., m)
    abs_sum = torch.sum(torch.abs(gram), dim=-1) - torch.abs(diag)
    off_mean = abs_sum / max(1, m - 1)
    r = diag / (off_mean + eps)
    return DominanceStats(
        r_avg=torch.mean(r),
        r_min=torch.mean(torch.amin(r, dim=-1)),
        r_max=torch.mean(torch.amax(r, dim=-1)),
    )


def global_dominance(momentum: PyTree, matrix_embed: bool = True) -> Dict[str, torch.Tensor]:
    """Average per-parameter r_avg/min/max over all matrix parameters
    (paper Eq. 14-16)."""
    stats = [dominance_ratios(leaf) for path, leaf in tree_paths(momentum)
             if is_matrix_param(path, leaf, matrix_embed)]
    if not stats:
        z = torch.zeros(())
        return {"r_avg": z, "r_min": z, "r_max": z}
    return {name: torch.mean(torch.stack([getattr(s, name) for s in stats]))
            for name in DominanceStats._fields}
