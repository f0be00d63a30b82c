"""Hand-written Hopper kernels of the port and their plain PyTorch versions.

``LAUNCHES`` counts kernel launches: each wrapper adds one to its kernel's
entry where it launches the kernel on the card, and nowhere else (the plain
versions that CPU tensors take are not counted). A caller that wants to show
that a run went through the kernels sets the counts to 0 with
:func:`reset_launches` and reads them afterwards.
"""
from __future__ import annotations

from typing import Dict

LAUNCHES: Dict[str, int] = {
    "rmnp_precondition": 0,   # kernels/rmnp_update.py, APPLY=False
    "rmnp_apply": 0,          # kernels/rmnp_update.py, APPLY=True
    "flash_attention_fwd": 0,  # kernels/flash_attention.py
    # kernels/matmul.py (csrc/matmul.cu): the products of Newton-Schulz
    # (Gram and apply) and the polynomial fused into the G@G epilogue, 2-D
    # and stacked
    "matmul": 0,
    "matmul3": 0,
    "ns_poly": 0,
    "ns_poly3": 0,
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
