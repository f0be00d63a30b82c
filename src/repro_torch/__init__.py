"""PyTorch/CUDA port of the RMNP system, beside the JAX reference ``repro``.

It mirrors the JAX package's module names and imports nothing from it.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
Every matrix parameter is stored ``(d_in, d_out)`` and applied as ``x @ W``.
"""
