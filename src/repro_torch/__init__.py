"""PyTorch/CUDA port of the power-aware automatic offloading system.

Laid out module by module like the JAX package ``repro``, which stays the
reference; this package imports neither JAX nor ``repro``. Its entry points
run on the CUDA card unless the caller passes ``device="cpu"``.
"""
