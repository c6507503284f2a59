"""Matmul precision, named by algorithm, resolved per platform.

The reference multiplies TF32 x TF32 with fp32 accumulation on tensor
cores (src/sddmmKernel.cu:310-326). ``SddmmConfig.matmul_precision`` names
the dot algorithm; every matmul in the package (ops/sddmm.py,
ops/graph_rphm.py, ops/triton_tiles.py, parallel/ring.py, baselines.py)
resolves it here:

* ``"tf32"``   — TF32 inputs, fp32 accumulation (the reference's choice).
* ``"bf16x3"`` — each fp32 operand split into bf16 hi + lo, three bf16
  products, fp32 accumulation.
* ``"fp32"``   — full fp32 products.

The CPU backend has no TF32 unit and refuses ``TF32_TF32_F32``; there
``"tf32"`` runs as ``F32_F32_F32``, which is strictly more accurate. CPU
runs are tests, never measurements.
"""

from __future__ import annotations

from typing import Optional

import jax

_ALGORITHMS = {
    "tf32": jax.lax.DotAlgorithmPreset.TF32_TF32_F32,
    "bf16x3": jax.lax.DotAlgorithmPreset.BF16_BF16_F32_X3,
    "fp32": jax.lax.DotAlgorithmPreset.F32_F32_F32,
}

PRECISIONS = tuple(_ALGORITHMS)


def dot_algorithm(name: str, platform: Optional[str] = None):
    """The ``lax.DotAlgorithmPreset`` for precision ``name`` on
    ``platform`` (default: JAX's default backend)."""
    if name not in _ALGORITHMS:
        raise ValueError(f"unknown matmul precision {name!r}; "
                         f"expected one of {PRECISIONS}")
    platform = platform or jax.default_backend()
    if platform == "cpu" and name == "tf32":
        return jax.lax.DotAlgorithmPreset.F32_F32_F32
    return _ALGORITHMS[name]
