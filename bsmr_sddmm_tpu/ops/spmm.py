"""Public SpMM over a BSMR-packed mask: ``out = S @ V``.

The reference repository's row-reordering algorithm originates in
BSA_SpMM (SURVEY.md section 2b) — reordered block-structured *SpMM* —
so the framework exposes SpMM as a first-class op: the CSR matrix's
values are packed once into the plan's rphm layout (a host-side scatter
along the plan's static maps) and every call is the tile-native
aggregation of ops/graph_rphm (dense tier = per-tile matmuls against
contiguous V blocks).
"""

from __future__ import annotations

from typing import Callable, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from bsmr_sddmm_tpu.formats import CSR
from bsmr_sddmm_tpu.ops.graph_rphm import make_spmm_rphm
from bsmr_sddmm_tpu.ops.sddmm import device_plan
from bsmr_sddmm_tpu.pack import TilePlan


def pack_values_rphm(plan: TilePlan, values: np.ndarray
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                np.ndarray]:
    """Scatter CSR-order values into the plan's four-tier rphm layout
    (host side, one-time per value set). Trash/pad slots become zero."""
    v = np.concatenate([np.asarray(values, np.float32), [0.0]])
    dense = v[plan.tile_scatter]        # (T, ph, bw)
    packed = (v[plan.sp_scatter]
              if plan.sp_scatter is not None and plan.sp_scatter.size
              else np.zeros((0, plan.panel_height, plan.block_width),
                            np.float32))
    gathered = v[plan.g_scatter]        # (Tg, ph, bw)
    res = v[plan.res_out]               # (E,)
    return dense, packed, gathered, res


def make_spmm_fn(plan: TilePlan, precision: str = "tf32") -> Callable:
    """Build jitted ``fn(dense, packed, gathered, res, V, dplan) ->
    (M, F)`` — the tile-layout SpMM (values from
    :func:`pack_values_rphm` or a previous SDDMM/softmax in rphm
    layout). ``precision`` follows SddmmConfig.matmul_precision
    semantics (default "high" = the 3-pass bf16 decomposition,
    TF32-class; passes the rel-1e-3 check)."""
    return jax.jit(make_spmm_rphm(plan, precision))


def spmm(csr: CSR, plan: TilePlan, V: np.ndarray) -> np.ndarray:
    """One-shot ``csr @ V`` using the packed plan (values = csr.values)."""
    d, p, g, r = pack_values_rphm(plan, csr.values)
    fn = make_spmm_fn(plan)
    out = fn(jnp.asarray(d), jnp.asarray(p), jnp.asarray(g),
             jnp.asarray(r), jnp.asarray(V, jnp.float32),
             device_plan(plan))
    return np.asarray(out)
