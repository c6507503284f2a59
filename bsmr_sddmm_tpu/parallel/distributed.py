"""Multi-host initialization and scaling measurement helpers.

The reference is single-process/single-GPU (SURVEY.md section 2d); this
is the framework's *new* distributed layer. Usage on several hosts:

    from bsmr_sddmm_tpu.parallel import distributed
    distributed.initialize()          # jax.distributed, once per process
    mesh = make_mesh()                # all devices across all hosts

Sharding/collectives are expressed per-array (parallel.sharding); this
module only owns process bootstrap and the weak-scaling measurement the
BASELINE targets ask for (nnz/s at 1 chip / 1 host / N hosts).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """Initialize jax.distributed for multi-host execution. No-ops when
    single-process (the common case on one host: all local chips are
    already visible). Arguments default to the standard JAX cluster
    environment variables."""
    import jax
    if num_processes in (None, 1) and not coordinator_address \
            and "JAX_COORDINATOR_ADDRESS" not in os.environ:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id)


def weak_scaling(plan_fn, device_counts: Sequence[int],
                 iterations: int = 10) -> dict:
    """Measure nnz/s at each device count (same per-device work: the
    caller's plan_fn(n) returns (fn, args, nnz) for an n-device mesh).

    Returns {n: {"ms": ..., "nnz_per_s": ..., "efficiency": ...}} with
    efficiency relative to perfect scaling from the smallest count."""
    from bsmr_sddmm_tpu.utils.timing import time_jitted
    results = {}
    base_rate = None
    for n in device_counts:
        fn, args, nnz = plan_fn(n)
        ms, _ = time_jitted(fn, *args, iterations=iterations)
        rate = nnz / (ms * 1e-3)
        if base_rate is None:
            base_rate = rate / n
        results[n] = {"ms": ms, "nnz_per_s": rate,
                      "efficiency": rate / (base_rate * n)}
    return results


def sddmm_weak_scaling(device_counts: Sequence[int],
                       rows_per_device: int = 8192,
                       nnz_per_device: int = 500_000,
                       cols: int = 8192, k: int = 128,
                       bandwidth: int = 256,
                       config=None,
                       iterations: int = 10,
                       seed: int = 7) -> dict:
    """Weak scaling of the REAL sharded hybrid SDDMM (make_sharded_sddmm,
    emit="rphm"): per device, a constant slice of a banded mask
    (rows_per_device x cols, nnz_per_device nonzeros). Rows and nnz grow
    with the mesh; B is replicated (column space fixed).

    Returns the weak_scaling() dict. On a virtual CPU mesh this validates
    the scaling *structure* (per-shard shapes constant, no combine in the
    hot path); on real devices it measures the interconnect-relative
    efficiency."""
    from bsmr_sddmm_tpu.config import SddmmConfig
    from bsmr_sddmm_tpu.datasets import banded
    from bsmr_sddmm_tpu.formats import make_dense
    from bsmr_sddmm_tpu.parallel.sharding import (make_mesh,
                                                  make_sharded_sddmm,
                                                  shard_operands)
    from bsmr_sddmm_tpu.reorder import bsmr as bsmr_reorder

    cfg = config or SddmmConfig(k=k, panel_height=32)

    def plan_fn(n):
        csr = banded(n * rows_per_device, n * nnz_per_device,
                     bandwidth, seed=seed)
        # banded() is square; crop columns to the fixed per-run width so
        # B stays constant-size as the mesh grows
        csr = _crop_cols(csr, cols)
        mesh = make_mesh(n)
        reord = bsmr_reorder(csr, cfg)
        fn, dplan, _ = make_sharded_sddmm(csr, reord, cfg, mesh, k=k,
                                          emit="rphm")
        A = make_dense(csr.rows, k, seed=1)
        Bt = make_dense(csr.cols, k, seed=2)
        A_dev, Bt_dev = shard_operands(A, Bt, mesh)
        return (fn, (A_dev, Bt_dev, dplan), csr.nnz)

    return weak_scaling(plan_fn, device_counts, iterations=iterations)


def _crop_cols(csr, cols: int):
    """Project a CSR mask onto its first ``cols`` columns, rescaling
    column ids (keeps per-row counts roughly constant)."""
    import numpy as np
    from bsmr_sddmm_tpu.formats import COO
    if csr.cols <= cols:
        return csr
    scale = cols / csr.cols
    new_c = np.minimum((csr.col_indices * scale).astype(np.int64),
                       cols - 1)
    key = csr.coo_rows().astype(np.int64) * cols + new_c
    uniq = np.unique(key)
    return COO(csr.rows, cols, (uniq // cols).astype(np.int32),
               (uniq % cols).astype(np.int32),
               np.ones(uniq.size, np.float32)).to_csr()
