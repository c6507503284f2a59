"""Baseline SDDMM implementations for the comparison methodology.

The reference vendors eight CUDA baselines (cuSPARSE, cuSDDMM, ASpT, RoDe,
Sputnik, TCGNN, FlashSparse, BSA — SURVEY.md section 2b) and benchmarks BSMR
against them with a shared log schema. This module provides the
comparable baselines in JAX that the methodology needs:

* ``dense_masked`` — compute the full ``A @ B`` and gather the mask's
  entries. The cuSPARSE-analogue "just use the dense library" ceiling: it
  wastes ``1/density`` of the flops but runs the tensor cores at full
  rate.
* ``bcoo`` — ``jax.experimental.sparse.bcoo_dot_general_sampled``, the
  stock JAX sparse SDDMM (library baseline, like cusparseSDDMM in
  baselines/cuSPARSE_SDDMM/src/cuSPARSE-main.cu:7-33).
* ``gather_dot`` — per-nonzero row gathers of A and B^T with a fused
  multiply-reduce, chunked. The Sputnik-class "pure scalar/vector" path,
  identical to the framework's own residual kernel applied to *all*
  nonzeros (delta = 1.1 ablation).

Every baseline is a jitted ``fn(A, Bt) -> P`` with P in CSR value order,
so ``BsmrSddmm.benchmark``'s timing and the RunLog schema apply unchanged.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from bsmr_sddmm_tpu.formats import CSR
from bsmr_sddmm_tpu.utils.logger import RunLog
from bsmr_sddmm_tpu.utils.timing import time_jitted

BASELINE_NAMES = ("dense_masked", "bcoo", "gather_dot")


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def make_dense_masked_fn(csr: CSR, k: int,
                         tile_m: int = 512,
                         precision: str = "fp32") -> Callable:
    """Full-matmul baseline: P = (A @ B)[rows, cols].

    The matmul runs in row blocks of ``tile_m`` via lax.map so peak live
    memory is ``tile_m * N`` floats rather than ``M * N`` (a 503-matrix
    suite includes M,N ~ 1e5-1e6; the full product would not fit device
    memory).

    ``precision`` defaults to "fp32" because the baseline doubles as the
    accuracy ceiling (precision.py names the algorithms).
    """
    from bsmr_sddmm_tpu.precision import dot_algorithm
    rows = jnp.asarray(csr.coo_rows())
    cols = jnp.asarray(csr.col_indices.astype(np.int32))
    M = _round_up(csr.rows, tile_m)
    num_blocks = M // tile_m
    nnz = csr.nnz
    prec = dot_algorithm(precision)

    def fn(A: jax.Array, Bt: jax.Array) -> jax.Array:
        A = A.astype(jnp.float32)
        Ap = jnp.pad(A, ((0, M - A.shape[0]), (0, 0)))
        blocks = Ap.reshape(num_blocks, tile_m, k)

        def block_prod(blk):
            return jax.lax.dot_general(
                blk, Bt.astype(jnp.float32),
                dimension_numbers=(((1,), (1,)), ((), ())),
                precision=prec,
                preferred_element_type=jnp.float32)   # (tile_m, N)

        P_full = jax.lax.map(block_prod, blocks).reshape(M, -1)
        return P_full[rows, cols]

    return jax.jit(fn)


def make_bcoo_fn(csr: CSR, k: int) -> Callable:
    """Stock JAX sparse SDDMM (bcoo_dot_general_sampled)."""
    from jax.experimental import sparse

    indices = jnp.asarray(
        np.stack([csr.coo_rows(), csr.col_indices], axis=1).astype(np.int32))
    dn = (((1,), (0,)), ((), ()))

    def fn(A: jax.Array, Bt: jax.Array) -> jax.Array:
        return sparse.bcoo_dot_general_sampled(
            A.astype(jnp.float32), Bt.astype(jnp.float32).T, indices,
            dimension_numbers=dn)

    return jax.jit(fn)


def make_gather_dot_fn(csr: CSR, k: int,
                       chunk: int = 1 << 16) -> Callable:
    """Per-nonzero gather + fused multiply-reduce, chunked with lax.map."""
    rows = csr.coo_rows().astype(np.int32)
    cols = csr.col_indices.astype(np.int32)
    nnz = csr.nnz
    E = _round_up(max(nnz, 1), chunk)
    rows_p = jnp.asarray(np.pad(rows, (0, E - nnz)))
    cols_p = jnp.asarray(np.pad(cols, (0, E - nnz)))
    S = E // chunk

    def fn(A: jax.Array, Bt: jax.Array) -> jax.Array:
        A = A.astype(jnp.float32)
        Bt = Bt.astype(jnp.float32)

        def step(idx_pair):
            r, c = idx_pair
            return jnp.sum(jnp.take(A, r, axis=0)
                           * jnp.take(Bt, c, axis=0), axis=-1)

        vals = jax.lax.map(step, (rows_p.reshape(S, chunk),
                                  cols_p.reshape(S, chunk)))
        return vals.reshape(E)[:nnz]

    return jax.jit(fn)


_FACTORIES = {
    "dense_masked": make_dense_masked_fn,
    "bcoo": make_bcoo_fn,
    "gather_dot": make_gather_dot_fn,
}


def make_baseline_fn(name: str, csr: CSR, k: int, **kw) -> Callable:
    if name not in _FACTORIES:
        raise ValueError(f"unknown baseline {name!r}; "
                         f"choose from {BASELINE_NAMES}")
    return _FACTORIES[name](csr, k, **kw)


def benchmark_baseline(name: str, csr: CSR, A: np.ndarray, B: np.ndarray,
                       iterations: int = 10, file: str = "",
                       validate: bool = False) -> RunLog:
    """Timed baseline run with the shared RunLog schema (the reference's
    baseline drivers emit the same [key : value] records their analyzer
    parses, scripts/test_FlashSparse.py:208-213)."""
    k = A.shape[1]
    if B.shape[0] == k:
        Bt = B.T if isinstance(B, jax.Array) else \
            np.ascontiguousarray(B.T)
    else:
        Bt = B
    fn = make_baseline_fn(name, csr, k)
    ms, out = time_jitted(fn, jnp.asarray(A), jnp.asarray(Bt),
                          iterations=iterations)
    log = RunLog(
        file=file,
        device=jax.devices()[0].device_kind,
        backend=name,
        m=csr.rows, n=csr.cols, k=k, nnz=csr.nnz,
        sparsity=csr.sparsity,
        sddmm_ms=ms,
    )
    if validate:
        from bsmr_sddmm_tpu.ops.sddmm import sddmm_ref
        from bsmr_sddmm_tpu.utils.checkdata import check_data
        A_np = np.asarray(A)
        B_np = np.asarray(B if B.shape[0] == k else B.T)
        expected = sddmm_ref(A_np, B_np, csr)
        res = check_data(expected, np.asarray(out))
        log.check_result = "pass" if res.passed else "fail"
        log.error_rate = res.error_rate
    return log
