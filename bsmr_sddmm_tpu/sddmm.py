"""Orchestration: reorder -> pack -> execute -> validate -> log.

The counterpart of the reference's sddmm() driver
(src/sddmm.cu:10-39): BSMR reorder, RPHM pack, hybrid kernel, evaluation,
optional validation — with the preprocessing cached per (matrix, alpha)
so a delta/K sweep reuses the expensive row clustering the way test mode
does (src/sddmm.cu:62-118 reuses rowReordering per alpha).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from bsmr_sddmm_tpu.config import SddmmConfig
from bsmr_sddmm_tpu.formats import CSR
from bsmr_sddmm_tpu.ops.sddmm import (device_plan, make_sddmm_fn,
                                      resolve_backend, sddmm_ref)
from bsmr_sddmm_tpu.pack import TilePlan, pack_tiles
from bsmr_sddmm_tpu.reorder import (BsmrReordering, row_reordering,
                                    split_columns)
from bsmr_sddmm_tpu.utils.checkdata import check_data
from bsmr_sddmm_tpu.utils.logger import RunLog
from bsmr_sddmm_tpu.utils.timing import time_jitted


class BsmrSddmm:
    """Reusable pipeline for one mask matrix.

    Caches the row reordering per alpha (the dominant preprocessing cost,
    BASELINE.md: median 1.11 s on the reference) and the compiled kernel
    per plan shape bucket.
    """

    def __init__(self, csr: CSR, config: Optional[SddmmConfig] = None):
        self.csr = csr
        self.config = config or SddmmConfig()
        self._row_cache: Dict[Tuple[float, str], BsmrReordering] = {}
        self._fn_cache: Dict[Tuple, object] = {}

    def _row_reordering(self, alpha: Optional[float] = None
                        ) -> BsmrReordering:
        cfg = self.config
        alpha = cfg.alpha if alpha is None else alpha
        key = (alpha, cfg.row_strategy)
        if key not in self._row_cache:
            if cfg.reorder_cache:
                from bsmr_sddmm_tpu.cache import cached_row_reordering
                self._row_cache[key] = cached_row_reordering(
                    self.csr, alpha, cfg.replace(alpha=alpha))
            else:
                self._row_cache[key] = row_reordering(
                    self.csr, alpha, cfg.replace(alpha=alpha))
        return self._row_cache[key]

    def reorder(self, alpha: Optional[float] = None,
                delta: Optional[float] = None) -> BsmrReordering:
        cfg = self.config
        delta = cfg.delta if delta is None else delta
        base = self._row_reordering(alpha)
        # column split is cheap; recompute per delta on a shallow copy
        reord = dataclasses.replace(base)
        return split_columns(self.csr, reord, cfg, delta=delta)

    def choose(self, alpha=None, k: Optional[int] = None,
               refine_top: int = 0):
        """Full autotune decision: best tiled plan across the delta
        candidates (autotune.DeltaChoice), or — with ``alpha="auto"`` —
        across the whole (alpha, delta, subpack) grid
        (autotune.ConfigChoice, the reference's test-mode sweep priced
        host-side); either may instead pick the dense-fallback tier when
        the cost model says a masked full matmul wins (near-uniform
        masks). ``refine_top=N`` re-times the N best-priced plans on
        the device and picks the measured argmin (autotune.choose_config)
        — the fused-schedule overlap the affine model cannot see."""
        if alpha == "auto":
            from bsmr_sddmm_tpu.autotune import choose_config
            return choose_config(self.csr, self._row_reordering,
                                 self.config, k=k or self.config.k,
                                 refine_top=(refine_top or
                                             self.config.autotune_refine_top))
        from bsmr_sddmm_tpu.autotune import choose_delta
        base = self._row_reordering(alpha)
        return choose_delta(self.csr, base, self.config,
                            k=k or self.config.k)

    def plan(self, alpha: Optional[float] = None,
             delta=None, k: Optional[int] = None) -> TilePlan:
        """Pack a plan. ``delta="auto"`` picks the delta with the lowest
        predicted kernel time from the measured tier cost model
        (autotune.choose_delta) — priced instead of the reference's
        on-hardware config sweep."""
        if delta == "auto":
            return self.choose(alpha, k=k).plan
        if alpha == "auto":
            raise ValueError('alpha="auto" requires delta="auto"')
        reord = self.reorder(alpha, delta)
        return pack_tiles(self.csr, reord, self.config,
                          k=k or self.config.k)

    def dense_fn(self, k: int):
        """Compiled dense-fallback executor: XLA's sampled dense dot
        (bcoo_dot_general_sampled) — the full A @ B with the mask's
        extraction fused into the product by the compiler, never
        materializing (M, N), instead of an explicit
        masked-matmul-then-gather out of the product."""
        key = ("dense_fallback", k)
        if key not in self._fn_cache:
            from bsmr_sddmm_tpu.baselines import make_bcoo_fn
            self._fn_cache[key] = make_bcoo_fn(self.csr, k)
        return self._fn_cache[key]

    def compile(self, plan: TilePlan, backend: Optional[str] = None,
                emit: str = "csr"):
        # the cache key must cover EVERY plan attribute make_sddmm_body
        # bakes in as a static: two sweep deltas can bucket to identical
        # shapes yet differ in fat grouping, window-group boundaries, or
        # real-tile tails — running one plan's dplan through the other's
        # compiled body would be silently wrong.
        key = (plan.tile_panel.shape, plan.g_panel.shape,
               plan.res_arow.shape, plan.num_panels,
               plan.k, plan.nnz, plan.mode, emit,
               backend or self.config.backend,
               plan.sp_panel.shape if plan.sp_panel is not None else None,
               plan.sp_colperm.shape
               if plan.sp_colperm is not None else None,
               plan.num_packed, plan.subblock_width,
               plan.fat_group, plan.window_rows, plan.a_window_rows,
               plan.num_gathered, plan.num_residual,
               tuple(plan.g_groups) if plan.g_groups is not None else None,
               tuple(plan.res_groups)
               if plan.res_groups is not None else None)
        if key not in self._fn_cache:
            self._fn_cache[key] = make_sddmm_fn(plan, self.config, backend,
                                                emit=emit)
        return self._fn_cache[key]

    def run(self, A: np.ndarray, B: np.ndarray,
            alpha: Optional[float] = None, delta: Optional[float] = None,
            backend: Optional[str] = None) -> np.ndarray:
        """One-shot execution; returns P (nnz,) in CSR value order.

        ``delta="auto"`` autotunes over tiled plans AND the dense-fallback
        tier; ``delta="dense"`` forces the fallback (masked full matmul,
        no preprocessing)."""
        k = A.shape[1]
        Bt = np.ascontiguousarray(B.T) if B.shape[0] == k else B
        plan = None
        if delta == "auto":
            choice = self.choose(alpha, k=k)   # one autotune pass
            if alpha == "auto":
                alpha = choice.alpha
            if choice.use_dense:
                delta = "dense"
            else:
                plan = choice.plan
        elif alpha == "auto":
            raise ValueError('alpha="auto" requires delta="auto"')
        if delta == "dense":
            fn = self.dense_fn(k)
            return np.asarray(fn(jnp.asarray(A), jnp.asarray(Bt)))
        if plan is None:
            plan = self.plan(alpha, delta, k=k)
        fn = self.compile(plan, backend)
        dplan = device_plan(plan)
        out = fn(jnp.asarray(A), jnp.asarray(Bt), dplan)
        return np.asarray(out)

    def benchmark(self, A: np.ndarray, B: np.ndarray,
                  alpha: Optional[float] = None,
                  delta: Optional[float] = None,
                  backend: Optional[str] = None,
                  validate: bool = False,
                  tier_times: bool = False,
                  time_csr_emit: bool = True,
                  file: str = "") -> RunLog:
        """Timed run producing a reference-schema RunLog
        (src/sddmmKernel.cu:2561-2659 timing loop + Logger fields)."""
        cfg = self.config
        k = A.shape[1]
        plan = None
        if delta == "auto":
            choice = self.choose(alpha, k=k)   # one autotune pass
            if alpha == "auto":
                alpha = choice.alpha
            if choice.use_dense:
                delta = "dense"
            else:
                plan = choice.plan
                delta = plan.delta_used
                reord = self._row_reordering(alpha)
        elif alpha == "auto":
            raise ValueError('alpha="auto" requires delta="auto"')
        if delta == "dense":
            return self._benchmark_dense(A, B, alpha=alpha,
                                         validate=validate, file=file)
        if plan is None:
            reord = self.reorder(alpha, delta)
            plan = pack_tiles(self.csr, reord, cfg, k=k)
        # timing uses the LIGHT device plan (no output-placement maps —
        # they are >95% of plan bytes and the rphm body never reads
        # them); the full plan uploads only when the csr-emit path
        # actually runs (see device_plan)
        dplan = device_plan(plan, emit="rphm")
        if B.shape[0] == k:
            # (K, N) input: transpose (device-side for jax arrays — no
            # host round-trip / re-upload)
            Bt = B.T if isinstance(B, jax.Array) else \
                np.ascontiguousarray(B.T)
        else:
            Bt = B
        A_dev, Bt_dev = jnp.asarray(A), jnp.asarray(Bt)
        # headline kernel time: values in the plan's own (rphm) layout —
        # every nonzero computed exactly once, no per-element reorder.
        # On device the timing runs IN-PROGRAM (fori_loop repetition, one
        # submission per batch), so per-call dispatch does not count
        # against sub-ms kernels (utils/timing.time_rphm_inprogram).
        fn_rphm = self.compile(plan, backend, emit="rphm")
        if jax.default_backend() != "cpu":
            from bsmr_sddmm_tpu.ops.sddmm import make_sddmm_body
            from bsmr_sddmm_tpu.utils.timing import time_rphm_inprogram
            body = make_sddmm_body(plan, cfg, backend, emit="rphm")
            ms = time_rphm_inprogram(body, A_dev, Bt_dev, dplan,
                                     iterations=cfg.num_iterations)
        else:
            ms, _ = time_jitted(fn_rphm, A_dev, Bt_dev, dplan,
                                iterations=cfg.num_iterations)
        # CSR-order emission (reference output contract) timed separately;
        # skippable (the sweep driver only needs the rphm headline, and
        # the csr executable is an extra compile per shape bucket). Only
        # this path needs the full device plan (output-placement maps).
        if time_csr_emit or validate:
            fn = self.compile(plan, backend, emit="csr")
            dplan_full = device_plan(plan)
        if time_csr_emit:
            ms_csr, out = time_jitted(fn, A_dev, Bt_dev, dplan_full,
                                      iterations=cfg.num_iterations)
        elif validate:
            ms_csr, out = 0.0, fn(A_dev, Bt_dev, dplan_full)
        else:
            ms_csr, out = 0.0, None
        log = RunLog(
            file=file,
            device=jax.devices()[0].device_kind,
            backend=resolve_backend(backend or cfg.backend),
            m=self.csr.rows, n=self.csr.cols, k=k, nnz=self.csr.nnz,
            sparsity=self.csr.sparsity,
            alpha=cfg.alpha if alpha is None else alpha,
            delta=cfg.delta if delta is None else delta,
            panel_height=cfg.panel_height, block_width=cfg.block_width,
            num_clusters=reord.num_clusters,
            num_row_panels=plan.num_panels,
            num_dense_blocks=plan.num_tiles,
            num_packed_blocks=plan.num_packed,
            num_gathered_blocks=plan.num_gathered,
            dense_nnz=plan.dense_nnz,
            packed_nnz=plan.packed_nnz,
            gathered_nnz=plan.gathered_nnz,
            residual_nnz=plan.residual_nnz,
            average_tile_density=plan.average_tile_density,
            row_reordering_ms=reord.row_time_ms,
            col_reordering_ms=reord.col_time_ms,
            pack_ms=plan.pack_time_ms,
            sddmm_ms=ms,
        )
        log.extras["sddmm_csr_ms"] = f"{ms_csr:.6f}"
        log.extras["gflops_csr"] = (
            f"{2.0 * self.csr.nnz * k / (ms_csr * 1e6):.3f}"
            if ms_csr > 0 else "0")
        if tier_times:
            # measured per-tier time split (each tier compiled alone) —
            # the analogue of the reference's dense/sparse overlap
            # measurement (src/sddmmKernel.cu:2834-2844). The tiers run
            # fused in one program in production, so the sum can exceed
            # the fused time; the split shows where the time goes.
            from bsmr_sddmm_tpu.ops.sddmm import make_sddmm_body
            tier_ms = {}
            tiers = ["dense", "gathered", "residual"]
            if plan.num_packed:
                tiers.insert(1, "packed")
            for tier in tiers:
                tfn = jax.jit(make_sddmm_body(plan, cfg, backend,
                                              only_tier=tier))
                t_ms, _ = time_jitted(tfn, A_dev, Bt_dev, dplan,
                                      iterations=cfg.num_iterations)
                tier_ms[tier] = t_ms
            log.extras["tier_dense_ms"] = f"{tier_ms['dense']:.6f}"
            if plan.num_packed:
                log.extras["tier_packed_ms"] = f"{tier_ms['packed']:.6f}"
            log.extras["tier_gathered_ms"] = f"{tier_ms['gathered']:.6f}"
            log.extras["tier_residual_ms"] = f"{tier_ms['residual']:.6f}"
            overlap = sum(tier_ms.values()) / ms if ms > 0 else 0.0
            log.extras["tier_overlap_efficiency"] = f"{overlap:.3f}"
        if validate:
            # materialize device-resident operands host-side so the
            # oracle really accumulates in fp64
            A_np = np.asarray(A)
            B_np = np.asarray(B if B.shape[0] == k else B.T)
            expected = sddmm_ref(A_np, B_np, self.csr)
            res = check_data(expected, np.asarray(out))
            log.check_result = "pass" if res.passed else "fail"
            log.error_rate = res.error_rate
            log.extras["max_rel_err"] = f"{res.max_rel_err:.3e}"
        return log

    def _benchmark_dense(self, A: np.ndarray, B: np.ndarray,
                         alpha: Optional[float] = None,
                         validate: bool = False,
                         file: str = "") -> RunLog:
        """Timed dense-fallback run (masked full matmul tier): no
        reordering, no packing — the cost model picked the full product
        over tiles."""
        cfg = self.config
        k = A.shape[1]
        if B.shape[0] == k:
            Bt = B.T if isinstance(B, jax.Array) else \
                np.ascontiguousarray(B.T)
        else:
            Bt = B
        fn = self.dense_fn(k)
        A_dev, Bt_dev = jnp.asarray(A), jnp.asarray(Bt)
        ms, out = time_jitted(fn, A_dev, Bt_dev,
                              iterations=cfg.num_iterations)
        log = RunLog(
            file=file,
            device=jax.devices()[0].device_kind,
            backend="dense_fallback",
            m=self.csr.rows, n=self.csr.cols, k=k, nnz=self.csr.nnz,
            sparsity=self.csr.sparsity,
            alpha=cfg.alpha if alpha is None else alpha,
            delta=float("nan"),
            panel_height=cfg.panel_height, block_width=cfg.block_width,
            sddmm_ms=ms,
        )
        log.extras["strategy"] = "dense_fallback"
        if validate:
            A_np = np.asarray(A)
            B_np = np.asarray(B if B.shape[0] == k else B.T)
            expected = sddmm_ref(A_np, B_np, self.csr)
            res = check_data(expected, np.asarray(out))
            log.check_result = "pass" if res.passed else "fail"
            log.error_rate = res.error_rate
            log.extras["max_rel_err"] = f"{res.max_rel_err:.3e}"
        return log


def sddmm(A: np.ndarray, B: np.ndarray, csr: CSR,
          config: Optional[SddmmConfig] = None) -> np.ndarray:
    """Functional one-shot entry point (reference sddmm(),
    src/sddmm.cu:10-39). A is (M, K); B is (K, N) or pre-transposed
    (N, K); returns P values aligned with csr.values order."""
    return BsmrSddmm(csr, config).run(A, B)
