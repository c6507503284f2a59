"""Hybrid SDDMM execution: dense tensor-core tiles + sparse residual.

The reference's dual-stream kernel pair (src/sddmmKernel.cu) as one JAX
program: the dense path maps reordered tiles onto batched matmuls
(reference: WMMA m16n16k8 pipeline, sddmmKernel.cu:213-351), the residual
path is a fused gather/multiply/reduce over COO entries (reference:
CUDA-core shuffle kernel, sddmmKernel.cu:1994-2104). Where the reference
scatters from tensor-core fragments inside the kernel epilogue
(sddmmKernel.cu:332-350), the tiers here write their own layout and one
gather along a precomputed map emits CSR order.

Every tier runs as XLA's own code by default (``backend="xla"``). The
dense and packed tiers can instead run the Pallas-Triton tile kernel
(``backend="triton"``, ops/triton_tiles.py), which reads A panels and B
blocks in place instead of gathering them first.

Both paths live inside one jitted function, chunked with ``lax.scan`` so
live memory stays bounded regardless of tile count. The two "streams" of
the reference (sddmmKernel.cu:2555-2648) become one XLA program; overlap is
the compiler's job, and the hybrid split itself is what saves the flops.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from bsmr_sddmm_tpu.config import SddmmConfig
from bsmr_sddmm_tpu.formats import CSR
from bsmr_sddmm_tpu.pack import TilePlan
from bsmr_sddmm_tpu.precision import dot_algorithm


def resolve_backend(backend: str) -> str:
    """``"auto"`` is XLA's own code on every platform; an explicit
    backend is taken as asked (a kernel that cannot compile raises)."""
    return "xla" if backend == "auto" else backend


class DevicePlan(NamedTuple):
    """Device-resident TilePlan arrays (reference: the h2d block at
    BSMR.cpp:252-264). ``tile_src`` is per-tile column-block ids (T,) in
    bsr mode, or gathered column ids (T, bw) in reorder mode."""

    row_perm_padded: jax.Array   # (num_panels*ph,) int32
    tile_panel: jax.Array        # (T,) int32
    tile_src: jax.Array          # (T,) cblock ids | (T, bw) col ids
    tile_scatter: jax.Array      # (T, ph, bw) int32
    sp_panel: jax.Array          # (Tp,) int32  (packed sub-block tier)
    sp_sub: jax.Array            # (Tp, S) int32 sub-block ids into Bt2
    sp_scatter: jax.Array        # (Tp, ph, bw) int32
    sp_colperm: jax.Array        # (H,) int32; Bt2 = take(Bt, sp_colperm)
    g_panel: jax.Array           # (Tg,) int32
    g_cols: jax.Array            # (Tg, bw) int32
    g_scatter: jax.Array         # (Tg, ph, bw) int32
    res_arow: jax.Array          # (E,) int32
    res_col: jax.Array           # (E,) int32
    res_out: jax.Array           # (E,) int32
    rphm_to_csr: jax.Array       # (nnz,) int32 (empty in shard-local plans)


def device_plan(plan: TilePlan, emit: str = "csr") -> DevicePlan:
    """Upload a TilePlan's arrays (reference h2d: BSMR.cpp:252-264).

    ``emit="rphm"`` uploads only what the rphm-emit body reads and
    replaces the five output-placement maps (tile/sp/g scatter, res_out,
    rphm_to_csr) with empty arrays: those maps are >95% of a plan's
    bytes ((T, ph, bw) int32 = 16 KB/tile vs 4 B/tile of gather ids) and
    the rphm hot path never touches them, so a sweep that times many
    plans does not upload (or hold on the device) bytes it never reads."""
    if plan.mode != "bsr":
        tile_src = plan.tile_cols
    elif plan.fat_group > 1:
        tile_src = plan.step_cblock       # one cblock per fat step
    else:
        tile_src = plan.tile_cblock
    light = emit == "rphm"
    empty = np.zeros(0, np.int32)

    def maps(arr, fallback_shape=(0,)):
        if light:
            return jnp.asarray(empty)
        if arr is None:
            return jnp.asarray(np.zeros(fallback_shape, np.int32))
        return jnp.asarray(arr)

    return DevicePlan(
        row_perm_padded=jnp.asarray(plan.row_perm_padded),
        tile_panel=jnp.asarray(plan.tile_panel),
        tile_src=jnp.asarray(tile_src),
        tile_scatter=maps(plan.tile_scatter),
        sp_panel=jnp.asarray(plan.sp_panel if plan.sp_panel is not None
                             else np.zeros(0, np.int32)),
        sp_sub=jnp.asarray(plan.sp_sub if plan.sp_sub is not None
                           else np.zeros((0, 1), np.int32)),
        sp_scatter=maps(plan.sp_scatter,
                        (0, plan.panel_height, plan.block_width)),
        sp_colperm=jnp.asarray(
            plan.sp_colperm if plan.sp_colperm is not None
            else np.zeros(0, np.int32)),
        g_panel=jnp.asarray(plan.g_panel),
        g_cols=jnp.asarray(plan.g_cols),
        g_scatter=maps(plan.g_scatter),
        res_arow=jnp.asarray(plan.res_arow),
        res_col=jnp.asarray(plan.res_col),
        res_out=maps(plan.res_out),
        rphm_to_csr=maps(plan.rphm_to_csr),
    )


def _serialize_tiers(plan: TilePlan, config: SddmmConfig) -> bool:
    """Decide the tier_serialize arm (see SddmmConfig.tier_serialize).

    "auto" serializes a plan whose residual tier's predicted share of
    the plan's time exceeds the device's measured
    ``serialize_residual_share`` (autotune.COSTS); a device whose row
    carries no such measurement never serializes."""
    mode = config.tier_serialize
    if mode in (True, "on"):
        return True
    if mode in (False, "off"):
        return False
    from bsmr_sddmm_tpu.autotune import (_affine, current_costs,
                                         estimate_plan_ms,
                                         serialize_threshold)
    threshold = serialize_threshold()
    if threshold is None:
        return False
    costs = current_costs()
    res_ms = plan.num_residual * _affine(costs, "pernnz", plan.k) / 1e6
    total_ms = max(estimate_plan_ms(plan, costs)
                   - costs["fixed_us"] / 1e3, 1e-9)
    return res_ms / total_ms > threshold


def make_sddmm_body(plan: TilePlan, config: SddmmConfig,
                    backend: Optional[str] = None,
                    emit: str = "csr",
                    only_tier: Optional[str] = None) -> Callable:
    """Build the un-jitted hybrid SDDMM body for one TilePlan shape bucket.

    ``fn(A, Bt, dplan)`` where A is (M, K) row-major, Bt is (N, K) — i.e.
    B^T, so both operand gathers are row gathers. Output layout:

    * ``emit="csr"``: (nnz,) — the result in original CSR value order
      (the reference contract: matrixP in CSR value order,
      sddmmKernel.cu:332-350), emitted as ONE gather along the
      precomputed ``rphm_to_csr`` map.
    * ``emit="rphm"``: ``(dense_out (T, ph, bw), packed_out (Tp, ph, bw),
      gathered_out (Tg, ph, bw), res_vals (E,))`` — the values in the
      plan's own four-tier layout, no per-element reorder anywhere;
      ``TilePlan.rphm_to_csr`` is the static bijection back to CSR order.
    * ``emit="csr_scatter"``: like "csr" but via per-slot scatter with a
      trailing trash slot — slower, but non-owned slots become zeros,
      which is what the shard_map psum combine needs.

    ``only_tier`` ("dense" | "gathered" | "residual") restricts the body
    to a single tier's output (emit is ignored) — the measurement hook
    behind the per-tier time split in RunLog (the reference's analogue is
    the dense/sparse overlap-efficiency measurement,
    src/sddmmKernel.cu:2834-2844).

    Shared by the single-chip jit and the shard_map multi-chip wrapper.
    """
    backend = resolve_backend(config.backend if backend is None else backend)
    if emit not in ("csr", "csr_scatter", "rphm"):
        raise ValueError(f"unknown emit {emit!r}")
    if only_tier not in (None, "dense", "packed", "gathered", "residual"):
        raise ValueError(f"unknown only_tier {only_tier!r}")
    ph, bw, k = plan.panel_height, plan.block_width, plan.k
    num_panels = max(plan.num_panels, 1)
    T = plan.tile_panel.shape[0]
    E = plan.res_arow.shape[0]
    nnz = plan.nnz
    precision = dot_algorithm(config.matmul_precision)
    # fp16 emission: fp32 accumulate, narrow store — halves every tier's
    # output bytes and passes the reference tolerance (see
    # SddmmConfig.out_dtype)
    out_dt = (jnp.float16 if config.out_dtype == "float16"
              else jnp.float32)
    def _chunk_of(n: int, want: int) -> int:
        """Largest chunk <= want that divides n exactly (plans from
        pack.exec_size are already exact multiples; shard-local plans are
        arbitrary slices, so fall back to the gcd)."""
        import math
        c = max(8, min(want, n))
        return c if n % c == 0 else max(math.gcd(n, c), 1)

    dense_chunk = _chunk_of(T, config.dense_chunk)
    res_chunk = _chunk_of(E, config.residual_chunk)

    mode = plan.mode
    G = plan.fat_group
    if backend not in ("xla", "triton"):
        raise ValueError(f"unknown backend {backend!r}")

    def tile_kernel(sw, group):
        # interpret mode exists for the CPU tests only; on the GPU the
        # kernel compiles through Triton or the call fails
        from bsmr_sddmm_tpu.ops.triton_tiles import make_tile_kernel
        return make_tile_kernel(
            ph=ph, bw=bw, k=k, sw=sw, group=group, precision=precision,
            out_dtype=out_dt, interpret=jax.default_backend() == "cpu")

    # the triton route covers the bsr dense tier and the packed tier;
    # reorder-mode dense tiles gather arbitrary columns and stay on XLA
    dense_kernel = (tile_kernel(bw, G)
                    if backend == "triton" and mode == "bsr" and T
                    else None)

    n_cblocks = -(-plan.cols // bw)

    budget_bytes = config.tier_memory_mb << 20

    def dense_out_fn(A_panels, Bt, dplan):
        """Compute all dense tiles -> (T, ph, bw).

        Plan counts are exact execution-chunk multiples (pack.exec_size),
        so no runtime pad-then-slice copies happen anywhere here."""
        if dense_kernel is not None:
            return dense_kernel(A_panels.reshape(-1, k), Bt,
                                dplan.tile_panel,
                                dplan.tile_src.reshape(-1, 1))

        if mode == "bsr" and G > 1:
            # XLA fat path: chunk over steps; one B-block gather + one
            # (C, G*ph, bw) batched matmul per chunk
            n_steps = T // G
            step_chunk = _chunk_of(n_steps, dense_chunk)
            S = n_steps // step_chunk
            npad2 = n_cblocks * bw - plan.cols
            Bt_pad2 = jnp.pad(Bt, ((0, npad2), (0, 0))) if npad2 else Bt
            B_blocks2 = Bt_pad2.reshape(n_cblocks, bw, k)

            def fat_step(_, chunk):
                cb_c, tp_c = chunk
                b = jnp.take(B_blocks2, cb_c, axis=0)       # (C, bw, K)
                a = jnp.take(A_panels, tp_c, axis=0) \
                    .reshape(step_chunk, G * ph, k)
                out = jax.lax.dot_general(
                    a, b, dimension_numbers=(((2,), (2,)), ((0,), (0,))),
                    precision=precision,
                    preferred_element_type=jnp.float32)  # (C, G*ph, bw)
                return None, out.astype(out_dt)

            chunks = (dplan.tile_src.reshape(S, step_chunk),
                      dplan.tile_panel.reshape(S, step_chunk * G))
            if S == 1:
                out = fat_step(None, jax.tree.map(lambda x: x[0],
                                                  chunks))[1]
            else:
                _, out = jax.lax.scan(fat_step, None, chunks)
            return out.reshape(T, ph, bw)

        S = T // dense_chunk

        if mode == "bsr":
            npad = n_cblocks * bw - plan.cols
            Bt_pad = jnp.pad(Bt, ((0, npad), (0, 0))) if npad else Bt
            B_blocks = Bt_pad.reshape(n_cblocks, bw, k)

            def gather_b(src_c):
                # whole-block gather: contiguous bw*K slices
                return jnp.take(B_blocks, src_c, axis=0)  # (C, bw, K)
        else:
            def gather_b(src_c):
                b = jnp.take(Bt, src_c.reshape(-1), axis=0)
                return b.reshape(-1, bw, k)

        def matmul(b, panel_c):
            a = jnp.take(A_panels, panel_c, axis=0)    # (C, ph, K)
            return jax.lax.dot_general(
                a, b,
                dimension_numbers=(((2,), (2,)), ((0,), (0,))),
                precision=precision,
                preferred_element_type=jnp.float32,
            ).astype(out_dt)                           # (C, ph, bw)

        if T * bw * k * 4 <= budget_bytes:
            # single-shot: one gather + one batched matmul
            return matmul(gather_b(dplan.tile_src), dplan.tile_panel)

        def dense_step(_, chunk):
            panel_c, src_c = chunk
            return None, matmul(gather_b(src_c), panel_c)

        src_shape = ((S, dense_chunk) if dplan.tile_src.ndim == 1
                     else (S, dense_chunk, bw))
        chunks = (dplan.tile_panel.reshape(S, dense_chunk),
                  dplan.tile_src.reshape(src_shape))
        if S == 1:
            out = dense_step(None, jax.tree.map(lambda x: x[0], chunks))[1]
        else:
            _, out = jax.lax.scan(dense_step, None, chunks)
            out = out.reshape(T, ph, bw)
        return out

    # --- hot-column packed tier -------------------------------------------
    Tp = plan.sp_panel.shape[0] if plan.sp_panel is not None else 0
    sw = plan.subblock_width
    S = plan.sp_sub.shape[1] if (Tp and plan.sp_sub is not None) else 0
    H_cp = (plan.sp_colperm.shape[0]
            if (Tp and plan.sp_colperm is not None) else 0)
    n_sb = H_cp // sw if sw else 0
    subpack_kernel = (tile_kernel(sw, 1)
                      if backend == "triton" and Tp else None)

    def packed_out_fn(A_panels, Bt, dplan):
        """Compute all hot-column packed tiles -> (Tp, ph, bw).

        Bt2 = take(Bt, colperm) is ONE gather per call (hot residual
        columns made contiguous); each tile's B operand is then S
        contiguous (sw, K) slices of Bt2 instead of bw gathered rows."""
        if Tp == 0:
            return jnp.zeros((0, ph, bw), out_dt)
        Bt2 = jnp.take(Bt, dplan.sp_colperm, axis=0)    # (H, K)
        if subpack_kernel is not None:
            return subpack_kernel(A_panels.reshape(-1, k), Bt2,
                                  dplan.sp_panel, dplan.sp_sub)
        # XLA path: block-gather the sub-blocks, one batched matmul
        B_sub = Bt2.reshape(n_sb, sw, k)

        def tiles_matmul(pc, sc):
            n_t = pc.shape[0]
            b = jnp.take(B_sub, sc.reshape(-1), axis=0) \
                .reshape(n_t, bw, k)
            a = jnp.take(A_panels, pc, axis=0)       # (C, ph, K)
            return jax.lax.dot_general(
                a, b, dimension_numbers=(((2,), (2,)), ((0,), (0,))),
                precision=precision,
                preferred_element_type=jnp.float32).astype(out_dt)

        if Tp * bw * k * 4 <= budget_bytes:
            return tiles_matmul(dplan.sp_panel, dplan.sp_sub)
        pchunk = _chunk_of(Tp, dense_chunk)
        pc_big = max(pchunk, Tp // 32)
        pc_big = pc_big if Tp % pc_big == 0 else pchunk
        parts = []
        for s in range(0, Tp, pc_big):
            parts.append(tiles_matmul(
                jax.lax.slice_in_dim(dplan.sp_panel, s, s + pc_big),
                jax.lax.slice_in_dim(dplan.sp_sub, s, s + pc_big)))
        return jnp.concatenate(parts, axis=0)

    Tg = plan.g_panel.shape[0]

    def gathered_out_fn(A_panels, Bt, dplan):
        """Compute all gathered-column tiles -> (Tg, ph, bw).

        The B operand is a row gather of each tile's bw columns — one
        take() per chunk, then a batched matmul.
        """
        g_chunk = _chunk_of(Tg, dense_chunk)

        def tiles_matmul(pc, cc, B_src):
            n_t = pc.shape[0]
            b = jnp.take(B_src, cc.reshape(-1), axis=0) \
                .reshape(n_t, bw, k)
            a = jnp.take(A_panels, pc, axis=0)       # (C, ph, K)
            return jax.lax.dot_general(
                a, b, dimension_numbers=(((2,), (2,)), ((0,), (0,))),
                precision=precision,
                preferred_element_type=jnp.float32).astype(out_dt)

        if plan.g_groups is not None and plan.num_gathered:
            # windowed gathers: each static (base, start, end) group of
            # window-pure tiles gathers from the static window slice
            # Bt[base : base + window_rows] (SddmmConfig.gather_window_mb)
            W = plan.window_rows
            parts = []
            for base, s0, e0 in plan.g_groups:
                window = jax.lax.slice_in_dim(Bt, base, base + W)
                for c0 in range(s0, e0, g_chunk):
                    c1 = min(c0 + g_chunk, e0)
                    pc = jax.lax.slice_in_dim(dplan.g_panel, c0, c1)
                    cc = jax.lax.slice_in_dim(dplan.g_cols, c0, c1) - base
                    parts.append(tiles_matmul(pc, cc, window))
            tail = Tg - plan.num_gathered
            if tail:
                parts.append(jnp.zeros((tail, ph, bw), out_dt))
            return jnp.concatenate(parts, axis=0)

        if Tg * bw * k * 4 <= budget_bytes:
            # single-shot: one row gather + one batched matmul
            return tiles_matmul(dplan.g_panel, dplan.g_cols, Bt)

        # above budget: an UNROLLED chunk loop (independent chunks the
        # scheduler can overlap), not a lax.scan
        gc = max(g_chunk, Tg // 32)   # cap the unroll length
        gc = gc if Tg % gc == 0 else g_chunk
        parts = []
        for s in range(0, Tg, gc):
            pc = jax.lax.slice_in_dim(dplan.g_panel, s, s + gc)
            cc = jax.lax.slice_in_dim(dplan.g_cols, s, s + gc)
            parts.append(tiles_matmul(pc, cc, Bt))
        return jnp.concatenate(parts, axis=0)

    def res_vals_fn(A_perm, Bt, dplan):
        """Compute all residual values -> (E,)."""
        def dots(arow_c, col_c, B_src):
            a = jnp.take(A_perm, arow_c, axis=0)   # (C, K)
            b = jnp.take(B_src, col_c, axis=0)     # (C, K)
            return jnp.sum(a * b, axis=-1).astype(out_dt)  # fp32 acc

        if plan.res_groups is not None and plan.num_residual:
            # windowed gathers on either/both operands
            Wb = plan.window_rows
            Wa = plan.a_window_rows
            parts = []
            for a_base, b_base, s0, e0 in plan.res_groups:
                B_src = (jax.lax.slice_in_dim(Bt, b_base, b_base + Wb)
                         if b_base >= 0 else Bt)
                A_src = (jax.lax.slice_in_dim(A_perm, a_base,
                                              a_base + Wa)
                         if a_base >= 0 else A_perm)
                for c0 in range(s0, e0, res_chunk):
                    c1 = min(c0 + res_chunk, e0)
                    ar = jax.lax.slice_in_dim(dplan.res_arow, c0, c1)
                    rc = jax.lax.slice_in_dim(dplan.res_col, c0, c1)
                    if a_base >= 0:
                        ar = ar - a_base
                    if b_base >= 0:
                        rc = rc - b_base
                    a = jnp.take(A_src, ar, axis=0)
                    b = jnp.take(B_src, rc, axis=0)
                    parts.append(jnp.sum(a * b, axis=-1).astype(out_dt))
            tail = E - plan.num_residual
            if tail:
                parts.append(jnp.zeros(tail, out_dt))
            return jnp.concatenate(parts)

        if E * k * 4 * 2 <= budget_bytes:
            return dots(dplan.res_arow, dplan.res_col, Bt)

        # unrolled chunks, as in gathered_out_fn
        rc = max(res_chunk, E // 32)
        rc = rc if E % rc == 0 else res_chunk
        parts = []
        for s in range(0, E, rc):
            ar = jax.lax.slice_in_dim(dplan.res_arow, s, s + rc)
            cl = jax.lax.slice_in_dim(dplan.res_col, s, s + rc)
            parts.append(dots(ar, cl, Bt))
        return jnp.concatenate(parts)

    def fn(A: jax.Array, Bt: jax.Array, dplan: DevicePlan):
        A = A.astype(jnp.float32)
        Bt = Bt.astype(jnp.float32)
        A_perm = jnp.take(A, dplan.row_perm_padded, axis=0)  # (P*ph, K)
        A_panels = A_perm.reshape(num_panels, ph, k)
        if only_tier == "dense":
            return dense_out_fn(A_panels, Bt, dplan)
        if only_tier == "packed":
            return packed_out_fn(A_panels, Bt, dplan)
        if only_tier == "gathered":
            return gathered_out_fn(A_panels, Bt, dplan)
        if only_tier == "residual":
            return res_vals_fn(A_perm, Bt, dplan)
        if _serialize_tiers(plan, config):
            # force tier-at-a-time scheduling: the barrier threads each
            # tier's output into the next tier's operands so the
            # compiler cannot interleave them
            dense_out = dense_out_fn(A_panels, Bt, dplan)
            dense_out, A_panels, Bt = jax.lax.optimization_barrier(
                (dense_out, A_panels, Bt))
            packed_out = packed_out_fn(A_panels, Bt, dplan)
            packed_out, A_panels, Bt = jax.lax.optimization_barrier(
                (packed_out, A_panels, Bt))
            gathered_out = gathered_out_fn(A_panels, Bt, dplan)
            gathered_out, A_perm, Bt = jax.lax.optimization_barrier(
                (gathered_out, A_perm, Bt))
            res_vals = res_vals_fn(A_perm, Bt, dplan)
        else:
            dense_out = dense_out_fn(A_panels, Bt, dplan)
            packed_out = packed_out_fn(A_panels, Bt, dplan)
            gathered_out = gathered_out_fn(A_panels, Bt, dplan)
            res_vals = res_vals_fn(A_perm, Bt, dplan)
        if emit == "rphm":
            # four tiers, four arrays — never concatenated (gluing the
            # packed tier onto the dense output would copy the whole
            # dense tier through device memory)
            return dense_out, packed_out, gathered_out, res_vals
        if emit == "csr":
            # one gather along the precomputed inverse map — no scatter
            big = jnp.concatenate([dense_out.reshape(-1),
                                   packed_out.reshape(-1),
                                   gathered_out.reshape(-1), res_vals])
            return jnp.take(big, dplan.rphm_to_csr)
        # "csr_scatter": scatter every (padded) slot; slow, but each
        # non-owned slot lands in the trash element, which is what the
        # shard_map path needs (per-shard partials psum to the total)
        P = jnp.zeros(nnz + 1, dtype=out_dt)
        P = P.at[dplan.tile_scatter.reshape(-1)].set(
            dense_out.reshape(-1), mode="drop", unique_indices=False)
        if Tp:
            P = P.at[dplan.sp_scatter.reshape(-1)].set(
                packed_out.reshape(-1), mode="drop", unique_indices=False)
        P = P.at[dplan.g_scatter.reshape(-1)].set(
            gathered_out.reshape(-1), mode="drop", unique_indices=False)
        P = P.at[dplan.res_out].set(res_vals, mode="drop",
                                    unique_indices=False)
        return P

    return fn


def make_sddmm_fn(plan: TilePlan, config: SddmmConfig,
                  backend: Optional[str] = None,
                  emit: str = "csr") -> Callable:
    """Jitted single-device hybrid SDDMM. With ``emit="csr"`` (default):
    ``fn(A, Bt, dplan) -> P`` with P (nnz,) in original CSR value order
    (reference semantics: sddmm_gpu writes matrixP in CSR value order,
    sddmmKernel.cu:332-350). With ``emit="rphm"``: the tile-layout pair —
    see make_sddmm_body."""
    body = make_sddmm_body(plan, config, backend, emit=emit)
    nnz = plan.nnz

    if emit in ("rphm", "csr"):
        return jax.jit(body)

    def fn(A, Bt, dplan):
        return body(A, Bt, dplan)[:nnz]

    return jax.jit(fn)


def make_batched_sddmm_fn(plan: TilePlan, config: SddmmConfig,
                          backend: Optional[str] = None,
                          emit: str = "csr") -> Callable:
    """Batched hybrid SDDMM over a leading Z dimension of both operands
    (reference sddmm_gpu_batch, src/sddmmKernel.cu:2764-2850, which runs
    the batch over grid.z): ``fn(A (Z, M, K), Bt (Z, N, K), dplan)``.

    The TilePlan (mask structure) is shared across the batch — the
    reference's batch semantics. The default (``backend=None``/"auto")
    vmaps the XLA body: the per-tile matmuls become batched contractions
    and the gathered/residual row gathers stay single big takes with a
    batch dim. Explicit ``backend="triton"`` instead runs a ``lax.map``
    over the leading axis, one kernel launch per batch element."""
    explicit = backend is not None and \
        resolve_backend(backend) == "triton"
    nnz = plan.nnz
    if explicit:
        body = make_sddmm_body(plan, config, backend, emit=emit)

        def mapped(A, Bt, dplan):
            return jax.lax.map(lambda ab: body(ab[0], ab[1], dplan),
                               (A, Bt))
    else:
        body = make_sddmm_body(plan, config, "xla", emit=emit)
        mapped = jax.vmap(body, in_axes=(0, 0, None))
    if emit in ("rphm", "csr"):
        return jax.jit(mapped)

    def fn(A, Bt, dplan):
        return mapped(A, Bt, dplan)[:, :nnz]

    return jax.jit(fn)


# ---------------------------------------------------------------------------
# Reference oracle + simple baselines
# ---------------------------------------------------------------------------

def sddmm_ref(A: np.ndarray, B: np.ndarray, csr: CSR,
              chunk: int = 1 << 18) -> np.ndarray:
    """CPU oracle: P = (A @ B) sampled at the mask's nonzeros, in CSR value
    order (reference sddmm_cpu, src/host.cpp:44-91). fp64 accumulate so the
    oracle is strictly more accurate than any device path."""
    rows = csr.coo_rows()
    cols = csr.col_indices
    out = np.empty(csr.nnz, dtype=np.float64)
    Bt = np.ascontiguousarray(B.T)
    for s in range(0, csr.nnz, chunk):
        e = min(s + chunk, csr.nnz)
        out[s:e] = np.einsum(
            "ij,ij->i",
            A[rows[s:e]].astype(np.float64),
            Bt[cols[s:e]].astype(np.float64))
    return out.astype(np.float32)
