"""Tile-native graph ops: edge softmax + SpMM over the rphm layout.

The hybrid SDDMM's natural output is the plan's own three-tier layout
(`emit="rphm"`: dense tiles, gathered tiles, per-nnz residual). Consumers
that round-trip through CSR order pay an element gather per conversion;
these ops instead run the rest of sparse attention *in tile layout*:

    scores (rphm) -> edge_softmax_rphm -> alpha (rphm)
    alpha (rphm), V -> spmm_rphm -> (M, F) node features

Row-wise reductions become per-tile reductions + tiny segment ops
over panels; the SpMM's dense tier is per-tile (ph, bw) @ (bw, F)
matmuls against *contiguous* V blocks — the same zero-gather property the
SDDMM's dense tier enjoys. Nothing in this file touches per-element
indexing except the small per-nnz residual tier.

Validity masking: a tile slot is real iff its scatter index < nnz (the
trash-slot convention of pack.TilePlan), so masks come free from arrays
already on the device.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from bsmr_sddmm_tpu.ops.sddmm import DevicePlan
from bsmr_sddmm_tpu.pack import TilePlan
from bsmr_sddmm_tpu.precision import dot_algorithm

_NEG = -1e30  # mask value; avoids inf-inf NaNs in empty rows


def make_edge_softmax_rphm(plan: TilePlan) -> Callable:
    """Build ``fn(dense, packed, gathered, res, dplan) -> same 4-tuple``
    normalizing scores row-wise (numerically stable) entirely in the
    four-tier rphm layout (no tier is ever concatenated — that would
    copy the full dense output through device memory)."""
    P = max(plan.num_panels, 1)
    ph = plan.panel_height
    nnz = plan.nnz
    n_rows = P * ph
    Tp = plan.sp_panel.shape[0] if plan.sp_panel is not None else 0

    def fn(dense: jax.Array, packed: jax.Array, gathered: jax.Array,
           res: jax.Array, dplan: DevicePlan):
        d_valid = dplan.tile_scatter < nnz          # (T, ph, bw)
        g_valid = dplan.g_scatter < nnz             # (Tg, ph, bw)
        r_valid = dplan.res_out < nnz               # (E,)

        d_masked = jnp.where(d_valid, dense, _NEG)
        g_masked = jnp.where(g_valid, gathered, _NEG)
        r_masked = jnp.where(r_valid, res, _NEG)

        # --- row max over (panel, local row) -----------------------------
        d_rowmax = jax.ops.segment_max(
            d_masked.max(axis=2), dplan.tile_panel, num_segments=P)
        g_rowmax = jax.ops.segment_max(
            g_masked.max(axis=2), dplan.g_panel, num_segments=P)
        r_rowmax = jax.ops.segment_max(
            r_masked, dplan.res_arow, num_segments=n_rows).reshape(P, ph)
        row_max = jnp.maximum(jnp.maximum(d_rowmax, g_rowmax), r_rowmax)
        if Tp:
            p_valid = dplan.sp_scatter < nnz
            p_masked = jnp.where(p_valid, packed, _NEG)
            p_rowmax = jax.ops.segment_max(
                p_masked.max(axis=2), dplan.sp_panel, num_segments=P)
            row_max = jnp.maximum(row_max, p_rowmax)
        row_max = jnp.maximum(row_max, _NEG / 2)    # empty rows stay finite

        # --- exp + row sum ------------------------------------------------
        d_exp = jnp.where(
            d_valid, jnp.exp(dense - row_max[dplan.tile_panel][:, :, None]),
            0.0)
        g_exp = jnp.where(
            g_valid, jnp.exp(gathered - row_max[dplan.g_panel][:, :, None]),
            0.0)
        r_exp = jnp.where(
            r_valid, jnp.exp(res - row_max.reshape(-1)[dplan.res_arow]),
            0.0)

        d_rowsum = jax.ops.segment_sum(
            d_exp.sum(axis=2), dplan.tile_panel, num_segments=P)
        g_rowsum = jax.ops.segment_sum(
            g_exp.sum(axis=2), dplan.g_panel, num_segments=P)
        r_rowsum = jax.ops.segment_sum(
            r_exp, dplan.res_arow, num_segments=n_rows).reshape(P, ph)
        denom = d_rowsum + g_rowsum + r_rowsum
        if Tp:
            p_exp = jnp.where(
                p_valid,
                jnp.exp(packed - row_max[dplan.sp_panel][:, :, None]),
                0.0)
            denom = denom + jax.ops.segment_sum(
                p_exp.sum(axis=2), dplan.sp_panel, num_segments=P)
        else:
            p_exp = packed
        denom = jnp.maximum(denom, 1e-20)

        return (d_exp / denom[dplan.tile_panel][:, :, None],
                (p_exp / denom[dplan.sp_panel][:, :, None]
                 if Tp else packed),
                g_exp / denom[dplan.g_panel][:, :, None],
                r_exp / denom.reshape(-1)[dplan.res_arow])

    return fn


def make_spmm_rphm(plan: TilePlan, precision: str = "tf32") -> Callable:
    """Build ``fn(dense, packed, gathered, res, V, dplan) -> (M, F)``:
    ``out[r] = sum_e vals[e] * V[col[e]]`` with values in the four-tier
    rphm layout and the output in ORIGINAL row order.

    Dense tier: per-tile (ph, bw) @ contiguous V block (zero gather)
    in bsr mode; in reorder mode (column-permuted plans, tile_cblock is
    None) the tile's V rows are gathered per tile column from
    ``plan.tile_cols`` — same path the gathered tier uses.
    Gathered tier: per-tile (ph, bw) @ take(V, tile cols).
    Residual: per-entry gather + segment sum (small by construction).
    """
    P = max(plan.num_panels, 1)
    ph, bw = plan.panel_height, plan.block_width
    nnz = plan.nnz
    n_rows = P * ph
    N = plan.cols
    n_cblocks = -(-N // bw)
    M = plan.rows
    prec = dot_algorithm(precision)
    bsr_mode = plan.tile_cblock is not None
    # per-tile cblock (fat plans store per-step ids in dplan.tile_src);
    # reorder-mode plans instead carry per-tile column ids in tile_cols
    tile_cblock = (jnp.asarray(plan.tile_cblock) if bsr_mode
                   else None)
    tile_cols = None if bsr_mode else jnp.asarray(
        np.minimum(plan.tile_cols, max(N - 1, 0)))
    # original-row gather positions: row r sits at position inv_pos[r] of
    # the permuted layout; rows absent from the permutation read the last
    # (padded, zero-contribution) position
    inv_pos = np.full(M, n_rows, np.int64)
    perm = plan.row_perm_padded.astype(np.int64)
    # pad slots repeat row id 0; np.unique returns the FIRST occurrence,
    # which is the true position (pads only ever follow the real slots)
    uniq, first_idx = np.unique(perm, return_index=True)
    inv_pos[uniq] = first_idx
    inv_pos_dev = jnp.asarray(inv_pos, jnp.int32)

    Tp = plan.sp_panel.shape[0] if plan.sp_panel is not None else 0
    sw = plan.subblock_width

    def fn(dense: jax.Array, packed: jax.Array, gathered: jax.Array,
           res: jax.Array, V: jax.Array, dplan: DevicePlan) -> jax.Array:
        F = V.shape[1]
        # zero trash/pad slots: their rphm values are whatever the padded
        # matmuls computed (edge_softmax_rphm zeroes them, but raw values
        # must be safe too)
        dense = jnp.where(dplan.tile_scatter < nnz, dense, 0.0)
        gathered = jnp.where(dplan.g_scatter < nnz, gathered, 0.0)
        res = jnp.where(dplan.res_out < nnz, res, 0.0)
        Vp = jnp.pad(V.astype(jnp.float32),
                     ((0, n_cblocks * bw - N), (0, 0)))
        V_blocks = Vp.reshape(n_cblocks, bw, F)

        if bsr_mode:
            # dense tier: (T, ph, bw) @ (T, bw, F), contiguous V blocks
            vb = jnp.take(V_blocks, tile_cblock, axis=0)
        else:
            # reorder mode: per-tile column gather from tile_cols
            vb = jnp.take(Vp, tile_cols.reshape(-1), axis=0) \
                .reshape(-1, bw, F)
        d_part = jax.lax.dot_general(
            dense, vb, dimension_numbers=(((2,), (1,)), ((0,), (0,))),
            precision=prec,
            preferred_element_type=jnp.float32)       # (T, ph, F)
        out = jax.ops.segment_sum(d_part, dplan.tile_panel,
                                  num_segments=P)     # (P, ph, F)

        if Tp:
            # hot-column packed tiles: V2 = take(V, colperm), then S
            # contiguous (sw, F) block slices — same layout as the
            # SDDMM's Bt2 operand
            packed = jnp.where(dplan.sp_scatter < nnz, packed, 0.0)
            V2 = jnp.take(Vp, dplan.sp_colperm, axis=0)
            V_sub = V2.reshape(-1, sw, F)
            vb_pk = jnp.take(V_sub, dplan.sp_sub.reshape(-1), axis=0) \
                .reshape(Tp, bw, F)
            p_part = jax.lax.dot_general(
                packed, vb_pk,
                dimension_numbers=(((2,), (1,)), ((0,), (0,))),
                precision=prec,
                preferred_element_type=jnp.float32)   # (Tp, ph, F)
            out = out + jax.ops.segment_sum(p_part, dplan.sp_panel,
                                            num_segments=P)

        # gathered tier: V rows gathered per tile column
        vg = jnp.take(Vp, dplan.g_cols.reshape(-1), axis=0) \
            .reshape(-1, bw, F)
        g_part = jax.lax.dot_general(
            gathered, vg, dimension_numbers=(((2,), (1,)), ((0,), (0,))),
            precision=prec,
            preferred_element_type=jnp.float32)
        out = out + jax.ops.segment_sum(g_part, dplan.g_panel,
                                        num_segments=P)

        out = out.reshape(n_rows, F)

        # residual tier: per-entry contribution
        vr = jnp.take(Vp, dplan.res_col, axis=0)      # (E, F)
        r_part = vr * res[:, None]
        out = out + jax.ops.segment_sum(r_part, dplan.res_arow,
                                        num_segments=n_rows)

        # back to original row order (pad position n_rows reads zeros)
        out = jnp.concatenate([out, jnp.zeros((1, F), jnp.float32)])
        return jnp.take(out, inv_pos_dev, axis=0)     # (M, F)

    return fn


def make_spmm_transpose_rphm(plan: TilePlan,
                             precision: str = "tf32") -> Callable:
    """Build ``fn(dense, packed, gathered, res, A_full, dplan) -> (N, F)``:
    the column-side aggregation ``out[c] = sum_e vals[e] * A[row_e]`` —
    the transpose counterpart of :func:`make_spmm_rphm`, needed for the
    SDDMM backward pass (dB^T). Dense tier: per-tile (bw, ph) @ A panel on
    batched matmuls, segment-summed by column block (contiguous landing) in bsr
    mode, scatter-added per tile column (``plan.tile_cols``) in reorder
    mode; gathered tier scatter-adds per tile column; residual per
    entry."""
    P = max(plan.num_panels, 1)
    ph, bw = plan.panel_height, plan.block_width
    nnz = plan.nnz
    N = plan.cols
    n_cblocks = -(-N // bw)
    prec = dot_algorithm(precision)
    bsr_mode = plan.tile_cblock is not None
    tile_cblock = (jnp.asarray(plan.tile_cblock) if bsr_mode
                   else None)
    tile_cols = None if bsr_mode else jnp.asarray(
        np.minimum(plan.tile_cols, max(N - 1, 0)))

    Tp = plan.sp_panel.shape[0] if plan.sp_panel is not None else 0
    sw = plan.subblock_width

    def fn(dense: jax.Array, packed: jax.Array, gathered: jax.Array,
           res: jax.Array, A_full: jax.Array,
           dplan: DevicePlan) -> jax.Array:
        F = A_full.shape[1]
        dense = jnp.where(dplan.tile_scatter < nnz, dense, 0.0)
        gathered = jnp.where(dplan.g_scatter < nnz, gathered, 0.0)
        res = jnp.where(dplan.res_out < nnz, res, 0.0)
        A_perm = jnp.take(A_full, dplan.row_perm_padded, axis=0)
        A_panels = A_perm.reshape(P, ph, F)

        # dense tier: (T, bw, ph) @ (T, ph, F) -> (T, bw, F), summed per
        # column block (contiguous rows of the output)
        a_t = jnp.take(A_panels, dplan.tile_panel, axis=0)  # (T, ph, F)
        d_part = jax.lax.dot_general(
            dense, a_t, dimension_numbers=(((1,), (1,)), ((0,), (0,))),
            precision=prec,
            preferred_element_type=jnp.float32)         # (T, bw, F)
        if bsr_mode:
            out_blocks = jax.ops.segment_sum(
                d_part, tile_cblock, num_segments=n_cblocks)  # (C, bw, F)
            out = out_blocks.reshape(n_cblocks * bw, F)
        else:
            # reorder mode: the tile's columns are arbitrary — scatter-add
            # each tile column at its true id
            out = jax.ops.segment_sum(
                d_part.reshape(-1, F), tile_cols.reshape(-1),
                num_segments=n_cblocks * bw)
        if Tp:
            # packed tiles: column j of tile t lands at global column
            # colperm[sp_sub[t, j // sw] * sw + j % sw]
            packed = jnp.where(dplan.sp_scatter < nnz, packed, 0.0)
            a_p = jnp.take(A_panels, dplan.sp_panel, axis=0)
            p_part = jax.lax.dot_general(
                packed, a_p,
                dimension_numbers=(((1,), (1,)), ((0,), (0,))),
                precision=prec,
                preferred_element_type=jnp.float32)     # (Tp, bw, F)
            pk_pos = (dplan.sp_sub[:, :, None] * sw
                      + jnp.arange(sw, dtype=jnp.int32)).reshape(Tp, bw)
            pk_cols = jnp.take(dplan.sp_colperm, pk_pos.reshape(-1))
            out = out + jax.ops.segment_sum(
                p_part.reshape(-1, F), pk_cols,
                num_segments=n_cblocks * bw)

        # gathered tier: scatter-add per tile column
        a_g = jnp.take(A_panels, dplan.g_panel, axis=0)     # (Tg, ph, F)
        g_part = jax.lax.dot_general(
            gathered, a_g, dimension_numbers=(((1,), (1,)), ((0,), (0,))),
            precision=prec,
            preferred_element_type=jnp.float32)             # (Tg, bw, F)
        out = out + jax.ops.segment_sum(
            g_part.reshape(-1, F), dplan.g_cols.reshape(-1),
            num_segments=n_cblocks * bw)

        # residual tier
        a_r = jnp.take(A_perm, dplan.res_arow, axis=0)      # (E, F)
        out = out + jax.ops.segment_sum(
            a_r * res[:, None], dplan.res_col,
            num_segments=n_cblocks * bw)
        return out[:N]

    return fn


def make_diff_sddmm_body(plan: TilePlan, body: Callable,
                         precision: str = "tf32") -> Callable:
    """Wrap a ``make_sddmm_body(..., emit="rphm")`` callable with a custom
    VJP, so models can train through either backend (a pallas_call has
    no autodiff rule). The backward pass is itself tile-native:

        dA  = SpMM(dP, B^T)            (make_spmm_rphm)
        dB^T = SpMM^T(dP, A)           (make_spmm_transpose_rphm)
    """
    spmm = make_spmm_rphm(plan, precision)
    spmm_t = make_spmm_transpose_rphm(plan, precision)
    nnz = plan.nnz

    @jax.custom_vjp
    def diff_body(A, Bt, dplan):
        return body(A, Bt, dplan)

    def fwd(A, Bt, dplan):
        return body(A, Bt, dplan), (A, Bt, dplan)

    def bwd(residuals, cotangents):
        A, Bt, dplan = residuals
        d_dense, d_pk, d_gath, d_res = cotangents
        dA = spmm(d_dense, d_pk, d_gath, d_res, Bt, dplan)
        dBt = spmm_t(d_dense, d_pk, d_gath, d_res, A, dplan)
        zero = jax.tree.map(
            lambda x: np.zeros(x.shape, dtype=jax.dtypes.float0), dplan)
        return dA, dBt, zero

    diff_body.defvjp(fwd, bwd)
    return diff_body


def make_sparse_attention_rphm(plan: TilePlan, body: Callable,
                               precision: str = "tf32") -> Callable:
    """Fused tile-native attention head: ``fn(q, k, v, dplan) -> (M, F)``
    = SpMM(softmax(SDDMM(q, k) / sqrt(dk)), v), never leaving the rphm
    layout and differentiable end to end (the SDDMM gets the tile-native
    custom VJP; everything else is plain jax). ``body`` is a
    make_sddmm_body(..., emit="rphm") callable."""
    softmax = make_edge_softmax_rphm(plan)
    spmm = make_spmm_rphm(plan, precision)
    diff_body = make_diff_sddmm_body(plan, body, precision)
    inv_sqrt = 1.0 / np.sqrt(plan.k)

    def fn(q: jax.Array, kk: jax.Array, v: jax.Array,
           dplan: DevicePlan) -> jax.Array:
        d, p, g, r = diff_body(q, kk, dplan)
        d, p, g, r = softmax(d * inv_sqrt, p * inv_sqrt, g * inv_sqrt,
                             r * inv_sqrt, dplan)
        return spmm(d, p, g, r, v, dplan)

    return fn
