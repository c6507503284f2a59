"""Ring execution: B-panel rotation overlapped with per-panel compute.

The b-sharded path in :mod:`bsmr_sddmm_tpu.parallel.sharding` does one
blocking ``all_gather`` of B before any compute — every flop waits for
the full (N, K) operand. This module keeps B sharded the whole time:
device d starts holding B panel d ((N/n, K) rows of B^T), computes the
part of its shard's SDDMM whose mask columns fall in that panel, and
passes the panel to its ring neighbor with ``lax.ppermute`` while XLA
overlaps the next panel's transfer with the current panel's compute (the
standard JAX collective-matmul pattern; on GPUs the collective-permute
goes through NCCL — SURVEY.md section 2d's north star; the reference has
no analogue, it is single-GPU).

Peak per-device B memory is 2 panels (current + in-flight) instead of
the all-gather path's full N*K — the memory-scalable layout for large B.

Packing: each (row-panel shard, B panel) pair gets a static-shaped tile
group. Tiers are dense BSR tiles + panel-local GATHERED tiles + per-nnz
residual: a gathered tile's columns all live in one B panel, so its row
gather reads the resident (w, K) panel — the single-chip gathered tier
re-created per ring step (community masks would otherwise fall entirely
to the per-nnz tier on multi-chip). The packed (hot-column)
tier needs a global column permutation of B and stays on the
single-program paths (a plan whose autotuned split leans on it should
prefer the all-gather layout).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from bsmr_sddmm_tpu.config import SddmmConfig
from bsmr_sddmm_tpu.formats import CSR
from bsmr_sddmm_tpu.parallel.sharding import AXIS, put_global
from bsmr_sddmm_tpu.precision import dot_algorithm
from bsmr_sddmm_tpu.reorder import BsmrReordering, _concat_ranges



@dataclasses.dataclass
class RingPlan:
    """Static-shaped per-(shard, B-panel) packing for the ring body.

    Device arrays are stacked (n_shards * n_panels, ...) with the leading
    dim sharded; inside shard_map each device sees (n_panels, ...) — its
    own row shard's groups, indexed by the B panel it currently holds.
    """

    n: int                      # mesh size = ring length = B panel count
    rows: int
    cols: int                   # original N
    w: int                      # B panel width (rows of Bt), n * w >= N
    nnz: int
    k: int
    panel_height: int
    block_width: int
    panels_per_shard: int       # P_l: row panels per shard (padded common)
    tiles_per_group: int        # Td
    tiles_g_per_group: int      # Tg (0 = gathered tier off)
    res_per_group: int          # E
    num_gathered: int           # total real gathered tiles across groups

    row_perm: np.ndarray        # (n, P_l * ph) int32 (pad: 0)
    tile_rpanel: np.ndarray     # (n, n, Td) int32 local row panel
    tile_cb: np.ndarray         # (n, n, Td) int32 cblock LOCAL to panel
    tile_scatter: np.ndarray    # (n, n, Td, ph, bw) int32 into [0, nnz]
    g_rpanel: np.ndarray        # (n, n, Tg) int32 local row panel
    g_cols_l: np.ndarray        # (n, n, Tg, bw) int32 cols LOCAL to panel
    g_scatter: np.ndarray       # (n, n, Tg, ph, bw) int32 into [0, nnz]
    res_arow: np.ndarray        # (n, n, E) int32 local permuted A row
    res_col: np.ndarray         # (n, n, E) int32 col LOCAL to panel
    res_out: np.ndarray         # (n, n, E) int32 into [0, nnz]
    rphm_to_csr: np.ndarray     # (nnz,) int32 into the stacked outputs


def pack_ring_plans(csr: CSR, reord: BsmrReordering,
                    config: SddmmConfig, n_shards: int,
                    k: Optional[int] = None) -> RingPlan:
    """Pack the mask for the ring: nnz-balanced contiguous row-panel
    shards (as pack_shard_plans), then per shard a (B panel) -> tile
    group split. Dense tiles are the natural 128-wide column blocks
    whose in-panel count meets delta (col_mode="bsr" semantics,
    reference colReordering.cu:246-261 re-thresholded at tile width);
    everything else is per-nnz residual grouped by B panel."""
    k = config.k if k is None else k
    ph, bw = config.panel_height, config.block_width
    n = n_shards
    N = csr.cols
    nnz = csr.nnz
    # B panel width: multiple of bw, n panels cover N
    per = -(-N // n)           # ceil(N / n)
    w = -(-per // bw) * bw     # rounded up to a cblock multiple
    cb_per_panel = w // bw
    thresh = max(int(np.ceil(config.delta * ph * bw)), 1)

    perm = reord.row_perm.astype(np.int64)
    R = perm.shape[0]
    num_panels = -(-R // ph)
    # cost-balanced contiguous shard bounds (panel_cost_weights uses the
    # single-chip column split as the tile-count proxy; the ring's own
    # dense membership is the natural-block threshold, which correlates —
    # either beats nnz-only balancing on power-law masks)
    if reord.dense_cols is not None and reord.num_row_panels == num_panels:
        from bsmr_sddmm_tpu.pack import panel_cost_weights
        weights = panel_cost_weights(csr, reord, config, k=k)
    else:
        row_nnz = csr.row_nnz()[perm]
        pad_rows = num_panels * ph - R
        weights = np.concatenate(
            [row_nnz, np.zeros(pad_rows, np.int64)]) \
            .reshape(num_panels, ph).sum(axis=1).astype(np.float64)
    cum = np.concatenate([[0.0], np.cumsum(weights)])
    targets = cum[-1] * np.arange(1, n) / n
    bounds = np.concatenate([[0], np.searchsorted(cum, targets),
                             [num_panels]]).astype(np.int64)
    bounds = np.maximum.accumulate(bounds)
    P_l = max(int((bounds[1:] - bounds[:-1]).max()), 1)

    shards = []
    Td_max, E_max, Tg_max = 1, 1, 0
    for s in range(n):
        p0, p1 = int(bounds[s]), int(bounds[s + 1])
        rows = perm[p0 * ph: min(p1 * ph, R)]
        rn = csr.row_nnz()[rows]
        pos = np.repeat(np.arange(rows.shape[0], dtype=np.int64), rn)
        eidx = _concat_ranges(csr.row_offsets[rows], rn)
        cols = csr.col_indices[eidx].astype(np.int64)
        rpanel = pos // ph
        lrow = pos % ph
        cblock = cols // bw
        bpanel = cols // w
        # dense membership: (rpanel, cblock) counts
        keyc = rpanel * np.int64(cb_per_panel * n + 1) + cblock
        order = np.argsort(keyc, kind="stable")
        ks = keyc[order]
        uq_pos = np.nonzero(np.diff(ks, prepend=-1))[0]
        uq_cnt = np.diff(np.append(uq_pos, ks.shape[0]))
        qual = uq_cnt >= thresh
        ent_uq = np.searchsorted(ks[uq_pos], keyc)
        is_dense = qual[ent_uq]
        # tiles grouped by B panel
        q_key = ks[uq_pos][qual]
        q_rp = q_key // np.int64(cb_per_panel * n + 1)
        q_cb = q_key % np.int64(cb_per_panel * n + 1)
        q_bp = q_cb // cb_per_panel
        tile_of_uq = np.full(uq_pos.shape[0], -1, np.int64)
        # order tiles by (b panel, rpanel, cblock): group-local ids
        t_order = np.lexsort((q_cb, q_rp, q_bp))
        q_rp, q_cb, q_bp = q_rp[t_order], q_cb[t_order], q_bp[t_order]
        grp_counts = np.bincount(q_bp, minlength=n)
        Td_max = max(Td_max, int(grp_counts.max()) if q_bp.size else 0)
        within = np.arange(q_bp.shape[0]) - np.concatenate(
            [[0], np.cumsum(grp_counts)])[q_bp]
        qual_ids = np.nonzero(qual)[0][t_order]
        tile_of_uq[qual_ids] = q_bp * (1 << 32) + within  # packed (bp, id)
        # gathered tier: residual (rpanel, col) pairs chunked bw-wide per
        # (B panel, rpanel), count-descending — the single-chip gathered
        # tier per ring step. A chunk qualifies when it covers at least
        # residual_tile_min_nnz nonzeros; the rest stays per-nnz.
        res_m = ~is_dense
        in_g = np.zeros(pos.shape[0], dtype=bool)
        g_bp_e = np.zeros(pos.shape[0], np.int64)
        g_tile_e = np.zeros(pos.shape[0], np.int64)
        g_slot_e = np.zeros(pos.shape[0], np.int64)
        g_meta = {}   # bpanel -> (rpanel_per_tile, cols_per_tile (Tg,bw))
        if config.residual_mode == "gathered" and res_m.any():
            ridx = np.nonzero(res_m)[0]
            key = rpanel[ridx] * np.int64(N + 1) + cols[ridx]
            korder = np.argsort(key, kind="stable")
            ks2 = key[korder]
            upos = np.nonzero(np.diff(ks2, prepend=-1))[0]
            ukey = ks2[upos]                      # ascending
            ucnt = np.diff(np.append(upos, ks2.shape[0]))
            u_rp = ukey // np.int64(N + 1)
            u_col = ukey % np.int64(N + 1)
            u_bp = u_col // w
            # (bpanel, rpanel, count desc, col) order, chunked bw-wide
            # within each (bpanel, rpanel) segment
            uorder = np.lexsort((u_col, -ucnt, u_rp, u_bp))
            s_rp, s_col, s_bp = u_rp[uorder], u_col[uorder], u_bp[uorder]
            s_cnt = ucnt[uorder]
            U = uorder.shape[0]
            seg = s_bp * np.int64(P_l + 1) + s_rp
            seg_starts = np.nonzero(np.diff(seg, prepend=-1))[0]
            seg_of = np.searchsorted(seg_starts, np.arange(U),
                                     side="right") - 1
            within = np.arange(U) - seg_starts[seg_of]
            chunk_of = within // bw
            slot_of = within % bw
            ckey = seg_of.astype(np.int64) * np.int64(U + 1) + chunk_of
            cpos = np.nonzero(np.diff(ckey, prepend=-1))[0]
            chunk_nnz = np.add.reduceat(s_cnt, cpos)
            keep_chunk = chunk_nnz >= config.residual_tile_min_nnz
            col_chunk = np.searchsorted(cpos, np.arange(U),
                                        side="right") - 1
            if keep_chunk.any():
                kept = np.nonzero(keep_chunk)[0]
                bp_of_chunk = s_bp[cpos]
                # tile id within its bpanel group (stable order)
                tile_of_chunk = np.full(keep_chunk.shape[0], -1, np.int64)
                kept_bp = bp_of_chunk[kept]
                gcounts = np.bincount(kept_bp, minlength=n)
                gbase = np.zeros(n, np.int64)
                np.cumsum(gcounts[:-1], out=gbase[1:])
                # within-group id: kept is ascending and chunks of one
                # bpanel are contiguous in (bp, rp, ...) order, so
                # arange - first-kept-of-group enumerates each group
                tile_of_chunk[kept] = (np.arange(kept.shape[0])
                                       - gbase[kept_bp])
                Tg_max = max(Tg_max, int(gcounts.max()))
                # per-tile column lists, vectorized over ALL kept chunks
                # at once (a big mask can have 100k+ tiles — a Python
                # loop here bound the host side): each chunk's <=bw
                # unique cols land in one row of (Kc, bw); pad slots
                # repeat the chunk's first col (gather stays in-panel,
                # scatter slots are trash)
                cstarts = cpos[kept]
                lens = np.append(cpos, U)[kept + 1] - cstarts
                lane = np.arange(bw)
                src = cstarts[:, None] + np.where(lane < lens[:, None],
                                                  lane, 0)
                cols_all = (s_col[src]
                            - kept_bp[:, None] * w).astype(np.int32)
                rp_all = s_rp[cstarts].astype(np.int32)
                # kept chunks are (bpanel, ...)-sorted, so each group is
                # a contiguous slice
                for p in np.nonzero(gcounts)[0]:
                    s0, s1 = np.searchsorted(kept_bp, [p, p + 1])
                    g_meta[int(p)] = (rp_all[s0:s1], cols_all[s0:s1])
                # route entries through their unique col's chunk
                inv_uorder = np.empty(U, np.int64)
                inv_uorder[uorder] = np.arange(U)
                ent_u = inv_uorder[np.searchsorted(ukey, key)]
                ent_chunk = col_chunk[ent_u]
                ent_kept = keep_chunk[ent_chunk]
                gsel = ridx[ent_kept]
                in_g[gsel] = True
                g_bp_e[gsel] = s_bp[ent_u[ent_kept]]
                g_tile_e[gsel] = tile_of_chunk[ent_chunk[ent_kept]]
                g_slot_e[gsel] = slot_of[ent_u[ent_kept]]
        res_counts = np.bincount(bpanel[res_m & ~in_g], minlength=n)
        E_max = max(E_max, int(res_counts.max()) if res_counts.size else 0)
        shards.append(dict(
            rows=rows, eidx=eidx, cols=cols, rpanel=rpanel, lrow=lrow,
            cblock=cblock, bpanel=bpanel, is_dense=is_dense,
            ent_uq=ent_uq, tile_of_uq=tile_of_uq,
            q_rp=q_rp, q_cb=q_cb, q_bp=q_bp, grp_counts=grp_counts,
            in_g=in_g, g_bp_e=g_bp_e, g_tile_e=g_tile_e,
            g_slot_e=g_slot_e, g_meta=g_meta))

    Td = max(Td_max, 1)
    E = max(E_max, 1)
    Tg = Tg_max   # 0 = gathered tier absent (static, drops its compute)
    row_perm_arr = np.zeros((n, P_l * ph), np.int32)
    tile_rpanel = np.zeros((n, n, Td), np.int32)
    tile_cb = np.zeros((n, n, Td), np.int32)
    tile_scatter = np.full((n, n, Td, ph, bw), nnz, np.int32)
    g_rpanel = np.zeros((n, n, Tg), np.int32)
    g_cols_l = np.zeros((n, n, Tg, bw), np.int32)
    g_scatter = np.full((n, n, Tg, ph, bw), nnz, np.int32)
    num_gathered = 0
    res_arow = np.zeros((n, n, E), np.int32)
    res_col = np.zeros((n, n, E), np.int32)
    res_out = np.full((n, n, E), nnz, np.int32)

    for s, sh in enumerate(shards):
        row_perm_arr[s, :sh["rows"].shape[0]] = sh["rows"]
        # tiles
        gc = sh["grp_counts"]
        for p in np.nonzero(gc)[0]:
            m = sh["q_bp"] == p
            cnt = int(gc[p])
            tile_rpanel[s, p, :cnt] = sh["q_rp"][m]
            tile_cb[s, p, :cnt] = sh["q_cb"][m] - p * cb_per_panel
        # dense entries -> scatter
        de = sh["is_dense"]
        packed = sh["tile_of_uq"][sh["ent_uq"][de]]
        bp_of_e = (packed >> 32).astype(np.int64)
        tid_of_e = (packed & ((1 << 32) - 1)).astype(np.int64)
        tile_scatter[s, bp_of_e, tid_of_e, sh["lrow"][de],
                     sh["cols"][de] % bw] = sh["eidx"][de]
        # gathered tiles: per-(bpanel) metadata + entry scatter
        for p, (rp_t, cols_t) in sh["g_meta"].items():
            cnt = rp_t.shape[0]
            num_gathered += cnt
            g_rpanel[s, p, :cnt] = rp_t
            g_cols_l[s, p, :cnt] = cols_t
        ge = sh["in_g"]
        if ge.any():
            g_scatter[s, sh["g_bp_e"][ge], sh["g_tile_e"][ge],
                      sh["lrow"][ge], sh["g_slot_e"][ge]] = sh["eidx"][ge]
        # residual entries grouped by b panel
        re_m = ~de & ~ge
        rbp = sh["bpanel"][re_m]
        order = np.argsort(rbp, kind="stable")
        rbp_s = rbp[order]
        starts = np.searchsorted(rbp_s, np.arange(n))
        ends = np.searchsorted(rbp_s, np.arange(n), side="right")
        r_pos = sh["rpanel"][re_m][order] * ph + sh["lrow"][re_m][order]
        r_col = sh["cols"][re_m][order]
        r_idx = sh["eidx"][re_m][order]
        for p in range(n):
            s0, e0 = int(starts[p]), int(ends[p])
            cnt = e0 - s0
            if not cnt:
                continue
            res_arow[s, p, :cnt] = r_pos[s0:e0]
            res_col[s, p, :cnt] = r_col[s0:e0] - p * w
            res_out[s, p, :cnt] = r_idx[s0:e0]

    # inverse map into the stacked ring outputs:
    # [dense (s*n + p)*Td*ph*bw + ... | gathered | residual]
    d_total = n * n * Td * ph * bw
    g_total = n * n * Tg * ph * bw
    assert d_total + g_total + n * n * E < np.iinfo(np.int32).max, (
        "ring rphm layout exceeds int32 indexing — lower n_shards or "
        "use the all-gather path")
    rphm_to_csr = np.zeros(nnz, np.int32)
    ts = tile_scatter.reshape(-1)
    m = ts < nnz
    rphm_to_csr[ts[m]] = np.nonzero(m)[0].astype(np.int32)
    if Tg:
        gs = g_scatter.reshape(-1)
        m = gs < nnz
        rphm_to_csr[gs[m]] = (np.nonzero(m)[0] + d_total).astype(np.int32)
    ro = res_out.reshape(-1)
    m = ro < nnz
    rphm_to_csr[ro[m]] = (np.nonzero(m)[0] + d_total
                          + g_total).astype(np.int32)

    return RingPlan(
        n=n, rows=csr.rows, cols=N, w=w, nnz=nnz, k=k,
        panel_height=ph, block_width=bw, panels_per_shard=P_l,
        tiles_per_group=Td, tiles_g_per_group=Tg, res_per_group=E,
        num_gathered=num_gathered,
        row_perm=row_perm_arr, tile_rpanel=tile_rpanel, tile_cb=tile_cb,
        tile_scatter=tile_scatter, g_rpanel=g_rpanel, g_cols_l=g_cols_l,
        g_scatter=g_scatter, res_arow=res_arow, res_col=res_col,
        res_out=res_out, rphm_to_csr=rphm_to_csr)


def ring_operands(A: np.ndarray, Bt: np.ndarray, plan: RingPlan,
                  mesh: Mesh) -> Tuple[jax.Array, jax.Array]:
    """A replicated; Bt padded to n*w rows and row-sharded (panel d on
    device d)."""
    pad = plan.n * plan.w - Bt.shape[0]
    Bt_p = np.pad(np.asarray(Bt), ((0, pad), (0, 0))) if pad else Bt
    return (put_global(np.asarray(A), NamedSharding(mesh, P())),
            put_global(Bt_p, NamedSharding(mesh, P(AXIS))))


def make_ring_sddmm(csr: CSR, reord: BsmrReordering, config: SddmmConfig,
                    mesh: Mesh, k: Optional[int] = None,
                    emit: str = "csr") -> Tuple[Callable, RingPlan]:
    """Build the ring-overlap SDDMM: ``fn(A, Bt_sharded, dplan_arrays)``.

    Each of the n unrolled steps computes the tile group for the B panel
    the device currently holds, then rotates the panel one hop with
    ``lax.ppermute`` — XLA schedules the permute of step i+1 concurrently
    with the compute of step i (no data dependence), so the transfer
    runs under the matmuls.
    """
    n = mesh.devices.size
    plan = pack_ring_plans(csr, reord, config, n, k=k)
    ph, bw, kk = plan.panel_height, plan.block_width, plan.k
    P_l = plan.panels_per_shard
    w = plan.w
    precision = dot_algorithm(config.matmul_precision)
    nnz = plan.nnz
    perm_pairs = [((j + 1) % n, j) for j in range(n)]   # receive from right

    Tg = plan.tiles_g_per_group

    def shard_body(A, B_local, row_perm, tile_rp, tile_cb, g_rp_a,
                   g_cl_a, res_ar, res_cl):
        # per-device shapes: B_local (1*w, K) -> (w, K); groups (1, n, ...)
        B_cur = B_local.reshape(w, kk)
        A_perm = jnp.take(A.astype(jnp.float32),
                          row_perm.reshape(-1), axis=0)   # (P_l*ph, K)
        A_panels = A_perm.reshape(P_l, ph, kk)
        dev = jax.lax.axis_index(AXIS)
        dense_out = jnp.zeros((n, plan.tiles_per_group, ph, bw),
                              jnp.float32)
        g_out = jnp.zeros((n, Tg, ph, bw), jnp.float32)
        res_vals = jnp.zeros((n, plan.res_per_group), jnp.float32)
        tile_rp = tile_rp.reshape(n, plan.tiles_per_group)
        tile_cb = tile_cb.reshape(n, plan.tiles_per_group)
        g_rp_a = g_rp_a.reshape(n, max(Tg, 1))
        g_cl_a = g_cl_a.reshape(n, max(Tg, 1), bw)
        res_ar = res_ar.reshape(n, plan.res_per_group)
        res_cl = res_cl.reshape(n, plan.res_per_group)
        for i in range(n):
            p = jax.lax.rem(dev + i, n)
            rp = jnp.take(tile_rp, p, axis=0)             # (Td,)
            cb = jnp.take(tile_cb, p, axis=0)
            B_blocks = B_cur.reshape(w // bw, bw, kk)
            b = jnp.take(B_blocks, cb, axis=0)            # (Td, bw, K)
            a = jnp.take(A_panels, rp, axis=0)            # (Td, ph, K)
            part = jax.lax.dot_general(
                a, b, dimension_numbers=(((2,), (2,)), ((0,), (0,))),
                precision=precision,
                preferred_element_type=jnp.float32)
            dense_out = dense_out.at[p].set(part)
            if Tg:   # gathered tier: panel-local row gather + matmul
                gcl = jnp.take(g_cl_a, p, axis=0)         # (Tg, bw)
                gb = jnp.take(B_cur, gcl.reshape(-1),
                              axis=0).reshape(Tg, bw, kk)
                ga = jnp.take(A_panels, jnp.take(g_rp_a, p, axis=0),
                              axis=0)                     # (Tg, ph, K)
                gpart = jax.lax.dot_general(
                    ga, gb, dimension_numbers=(((2,), (2,)), ((0,), (0,))),
                    precision=precision,
                    preferred_element_type=jnp.float32)
                g_out = g_out.at[p].set(gpart)
            ar = jnp.take(res_ar, p, axis=0)
            cl = jnp.take(res_cl, p, axis=0)
            av = jnp.take(A_perm, ar, axis=0)             # (E, K)
            bv = jnp.take(B_cur, cl, axis=0)              # (E, K)
            res_vals = res_vals.at[p].set(jnp.sum(av * bv, axis=-1))
            if i < n - 1:
                B_cur = jax.lax.ppermute(B_cur, AXIS, perm=perm_pairs)
        return dense_out, g_out, res_vals

    mapped = jax.shard_map(
        shard_body, mesh=mesh,
        in_specs=(P(), P(AXIS), P(AXIS), P(AXIS), P(AXIS), P(AXIS),
                  P(AXIS), P(AXIS), P(AXIS)),
        out_specs=(P(AXIS), P(AXIS), P(AXIS)),
    )

    dev_arrays = tuple(
        put_global(a, NamedSharding(mesh, P(AXIS)))
        for a in (plan.row_perm,
                  plan.tile_rpanel.reshape(n, -1),
                  plan.tile_cb.reshape(n, -1),
                  # keep specs static when the tier is off (Tg=0): ship a
                  # one-slot dummy whose compute is dropped by the Python
                  # branch above
                  (plan.g_rpanel if Tg else
                   np.zeros((n, n, 1), np.int32)).reshape(n, -1),
                  (plan.g_cols_l if Tg else
                   np.zeros((n, n, 1, plan.block_width),
                            np.int32)).reshape(n, -1),
                  plan.res_arow.reshape(n, -1),
                  plan.res_col.reshape(n, -1)))

    # plan arrays are passed as jit ARGUMENTS, not closed over: a
    # multi-process program may not close over global (non-addressable)
    # arrays, and arguments also keep them out of the compiled constant
    # pool
    if emit == "rphm":
        jitted = jax.jit(lambda A, Bt, *dv: mapped(A, Bt, *dv))

        def fn(A, Bt):
            return jitted(A, Bt, *dev_arrays)
        return fn, plan

    if emit != "csr":
        raise ValueError(f"unknown emit {emit!r}")
    repl = NamedSharding(mesh, P())
    csr_map = put_global(plan.rphm_to_csr, repl)

    def inner(A, Bt, cmap, *dv):
        d, g, r = mapped(A, Bt, *dv)
        big = jnp.concatenate([d.reshape(-1), g.reshape(-1),
                               r.reshape(-1)])
        return jnp.take(big, cmap)

    # csr emission is the full values vector — replicate it so every
    # process can read it (the take above already globalizes the data)
    jitted = jax.jit(inner, out_shardings=repl)

    def fn(A, Bt):
        return jitted(A, Bt, csr_map, *dev_arrays)

    return fn, plan
