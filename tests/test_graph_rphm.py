"""Tile-native (rphm-layout) edge softmax + SpMM vs the CSR-path oracle."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from bsmr_sddmm_tpu.config import SddmmConfig
from bsmr_sddmm_tpu.formats import make_dense, random_mask
from bsmr_sddmm_tpu.ops.graph import csr_segment_ids, edge_softmax, spmm
from bsmr_sddmm_tpu.ops.graph_rphm import (make_edge_softmax_rphm,
                                           make_spmm_rphm,
                                           make_sparse_attention_rphm)
from bsmr_sddmm_tpu.ops.sddmm import device_plan, make_sddmm_body
from bsmr_sddmm_tpu.pack import pack_tiles
from bsmr_sddmm_tpu.reorder import bsmr

from conftest import make_ab


def _setup(delta=0.05, rows=512, cols=768, nnz=20000, seed=7,
           col_mode="bsr"):
    csr = random_mask(rows=rows, cols=cols, nnz=nnz, seed=seed,
                      block_rows=24, block_cols=96)
    cfg = SddmmConfig(k=32, panel_height=16, dense_chunk=16,
                      residual_chunk=2048, delta=delta, col_mode=col_mode)
    reord = bsmr(csr, cfg)
    plan = pack_tiles(csr, reord, cfg)
    return csr, cfg, plan


def _csr_from_rphm(plan, d, pk, g, r):
    return plan.csr_values_from_rphm(np.asarray(d), np.asarray(pk),
                                     np.asarray(g), np.asarray(r))


@pytest.mark.parametrize("delta", [0.006, 0.05, 1.1])
def test_edge_softmax_rphm_matches_csr(delta):
    csr, cfg, plan = _setup(delta=delta)
    dplan = device_plan(plan)
    A, B = make_ab(csr, cfg.k)
    Bt = np.ascontiguousarray(B.T)
    body = make_sddmm_body(plan, cfg, emit="rphm")
    d, pk, g, r = jax.jit(body)(jnp.asarray(A), jnp.asarray(Bt), dplan)

    softmax = make_edge_softmax_rphm(plan)
    da, pa, ga, ra = jax.jit(softmax)(d, pk, g, r, dplan)
    got = _csr_from_rphm(plan, da, pa, ga, ra)

    scores = _csr_from_rphm(plan, d, pk, g, r)
    seg = jnp.asarray(csr_segment_ids(csr))
    want = np.asarray(edge_softmax(jnp.asarray(scores), seg, csr.rows))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("delta", [0.006, 1.1])
def test_spmm_rphm_matches_csr(delta):
    csr, cfg, plan = _setup(delta=delta)
    dplan = device_plan(plan)
    A, B = make_ab(csr, cfg.k)
    Bt = np.ascontiguousarray(B.T)
    body = make_sddmm_body(plan, cfg, emit="rphm")
    d, pk, g, r = jax.jit(body)(jnp.asarray(A), jnp.asarray(Bt), dplan)
    vals = _csr_from_rphm(plan, d, pk, g, r)

    F = 24
    V = make_dense(csr.cols, F, seed=99)
    spmm_fn = make_spmm_rphm(plan)
    got = np.asarray(jax.jit(spmm_fn)(d, pk, g, r, jnp.asarray(V),
                                      dplan))

    seg = jnp.asarray(csr_segment_ids(csr))
    col = jnp.asarray(csr.col_indices.astype(np.int32))
    want = np.asarray(spmm(jnp.asarray(vals), col, seg, jnp.asarray(V),
                           csr.rows))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_fused_attention_head_matches_csr_path():
    csr, cfg, plan = _setup()
    dplan = device_plan(plan)
    rng = np.random.default_rng(3)
    q = jnp.asarray(rng.normal(size=(csr.rows, cfg.k)), jnp.float32)
    k = jnp.asarray(rng.normal(size=(csr.cols, cfg.k)), jnp.float32)
    v = jnp.asarray(rng.normal(size=(csr.cols, 16)), jnp.float32)

    body = make_sddmm_body(plan, cfg, emit="rphm")
    head = make_sparse_attention_rphm(plan, body)
    got = np.asarray(jax.jit(head)(q, k, v, dplan))

    body_csr = make_sddmm_body(plan, cfg, emit="csr")
    seg = jnp.asarray(csr_segment_ids(csr))
    col = jnp.asarray(csr.col_indices.astype(np.int32))
    scores = body_csr(q, k, dplan) / np.sqrt(cfg.k)
    alpha = edge_softmax(scores, seg, csr.rows)
    want = np.asarray(spmm(alpha, col, seg, v, csr.rows))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_spmm_rphm_empty_rows():
    """Rows with no nonzeros must come back exactly zero."""
    csr, cfg, plan = _setup(nnz=900, rows=96, cols=160, seed=3)
    empty = np.nonzero(csr.row_nnz() == 0)[0]
    if empty.size == 0:
        pytest.skip("mask has no empty rows")
    dplan = device_plan(plan)
    A, B = make_ab(csr, cfg.k)
    body = make_sddmm_body(plan, cfg, emit="rphm")
    d, pk, g, r = jax.jit(body)(jnp.asarray(A),
                                jnp.asarray(np.ascontiguousarray(B.T)),
                                dplan)
    V = make_dense(csr.cols, 8, seed=1)
    out = np.asarray(make_spmm_rphm(plan)(d, pk, g, r, jnp.asarray(V),
                                          dplan))
    np.testing.assert_array_equal(out[empty], 0.0)


def test_diff_sddmm_gradients_match_xla():
    """The custom VJP's gradients must match autodiff through the plain
    XLA body (which IS differentiable)."""
    from bsmr_sddmm_tpu.ops.graph_rphm import make_diff_sddmm_body
    csr, cfg, plan = _setup()
    dplan = device_plan(plan)
    body = make_sddmm_body(plan, cfg, emit="rphm")  # xla on CPU
    diff_body = make_diff_sddmm_body(plan, body)
    rng = np.random.default_rng(5)
    A = jnp.asarray(rng.normal(size=(csr.rows, cfg.k)), jnp.float32)
    Bt = jnp.asarray(rng.normal(size=(csr.cols, cfg.k)), jnp.float32)
    w = [jnp.asarray(rng.normal(size=x.shape), jnp.float32)
         for x in jax.eval_shape(lambda a, b: body(a, b, dplan), A, Bt)]

    def loss_custom(a, b):
        d, pk, g, r = diff_body(a, b, dplan)
        return (jnp.vdot(d, w[0]) + jnp.vdot(pk, w[1])
                + jnp.vdot(g, w[2]) + jnp.vdot(r, w[3]))

    def loss_plain(a, b):
        d, pk, g, r = body(a, b, dplan)
        nnz = plan.nnz
        d = jnp.where(dplan.tile_scatter < nnz, d, 0.0)
        pk = jnp.where(dplan.sp_scatter < nnz, pk, 0.0)
        g = jnp.where(dplan.g_scatter < nnz, g, 0.0)
        r = jnp.where(dplan.res_out < nnz, r, 0.0)
        wd = jnp.where(dplan.tile_scatter < nnz, w[0], 0.0)
        wp = jnp.where(dplan.sp_scatter < nnz, w[1], 0.0)
        wg = jnp.where(dplan.g_scatter < nnz, w[2], 0.0)
        wr = jnp.where(dplan.res_out < nnz, w[3], 0.0)
        return (jnp.vdot(d, wd) + jnp.vdot(pk, wp) + jnp.vdot(g, wg)
                + jnp.vdot(r, wr))

    gA, gB = jax.grad(loss_custom, argnums=(0, 1))(A, Bt)
    gA0, gB0 = jax.grad(loss_plain, argnums=(0, 1))(A, Bt)
    np.testing.assert_allclose(np.asarray(gA), np.asarray(gA0),
                               rtol=3e-4, atol=3e-4)
    np.testing.assert_allclose(np.asarray(gB), np.asarray(gB0),
                               rtol=3e-4, atol=3e-4)


def test_spmm_rphm_reorder_mode_matches_scipy():
    """Column-permuted (reorder-mode) plans have no tile_cblock: the dense
    tier must gather V rows from tile_cols instead of substituting block 0
    (round-1 advisor finding: max abs err 36 vs scipy before the fix)."""
    import scipy.sparse as sp
    from bsmr_sddmm_tpu.ops import spmm as spmm_mod
    csr, cfg, plan = _setup(delta=0.3, col_mode="reorder")
    assert plan.tile_cblock is None and plan.num_tiles > 0
    rng = np.random.default_rng(13)
    csr.values[:] = rng.normal(size=csr.nnz).astype(np.float32)
    V = make_dense(csr.cols, 24, seed=21)
    got = spmm_mod.spmm(csr, plan, V)
    S = sp.csr_matrix((csr.values, csr.col_indices, csr.row_offsets),
                      shape=(csr.rows, csr.cols))
    np.testing.assert_allclose(got, S @ V, rtol=2e-4, atol=2e-4)


def test_spmm_transpose_rphm_reorder_mode_matches_scipy():
    """S^T aggregation in reorder mode must scatter-add dense-tile columns
    at their true (permuted) ids."""
    import scipy.sparse as sp
    from bsmr_sddmm_tpu.ops.graph_rphm import make_spmm_transpose_rphm
    from bsmr_sddmm_tpu.ops.spmm import pack_values_rphm
    csr, cfg, plan = _setup(delta=0.3, col_mode="reorder")
    assert plan.tile_cblock is None and plan.num_tiles > 0
    rng = np.random.default_rng(17)
    vals = rng.normal(size=csr.nnz).astype(np.float32)
    d, pk, g, r = pack_values_rphm(plan, vals)
    A = make_dense(csr.rows, 16, seed=23)
    dplan = device_plan(plan)
    fn = jax.jit(make_spmm_transpose_rphm(plan))
    got = np.asarray(fn(jnp.asarray(d), jnp.asarray(pk), jnp.asarray(g),
                        jnp.asarray(r), jnp.asarray(A), dplan))
    S = sp.csr_matrix((vals, csr.col_indices, csr.row_offsets),
                      shape=(csr.rows, csr.cols))
    np.testing.assert_allclose(got, S.T @ A, rtol=2e-4, atol=2e-4)


def test_public_spmm_matches_scipy():
    """ops.spmm: S @ V with real CSR values vs scipy."""
    import scipy.sparse as sp
    from bsmr_sddmm_tpu.ops import spmm as spmm_mod
    csr, cfg, plan = _setup()
    # give the mask non-trivial values
    rng = np.random.default_rng(11)
    csr.values[:] = rng.normal(size=csr.nnz).astype(np.float32)
    # re-pack so nothing depends on values (it should not: plan is
    # pattern-only; pack_values_rphm carries the values)
    V = make_dense(csr.cols, 24, seed=2)
    got = spmm_mod.spmm(csr, plan, V)
    S = sp.csr_matrix((csr.values, csr.col_indices, csr.row_offsets),
                      shape=(csr.rows, csr.cols))
    want = S @ V
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
