"""Batched SDDMM, B-sharded multi-chip path, reordering evaluation."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from bsmr_sddmm_tpu.config import SddmmConfig
from bsmr_sddmm_tpu.evaluate import evaluate_reordering
from bsmr_sddmm_tpu.formats import make_dense, random_mask
from bsmr_sddmm_tpu.ops.sddmm import (device_plan, make_batched_sddmm_fn,
                                      sddmm_ref)
from bsmr_sddmm_tpu.pack import pack_tiles
from bsmr_sddmm_tpu.parallel import (make_mesh, make_sharded_sddmm,
                                     shard_operands)
from bsmr_sddmm_tpu.reorder import bsmr
from bsmr_sddmm_tpu.utils.checkdata import check_data

from conftest import make_ab


def test_batched_sddmm_matches_oracle(tiny_mask, cfg):
    Z = 3
    reord = bsmr(tiny_mask, cfg)
    plan = pack_tiles(tiny_mask, reord, cfg)
    fn = make_batched_sddmm_fn(plan, cfg)
    A = np.stack([make_dense(tiny_mask.rows, cfg.k, seed=i)
                  for i in range(Z)])
    B = np.stack([make_dense(cfg.k, tiny_mask.cols, seed=100 + i)
                  for i in range(Z)])
    Bt = np.ascontiguousarray(B.transpose(0, 2, 1))
    out = np.asarray(fn(jnp.asarray(A), jnp.asarray(Bt),
                        device_plan(plan)))
    assert out.shape == (Z, tiny_mask.nnz)
    for z in range(Z):
        expected = sddmm_ref(A[z], B[z], tiny_mask)
        assert check_data(expected, out[z]).passed, f"batch {z}"


@pytest.mark.parametrize("b_sharded", [False, True])
def test_sharded_sddmm_matches_oracle(b_sharded):
    # cols divisible by the 8-device mesh for the b_sharded layout
    csr = random_mask(rows=256, cols=512, nnz=6000, seed=13,
                      block_rows=16, block_cols=64)
    cfg = SddmmConfig(k=32, panel_height=16, dense_chunk=16,
                      residual_chunk=2048)
    mesh = make_mesh(8)
    reord = bsmr(csr, cfg)
    fn, dplan, plans = make_sharded_sddmm(csr, reord, cfg, mesh,
                                          b_sharded=b_sharded, emit="csr")
    assert len(plans) == 8
    A, B = make_ab(csr, cfg.k)
    Bt = np.ascontiguousarray(B.T)
    A_dev, Bt_dev = shard_operands(A, Bt, mesh, b_sharded=b_sharded)
    out = np.asarray(fn(A_dev, Bt_dev, dplan))
    expected = sddmm_ref(A, B, csr)
    assert check_data(expected, out).passed

    # the hot path: sharded rphm outputs, no combine; must reassemble to
    # the same CSR values via the global map
    fn2, dplan2, plans2 = make_sharded_sddmm(csr, reord, cfg, mesh,
                                             b_sharded=b_sharded,
                                             emit="rphm")
    import jax
    d, pk, g, r = jax.block_until_ready(fn2(A_dev, Bt_dev, dplan2))
    from bsmr_sddmm_tpu.parallel import sharded_rphm_to_csr
    big = np.concatenate([np.asarray(d).reshape(-1),
                          np.asarray(pk).reshape(-1),
                          np.asarray(g).reshape(-1), np.asarray(r)])
    out2 = big[sharded_rphm_to_csr(plans2)]
    assert check_data(expected, out2).passed


def test_sharded_windowed_plans_match_oracle():
    """Cliff-scale B (beyond gather_window_threshold_mb) must keep
    windowed gathers under shard_map: every shard carries the SAME static
    window-group metadata (one shared body), per-window counts padded to
    the max with trash slots, and the output still matches the oracle.
    An earlier slice-a-global-plan version silently dropped the windows."""
    csr = random_mask(rows=1024, cols=32768, nnz=40000, seed=29,
                      block_rows=16, block_cols=64)
    # thresholds shrunk so a CPU-sized B crosses the "cliff": N*k*4 =
    # 4 MB > 1 MB threshold, window = 8192 rows -> 4 windows
    cfg = SddmmConfig(k=32, panel_height=16, dense_chunk=16,
                      residual_chunk=2048, gather_window_mb=1,
                      gather_window_threshold_mb=1,
                      residual_tile_min_nnz=4)
    mesh = make_mesh(8)
    reord = bsmr(csr, cfg)
    fn, dplan, plans = make_sharded_sddmm(csr, reord, cfg, mesh,
                                          emit="csr")
    assert plans[0].window_rows is not None
    # identical static window metadata on every shard (the shared body
    # is built from plans[0])
    for p in plans[1:]:
        assert p.g_groups == plans[0].g_groups
        assert p.res_groups == plans[0].res_groups
        assert p.num_gathered == plans[0].num_gathered
        assert p.num_residual == plans[0].num_residual
        assert p.a_window_rows == plans[0].a_window_rows
    # the mask must actually exercise BOTH windowed tiers across
    # multiple windows
    assert plans[0].g_groups is not None
    assert len(plans[0].g_groups) > 1
    assert plans[0].num_gathered > 0
    assert plans[0].res_groups is not None
    assert len(plans[0].res_groups) > 1
    A, B = make_ab(csr, cfg.k)
    Bt = np.ascontiguousarray(B.T)
    A_dev, Bt_dev = shard_operands(A, Bt, mesh)
    out = np.asarray(fn(A_dev, Bt_dev, dplan))
    expected = sddmm_ref(A, B, csr)
    assert check_data(expected, out).passed


def test_sharded_a_side_windows_match_oracle():
    """Tall masks (A_perm beyond the threshold) window the A side of the
    per-nnz residual too; the shard-unified (a_base, b_base) pair groups
    must agree across shards and stay correct."""
    # per-shard A_perm must itself cross the (shrunken) threshold: a
    # 2-shard split of 16384 mostly-nonempty rows leaves ~8192 rows x
    # k=128 x 4 B = 4 MB per shard > 1 MB -> A window 2048 rows; B stays
    # unwindowed (4096 cols = exactly 2 windows, below the 2x minimum)
    csr = random_mask(rows=16384, cols=4096, nnz=60000, seed=31,
                      block_rows=16, block_cols=64)
    cfg = SddmmConfig(k=128, panel_height=16, dense_chunk=16,
                      residual_chunk=2048, gather_window_mb=1,
                      gather_window_threshold_mb=1)
    mesh = make_mesh(2)
    reord = bsmr(csr, cfg)
    fn, dplan, plans = make_sharded_sddmm(csr, reord, cfg, mesh,
                                          emit="csr")
    assert plans[0].a_window_rows is not None
    assert any(a >= 0 for a, _, _, _ in plans[0].res_groups or [])
    for p in plans[1:]:
        assert p.res_groups == plans[0].res_groups
        assert p.a_window_rows == plans[0].a_window_rows
    A, B = make_ab(csr, cfg.k)
    Bt = np.ascontiguousarray(B.T)
    A_dev, Bt_dev = shard_operands(A, Bt, mesh)
    out = np.asarray(fn(A_dev, Bt_dev, dplan))
    assert check_data(sddmm_ref(A, B, csr), out).passed


def test_shard_operands_divisibility():
    mesh = make_mesh(8)
    A = np.zeros((16, 8), np.float32)
    Bt = np.zeros((30, 8), np.float32)  # 30 % 8 != 0
    with pytest.raises(ValueError, match="divisible"):
        shard_operands(A, Bt, mesh, b_sharded=True)


def test_evaluate_reordering_finds_structure():
    """On a shuffled block mask, reordering must recover more dense blocks
    than the identity ordering (the reference's evaluationReordering
    comparison, BSMR.cpp:826-994)."""
    csr = random_mask(rows=1024, cols=1024, nnz=60000, seed=17,
                      block_rows=64, block_cols=256, block_fill=0.9,
                      shuffle_rows=True)
    cfg = SddmmConfig(k=32, panel_height=16, delta=0.3)
    ev = evaluate_reordering(csr, cfg)
    assert ev.num_dense_blocks > ev.num_dense_blocks_original
    assert ev.dense_nnz > ev.dense_nnz_original
    assert 0.0 < ev.dense_coverage <= 1.0
    extras = ev.as_extras()
    assert "denseBlockGain" in extras
