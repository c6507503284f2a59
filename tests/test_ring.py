"""ppermute B-panel ring vs the fp64 oracle on the virtual 8-mesh."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from bsmr_sddmm_tpu.config import SddmmConfig
from bsmr_sddmm_tpu.datasets import banded
from bsmr_sddmm_tpu.formats import make_dense, random_mask
from bsmr_sddmm_tpu.ops.sddmm import sddmm_ref
from bsmr_sddmm_tpu.parallel.ring import (make_ring_sddmm, pack_ring_plans,
                                          ring_operands)
from bsmr_sddmm_tpu.parallel.sharding import make_mesh
from bsmr_sddmm_tpu.reorder import bsmr
from bsmr_sddmm_tpu.utils.checkdata import check_data


@pytest.mark.parametrize("n", [2, 8])
@pytest.mark.parametrize("gen", ["banded", "blocks"])
def test_ring_matches_oracle(n, gen):
    if gen == "banded":
        csr = banded(1024, 30000, 96, seed=3)
    else:
        csr = random_mask(rows=768, cols=1500, nnz=25000, seed=9,
                          block_rows=24, block_cols=96)
    cfg = SddmmConfig(k=32, panel_height=16, delta=0.02)
    mesh = make_mesh(n)
    reord = bsmr(csr, cfg)
    fn, plan = make_ring_sddmm(csr, reord, cfg, mesh, emit="csr")
    A = make_dense(csr.rows, cfg.k, seed=1)
    Bt = make_dense(csr.cols, cfg.k, seed=2)
    A_dev, Bt_dev = ring_operands(A, Bt, plan, mesh)
    out = np.asarray(jax.block_until_ready(fn(A_dev, Bt_dev)))
    expected = sddmm_ref(A, Bt.T, csr)
    res = check_data(expected, out)
    assert res.passed, f"error rate {res.error_rate}"


def test_ring_packing_partition():
    """Every nonzero lands in exactly one (shard, panel) group slot
    across the dense + gathered + residual tiers."""
    csr = random_mask(rows=512, cols=1024, nnz=20000, seed=5,
                      block_rows=16, block_cols=64)
    cfg = SddmmConfig(k=32, panel_height=16, delta=0.05)
    reord = bsmr(csr, cfg)
    plan = pack_ring_plans(csr, reord, cfg, 4)
    nnz = csr.nnz
    d = plan.tile_scatter[plan.tile_scatter < nnz]
    g = plan.g_scatter[plan.g_scatter < nnz]
    r = plan.res_out[plan.res_out < nnz]
    allv = np.concatenate([d.ravel(), g.ravel(), r.ravel()])
    assert allv.shape[0] == nnz
    np.testing.assert_array_equal(np.sort(allv), np.arange(nnz))
    # tile cblocks / gathered cols / residual cols are panel-local
    assert plan.tile_cb.max() < plan.w // plan.block_width
    if plan.num_gathered:
        assert plan.g_cols_l.max() < plan.w
    assert plan.res_col.max() < plan.w


def test_ring_gathered_tier_oracle():
    """A mask with hot residual columns must form panel-local gathered
    tiles in the ring plan (not fall entirely to per-nnz), and the ring
    output must still match the fp64 oracle."""
    rng = np.random.default_rng(11)
    # hub columns: many rows hit a small set of columns -> residual
    # (panel, col) counts well above the gathered cutoff
    rows, cols = 768, 2048
    hub = rng.integers(0, 64, 22000)
    rr = rng.integers(0, rows, 22000)
    uniq = np.unique(rr * cols + hub)
    from bsmr_sddmm_tpu.formats import CSR
    r_idx, c_idx = uniq // cols, uniq % cols
    order = np.lexsort((c_idx, r_idx))
    r_idx, c_idx = r_idx[order], c_idx[order]
    offs = np.zeros(rows + 1, np.int64)
    np.add.at(offs, r_idx + 1, 1)
    np.cumsum(offs, out=offs)
    csr = CSR(rows=rows, cols=cols, row_offsets=offs,
              col_indices=c_idx.astype(np.int32),
              values=np.ones(r_idx.shape[0], np.float32))
    cfg = SddmmConfig(k=32, panel_height=16, delta=0.6,
                      residual_tile_min_nnz=8)
    n = 4
    mesh = make_mesh(n)
    reord = bsmr(csr, cfg)
    fn, plan = make_ring_sddmm(csr, reord, cfg, mesh, emit="csr")
    assert plan.num_gathered > 0, "hub mask must form gathered ring tiles"
    A = make_dense(csr.rows, cfg.k, seed=1)
    Bt = make_dense(csr.cols, cfg.k, seed=2)
    A_dev, Bt_dev = ring_operands(A, Bt, plan, mesh)
    out = np.asarray(jax.block_until_ready(fn(A_dev, Bt_dev)))
    expected = sddmm_ref(A, Bt.T, csr)
    res = check_data(expected, out)
    assert res.passed, f"error rate {res.error_rate}"


def test_ring_uses_ppermute_not_all_gather():
    """The ring's jaxpr must rotate with ppermute (n-1 hops) and never
    all-gather B — the whole point of the layout."""
    csr = banded(512, 12000, 64, seed=7)
    cfg = SddmmConfig(k=32, panel_height=16, delta=0.02)
    n = 4
    mesh = make_mesh(n)
    reord = bsmr(csr, cfg)
    fn, plan = make_ring_sddmm(csr, reord, cfg, mesh, emit="rphm")
    A = make_dense(csr.rows, cfg.k, seed=1)
    Bt = make_dense(csr.cols, cfg.k, seed=2)
    A_dev, Bt_dev = ring_operands(A, Bt, plan, mesh)
    jaxpr = str(jax.make_jaxpr(fn)(A_dev, Bt_dev))
    assert jaxpr.count("ppermute") == n - 1
    assert "all_gather" not in jaxpr


def test_cost_balanced_shards_beat_nnz_on_skewed_mask():
    """On a mask whose tile density varies across row panels (power-law
    style), cost-balanced shard bounds must not be worse than the
    round-2 nnz bounds in predicted imbalance."""
    from bsmr_sddmm_tpu.autotune import COSTS, H100_KIND, estimate_plan_ms
    from bsmr_sddmm_tpu.pack import pack_shard_plans
    from bsmr_sddmm_tpu.datasets import rmat
    costs = COSTS[H100_KIND]   # the table, passed explicitly
    csr = rmat(4096, 150000, seed=13)
    cfg = SddmmConfig(k=128, panel_height=32, delta=0.006)
    reord = bsmr(csr, cfg)

    def imbalance(balance):
        plans = pack_shard_plans(csr, reord, cfg, 4, balance=balance)
        ms = [estimate_plan_ms(p, costs) for p in plans]
        return max(ms) / (sum(ms) / len(ms))

    imb_cost = imbalance("cost")
    imb_nnz = imbalance("nnz")
    assert imb_cost <= imb_nnz * 1.02, (imb_cost, imb_nnz)
    assert imb_cost < 1.5, imb_cost
