"""Numerical tests of the hybrid SDDMM against the fp64 oracle, with the
reference tolerance (abs 1e-5 OR rel 1e-3, include/checkData.hpp:14-30)."""

import numpy as np
import pytest

from bsmr_sddmm_tpu.config import SddmmConfig
from bsmr_sddmm_tpu.formats import make_dense, random_mask
from bsmr_sddmm_tpu.ops.sddmm import sddmm_ref
from bsmr_sddmm_tpu.sddmm import BsmrSddmm, sddmm
from bsmr_sddmm_tpu.utils.checkdata import check_data

from conftest import make_ab


@pytest.mark.parametrize("mode", ["bsr", "reorder"])
@pytest.mark.parametrize("delta", [0.0, 0.3, 1.1])
def test_xla_backend_matches_oracle(small_mask, delta, mode):
    cfg = SddmmConfig(k=32, panel_height=16, delta=delta, col_mode=mode,
                      dense_chunk=64, residual_chunk=4096)
    A, B = make_ab(small_mask, cfg.k)
    out = sddmm(A, B, small_mask, cfg)
    expected = sddmm_ref(A, B, small_mask)
    res = check_data(expected, out)
    assert res.passed, str(res)


@pytest.mark.parametrize("k", [8, 32, 64])
def test_k_sweep(tiny_mask, k):
    cfg = SddmmConfig(k=k, panel_height=16, dense_chunk=32,
                      residual_chunk=1024)
    A, B = make_ab(tiny_mask, k)
    out = sddmm(A, B, tiny_mask, cfg)
    res = check_data(sddmm_ref(A, B, tiny_mask), out)
    assert res.passed, str(res)


@pytest.mark.parametrize("mode", ["bsr", "reorder"])
def test_pallas_backend_matches_oracle(tiny_mask, mode):
    """backend="triton": the Pallas-Triton tile kernel (interpret mode on
    the CPU) for the bsr dense and packed tiers."""
    cfg = SddmmConfig(k=32, panel_height=16, backend="triton",
                      col_mode=mode, dense_chunk=32, residual_chunk=1024)
    A, B = make_ab(tiny_mask, cfg.k)
    out = sddmm(A, B, tiny_mask, cfg)
    res = check_data(sddmm_ref(A, B, tiny_mask), out)
    assert res.passed, str(res)


@pytest.mark.parametrize("backend", ["xla", "triton"])
@pytest.mark.parametrize("delta", [0.0, 0.3, 1.1])
def test_fp16_emission_matches_oracle(small_mask, delta, backend):
    """out_dtype="float16": fp32 accumulate, fp16 store. Must still pass
    the reference tolerance (fp16 round-off rel ~5e-4 < the 1e-3 gate)
    on every tier mix, both backends."""
    cfg = SddmmConfig(k=32, panel_height=16, delta=delta,
                      out_dtype="float16", backend=backend,
                      subpack_min_nnz=12,
                      dense_chunk=64, residual_chunk=4096)
    A, B = make_ab(small_mask, cfg.k)
    out = sddmm(A, B, small_mask, cfg)
    assert out.dtype == np.float16
    res = check_data(sddmm_ref(A, B, small_mask), out)
    assert res.passed, str(res)


def test_panel_heights(small_mask):
    for ph in (16, 32, 64):
        cfg = SddmmConfig(k=32, panel_height=ph, dense_chunk=32,
                          residual_chunk=4096)
        A, B = make_ab(small_mask, cfg.k)
        out = sddmm(A, B, small_mask, cfg)
        res = check_data(sddmm_ref(A, B, small_mask), out)
        assert res.passed, f"ph={ph}: {res}"


def test_pretransposed_b(tiny_mask):
    cfg = SddmmConfig(k=32, panel_height=16)
    A, B = make_ab(tiny_mask, cfg.k)
    pipe = BsmrSddmm(tiny_mask, cfg)
    out1 = pipe.run(A, B)                       # (K, N)
    out2 = pipe.run(A, np.ascontiguousarray(B.T))  # (N, K)
    np.testing.assert_allclose(out1, out2, rtol=1e-6)


def test_benchmark_log(tiny_mask):
    cfg = SddmmConfig(k=32, panel_height=16, num_iterations=2)
    A, B = make_ab(tiny_mask, cfg.k)
    pipe = BsmrSddmm(tiny_mask, cfg)
    log = pipe.benchmark(A, B, validate=True, file="tiny")
    assert log.check_result == "pass"
    assert log.gflops > 0
    text = log.to_text()
    assert "[bsmr_gflops" in text and "---New data---" in text
    from bsmr_sddmm_tpu.utils.logger import parse_log_text
    rec = parse_log_text(text)[0]
    assert rec["File"] == "tiny"
    assert int(rec["NNZ"]) == tiny_mask.nnz


def test_alpha_delta_cache(tiny_mask):
    """Row reordering must be computed once per alpha across a delta sweep
    (reference test mode reuses it, src/sddmm.cu:62-118)."""
    cfg = SddmmConfig(k=32)
    pipe = BsmrSddmm(tiny_mask, cfg)
    pipe.reorder(alpha=0.3, delta=0.1)
    r1 = pipe._row_cache[(0.3, cfg.row_strategy)]
    pipe.reorder(alpha=0.3, delta=0.9)
    assert pipe._row_cache[(0.3, cfg.row_strategy)] is r1


def test_windowed_gather_matches_oracle():
    """Force B-gather windowing (small window/threshold on a wide mask)
    and check the result is identical to the unwindowed path and the
    oracle — windowing must be a pure refactor."""
    import dataclasses
    import jax.numpy as jnp
    from bsmr_sddmm_tpu.ops.sddmm import device_plan, make_sddmm_fn
    from bsmr_sddmm_tpu.pack import pack_tiles
    from bsmr_sddmm_tpu.reorder import bsmr

    csr = random_mask(rows=1024, cols=40960, nnz=80000, seed=31,
                      block_rows=16, block_cols=64)
    # cols*k*4 = 5 MB > 2 MB threshold; window = 1 MB = 8192 rows
    cfg = SddmmConfig(k=32, panel_height=16, dense_chunk=16,
                      residual_chunk=2048, delta=0.9,
                      gather_window_mb=1, gather_window_threshold_mb=2)
    reord = bsmr(csr, cfg)
    plan = pack_tiles(csr, reord, cfg)
    assert plan.window_rows == 8192
    assert plan.g_groups or plan.res_groups
    if plan.g_groups:
        # window purity: every tile's columns inside its group window
        for base, s0, e0 in plan.g_groups:
            cols = plan.g_cols[s0:e0]
            assert cols.min() >= base
            assert cols.max() < base + plan.window_rows
    A, B = make_ab(csr, cfg.k)
    Bt = np.ascontiguousarray(B.T)
    fn = make_sddmm_fn(plan, cfg)
    out = np.asarray(fn(jnp.asarray(A), jnp.asarray(Bt),
                        device_plan(plan)))
    expected = sddmm_ref(A, B, csr)
    assert check_data(expected, out).passed
    # unwindowed plan computes the same values
    cfg0 = dataclasses.replace(cfg, gather_window_mb=0)
    plan0 = pack_tiles(csr, bsmr(csr, cfg0), cfg0)
    assert plan0.window_rows is None
    fn0 = make_sddmm_fn(plan0, cfg0)
    out0 = np.asarray(fn0(jnp.asarray(A), jnp.asarray(Bt),
                          device_plan(plan0)))
    np.testing.assert_allclose(out, out0, rtol=1e-5)


def test_tier_serialize_matches_default(small_mask, cfg):
    """The optimization_barrier chain (tier_serialize arm) is a
    scheduling hint only — outputs must be bit-identical to the
    freely-fused body."""
    import jax.numpy as jnp
    from bsmr_sddmm_tpu.formats import make_dense
    from bsmr_sddmm_tpu.ops.sddmm import device_plan, make_sddmm_body
    from bsmr_sddmm_tpu.pack import pack_tiles
    from bsmr_sddmm_tpu.reorder import bsmr

    plan = pack_tiles(small_mask, bsmr(small_mask, cfg), cfg)
    A = jnp.asarray(make_dense(small_mask.rows, cfg.k, seed=5))
    Bt = jnp.asarray(make_dense(small_mask.cols, cfg.k, seed=6))
    dplan = device_plan(plan, emit="rphm")
    base = make_sddmm_body(plan, cfg, emit="rphm")(A, Bt, dplan)
    ser = make_sddmm_body(plan, cfg.replace(tier_serialize=True),
                          emit="rphm")(A, Bt, dplan)
    for a, b in zip(base, ser):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
